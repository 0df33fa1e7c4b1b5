"""Dense feed-forward blocks: (Sw)iGLU-gated and plain two-layer MLPs.
Port of ``repro/models/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch.models import layers


def init_mlp_params(gen, d_model: int, d_ff: int, glu: bool, param_dtype,
                    device, lead=()) -> dict:
    """Weights with leading axes ``lead`` (a layer stack)."""
    lead = tuple(lead)

    def dense(shape):
        return layers.dense_init(gen, lead + shape, param_dtype, device,
                                 len(lead))
    p = {"wi": dense((d_model, d_ff)), "wo": dense((d_ff, d_model))}
    if glu:
        p["wg"] = dense((d_model, d_ff))
    return p


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    dt = x.dtype
    fn = layers.activation(act)
    h = x @ p["wi"].to(dt)
    if "wg" in p:
        h = fn(x @ p["wg"].to(dt)) * h
    else:
        h = fn(h)
    return h @ p["wo"].to(dt)
