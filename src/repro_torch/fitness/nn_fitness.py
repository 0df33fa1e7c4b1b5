"""Neural-network loss as a black-box objective for IPOP-CMA-ES.  Port of
``repro/fitness/nn_fitness.py``.

A low-dimensional θ ∈ Rⁿ parameterises an adapter on a frozen LM (per-layer
output gains, a logit scale and an embedding gain), and the fitness is the
cross-entropy of the adapted model on a fixed batch: one ``lm.forward`` and
one ``lm.chunked_ce`` per candidate.  The returned function takes the
population (λ, n) and returns (λ,) in X's dtype (the port's ladder runs
float64; the model computes in its config's dtype and θ enters as f32, as
in the JAX package), meeting ``run_ipop``'s ``fitness_fn`` contract.
Candidates are evaluated one after another, as the JAX package's
``lax.map`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class AdapterSpace:
    """θ layout: [layer_gains (n_scales) | logit_scale (1) | embed_gain (1)]."""
    cfg: ModelConfig
    n_scales: int

    @property
    def dim(self) -> int:
        return self.n_scales + 2


def adapter_space(cfg: ModelConfig) -> AdapterSpace:
    return AdapterSpace(cfg=cfg, n_scales=cfg.n_layers)


def _apply_adapter(space: AdapterSpace, params: dict, theta: torch.Tensor):
    """The params with the stacked layers' ``wo``/``out_proj`` leaves scaled
    by (1 + 0.1·g_l); returns (params, logit_scale, embed_gain).  The other
    leaves are shared, not copied."""
    gains = theta[: space.n_scales]

    def scale_stacked(leaf):
        n_lead = leaf.shape[0]
        g = (1.0 + 0.1 * gains[:n_lead]).to(leaf.dtype)
        return leaf * g.reshape((n_lead,) + (1,) * (leaf.dim() - 1))

    def walk_scale(tree):
        if isinstance(tree, dict):
            return {k: (walk_scale(v) if k not in ("wo", "out_proj")
                        else scale_stacked(v)) for k, v in tree.items()}
        return tree

    p2 = dict(params)
    seg = dict(p2["segments"])
    seg["unit"] = walk_scale(seg["unit"])
    p2["segments"] = seg
    return p2, theta[space.n_scales], theta[space.n_scales + 1]


def make_nn_fitness(cfg: ModelConfig, params: dict, batch: dict,
                    device=None) -> tuple[Callable, AdapterSpace]:
    """Returns (fitness(X (λ, dim)) → (λ,), space).  ``batch`` holds
    ``tokens`` and ``labels`` (numpy or tensors); ``device=None`` means the
    CUDA device (and raises without one).  Params and batch are moved there
    if they are not."""
    device = resolve_device(device)
    space = adapter_space(cfg)
    params = lm.tree_to(params, device)
    batch = lm.tree_to(dict(batch), device)

    def eval_one(theta):
        p2, logit_scale, embed_gain = _apply_adapter(space, params, theta)
        hidden, _ = lm.forward(cfg, p2, batch)
        hidden = hidden * (1.0 + 0.1 * embed_gain).to(hidden.dtype)
        ce = lm.chunked_ce(cfg, p2, hidden, batch["labels"])
        return ce * (1.0 + 0.01 * torch.tanh(logit_scale))

    def fitness(X):
        with torch.no_grad():
            Xf = X.to(device=device, dtype=torch.float32)
            f = torch.stack([eval_one(theta) for theta in Xf])
        return f.to(X.dtype)

    return fitness, space
