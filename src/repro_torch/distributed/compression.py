"""Gradient compression: per-leaf symmetric int8 quantization with an
error-feedback residual.  Port of ``repro/distributed/compression.py``.

``compress_decompress`` is the train step's hook: it round-trips every
gradient leaf through int8 (one f32 scale a leaf), which is what a
data-parallel all-reduce would move.  On one card there is no collective:
the hook costs the round trip and changes the gradients as the JAX
package's does.  ``torch.round`` and ``jnp.round`` both round half to
even, so the int8 codes equal the JAX package's bit for bit.

``ErrorFeedback`` keeps the quantization residual and adds it to the next
step's gradient (1-bit/signSGD-style EF).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed.sharding import tree_map


def quantize_int8(x: torch.Tensor):
    """(q int8, scale f32 0-d): q = clip(round(x / scale), ±127), scale =
    max|x| / 127 (1 for an all-zero x)."""
    x32 = x.to(torch.float32)
    amax = torch.max(torch.abs(x32))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compress_decompress(grads):
    """The int8 round trip of every gradient leaf (lossy), f32 out."""
    def rt(g):
        q, s = quantize_int8(g)
        return dequantize_int8(q, s, torch.float32)
    return tree_map(rt, grads)


class ErrorFeedback(NamedTuple):
    residual: dict


def init_error_feedback(params) -> ErrorFeedback:
    return ErrorFeedback(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params))


def compress_with_feedback(grads, ef: ErrorFeedback):
    """g' = Q(g + r);  r ← (g + r) − g'.  Returns (g', new_ef)."""
    def g_new(g, r):
        t = g.to(torch.float32) + r
        return dequantize_int8(*quantize_int8(t))
    g2 = tree_map(g_new, grads, ef.residual)
    r2 = tree_map(lambda g, r, d: g.to(torch.float32) + r - d, grads,
                  ef.residual, g2)
    return g2, ErrorFeedback(residual=r2)
