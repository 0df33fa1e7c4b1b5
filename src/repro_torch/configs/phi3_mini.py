"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (kv=32 ⇒ MHA) d_ff=8192
vocab=32064 — RoPE + SwiGLU [arXiv:2404.14219]."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab=32064,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        ARCH, n_layers=2, d_model=64, d_ff=192, n_heads=4, n_kv_heads=4,
        head_dim=16, vocab=512, q_chunk=32, logits_chunk=64)
