"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA with QKV bias, tied embeddings [arXiv:2407.10671]."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    d_ff=4864,
    vocab=151936,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    qkv_bias=True,
    tied_embeddings=True,
    rope_theta=1e6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        ARCH, n_layers=2, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2,
        head_dim=16, vocab=512, q_chunk=32, logits_chunk=64)
