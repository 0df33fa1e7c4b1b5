"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536 —
RWKV-6 "Finch", data-dependent decay [arXiv:2404.05892]."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab=65536,
    rwkv_head_dim=64,
    norm="layernorm",
    pos="none",
    glu=False,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        ARCH, n_layers=2, d_model=64, d_ff=128, vocab=512, rwkv_head_dim=16,
        logits_chunk=64)
