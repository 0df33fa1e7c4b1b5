"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global, 128k context [hf:google/gemma-3-4b-pt]."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    d_ff=10240,
    vocab=262144,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    act="gelu",
    sliding_window=1024,
    local_per_global=5,
    rope_theta=1e4,
    rope_theta_global=1e6,
    logits_chunk=512,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        ARCH, n_layers=12, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2,
        head_dim=16, vocab=512, sliding_window=32, q_chunk=32,
        logits_chunk=64)
