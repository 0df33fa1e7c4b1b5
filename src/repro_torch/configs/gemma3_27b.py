"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local(sliding 1024):global interleave, dual RoPE theta
(10k local / 1M global), head_dim 128 decoupled from d_model, RMSNorm with
(1+w) scale [hf:google/gemma-3-*].

62 layers: 10 full (5 local + 1 global) pattern units + a 2-layer local tail
(the scanned stack handles the remainder — models/lm.py).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    d_ff=21504,
    vocab=262144,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    act="gelu",
    sliding_window=1024,
    local_per_global=5,
    rope_theta=1e4,
    rope_theta_global=1e6,
    logits_chunk=512,            # 262k vocab → small CE chunks
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        ARCH, n_layers=12, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2,
        head_dim=16, vocab=512, sliding_window=32, q_chunk=32,
        logits_chunk=64)
