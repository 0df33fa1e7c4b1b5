"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000
ssm_state=64 — Mamba2 backbone + shared full-attention block
[arXiv:2411.15242].

Simplification (DESIGN.md §5): a single shared transformer block (MHA + GLU
MLP over concat(x, x_embed₀), projected back to d_model) invoked after every
6th Mamba2 layer — 81 = 13 units of (6 mamba + shared-attn) + 3 tail mamba
layers.  The real Zamba2 alternates two shared blocks with per-invocation
LoRAs; the memory/compute shape is the same.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab=32000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        ARCH, n_layers=9, d_model=64, d_ff=128, n_heads=4, n_kv_heads=4,
        head_dim=32, vocab=512, ssm_state=16, ssm_head_dim=16,
        shared_attn_every=3, q_chunk=32, logits_chunk=64)
