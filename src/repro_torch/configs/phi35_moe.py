"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
(per expert) vocab=32064, MoE 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    d_ff=6400,
    vocab=32064,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    n_experts=16,
    experts_per_tok=2,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        ARCH, n_layers=2, d_model=64, d_ff=96, n_heads=4, n_kv_heads=2,
        head_dim=16, vocab=512, n_experts=4, experts_per_tok=2,
        q_chunk=32, logits_chunk=64)
