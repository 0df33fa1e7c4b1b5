"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
(per expert) vocab=163840, MoE 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B]."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    d_ff=1408,
    vocab=163840,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    n_experts=64,
    experts_per_tok=6,
    logits_chunk=1024,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        ARCH, n_layers=2, d_model=64, d_ff=96, n_heads=4, n_kv_heads=4,
        head_dim=16, vocab=512, n_experts=8, experts_per_tok=2,
        q_chunk=32, logits_chunk=64)
