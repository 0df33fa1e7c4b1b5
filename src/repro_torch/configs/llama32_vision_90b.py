"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attention image layers [hf:meta-llama/Llama-3.2-*-Vision].

100 layers = 20 pattern units of (4 self-attn + 1 gated cross-attn).  The
vision tower is a STUB per the assignment: ``input_specs`` provides
precomputed image patch embeddings (B, n_img_tokens, d_model); cross-attn KV
is computed once and cached for decode.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    d_ff=28672,
    vocab=128256,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    rope_theta=5e5,
    cross_every=5,
    n_img_tokens=1601,           # (448/14)² + 1 CLS, one tile
    logits_chunk=1024,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        ARCH, n_layers=10, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2,
        head_dim=16, vocab=512, cross_every=5, n_img_tokens=17,
        q_chunk=32, logits_chunk=64)
