"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32 ⇒ MHA) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec frontend is a STUB per the assignment: ``input_specs`` provides
precomputed frame embeddings (B, S, d_model); the backbone is a classic
pre-LN transformer (LayerNorm, GELU, no GLU, sinusoidal positions) with an
LM head over the 2048-entry codebook.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    d_ff=8192,
    vocab=2048,
    n_heads=32,
    n_kv_heads=32,
    norm="layernorm",
    act="gelu",
    glu=False,
    pos="sinusoidal",
    embed_inputs=False,          # frame embeddings come from the stub frontend
    logits_chunk=4096,           # tiny vocab → big chunks are fine
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        ARCH, n_layers=2, d_model=64, d_ff=256, n_heads=4, n_kv_heads=4,
        head_dim=16, vocab=256, q_chunk=32, logits_chunk=64)
