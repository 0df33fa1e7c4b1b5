"""Architecture registry of the port: the JAX package's ten archs, in its
order, one module each with the published ``ARCH`` and its ``smoke()``
reduction.

    from repro_torch.configs import get_config, smoke_config, ARCHS
    cfg = get_config("qwen2-0.5b")
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

ARCHS = (
    "musicgen-large",
    "qwen2-0.5b",
    "phi3-mini-3.8b",
    "gemma3-27b",
    "gemma3-4b",
    "rwkv6-3b",
    "moonshot-v1-16b-a3b",
    "phi3.5-moe-42b-a6.6b",
    "zamba2-7b",
    "llama-3.2-vision-90b",
)

_MODULES = {
    "musicgen-large": "musicgen_large",
    "qwen2-0.5b": "qwen2_0_5b",
    "phi3-mini-3.8b": "phi3_mini",
    "gemma3-27b": "gemma3_27b",
    "gemma3-4b": "gemma3_4b",
    "rwkv6-3b": "rwkv6_3b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "zamba2-7b": "zamba2_7b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).ARCH


def smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


def override(cfg: ModelConfig, **kw) -> ModelConfig:
    return dataclasses.replace(cfg, **kw)
