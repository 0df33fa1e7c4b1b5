"""Architecture registry of the port: the archs whose serving path is
ported.  The JAX package's other archs raise ``KeyError`` (ROADMAP.md,
queue A item 14).

    from repro_torch.configs import get_config, smoke_config, ARCHS
    cfg = get_config("qwen2-0.5b")
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

ARCHS = ("qwen2-0.5b", "rwkv6-3b")

_MODULES = {"qwen2-0.5b": "qwen2_0_5b", "rwkv6-3b": "rwkv6_3b"}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported; the port has "
                       f"{list(ARCHS)} (ROADMAP.md, queue A item 14)")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).ARCH


def smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


def override(cfg: ModelConfig, **kw) -> ModelConfig:
    return dataclasses.replace(cfg, **kw)
