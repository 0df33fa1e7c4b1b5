"""AdamW with decoupled weight decay and global-norm clipping.  Port of
``repro/train/optimizer.py``.

Parameters, gradients and moments are nested dicts of tensors (the LM's
parameter tree); the moments are float32 and live on each parameter's
device.  ``adamw_update`` is functional, as in the JAX package: it returns
new parameter and moment tensors and leaves its arguments untouched, so a
caller can still drop a step (the trainer's NaN skip).  The scalars
(step, learning rate, bias corrections, clip factor) stay on the device:
a step reads nothing back to the host.

The decay mask pairs every leaf with its own path.  The JAX package zips
the leaves in ``jax.tree_util`` order (sorted keys) with the paths in the
dicts' insertion order, so on a tree whose dicts are not in sorted key
order it decays some other leaves than ``_decayable`` names (ROADMAP.md,
queue C); on a tree in sorted key order the two agree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.distributed.sharding import from_leaves, leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: dict              # first moment (f32, on each parameter's device)
    nu: dict              # second moment (f32)
    step: torch.Tensor    # () int32


def init_opt_state(params: dict) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    dev = leaves(params)[0].device
    return OptState(mu=zeros, nu=tree_map(torch.clone, zeros),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac·lr (f32)."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """√(Σ leaves Σ x²) in f32, the leaves summed in ``jax.tree_util``
    order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def _decayable(path: str) -> bool:
    """No decay on norms/scalars/biases (path-suffix heuristic)."""
    last = path.rsplit("/", 1)[-1]
    return not (last.startswith("ln") or "norm" in last or "scale" in last
                or last.startswith("b") and len(last) <= 2
                or last.startswith("gate") or last in ("u", "w0", "D",
                                                       "A_log", "dt_bias"))


def _flatten(tree, prefix: str = ""):
    """[(path, leaf)] in ``jax.tree_util`` order (sorted keys)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [pl for k in sorted(tree)
            for pl in _flatten(tree[k], f"{prefix}/{k}" if prefix else k)]


def adamw_update(cfg: AdamWConfig, params: dict, grads: dict,
                 state: OptState):
    """Returns (new_params, new_state, metrics): new tensors, the
    arguments untouched.  ``metrics`` holds the pre-clip ``grad_norm`` and
    the step's ``lr`` (0-d f32 tensors)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    new_p, new_mu, new_nu = [], [], []
    for (path, p), g, mu, nu in zip(_flatten(params), leaves(grads),
                                    leaves(state.mu), leaves(state.nu)):
        g32 = g.to(torch.float32) * scale
        mu = b1 * mu + (1 - b1) * g32
        nu = b2 * nu + (1 - b2) * torch.square(g32)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if _decayable(path) and cfg.weight_decay > 0:
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * upd).to(p.dtype))
        new_mu.append(mu)
        new_nu.append(nu)
    return (from_leaves(params, new_p),
            OptState(mu=from_leaves(params, new_mu),
                     nu=from_leaves(params, new_nu), step=step),
            {"grad_norm": gnorm, "lr": lr})
