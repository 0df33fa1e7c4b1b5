"""The training step: microbatched gradient accumulation, remat (inside
the model, ``cfg.remat``), mixed precision (the config's compute dtype,
f32 parameters and moments), optional int8 gradient compression, AdamW.
Port of ``repro/train/train_step.py``.

Gradients come from ``torch.autograd.grad`` over the parameter leaves: on
the card the LM's flash attention and WKV run their forward and backward
kernels (``kernels/ops.py``), on the CPU the plain versions' autograd.
The step is functional, as the JAX package's jitted one: it returns new
parameters and optimizer state and leaves its arguments untouched.
Sharding (``shard_grad_accum`` with a mesh, ``shardings_for``, a mesh at
all) is multi-card work and raises (ROADMAP.md, queue A item 16).
"""
from __future__ import annotations

import dataclasses
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compression import compress_decompress
from repro_torch.distributed.sharding import from_leaves, leaves, tree_map
from repro_torch.models import lm
from repro_torch.train import optimizer as opt_mod


def _no_mesh(what: str):
    return NotImplementedError(
        f"{what} needs a device mesh: multi-card training is not ported "
        "(ROADMAP.md, queue A item 16)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1           # grad-accumulation steps per train step
    grad_compress: str = "none"     # none | int8
    grad_accum_dtype: str = "float32"   # the accumulator's dtype
    shard_grad_accum: bool = False      # a no-op without a mesh
    adamw: opt_mod.AdamWConfig = dataclasses.field(
        default_factory=opt_mod.AdamWConfig)


def _split_microbatches(batch: dict, n: int):
    """(B, ...) → (n, B/n, ...) for every leaf with a leading batch dim."""
    def sp(x):
        B = x.shape[0]
        assert B % n == 0, f"batch {B} not divisible by microbatches {n}"
        return x.reshape((n, B // n) + tuple(x.shape[1:]))
    return {k: sp(v) for k, v in batch.items()}


def _value_and_grad(cfg: ModelConfig, params: dict, batch: dict):
    """((loss, metrics), grads): the gradient of ``lm.loss`` w.r.t. every
    parameter leaf, in the leaf's dtype."""
    flat = leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    val, metrics = lm.loss(cfg, from_leaves(params, live), batch)
    grads = torch.autograd.grad(val, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return ((val.detach(), {k: v.detach() for k, v in metrics.items()}),
            from_leaves(params, grads))


def grads_and_loss(cfg: ModelConfig, params: dict, batch: dict,
                   microbatches: int = 1, accum_dtype=torch.float32,
                   shard_accum: bool = False, mesh=None):
    """(grads, loss, metrics), the gradients accumulated over
    ``microbatches`` slices of the batch in ``accum_dtype`` and averaged,
    as the JAX package's scan does."""
    if shard_accum and mesh is not None:
        raise _no_mesh("shard_grad_accum")
    accum_dtype = _dtype(accum_dtype)
    if microbatches <= 1:
        (val, metrics), grads = _value_and_grad(cfg, params, batch)
        if accum_dtype != torch.float32:
            grads = tree_map(lambda g: g.to(accum_dtype), grads)
        return grads, val, metrics

    mb = _split_microbatches(batch, microbatches)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                         device=p.device), params)
    tot = torch.zeros((), dtype=torch.float32,
                      device=leaves(params)[0].device)
    for i in range(microbatches):
        (val, _), g = _value_and_grad(cfg, params,
                                      {k: v[i] for k, v in mb.items()})
        acc = tree_map(lambda a, x: a + x.to(accum_dtype), acc, g)
        tot = tot + val
    inv = 1.0 / microbatches
    grads = tree_map(lambda g: (g.to(torch.float32) * inv).to(accum_dtype),
                     acc)
    return grads, tot * inv, {"ce": tot * inv,
                              "moe_aux": torch.zeros_like(tot)}


def _dtype(d) -> torch.dtype:
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """Returns step(params, opt_state, batch) → (params, opt_state,
    metrics); ``batch`` holds ``tokens`` and ``labels`` tensors on the
    parameters' device.  ``grad_compress="int8"`` round-trips every
    gradient leaf through int8 before the update."""
    if mesh is not None:
        raise _no_mesh("make_train_step(mesh=...)")

    def step(params, opt_state, batch):
        grads, loss_val, metrics = grads_and_loss(
            cfg, params, batch, tcfg.microbatches,
            accum_dtype=_dtype(tcfg.grad_accum_dtype),
            shard_accum=tcfg.shard_grad_accum)
        if tcfg.grad_compress == "int8":
            grads = compress_decompress(grads)
        params2, opt2, opt_metrics = opt_mod.adamw_update(
            tcfg.adamw, params, grads, opt_state)
        return params2, opt2, dict(loss=loss_val, **metrics, **opt_metrics)

    return step


def shardings_for(cfg: ModelConfig, mesh, batch_example=None,
                  params_abstract=None):
    """The JAX package's (param, opt, batch) shardings: multi-card."""
    raise _no_mesh("shardings_for")

