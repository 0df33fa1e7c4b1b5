"""Evaluation dispatch on a leading virtual-device axis (port of
``repro/core/eval_dispatch.py`` without ``shard_map_compat``, which waits
for the mesh slice).

The JAX package writes these from the per-device view, with named-axis
collectives under ``shard_map`` or ``vmap``.  Here the P virtual devices
are the leading axis of a tensor: ``flat_index`` is ``arange(P)``, an
all-gather is the tensor itself, and a psum is a sum over that axis or
over the devices of one group (``psum``).  A group is a contiguous range
of devices sharing one state slot: a descent of the strategies
(``Groups``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class FusableEval:
    """A fitness closure that also carries the separable coefficients of its
    evaluation.  Calling it behaves like the wrapped closure; the ladder
    detects the ``.sep`` payload and samples through the eval-fused kernel,
    so X is never written.  Built by ``bbob.fusable_fitness``."""

    __slots__ = ("fn", "sep")

    def __init__(self, fn, sep):
        self.fn = fn
        self.sep = sep

    def __call__(self, X):
        return self.fn(X)


class Groups(NamedTuple):
    """Devices in contiguous ranges, one per state slot: slot g owns the
    devices ``starts[g]:starts[g+1]``."""
    starts: tuple            # G + 1 Python ints, 0 … P
    index: torch.Tensor      # (P,) int64: the slot of each device


def groups(index: torch.Tensor) -> Groups:
    """``Groups`` of a per-device slot index that never decreases (each
    slot's devices contiguous).  Reads ``index`` on the host once."""
    idx = index.cpu().tolist()
    if any(b < a for a, b in zip(idx, idx[1:])):
        raise ValueError("a slot's devices must be contiguous")
    G = idx[-1] + 1 if idx else 0
    starts = [0] * (G + 1)
    for s in idx:
        starts[s + 1] += 1
    for g in range(G):
        starts[g + 1] += starts[g]
    return Groups(tuple(starts), index.long())


def flat_index(P: int, device=None) -> torch.Tensor:
    """The linear index of every device, (P,) int64."""
    return torch.arange(P, dtype=torch.int64, device=device)


def axis_size(x: torch.Tensor, axes: int = 1) -> int:
    """The number of devices of ``x``'s leading ``axes`` device axes."""
    size = 1
    for s in x.shape[:axes]:
        size *= int(s)
    return size


def all_gather_flat(x: torch.Tensor, axes: int = 1) -> torch.Tensor:
    """Every device's ``x`` in ``flat_index`` order: ``x`` with its leading
    ``axes`` device axes flattened into one."""
    return x.reshape((axis_size(x, axes),) + tuple(x.shape[axes:]))


def psum(x: torch.Tensor, grp: Groups) -> torch.Tensor:
    """Sum of ``x`` (P, ...) over the devices of each group: (G, ...)."""
    counts = {b - a for a, b in zip(grp.starts, grp.starts[1:])}
    G = len(grp.starts) - 1
    if len(counts) == 1:
        return x.reshape((G, counts.pop()) + tuple(x.shape[1:])).sum(1)
    return torch.stack([x[a:b].sum(0)
                        for a, b in zip(grp.starts, grp.starts[1:])])


def local_ranks(f_local: torch.Tensor, f_all_flat: torch.Tensor,
                my_flat_base: torch.Tensor) -> torch.Tensor:
    """Rank of each local fitness among a (masked) flat fitness vector.

    ``f_local`` (..., λ), ``f_all_flat`` (..., R) holding the descent's
    whole population with non-members and failed evaluations set to +inf,
    ``my_flat_base`` (...,) the flat slot of each device's first row;
    leading axes broadcast.  Ties are broken by the flat slot index, so the
    ranking is a strict total order (a centralized stable argsort)."""
    lam_local = f_local.shape[-1]
    dev = f_local.device
    my_idx = (my_flat_base[..., None]
              + torch.arange(lam_local, device=dev))            # (..., λ)
    all_idx = torch.arange(f_all_flat.shape[-1], device=dev)
    f_all = f_all_flat[..., None, :]
    f_loc = f_local[..., :, None]
    smaller = f_all < f_loc
    tie = (f_all == f_loc) & (all_idx < my_idx[..., None])
    finite = torch.isfinite(f_all)
    return ((smaller | tie) & finite).sum(-1)


def masked_fitness(f: torch.Tensor,
                   valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The straggler/failure mask: invalid evaluations rank last."""
    if valid is None:
        return f
    return torch.where(valid, f, torch.inf)
