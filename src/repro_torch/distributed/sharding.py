"""A campaign's member axis over the islands of a campaign mesh: the
port's counterpart of ``campaign_shardings`` in
``repro/distributed/sharding.py``.

Every leaf of a campaign tree (the keys, the stacked ``BBOBInstance``, a
``LadderCarry``, a member-major trace) carries the members on its leading
axis, so one split of that axis shards the whole tree, as one
``P("camp")`` spec does in JAX.  ``shard_members`` copies each island's
slice (or each device group's islands' slices) onto the island's device;
``join_members`` puts the parts back in island order.  ``tree_map`` and
``leaves`` also walk the LM's nested dicts (keys in sorted order, as
``jax.tree_util`` flattens them).  The LM sharding rules (``ShardingRules``,
``param_specs``, ``cache_specs``) wait for multi-card training (ROADMAP.md,
queue A item 16).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.launch.mesh import CampaignMesh


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensor leaves of dicts (sorted keys), NamedTuples,
    tuples and lists; None stays."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(t0)}
    if isinstance(t0, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    if isinstance(t0, tuple):
        vals = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*vals) if hasattr(t0, "_fields") else tuple(vals)
    raise TypeError(f"not a tensor tree: {type(t0)}")


def leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def from_leaves(template, values):
    """``values``, in ``leaves(template)``'s order, in ``template``'s
    structure."""
    it = iter(values)
    return tree_map(lambda _: next(it), template)


def members(tree) -> int:
    """The tree's member count: its leaves' leading axis."""
    return int(leaves(tree)[0].shape[0])


def _slices(mesh: CampaignMesh, B: int,
            groups: Optional[Sequence[Sequence[int]]]):
    """Per part, its device (the group's first island's) and its member
    indices: island s owns members [s·B/P, (s+1)·B/P)."""
    P = mesh.size
    if B % P:
        raise ValueError(f"{B} members do not split over {P} islands")
    Bl = B // P
    groups = [[i] for i in range(P)] if groups is None else groups
    return [(mesh.devices[g[0]], [j for i in g
                                  for j in range(i * Bl, (i + 1) * Bl)])
            for g in groups]


def place(tree, device: torch.device, index: List[int]):
    """A copy of ``tree``'s members ``index`` on ``device``."""
    def take(a):
        if index == list(range(index[0], index[-1] + 1)):
            a = a[index[0]:index[-1] + 1]
        else:
            a = a.index_select(0, torch.tensor(index, device=a.device))
        return a.to(device, copy=True)
    return tree_map(take, tree)


def shard_members(tree, mesh: CampaignMesh,
                  groups: Optional[Sequence[Sequence[int]]] = None) -> list:
    """``tree``'s member slices, one per island on its island, or with
    ``groups`` (lists of island indices) one per group, its islands'
    slices in group order on the group's first island."""
    return [place(tree, dev, idx)
            for dev, idx in _slices(mesh, members(tree), groups)]


def join_members(parts: list, mesh: CampaignMesh,
                 groups: Optional[Sequence[Sequence[int]]] = None,
                 device=None):
    """The inverse of ``shard_members``: one tree, its members in island
    order, on ``device`` (the first island's by default)."""
    groups = [[i] for i in range(mesh.size)] if groups is None else groups
    device = mesh.devices[0] if device is None else device
    chunks = {}
    for part, g in zip(parts, groups):
        Bl = members(part) // len(g)
        for j, i in enumerate(g):
            chunks[i] = tree_map(lambda a: a[j * Bl:(j + 1) * Bl], part)
    ordered = [chunks[i] for i in range(mesh.size)]
    return tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]),
                    *ordered)
