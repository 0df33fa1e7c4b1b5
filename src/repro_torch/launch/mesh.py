"""The campaign mesh: the islands a mesh campaign runs on.  Port of
``make_campaign_mesh`` in ``repro/launch/mesh.py``.

JAX's campaign mesh is a 1-d ``("camp",)`` device mesh: one member slice
per device.  The port's is an ordered list of islands, each a
``torch.device``.  More islands than devices go round-robin over the
devices, as JAX's virtual CPU devices
(``--xla_force_host_platform_device_count``) put many on one host: eight
islands on one H100 are a valid mesh.  Islands on one card run in turn on
its default stream: the host makes every launch and syncs at every
eigen refresh, so a stream an island overlaps nothing, and a worker
thread an island ran S2 3.8–5.7× slower on an H100, every op handing
the GIL over (PERF.md, §6).  JAX's pod meshes
(``make_production_mesh``, ``make_mesh_for``, ``make_eval_mesh``,
``make_group_mesh``) have no counterpart yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CampaignMesh:
    """The ordered islands of a campaign, each a device (repeats
    included); member slice s runs on island s."""

    devices: Tuple[torch.device, ...]
    axis: str = "camp"

    @property
    def size(self) -> int:
        return len(self.devices)


def _physical(device) -> List[torch.device]:
    """The devices to place islands on: every visible CUDA device for
    ``None`` (raising without one), else ``device`` alone."""
    if device is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev]


def make_campaign_mesh(n_devices: Optional[int] = None,
                       devices: Optional[Sequence] = None, *,
                       device=None) -> CampaignMesh:
    """A campaign mesh of ``n_devices`` islands, round-robin over the
    visible CUDA devices (one island each by default), or over
    ``device`` alone (``device="cpu"``: islands on the CPU, as the tests
    use them).  ``devices`` lists the island devices explicitly, one
    island each, in order."""
    if devices is not None:
        placed = [_physical(d)[0] for d in devices]
        n = len(placed)
    else:
        phys = _physical(device)
        n = len(phys) if n_devices is None else int(n_devices)
        placed = [phys[i % len(phys)] for i in range(n)]
    if n < 1:
        raise ValueError(f"a campaign mesh needs an island, got {n}")
    return CampaignMesh(tuple(placed))
