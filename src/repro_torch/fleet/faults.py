"""Deterministic fault injection: the ``FaultPlan`` chaos schedule (port
of ``repro/fleet/faults.py``, the same events from the same seed).

A plan is a static list of ``FaultEvent``s, each pinned to a (island,
segment-boundary) coordinate, so a chaos run is exactly reproducible: the
same plan against the same request trace produces the same failures at
the same points of the schedule.  Three fault kinds:

* ``kill``    — the island dies at boundary ``b`` (its device state is
  considered lost); ``down_for`` boundaries later it may rejoin empty.
* ``delay``   — a host-side ``delay_s`` sleep is injected immediately
  before the island's next segment dispatch (models a slow worker; used
  to exercise the health deadline without killing anything).
* ``corrupt`` — the island's next boundary schedule pull returns a
  garbled (non-monotone) budget counter once; the supervisor's retry
  path must detect and re-pull.

This module is deliberately stdlib-only (no torch, no numpy): plans are
data.  Applying a fault — restoring a snapshot, sleeping, garbling a
pulled array — is the supervisor's job (fleet/controller.py).  The
zero-overhead contract is structural: engines hold no reference to this
module; a run without a supervisor pays a single host-side ``is None``
check per boundary and nothing else (pinned in tests/test_torch_fleet.py).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

KILL = "kill"
DELAY = "delay"
CORRUPT = "corrupt"
KINDS = (KILL, DELAY, CORRUPT)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``kind`` at (``island``, ``boundary``)."""

    kind: str
    island: int
    boundary: int
    down_for: int = 0        # kill: boundaries until rejoin (0 = never)
    delay_s: float = 0.0     # delay: injected host sleep before dispatch

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.island < 0 or self.boundary < 0:
            raise ValueError(f"fault coordinates must be >= 0: {self}")
        if self.kind == KILL and self.boundary == 0:
            # boundary 0 precedes the first snapshot-able state; a kill
            # there is indistinguishable from never starting the island
            raise ValueError("kill events start at boundary 1")
        if self.down_for < 0 or self.delay_s < 0:
            raise ValueError(f"negative fault magnitude: {self}")


class FaultPlan:
    """An immutable, indexable schedule of ``FaultEvent``s."""

    def __init__(self, events: Sequence[FaultEvent]):
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.boundary, e.island, e.kind)))
        self._kills: Dict[int, List[FaultEvent]] = {}
        self._delays: Dict[Tuple[int, int], float] = {}
        self._corrupts: Dict[Tuple[int, int], bool] = {}
        for ev in self.events:
            if ev.kind == KILL:
                self._kills.setdefault(ev.boundary, []).append(ev)
            elif ev.kind == DELAY:
                key = (ev.island, ev.boundary)
                self._delays[key] = self._delays.get(key, 0.0) + ev.delay_s
            else:
                self._corrupts[(ev.island, ev.boundary)] = True

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return f"FaultPlan({list(self.events)!r})"

    def kills_at(self, boundary: int) -> List[FaultEvent]:
        """Kill events due exactly at ``boundary`` (sorted by island)."""
        return self._kills.get(boundary, [])

    def kill_at(self, island: int, boundary: int) -> Optional[FaultEvent]:
        for ev in self._kills.get(boundary, []):
            if ev.island == island:
                return ev
        return None

    def delay(self, island: int, boundary: int) -> float:
        """Injected sleep (seconds) before this island's dispatch."""
        return self._delays.get((island, boundary), 0.0)

    def corrupts(self, island: int, boundary: int) -> bool:
        """True when this island's boundary pull must be garbled once."""
        return self._corrupts.get((island, boundary), False)

    def max_boundary(self) -> int:
        return max((e.boundary for e in self.events), default=0)

    # -- reproducible schedule generation -----------------------------------

    @classmethod
    def seeded(cls, seed: int, n_islands: int, *, kills: int = 1,
               delays: int = 0, corrupts: int = 0, horizon: int = 16,
               min_boundary: int = 1, down_for: int = 0,
               delay_s: float = 0.05) -> "FaultPlan":
        """A deterministic chaos schedule drawn from ``seed``: ``kills``
        kill events (at most one per island), plus optional delay/corrupt
        noise, all landing in ``[min_boundary, horizon]``."""
        if n_islands < 1:
            raise ValueError("need at least one island")
        lo = max(1, min_boundary)
        if horizon < lo:
            raise ValueError(f"horizon {horizon} < min boundary {lo}")
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        victims = list(range(n_islands))
        rng.shuffle(victims)
        for i in victims[:kills]:
            events.append(FaultEvent(KILL, i, rng.randint(lo, horizon),
                                     down_for=down_for))
        for _ in range(delays):
            events.append(FaultEvent(DELAY, rng.randrange(n_islands),
                                     rng.randint(lo, horizon),
                                     delay_s=delay_s))
        for _ in range(corrupts):
            events.append(FaultEvent(CORRUPT, rng.randrange(n_islands),
                                     rng.randint(lo, horizon)))
        return cls(events)

    @classmethod
    def parse(cls, spec: str, *, down_for: int = 0) -> "FaultPlan":
        """Parse a CLI kill schedule: ``"island:boundary[:down_for],..."``
        — e.g. ``"0:3,1:5:4"`` kills island 0 at boundary 3 forever and
        island 1 at boundary 5 for 4 boundaries."""
        events = []
        for cell in spec.split(","):
            cell = cell.strip()
            if not cell:
                continue
            parts = [int(p) for p in cell.split(":")]
            if len(parts) not in (2, 3):
                raise ValueError(f"bad kill cell {cell!r} "
                                 "(want island:boundary[:down_for])")
            dfor = parts[2] if len(parts) == 3 else down_for
            events.append(FaultEvent(KILL, parts[0], parts[1],
                                     down_for=dfor))
        return cls(events)
