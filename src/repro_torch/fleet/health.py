"""Per-island health tracking at segment boundaries (port of
``repro/fleet/health.py``: the same state machine).

The fleet's failure detector is a stale-lock-style watcher folded into the
one host sync the engines already pay: every boundary schedule pull is an
implicit heartbeat.  ``FleetHealth.observe`` grades each pull on two
axes —

* **deadline** — the pull's wall time.  A boundary pull is the only
  blocking wait on an island's device, so a pull that exceeds
  ``deadline_s`` means the island's running segment is wedged (or the
  device is gone).  One slow pull makes the island SUSPECT; ``retries``
  consecutive slow pulls make it DEAD.
* **progress** — the island's summed budget counters.  Counters that sit
  still for ``stall_boundaries`` boundaries while work is expected mean
  the island is burning schedule without evaluating (a stale lock on
  progress); that too is DEAD, with ``reason="stalled"``.

A *regressing* counter (fewer total evaluations than last observed) is
not graded here at all: budget counters are monotone by construction, so
a regress can only be a garbled read — the supervisor's pull wrapper
retries it (with ``backoff_s`` backoff) before the observation lands.

State transitions emit the ``fleet_island_state`` gauge (0=alive,
1=suspect, 2=dead).  The module needs nothing beyond the stdlib and the
dependency-free obs registry, so health logic is unit-testable with
synthetic observations — no devices, no engines.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch import obs

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"
STATE_CODE = {ALIVE: 0, SUSPECT: 1, DEAD: 2}


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Failure-detector knobs (see FleetConfig for the user surface)."""

    deadline_s: float = 30.0     # boundary pull slower than this: suspect
    stall_boundaries: int = 3    # no-progress boundaries before dead
    retries: int = 2             # consecutive suspect pulls before dead
    backoff_s: float = 0.0       # sleep between garbled-pull re-reads


@dataclasses.dataclass
class IslandHealth:
    """One island's detector record."""

    state: str = ALIVE
    reason: str = ""             # why DEAD: killed | deadline | stalled
    last_fev: float = 0.0        # last observed summed budget counter
    stalled_for: int = 0         # consecutive no-progress boundaries
    slow_pulls: int = 0          # consecutive over-deadline pulls
    down_since: Optional[int] = None


class FleetHealth:
    """The per-island state machine; islands materialize on first touch
    so one instance serves 1-island engine runs and N-island services."""

    def __init__(self, cfg: Optional[HealthConfig] = None):
        self.cfg = cfg or HealthConfig()
        self._islands: Dict[int, IslandHealth] = {}

    def island(self, i: int) -> IslandHealth:
        if i not in self._islands:
            self._islands[i] = IslandHealth()
            self._emit(i)
        return self._islands[i]

    def _emit(self, i: int):
        rec = self._islands[i]
        obs.metrics().gauge("fleet_island_state", island=i).set(
            float(STATE_CODE[rec.state]))

    def _set(self, i: int, state: str, boundary: int, reason: str = ""):
        rec = self.island(i)
        if rec.state == state:
            return
        rec.state = state
        rec.reason = reason if state == DEAD else ""
        rec.down_since = boundary if state == DEAD else None
        self._emit(i)
        # the detection timestamp of a kill→detect→restore recovery trace:
        # an instantaneous marker on the island's lane track
        obs.tracer().event("health", island=i, state=state,
                           boundary=boundary, reason=reason)

    # -- observations -------------------------------------------------------

    def observe_progress(self, i: int, boundary: int, progressed: bool,
                         wall_s: float, expect_progress: bool = True) -> str:
        """Grade one boundary with an EXPLICIT progress verdict; returns the
        island's new state.  This is the detector core: callers that can
        attribute progress precisely — the service-level controller knows
        per-row, per-job feval deltas and which rows were actually
        dispatched — pass their own ``progressed``/``expect_progress``
        booleans, so job-level pathology (a quarantined poison row, a
        retired slot being re-used) never reads as island stall.  The
        engine-level ``observe`` wraps this with the summed-counter
        watermark."""
        rec = self.island(i)
        if rec.state == DEAD:
            return DEAD
        if wall_s > self.cfg.deadline_s:
            rec.slow_pulls += 1
            if rec.slow_pulls > self.cfg.retries:
                self._set(i, DEAD, boundary, reason="deadline")
                return DEAD
            self._set(i, SUSPECT, boundary)
        else:
            rec.slow_pulls = 0
        if expect_progress and not progressed:
            rec.stalled_for += 1
            if rec.stalled_for >= self.cfg.stall_boundaries:
                self._set(i, DEAD, boundary, reason="stalled")
                return DEAD
            if rec.state == ALIVE:
                self._set(i, SUSPECT, boundary)
        else:
            rec.stalled_for = 0
            if rec.state == SUSPECT and rec.slow_pulls == 0:
                self._set(i, ALIVE, boundary)
        return rec.state

    def observe(self, i: int, boundary: int, fev_sum: float, wall_s: float,
                expect_progress: bool = True) -> str:
        """Grade one boundary pull; returns the island's new state.
        Progress is the summed budget counter advancing past its watermark
        (the single-tenant engine view — one island, one monotone sum)."""
        rec = self.island(i)
        state = self.observe_progress(i, boundary, fev_sum > rec.last_fev,
                                      wall_s, expect_progress=expect_progress)
        if state != DEAD:
            rec.last_fev = max(rec.last_fev, fev_sum)
        return state

    def last_fev(self, i: int) -> float:
        return self.island(i).last_fev

    def reset_progress(self, i: int, fev_sum: float):
        """Rebase the progress watermark after a snapshot restore (the
        restored counters are legitimately behind the last observation)."""
        rec = self.island(i)
        rec.last_fev = float(fev_sum)
        rec.stalled_for = 0

    # -- verdicts (the controller applies them) -----------------------------

    def mark_dead(self, i: int, boundary: int, reason: str):
        self._set(i, DEAD, boundary, reason=reason)

    def revive(self, i: int, boundary: int):
        rec = self.island(i)
        rec.slow_pulls = 0
        rec.stalled_for = 0
        rec.last_fev = 0.0
        self._set(i, ALIVE, boundary)

    def state(self, i: int) -> str:
        return self.island(i).state

    def is_dead(self, i: int) -> bool:
        return self.island(i).state == DEAD

    def dead_islands(self) -> List[int]:
        return sorted(i for i, r in self._islands.items() if r.state == DEAD)
