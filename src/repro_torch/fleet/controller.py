"""The fleet recovery loop: supervision for engines and the service (port
of ``repro/fleet/controller.py``).

Two supervisors share one failure model (fleet/health.py) and one fault
schedule (fleet/faults.py):

* ``IslandSupervisor`` — engine-level.  Hooks into the segment drivers
  through optional callbacks (``drive_segments(supervisor=...)`` and the
  mesh S2 round loop): a **supervised pull** that garbles/retries
  boundary reads and feeds the health detector, a **pre-dispatch** hook
  that injects scheduled delays, and a **boundary** hook that takes
  periodic host snapshots of island state and — on a death verdict —
  restores the last snapshot and replays.  Replay is exact: a carry is
  the island's complete search state and sampling is row-keyed
  prefix-stable, so re-running the lost segments regenerates the same
  generations the dead island computed (the mesh path re-lands them on a
  surviving device where there is one).
* ``FleetController`` — service-level.  Wraps a ``CampaignServer``: the
  server skips islands in ``server.down_islands`` and calls the
  controller's pull/delay hooks (``server.fleet``); the controller's
  ``step()`` applies due kills, converts health verdicts into failures,
  recovers a dead island's rows from the last on-disk snapshot (a
  PARTIAL ``checkpoint.store.restore`` — only the dead island's subtree
  is read), re-places them on surviving islands through the allocator
  (degraded mode; unplaceable rows park until a slot or the island
  returns), re-admits returning islands, and schedules
  ``_repack_lane``-based lane rebalancing when slot-occupancy skew
  between islands exceeds a threshold — the same relocation mechanism
  recovery uses, on a second trigger.

Snapshots own their storage: an engine snapshot is a CPU clone of every
leaf (``_host``), and a restore clones it again onto the island's device
(``_put``), so neither the live carry nor a later restore aliases it and
a second kill after the same snapshot replays exactly.  Recovery replays
the segment runners the run already used: it adds no program.

Rows recovered from a snapshot resume with the same state and keys; a
row that was admitted after the last snapshot replays from its request,
which is equally deterministic (admission state is a pure function of
it).  Either way the final ``IPOPResult`` matches the fault-free run
(``tests/test_torch_fleet.py``; ``chip_smoke.py`` phase 12 on the card).

Zero-overhead contract: nothing in the engines or the server imports
this module; with no supervisor installed every hook site is a single
host-side ``is None`` check (no device reads, no ``fleet_*`` series).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import store
from repro_torch.core import ladder
from repro_torch.distributed.sharding import tree_map
from repro_torch.fleet.faults import FaultPlan
from repro_torch.fleet.health import FleetHealth, HealthConfig
from repro_torch.obs.recorder import recorder as flight_recorder


@dataclasses.dataclass
class FleetConfig:
    """User surface of fleet supervision (``run_ipop(fleet=...)``,
    ``serve_campaigns --fleet``)."""

    snapshot_every: int = 4          # boundaries between snapshots
    plan: Optional[FaultPlan] = None  # injected chaos schedule (tests/bench)
    deadline_s: float = 30.0         # health: boundary-pull deadline
    stall_boundaries: int = 3        # health: no-progress boundaries → dead
    retries: int = 2                 # suspect pulls before dead; garbled-pull
    backoff_s: float = 0.0           # re-reads share the same retry budget
    skew_threshold: float = 0.5      # occupancy-fraction skew → lane repack
    postmortem_dir: Optional[str] = None  # flight-recorder dump directory

    def health_config(self) -> HealthConfig:
        return HealthConfig(deadline_s=self.deadline_s,
                            stall_boundaries=self.stall_boundaries,
                            retries=self.retries, backoff_s=self.backoff_s)


def _host(tree):
    """An owning host copy of a tree of tensors (dicts, NamedTuples,
    tuples, lists): every leaf cloned onto the CPU.  ``.cpu()`` of a CPU
    tensor is the tensor itself, so a snapshot made with it would follow
    the in-place row writes of the live state."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree_map(lambda a: a.detach().to("cpu", copy=True), tree)


def _devices(tree):
    """The device of every leaf, in ``tree``'s structure."""
    return tree_map(lambda a: a.device, tree)


def _put(tree, devices):
    """A fresh copy of a host tree on ``devices`` (one device, or a tree of
    them as ``_devices`` gives): the snapshot itself is never handed out."""
    if isinstance(devices, torch.device):
        return tree_map(lambda a: a.to(devices, copy=True), tree)
    return tree_map(lambda a, d: a.to(d, copy=True), tree, devices)


class IslandSupervisor:
    """Engine-level supervision: snapshot / fault / health hooks for the
    bucketed segment driver (one island) and the mesh S2 round loop (one
    island per shard)."""

    def __init__(self, cfg: Optional[FleetConfig] = None):
        self.cfg = cfg or FleetConfig()
        self.plan = self.cfg.plan
        self.health = FleetHealth(self.cfg.health_config())
        self._dispatched: set = set()   # islands with a segment in flight
        self._snap: Dict[int, dict] = {}
        self._statics: Dict[int, dict] = {}
        self._shard_dev: Dict[int, object] = {}
        self._dead_devs: set = set()
        #: host seconds each snapshot took (``chip_smoke.py`` reads them)
        self.snapshot_s: List[float] = []
        if self.cfg.postmortem_dir:
            flight_recorder().out_dir = self.cfg.postmortem_dir

    # -- shared hooks (service + both engine drivers) -----------------------

    def pull(self, island: int, boundary: int, fn):
        """Supervised boundary pull: apply scheduled corruption, retry
        implausible (non-monotone budget) reads, grade health.  ``fn``
        reads the schedule again at every call (a retry re-reads)."""
        t0 = time.perf_counter()
        k_idx, active, fevals, best_f = fn()
        if self.plan is not None and self.plan.corrupts(island, boundary):
            fevals = np.zeros_like(fevals)      # garbled read, fired once
        fev = float(np.sum(fevals))
        tries = 0
        while fev < self.health.last_fev(island) \
                and tries < max(1, self.cfg.retries):
            # budget counters are monotone by construction: a regressing
            # sum can only be a corrupt read — re-pull, with backoff
            tries += 1
            obs.metrics().counter("fleet_pull_retries_total",
                                  island=island).inc()
            if self.cfg.backoff_s:
                time.sleep(self.cfg.backoff_s * tries)
            k_idx, active, fevals, best_f = fn()
            fev = float(np.sum(fevals))
        expect = island in self._dispatched
        self._dispatched.discard(island)
        wall = time.perf_counter() - t0
        self.health.observe(island, boundary, fev, wall,
                            expect_progress=expect)
        # flight-recorder feed: host scalars already pulled, nothing new
        flight_recorder().observe(island, boundary, wall=round(wall, 6),
                                  fevals=fev,
                                  grade=self.health.state(island))
        return k_idx, active, fevals, best_f

    def before_dispatch(self, island: int, boundary: int):
        """Pre-dispatch hook: injected delay faults + the progress-expected
        marker the stall detector keys on."""
        if self.plan is not None:
            d = self.plan.delay(island, boundary)
            if d:
                time.sleep(d)
        self._dispatched.add(island)

    def _record_failure(self, island: int, b: int, reason: str, snap: dict):
        reg = obs.metrics()
        reg.counter("fleet_failures_total", reason=reason).inc()
        rec = flight_recorder()
        rec.observe(island, b, event="fault", grade="dead", reason=reason)
        rec.dump(island, b, "dead", extra={"reason": reason,
                                           "mode": "replayed",
                                           "snapshot_boundary":
                                               snap["boundary"]})
        return max(0.0, self.health.last_fev(island) - snap["fev"])

    def _record_recovery(self, t0: float, lost: float):
        reg = obs.metrics()
        reg.counter("fleet_recoveries_total", mode="replayed").inc()
        reg.histogram("fleet_recovery_wall_s").observe(
            time.perf_counter() - t0)
        reg.histogram("fleet_lost_work_evals").observe(lost)

    # -- bucketed drive_segments (single island 0) --------------------------

    def segment_boundary(self, b: int, carry, n_traces: int):
        """Called at the top of every ``drive_segments`` iteration; returns
        ``(carry, n_traces_to_keep, recovered)``.  On a death verdict the
        last snapshot's carry is restored on the devices it was taken from
        (the mesh S1 carry is a list of member slices, each on its own
        device) and the trace list truncated to the snapshot point —
        replay regenerates the rest identically."""
        ev = self.plan.kill_at(0, b) if self.plan is not None else None
        if ev is not None or self.health.is_dead(0):
            reason = ("killed" if ev is not None
                      else self.health.island(0).reason or "deadline")
            snap = self._snap.get(0)
            if snap is None:
                raise RuntimeError(
                    f"island died at boundary {b} before the first snapshot")
            t0 = time.perf_counter()
            lost = self._record_failure(0, b, reason, snap)
            with obs.tracer().span("recover", island=0, boundary=b,
                                   reason=reason, mode="replayed"):
                carry = _put(snap["carry"], snap["devices"])
                self.health.revive(0, b)
                self.health.reset_progress(0, snap["fev"])
                self._dispatched.discard(0)
            self._record_recovery(t0, lost)
            return carry, snap["n_traces"], True
        if self.cfg.snapshot_every and b % self.cfg.snapshot_every == 0:
            t0 = time.perf_counter()
            self._snap[0] = {"carry": _host(carry),
                             "devices": _devices(carry),
                             "n_traces": int(n_traces),
                             "fev": self.health.last_fev(0), "boundary": b}
            self.snapshot_s.append(time.perf_counter() - t0)
        return carry, n_traces, False

    # -- mesh S2 round loop (one island per shard) --------------------------

    def mesh_init(self, shards: List[dict], devs: List):
        """Record the per-shard statics (the keys and the fitness never
        change mid-campaign; a shard's ``"refit"``, where it has one,
        rebuilds its fitness on another device) and take snapshot 0."""
        for s, sh in enumerate(shards):
            self._statics[s] = {"keys": _host(sh["keys"]), "fit": sh["fit"],
                                "refit": sh.get("refit")}
            self._shard_dev[s] = devs[s % len(devs)]
        self._mesh_snapshot(0, shards)

    def _mesh_snapshot(self, rnd: int, shards: List[dict]):
        t0 = time.perf_counter()
        for s, sh in enumerate(shards):
            if sh["done"] and s in self._snap:
                continue                # final state already captured
            self._snap[s] = {
                "carry": _host(sh["carry"]),
                "traces": [_host(t) for t in sh["traces"]],
                "segments": list(sh["segments"]),
                "done": sh["done"], "best": sh["best"],
                "fevals": sh["fevals"],
                "fev": self.health.last_fev(s), "boundary": rnd,
            }
        self.snapshot_s.append(time.perf_counter() - t0)

    def mesh_round(self, rnd: int, shards: List[dict], devs: List):
        """Called at the top of every S2 round: apply due kills, convert
        health verdicts, take the periodic snapshot."""
        if self.plan is not None:
            for ev in self.plan.kills_at(rnd):
                if ev.island < len(shards):
                    self._mesh_kill(ev.island, rnd, shards, devs, "killed")
        for s in range(len(shards)):
            if self.health.is_dead(s):
                self._mesh_kill(s, rnd, shards, devs,
                                self.health.island(s).reason or "deadline")
        if self.cfg.snapshot_every and rnd \
                and rnd % self.cfg.snapshot_every == 0:
            self._mesh_snapshot(rnd, shards)

    def _replacement_device(self, s: int, devs: List):
        """Next device after the dead one, skipping known-dead devices;
        falls back to the dead device itself when no healthy device is
        left (simulated faults: the hardware is actually fine).  On one
        card every island is the same ``torch.device``, so the shard
        replays on that card: the simulated case."""
        old = self._shard_dev[s]
        self._dead_devs.add(old)
        start = devs.index(old) if old in devs else s
        for off in range(1, len(devs) + 1):
            cand = devs[(start + off) % len(devs)]
            if cand not in self._dead_devs:
                return cand
        return old

    def _mesh_kill(self, s: int, rnd: int, shards: List[dict], devs: List,
                   reason: str):
        snap = self._snap.get(s)
        if snap is None:
            raise RuntimeError(
                f"island {s} died at round {rnd} before the first snapshot")
        t0 = time.perf_counter()
        lost = self._record_failure(s, rnd, reason, snap)
        with obs.tracer().span("recover", island=s, boundary=rnd,
                               reason=reason, mode="replayed"):
            old = self._shard_dev[s]
            dev = self._replacement_device(s, devs)
            sh, stat = shards[s], self._statics[s]
            sh["keys"] = _put(stat["keys"], dev)
            sh["fit"] = (stat["refit"](dev)
                         if dev != old and stat["refit"] is not None
                         else stat["fit"])
            sh["carry"] = _put(snap["carry"], dev)
            sh["traces"] = list(snap["traces"])  # host trees; assembly is host
            sh["segments"] = list(snap["segments"])
            sh["done"], sh["best"] = snap["done"], snap["best"]
            sh["fevals"] = snap["fevals"]
            self._shard_dev[s] = dev
            self.health.revive(s, rnd)
            self.health.reset_progress(s, snap["fev"])
            self._dispatched.discard(s)
        self._record_recovery(t0, lost)


# ---------------------------------------------------------------------------
# service-level controller
# ---------------------------------------------------------------------------

def _rows_regressed(prev, jobs, fevals) -> bool:
    """True when some row STILL HOLDING the job it held at the last pull
    reads fewer evaluations — impossible for a monotone counter, so it can
    only be a garbled read.  Rows whose job changed (retired + re-used
    slot) are excluded: their reset-to-zero is legitimate."""
    if prev is None:
        return False
    pjobs, pfev = prev
    same = (pjobs == jobs) & (jobs >= 0)
    return bool(np.any(np.asarray(fevals)[same] < pfev[same]))


def _rows_advanced(prev, jobs, fevals) -> bool:
    """True when the island did real work since the last pull: a same-job
    row's counter advanced, or a freshly admitted row (job changed since
    the last pull) evaluated anything at all."""
    if prev is None:
        return True                     # first pull: nothing to compare
    pjobs, pfev = prev
    fevals = np.asarray(fevals)
    same = (pjobs == jobs) & (jobs >= 0)
    fresh = (pjobs != jobs) & (jobs >= 0)
    return bool(np.any(fevals[same] > pfev[same])
                or np.any(fevals[fresh] > 0))


def occupancy_counts(al) -> List[int]:
    """Occupied rows per island of one lane's allocator."""
    return [al.rows_per_island - al.free_rows(i)
            for i in range(al.n_islands)]


def occupancy_skew(al) -> float:
    """Max-min occupied-fraction spread across one lane's islands — the
    ``service_slot_occupancy`` skew the rebalance trigger is written
    against."""
    counts = occupancy_counts(al)
    return (max(counts) - min(counts)) / al.rows_per_island


class FleetController:
    """Fault-tolerant supervision loop around a ``CampaignServer``.

    Install by construction: ``ctl = FleetController(server, config)``;
    then drive the service through ``ctl.step()`` / ``ctl.drain()``
    instead of the server's own.  The controller owns the snapshot
    cadence (through the server's auto-snapshot path), fault application,
    health verdicts, row recovery and skew rebalancing; the server only
    carries two passive hook points (``down_islands`` and the
    ``fleet.pull`` / ``fleet.before_dispatch`` callbacks).
    """

    def __init__(self, server, config: Optional[FleetConfig] = None):
        from repro_torch.service import server as server_mod  # no cycle
        self._server_mod = server_mod
        self.server = server
        self.cfg = config or FleetConfig()
        self.sup = IslandSupervisor(self.cfg)
        self._pending: List[dict] = []       # parked recovered rows
        self._down_until: Dict[int, int] = {}
        # service-level progress attribution: lanes share an island index
        # and a retired slot's re-use legitimately REGRESSES the summed
        # counter, so the controller keeps per-(lane, island) row records
        # keyed by job id, grades corrupt reads and progress per same-job
        # row, and feeds the health core ONE observation per island per
        # round
        self._lane_rows: Dict[tuple, tuple] = {}  # (lane,isl)->(jobs,fevals)
        self._round: Dict[int, dict] = {}         # isl -> this round's obs
        self._live_next: Dict[int, int] = {}      # isl -> live rows dispatched
        self._expect: Dict[int, bool] = {}        # isl -> expect progress
        server.fleet = self
        if server.snapshot_dir and not server.snapshot_every:
            server.snapshot_every = self.cfg.snapshot_every
        if self.cfg.postmortem_dir:
            flight_recorder().out_dir = self.cfg.postmortem_dir

    @property
    def health(self) -> FleetHealth:
        """The fleet's detector — the server's boundary code reads island
        grades through ``server.fleet.health`` for its recorder feed."""
        return self.sup.health

    # hook points the server calls (see server._island_boundary)
    def pull(self, island: int, boundary: int, fn, lane=None, jobs=None):
        """Supervised boundary pull.  With ``lane``/``jobs`` (the service
        path) the monotonicity retry and the progress verdict are per
        same-job row: only a row still holding the job it held at the last
        pull can regress (corrupt read) or advance (progress) — slot re-use
        and multi-lane islands never alias.  Without them (engine paths)
        this defers to the island supervisor's summed-watermark pull."""
        if lane is None:
            return self.sup.pull(island, boundary, fn)
        t0 = time.perf_counter()
        k_idx, active, fevals, best_f = fn()
        if self.sup.plan is not None \
                and self.sup.plan.corrupts(island, boundary):
            fevals = np.zeros_like(fevals)      # garbled read, fired once
        jobs = np.asarray(jobs)
        prev = self._lane_rows.get((lane, island))
        tries = 0
        while prev is not None \
                and _rows_regressed(prev, jobs, fevals) \
                and tries < max(1, self.cfg.retries):
            tries += 1
            obs.metrics().counter("fleet_pull_retries_total",
                                  island=island).inc()
            if self.cfg.backoff_s:
                time.sleep(self.cfg.backoff_s * tries)
            k_idx, active, fevals, best_f = fn()
        rec = self._round.setdefault(island,
                                     {"wall": 0.0, "progressed": False})
        rec["wall"] = max(rec["wall"], time.perf_counter() - t0)
        rec["progressed"] = (rec["progressed"]
                             or _rows_advanced(prev, jobs, fevals))
        self._lane_rows[(lane, island)] = (jobs.copy(),
                                           np.asarray(fevals).copy())
        return k_idx, active, fevals, best_f

    def before_dispatch(self, island: int, boundary: int,
                        live_rows: Optional[int] = None):
        if live_rows is None:
            return self.sup.before_dispatch(island, boundary)
        if self.sup.plan is not None:
            d = self.sup.plan.delay(island, boundary)
            if d:
                time.sleep(d)
        # the island is only EXPECTED to progress next round if some live,
        # non-retired row was actually dispatched — an island whose only
        # residents are quarantined/finished rows dispatches nothing and
        # must never be graded "stalled"
        self._live_next[island] = (self._live_next.get(island, 0)
                                   + int(live_rows))

    def _grade_round(self, boundary: int):
        """Fold this round's per-lane pull records into one health
        observation per island, then roll the dispatch expectations."""
        for island, rec in self._round.items():
            self.sup.health.observe_progress(
                island, boundary, rec["progressed"], rec["wall"],
                expect_progress=self._expect.get(island, False))
        self._expect = {i: n > 0 for i, n in self._live_next.items()}
        self._round = {}
        self._live_next = {}

    # -- the supervised service loop ----------------------------------------

    def step(self):
        srv, b = self.server, self.server._boundary_n
        rejoined = [i for i, until in list(self._down_until.items())
                    if b >= until]
        for i in rejoined:
            self._rejoin(i, b)
        if self.cfg.plan is not None:
            for ev in self.cfg.plan.kills_at(b):
                if (ev.island < len(srv.devices)
                        and ev.island not in srv.down_islands):
                    self._fail_island(ev.island, b, "killed",
                                      down_for=ev.down_for)
        for i in self.sup.health.dead_islands():
            if i not in srv.down_islands and i < len(srv.devices):
                self._fail_island(
                    i, b, self.sup.health.island(i).reason or "deadline")
        self._place_pending()
        stats = srv.step()
        self._grade_round(b)
        if not srv.down_islands:
            self._maybe_rebalance("rejoin" if rejoined else "skew")
        return stats

    def drain(self, max_steps: int = 10_000):
        """Supervised ``server.drain``: also waits on parked recoveries
        (rows that could not be re-placed yet)."""
        from repro_torch.service.queue import JOB_REJECTED
        srv = self.server
        for _ in range(max_steps):
            stats = self.step()
            if (not stats.progressed() and not srv._resident_jobs()
                    and not self._pending and not len(srv.queue)):
                break
        else:
            raise RuntimeError(
                f"fleet did not drain in {max_steps} steps "
                f"({len(self._pending)} recoveries still parked)")
        while len(srv.queue):
            item = srv.queue.take()
            if item is None:
                break
            _req, t = item
            t.done_s = time.monotonic()
            srv._transition(t, JOB_REJECTED, "unplaceable at idle")
            obs.metrics().counter("service_jobs_total",
                                  event="rejected").inc()
        return [t for t in srv.tickets.values() if t.done]

    # -- failure + recovery --------------------------------------------------

    def _fail_island(self, i: int, b: int, reason: str, down_for: int = 0):
        """Declare island ``i`` dead and recover every row it held: restore
        each resident job's state from the last on-disk snapshot (partial
        read of exactly that island's subtree) — or replay from its request
        if it was admitted after the snapshot — and re-place it on a
        surviving island (or park it)."""
        srv = self.server
        t0 = time.perf_counter()
        srv.down_islands.add(i)
        self.sup.health.mark_dead(i, b, reason)
        # drop the island's pull records + expectations: the recovered rows
        # re-land elsewhere and the rejoined island comes back blank
        self._lane_rows = {k: v for k, v in self._lane_rows.items()
                           if k[1] != i}
        self._round.pop(i, None)
        self._live_next.pop(i, None)
        self._expect.pop(i, None)
        reg = obs.metrics()
        reg.counter("fleet_failures_total", reason=reason).inc()
        frec = flight_recorder()
        # the fault boundary itself is the last timeline entry of the
        # post-mortem, whatever the island's pull cadence was
        frec.observe(i, b, event="fault", grade="dead", reason=reason)
        frec.dump(i, b, "dead",
                  extra={"reason": reason, "down_for": down_for})
        snap = self._open_snapshot()
        lost = 0.0
        with obs.tracer().span("recover", island=i, boundary=b,
                               reason=reason, mode="reassign") as rspan:
            moved = parked = 0
            for lane in srv.lanes.values():
                al = lane.allocator
                if i >= al.n_islands:
                    continue
                for row in np.nonzero(al.row_jobs[i] >= 0)[0]:
                    job = int(al.row_jobs[i][row])
                    al.release(i, int(row))
                    t = srv.tickets[job]
                    vals, tr_row, own_row, fev_snap = self._recover_job(
                        snap, lane, job, t)
                    lost += max(0.0, float(t.fevals) - fev_snap)
                    rec = {"lane_key": lane.key, "job": job, "vals": vals,
                           "trace": tr_row, "own": own_row,
                           "budget": int(t.request.budget),
                           "failed_island": i, "boundary": b}
                    if self._try_place(rec):
                        moved += 1
                    else:
                        parked += 1
                        self._pending.append(rec)
                        t.island = t.row = None
                        reg.counter("fleet_recoveries_total",
                                    mode="requeued").inc()
                        srv.note_recovery(job, i, "requeued", b)
            rspan.attrs["reassigned"] = moved
            rspan.attrs["requeued"] = parked
        if down_for:
            self._down_until[i] = b + down_for
        reg.histogram("fleet_recovery_wall_s").observe(
            time.perf_counter() - t0)
        reg.histogram("fleet_lost_work_evals").observe(lost)

    def _open_snapshot(self) -> Optional[dict]:
        srv = self.server
        if not srv.snapshot_dir:
            return None
        step = store.latest_step(srv.snapshot_dir)
        if step is None:
            return None
        meta = store.load_meta(srv.snapshot_dir, step)
        if meta is None:
            return None
        return {"step": step, "meta": meta, "cache": {}}

    def _recover_job(self, snap: Optional[dict], lane, job: int, t):
        """One job's recovered row: ``(vals, trace_row, own_row,
        fev_at_snapshot)``.  ``vals`` matches ``_write_row``'s structure
        (CPU tensors from the snapshot, or the request's row on the lane's
        device); ``trace_row`` is the job's snapshot-era trace slice (or
        None when it replays from scratch)."""
        from repro_torch.service.queue import JOB_RUNNING
        meta = snap["meta"] if snap is not None else None
        jm = meta["jobs"].get(str(job)) if meta is not None else None
        if jm is not None and jm["status"] == JOB_RUNNING \
                and jm.get("lane") == list(lane.key):
            li = next((n for n, lm in enumerate(meta["lanes"])
                       if tuple(lm["key"]) == lane.key), None)
            if li is not None:
                lmeta = meta["lanes"][li]
                oi, orow = int(jm["island"]), int(jm["row"])
                if lmeta["alloc"]["row_jobs"][oi][orow] == job:
                    entry = self._load_island(snap, lane, li, lmeta, oi)
                    vals = {
                        "keys": entry["keys"][orow],
                        "fn_idx": int(entry["fn_idx"][orow]),
                        "budgets": int(entry["budgets"][orow]),
                        "insts": tree_map(lambda a: a[orow], entry["insts"]),
                        "carry": tree_map(lambda a: a[orow], entry["carry"]),
                        "_fid": int(entry["insts"].fid[orow]),
                    }
                    tr_row = own_row = None
                    if "own" in entry:
                        mask = entry["own"][orow] == job
                        if bool(mask.any()):
                            tr_row = tree_map(lambda a: a[orow][mask],
                                              entry["trace"])
                            own_row = entry["own"][orow][mask].numpy()
                    return vals, tr_row, own_row, float(jm["fevals"] or 0)
        # admitted after the snapshot (or no snapshot): replay from the
        # request — admission state is a pure function of it
        return (self.server._job_vals(lane, t.request, lane.engine.device),
                None, None, 0.0)

    def _load_island(self, snap: dict, lane, li: int, lmeta: dict,
                     oi: int) -> dict:
        """Partial snapshot read: exactly one (lane, island) subtree, as
        CPU tensors."""
        ck = (li, oi)
        if ck not in snap["cache"]:
            tmpl = self._server_mod._lane_template(lane, lmeta)
            template = {"lanes": {str(li): {"islands": {
                str(oi): tmpl["islands"][str(oi)]}}}}
            sub = store.restore(self.server.snapshot_dir, snap["step"],
                                template, device="cpu")
            snap["cache"][ck] = sub["lanes"][str(li)]["islands"][str(oi)]
        return snap["cache"][ck]

    def _try_place(self, rec: dict) -> bool:
        """Place one recovered row on the healthiest surviving island of
        its lane; False parks it for a later boundary."""
        srv = self.server
        lane = srv.lanes[rec["lane_key"]]
        al = lane.allocator
        cands = [j for j in range(al.n_islands)
                 if j not in srv.down_islands and al.free_rows(j) > 0]
        if not cands:
            return False
        j = max(cands, key=lambda x: (al.free_rows(x), -x))
        placed = al.alloc(rec["job"], rec["budget"], island=j)
        assert placed is not None
        _j, nr = placed
        isl = lane.islands[j]
        vals = {k: (_put(v, isl.device)
                    if isinstance(v, (torch.Tensor, tuple)) else v)
                for k, v in rec["vals"].items()}
        srv._write_row(isl, vals, nr)
        if rec["own"] is not None:
            tr, own = _expand_trace_row(al.rows_per_island, nr, rec["trace"],
                                        rec["job"])
            isl.traces.append((_put(tr, isl.device), own))
        t = srv.tickets[rec["job"]]
        t.lane, t.island, t.row = lane.key, j, nr
        obs.metrics().counter("fleet_recoveries_total",
                              mode="reassigned").inc()
        # stitch the job's trace across the failure: close the pre-failure
        # phase, mark the recovery, open a post-failure phase on the same root
        srv.note_recovery(rec["job"], rec.get("failed_island", -1),
                          "reassigned", rec.get("boundary", 0))
        return True

    def _place_pending(self):
        still = []
        for rec in self._pending:
            if not self._try_place(rec):
                still.append(rec)
        self._pending = still

    def _rejoin(self, i: int, b: int):
        """Re-admit a returned island: blank state (its rows were recovered
        elsewhere), alive again; the skew trigger repopulates it."""
        srv = self.server
        srv.down_islands.discard(i)
        self._down_until.pop(i, None)
        self.sup.health.revive(i, b)
        for lane in srv.lanes.values():
            if i < len(lane.islands):
                lane.islands[i] = lane._blank_island(lane.islands[i].device)
        obs.metrics().counter("fleet_recoveries_total",
                              mode="rejoined").inc()

    # -- skew rebalancing ----------------------------------------------------

    def _maybe_rebalance(self, trigger: str):
        """Schedule a lane repack when slot occupancy is skewed beyond the
        threshold AND a repack can actually improve it (spread of occupied
        counts > 1 row).  Only with the whole fleet healthy — degraded
        mode defers rebalancing until islands return."""
        srv = self.server
        for lane in srv.lanes.values():
            al = lane.allocator
            if al.n_islands < 2 or not al.occupied():
                continue
            counts = occupancy_counts(al)
            if max(counts) - min(counts) <= 1:
                continue
            if occupancy_skew(al) <= self.cfg.skew_threshold:
                continue
            self._rebalance_lane(lane)
            obs.metrics().counter("fleet_rebalances_total",
                                  trigger=trigger).inc()

    def _rebalance_lane(self, lane):
        """Live repack: copy the lane's islands to the host, lay the
        occupied rows back out round-robin across all islands (the
        allocator's repack order is island-major, hence balanced), and put
        each island back on its device — the elastic re-shard path
        ``CampaignServer.restore`` uses, applied to a running lane."""
        ltree: dict = {"islands": {}}
        trace_T = {}
        for i, isl in enumerate(lane.islands):
            entry = _host(dict(isl.arrays))
            if isl.traces:
                entry["trace"] = ladder.LadderTrace(*(
                    torch.cat([x.cpu() for x in xs], dim=1)
                    for xs in zip(*[t for t, _o in isl.traces])))
                own = np.concatenate([o for _t, o in isl.traces], axis=1)
                entry["own"] = torch.from_numpy(own)
                trace_T[str(i)] = int(own.shape[1])
            else:
                trace_T[str(i)] = 0
            ltree["islands"][str(i)] = entry
        lmeta = {"alloc": lane.allocator.to_meta(), "trace_T": trace_T}
        self._server_mod._repack_lane(self.server, lane, lmeta, ltree)


def _expand_trace_row(Bl: int, row: int, tr_row, job: int):
    """Blow a recovered single-row trace slice back up to an island-shaped
    ``(trace, own)`` entry: row ``row`` carries the job's generations, every
    other row is inert (``own=-1`` → never sliced into any result)."""
    T = int(tr_row.ran.shape[0])

    def grow(a):
        out = torch.zeros((Bl,) + tuple(a.shape), dtype=a.dtype)
        out[row] = a
        return out
    own = np.full((Bl, T), -1, np.int64)
    own[row] = job
    return tree_map(grow, tr_row), own
