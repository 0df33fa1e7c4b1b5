"""The campaign server: streaming optimization as a service over the
bucketed engine (port of ``repro/service/server.py``).

Architecture
------------
The server owns a set of *lanes*, one per dim-class (``allocator.lane_key``).
A lane is a ``BucketedLadderEngine`` plus a fixed grid of member rows split
into *islands*, one a device entry of the campaign mesh, each driving its
own budget-adaptive segment schedule as the mesh engine's S2 does
(island-local ``bucketed.next_bucket``, one host read a boundary).  On one
device entry the lane is one island and the loop is the bucketed segment
driver with service hooks.  ``make_campaign_mesh(8)`` puts eight islands on
the one card; they run in turn, as the mesh engine's do.

Everything per job is a row of the island's tensors: base key, budget
(``segment_scan(max_evals=...)``, a (B,) tensor), fitness branch index and
BBOB instance; none is part of a program key.  Admission writes a row in
place at a segment boundary (ordered on the stream after the segment that
last read the tensor; no copy of the island is made), and the next segment
runs it, so the programs stay ≤ #buckets × #dim-classes for the service's
lifetime (``segment_compiles``).  The port compiles nothing: a program is
a segment runner from the mesh engine's ``ProgramCache``, keyed like the
JAX package's, and shared by successive servers.

The fitness of an island's rows: branch 0 is the BBOB menu (``bbob_fids``;
each fid evaluated once on the rows of that fid, as ``StackedFitness``
does; without a menu, +inf), branches 1..N the registered callables, each
called once on the rows that select it.  The JAX package evaluates every
branch on every row and selects one; the values are the same, and a NaN of
one branch stays in its rows.  A lane whose menu is wholly separable (f1,
f2) and has no callables samples through the eval-fused kernel, as the
campaigns do.  The fitness is built on the host from the rows' host
mirrors (branch and fid per row), so it reads nothing from the device.

Per boundary the server pulls the island's schedule (one transfer,
``bucketed.pull_schedule``), streams ticket updates, retires rows whose
job finished its budget, ladder or target, frees their slots, admits
queued requests into free rows, and dispatches the island's next bucket
segment.  Traces stay on the device until a row's job completes; then
that row's pieces and its best are pulled in one transfer and sliced into
the job's ``IPOPResult``.

Durability: ``snapshot()`` writes the island tensors, the traces and the
allocator and job tables through ``checkpoint/store.py``, in the JAX
package's layout; ``CampaignServer.restore`` rebuilds a server from the
newest committed step (the JAX package's too), onto another island count
if asked: rows are relocatable, so the allocator re-packs them.

Fleet supervision (``repro_torch.fleet.FleetController``) installs
itself on ``fleet`` and marks failed islands in ``down_islands``: the
server skips those islands, pulls through ``fleet.pull``, calls
``fleet.before_dispatch`` and reads island grades from ``fleet.health``.
Without a controller both stay empty and every hook site is one host
``is None`` test.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import store
from repro_torch.core import bucketed, ladder, prng
from repro_torch.core import ipop as ipop_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.eval_dispatch import FusableEval
from repro_torch.distributed.mesh_engine import ProgramCache
from repro_torch.distributed.sharding import leaves, tree_map
from repro_torch.fitness import bbob
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_campaign_mesh
from repro_torch.obs.recorder import recorder as flight_recorder
from repro_torch.service import queue as qmod
from repro_torch.service.allocator import SlotAllocator, lane_key
from repro_torch.service.queue import (JOB_CANCELLED, JOB_DONE, JOB_EXPIRED,
                                       JOB_QUARANTINED, JOB_QUEUED,
                                       JOB_REJECTED, JOB_RUNNING, JOB_SHED,
                                       CampaignRequest, CampaignTicket)


class FitnessRegistry:
    """Named fitness callables, branches 1..N of every lane's dispatch
    (branch 0 is the BBOB menu).  A callable is a batch evaluator
    ``f(X: (rows, n)) -> (rows,)`` of torch tensors.

    The registry is versioned: starting a server freezes the current
    generation, and registering on a live server opens generation g+1.
    Lanes are keyed by the generation they were built against
    (``allocator.lane_key``): resident generation-g lanes keep their
    programs and their prefix ``fns_at(g)`` of the branch list, while new
    jobs route to generation-g+1 lanes.  Registration is append-only, so
    a callable's branch index (``1 + index(name)``) is the same in every
    generation that holds it."""

    def __init__(self):
        self._names: List[str] = []
        self._fns: List[Callable] = []
        self._gens: List[int] = []      # birth generation per callable
        self._gen = 0                   # current (newest) generation
        self._frozen = False

    def register(self, name: str, fn: Callable):
        if name in self._names:
            raise ValueError(f"fitness {name!r} already registered")
        if self._frozen:
            # live rollout: a new program-family generation; existing
            # lanes never see the grown branch list
            self._gen += 1
            self._frozen = False
        self._names.append(name)
        self._fns.append(fn)
        self._gens.append(self._gen)
        return fn

    def freeze(self):
        self._frozen = True

    @property
    def generation(self) -> int:
        return self._gen

    def index(self, name: str) -> int:
        return self._names.index(name)

    def gen_added(self, name: str) -> int:
        """The generation a callable first appeared in: the lowest lane
        generation that can run a job naming it."""
        return self._gens[self._names.index(name)]

    def fns_at(self, gen: int) -> Tuple[Callable, ...]:
        """The branch list of generation ``gen`` (a prefix of ``fns``)."""
        return tuple(f for f, g in zip(self._fns, self._gens) if g <= gen)

    def names_at(self, gen: int) -> Tuple[str, ...]:
        return tuple(n for n, g in zip(self._names, self._gens) if g <= gen)

    def align_generations(self, names: Sequence[str], gens: Sequence[int],
                          gen: int):
        """Restore hook: stamp re-registered callables with their birth
        generations from the snapshot, so its lane keys resolve as they
        did."""
        for n, g in zip(names, gens):
            if n in self._names:
                self._gens[self._names.index(n)] = int(g)
        self._gen = max(self._gen, int(gen))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self._names)

    @property
    def fns(self) -> Tuple[Callable, ...]:
        return tuple(self._fns)


# ---------------------------------------------------------------------------
# lane program cache: the mesh engine's ProgramCache (closure-keyed entries
# capped and evicted first in, first out)
# ---------------------------------------------------------------------------

_SEGMENT_CACHE = ProgramCache()


def _lane_label(key: tuple) -> str:
    """Metric label of a lane key: ``d<dim>.l<lam_start>.k<kmax_exp>.<dtype>``
    plus ``.g<gen>`` after a registry rollout."""
    dim, lam, kmax, dtype = key[:4]
    gen = key[4] if len(key) > 4 else 0
    base = f"d{dim}.l{lam}.k{kmax}.{dtype}"
    return f"{base}.g{gen}" if gen else base


def program_cache_stats() -> dict:
    return _SEGMENT_CACHE.snapshot()


def clear_program_cache():
    _SEGMENT_CACHE.clear()


def _devices_key(devices) -> tuple:
    return tuple((d.type, d.index) for d in devices)


def pull_leaves(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Tensors of one device as numpy arrays in one device→host transfer:
    every leaf packed into one int64 tensor (floats by their float64
    bits), copied once and unpacked with its own dtype and shape."""
    parts = []
    for x in tensors:
        x = x.reshape(-1)
        parts.append(x.to(torch.float64).view(torch.int64)
                     if x.dtype.is_floating_point else x.to(torch.int64))
    host = torch.cat(parts).cpu().numpy()
    out, at = [], 0
    for x in tensors:
        n = x.numel()
        chunk = host[at:at + n]
        at += n
        np_dt = torch.empty((), dtype=x.dtype).numpy().dtype
        val = (chunk.view(np.float64) if x.dtype.is_floating_point
               else chunk).astype(np_dt)
        out.append(val.reshape(tuple(x.shape)))
    return out


class ServiceFitness:
    """The fitness of an island's rows: X (Bl, rows, n) → (Bl, rows).
    Built on the host from the rows' branch indices and fids: branch 0's
    rows go through ``bbob.StackedFitness`` (each BBOB fid of the menu once
    on its rows), each callable runs once on the rows that select it; rows
    with no job, and branch-0 rows of a server without a menu, get +inf."""

    def __init__(self, insts: bbob.BBOBInstance, fn_idx: np.ndarray,
                 fids: np.ndarray, occupied: np.ndarray,
                 bbob_fids: tuple, custom: tuple):
        dev = insts.x_opt.device
        idx = np.clip(fn_idx, 0, len(custom))
        # rows off branch 0 carry fid 0, which no menu holds
        self.menu = (bbob.StackedFitness(
            insts, tuple(bbob_fids),
            fids=np.where(occupied & (idx == 0), fids, 0), fill=np.inf)
            if bbob_fids else None)
        self.custom = []
        for j, fn in enumerate(custom):
            sel = occupied & (idx == j + 1)
            if sel.any():
                self.custom.append((fn, torch.as_tensor(
                    np.nonzero(sel)[0], dtype=torch.int64, device=dev)))

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        F = (self.menu(X) if self.menu is not None else
             torch.full(X.shape[:-1], torch.inf, dtype=X.dtype,
                        device=X.device))
        for fn, r in self.custom:
            Xr = X.index_select(0, r)
            val = torch.as_tensor(fn(Xr.reshape(-1, X.shape[-1])),
                                  dtype=X.dtype, device=X.device)
            F.index_copy_(0, r, val.reshape(Xr.shape[:-1]))
        return F


class _Island:
    """One device entry's slice of a lane: its rows' tensors, the host
    mirrors of their branch and fid, the device-resident traces, and the
    rows' fitness (rebuilt when a row is written or freed)."""

    __slots__ = ("device", "arrays", "traces", "fn_host", "fid_host", "fit")

    def __init__(self, device, arrays, fn_host, fid_host):
        self.device = device
        self.arrays = arrays    # {"keys","fn_idx","budgets","insts","carry"}
        # [(LadderTrace (Bl, g, S) on the device, its (Bl, g) np job ids)]
        self.traces: List[tuple] = []
        self.fn_host = fn_host
        self.fid_host = fid_host
        self.fit = None


class _Lane:
    """One dim-class: engine + islands + allocator + program bookkeeping."""

    def __init__(self, key: tuple, server: "CampaignServer"):
        dim, lam_start, kmax_exp, dtype, reg_gen = key
        self.key = key
        self.reg_gen = int(reg_gen)
        self.server = server
        devices = server.devices
        self.engine = bucketed.BucketedLadderEngine(
            n=dim, lam_start=lam_start, kmax_exp=kmax_exp,
            max_evals=server.max_budget, domain=server.domain,
            sigma0_frac=server.sigma0_frac, impl=server.impl, dtype=dtype,
            eigen_interval=server.eigen_interval,
            seg_blocks=server.seg_blocks, policy=server.policy,
            device=devices[0])
        # one engine (its parameter stacks) per device
        self.engines = {self.engine.device: self.engine}
        for d in devices:
            if d not in self.engines:
                self.engines[d] = dataclasses.replace(self.engine, device=d)
        self.bbob_fids = tuple(server.bbob_fids)
        # the branch list of this lane's registry generation: a rollout
        # grows the registry, never this tuple
        self.custom_fns = server.registry.fns_at(self.reg_gen)
        self.fused = bool(self.bbob_fids) and not self.custom_fns and all(
            f in bbob.FUSABLE_FIDS for f in self.bbob_fids)
        self.m_peaks = (101 if 21 in self.bbob_fids
                        else 21 if 22 in self.bbob_fids else 1)
        self.fill_fid = self.bbob_fids[0] if self.bbob_fids else 1
        self._fillers: Dict[torch.device, bbob.BBOBInstance] = {}
        self.seg_len: Dict[int, int] = {}
        self.used_programs: set = set()
        self.allocator = SlotAllocator(len(devices), server.rows_per_island)
        self.islands = [self._blank_island(d) for d in devices]

    @property
    def tdtype(self) -> torch.dtype:
        return self.engine.full.cfg.tdtype

    def filler_inst(self, device) -> bbob.BBOBInstance:
        """The inert rows' instance (the menu's first fid, instance 0)."""
        device = torch.device(device)
        if device not in self._fillers:
            self._fillers[device] = bbob.pad_instance(
                bbob.make_instance(self.fill_fid, self.key[0], 0,
                                   self.tdtype, device), self.m_peaks)
        return self._fillers[device]

    def blank_arrays(self, device, Bl: Optional[int] = None) -> dict:
        """One island's inert rows on ``device``: keys ``fold_in(PRNGKey(0),
        j)``, fresh carries with ``active`` False, the filler instance,
        branch 0 and budget 0."""
        Bl = self.allocator.rows_per_island if Bl is None else int(Bl)
        device = torch.device(device)
        eng = self.engines[device]
        keys = ladder.member_keys(0, Bl, device)
        # rows are written in place: no leaf may be a broadcast view
        carry = tree_map(lambda a: a.clone(
            memory_format=torch.contiguous_format), eng.init_carry(keys))
        carry = carry._replace(active=torch.zeros_like(carry.active))
        insts = bbob.BBOBInstance(*(leaf[None].repeat(
            (Bl,) + (1,) * leaf.dim()) for leaf in self.filler_inst(device)))
        return {"keys": keys,
                "fn_idx": torch.zeros((Bl,), dtype=torch.int32,
                                      device=device),
                "budgets": torch.zeros((Bl,), dtype=torch.int64,
                                       device=device),
                "insts": insts, "carry": carry}

    def _blank_island(self, device, Bl: Optional[int] = None) -> _Island:
        Bl = self.allocator.rows_per_island if Bl is None else int(Bl)
        return _Island(device, self.blank_arrays(device, Bl),
                       np.zeros(Bl, np.int32),
                       np.full(Bl, self.fill_fid, np.int64))

    # -- segment programs -----------------------------------------------------
    def program_key(self, k: int, seg_gens: int) -> tuple:
        eng, srv = self.engine, self.server
        return ("service", eng.bucket_cfgs[k], self.key, eng.max_evals,
                tuple(srv.domain), srv.sigma0_frac, srv.impl, self.bbob_fids,
                self.custom_fns, self.m_peaks, int(k), int(seg_gens),
                _devices_key(srv.devices))

    def runner(self, k: int, seg_gens: int) -> Callable:
        key = self.program_key(k, seg_gens)
        traces0 = _SEGMENT_CACHE.stats["traces"]
        with obs.tracer().span(
                "compile", key=f"{_lane_label(self.key)}.k{k}.g{seg_gens}",
                lane=_lane_label(self.key)) as sp:
            fn = _SEGMENT_CACHE.get(key,
                                    lambda: self._build_runner(k, seg_gens))
            sp.attrs["hit"] = _SEGMENT_CACHE.stats["traces"] == traces0
        self.used_programs.add(key)
        return fn

    def _build_runner(self, k: int, seg_gens: int) -> Callable:
        """``run(keys (Bl, 2), budgets (Bl,), fitness, carry) -> (carry,
        trace)`` of one island, the trace member-major (Bl, g, S)."""
        engines = self.engines

        def run(keys, budgets, fitness_fn, carry):
            eng = engines[carry.k_idx.device]
            c, tr = eng.segment_scan(k, keys, fitness_fn, carry, seg_gens,
                                     max_evals=budgets)
            return c, ladder.member_major(tr)
        return run

    def island_fitness(self, isl: _Island, i: int) -> Callable:
        """The island's fitness, built from its host mirrors once per row
        change; eval-fused (separable coefficients per row, laid out per
        slot) when the lane's menu allows it."""
        if isl.fit is None:
            occupied = self.allocator.row_jobs[i] >= 0
            insts = isl.arrays["insts"]
            fit = ServiceFitness(insts, isl.fn_host, isl.fid_host, occupied,
                                 self.bbob_fids, self.custom_fns)
            if self.fused:
                sep = bbob.separable_coeffs(insts, self.bbob_fids,
                                            fids=isl.fid_host)
                fit = FusableEval(fit, sep)
            isl.fit = ops.slot_fitness(fit, self.engine.full.n_slots,
                                       self.tdtype)
        return isl.fit


@dataclasses.dataclass
class StepStats:
    dispatched: int = 0
    admitted: int = 0
    finalized: int = 0
    rejected: int = 0
    expired: int = 0                    # queue-TTL/deadline retirements
    shed: int = 0                       # priority-shed settlements

    def progressed(self) -> bool:
        return bool(self.dispatched or self.admitted or self.finalized
                    or self.rejected or self.expired or self.shed)


class CampaignServer:
    """Multi-tenant streaming campaign service (see the module docstring).

    ``devices`` / ``mesh`` (a ``launch.mesh.CampaignMesh``) give the
    islands, one a device entry; by default one island on the CUDA device,
    raising without one.  ``bbob_fids`` is the BBOB menu requests may use;
    custom callables come from ``registry``.  ``max_budget`` bounds every
    job's budget (the bucket segments are sized by it)."""

    def __init__(self, registry: Optional[FitnessRegistry] = None,
                 mesh=None, devices: Optional[Sequence] = None,
                 bbob_fids: Tuple[int, ...] = (1, 8),
                 lam_start: int = 12, kmax_exp: int = 4,
                 dtype: str = "float64", impl: str = "auto",
                 policy: str = "cover", eigen_interval: Optional[int] = None,
                 seg_blocks: Optional[int] = None,
                 domain: Tuple[float, float] = (-5.0, 5.0),
                 sigma0_frac: float = 0.25, max_budget: int = 200_000,
                 rows_per_island: int = 4, max_pending: int = 256,
                 max_lanes: int = 16, snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 0,
                 metrics_out: Optional[str] = None,
                 quarantine_nonfinite: bool = True,
                 quarantine_stall_boundaries: int = 0):
        ops.validate_impl(impl)
        if devices is not None:
            mesh = make_campaign_mesh(devices=devices)
        elif mesh is None:
            mesh = make_campaign_mesh(1)    # the CUDA device, or raise
        self.devices = list(mesh.devices)
        self.registry = registry if registry is not None else FitnessRegistry()
        self.registry.freeze()
        self.bbob_fids = tuple(bbob_fids)
        self.lam_start, self.kmax_exp = int(lam_start), int(kmax_exp)
        self.dtype, self.impl, self.policy = dtype, impl, policy
        self.eigen_interval, self.seg_blocks = eigen_interval, seg_blocks
        self.domain, self.sigma0_frac = tuple(domain), float(sigma0_frac)
        self.max_budget = int(max_budget)
        self.rows_per_island = int(rows_per_island)
        self.max_lanes = int(max_lanes)
        self.snapshot_dir, self.snapshot_every = snapshot_dir, snapshot_every
        # the JSONL metrics sink, flushed once a round; where metrics go
        # belongs to the serving process, not to the snapshot's config
        self.metrics_out = metrics_out
        # poison policy: quarantine a job whose best is non-finite after
        # real evaluations, and/or whose evaluations stay flat for N
        # boundaries it was dispatched (0 = off); host checks on the
        # pulled schedule only
        self.quarantine_nonfinite = bool(quarantine_nonfinite)
        self.quarantine_stall_boundaries = int(quarantine_stall_boundaries)
        self.queue = qmod.AdmissionQueue(max_pending=max_pending)
        self.tickets: Dict[int, CampaignTicket] = {}
        self.lanes: Dict[tuple, _Lane] = {}
        self._completed: set = set()
        self._boundary_n = 0
        # per-job trace spans, kept off the ticket so snapshots hold none
        self._job_spans: Dict[int, dict] = {}
        self._cancels: set = set()      # running jobs to retire at boundary
        self._dedup: Dict[str, int] = {}        # dedup_key -> job id
        self._noprog: Dict[int, Tuple[int, int]] = {}   # job -> (fev, flats)
        self._seg_jobs: Dict[tuple, set] = {}   # (lane key, island) -> jobs
        # fleet supervision hook points (repro_torch.fleet.FleetController):
        # the server never imports the fleet — a controller installs itself
        # on ``fleet`` and marks failed islands in ``down_islands``
        self.fleet = None
        self.down_islands: set = set()

    # -- config round-trip (snapshots) ----------------------------------------
    _CONFIG_FIELDS = ("bbob_fids", "lam_start", "kmax_exp", "dtype", "impl",
                      "policy", "eigen_interval", "seg_blocks", "domain",
                      "sigma0_frac", "max_budget", "rows_per_island",
                      "max_lanes", "quarantine_nonfinite",
                      "quarantine_stall_boundaries")

    def config_meta(self) -> dict:
        out = {f: getattr(self, f) for f in self._CONFIG_FIELDS}
        out["bbob_fids"] = list(out["bbob_fids"])
        out["domain"] = list(out["domain"])
        return out

    # -- submission -----------------------------------------------------------
    def submit(self, req: CampaignRequest,
               now_s: Optional[float] = None) -> CampaignTicket:
        """Enqueue one job and return its ticket at once.  The request is
        checked against this server (budget ≤ ``max_budget``, ``fid`` in
        the BBOB menu, ``fitness`` registered): a violation raises
        ``ValueError`` here; a full queue raises ``queue.QueueFull``.
        ``now_s`` replaces the submit time (``time.monotonic()``).  A
        ``req.dedup_key`` that maps to a live or completed ticket returns
        that ticket and enqueues nothing; one whose job ended shed,
        cancelled, expired, rejected or quarantined admits the retry."""
        req.validate()
        if req.dedup_key is not None:
            prev = self.tickets.get(self._dedup.get(req.dedup_key, -1))
            if prev is not None and (not prev.terminal or prev.done):
                return prev             # idempotent resubmit
        if req.budget > self.max_budget:
            raise ValueError(f"budget {req.budget} exceeds the service "
                             f"max_budget {self.max_budget}")
        if req.fid is not None and req.fid not in self.bbob_fids:
            raise ValueError(f"fid {req.fid} is not in the BBOB menu "
                             f"{self.bbob_fids}")
        if req.fitness is not None and req.fitness not in self.registry.names:
            raise ValueError(f"unknown fitness {req.fitness!r}; registered: "
                             f"{self.registry.names}")
        self.registry.freeze()          # pin the current generation
        t = self.queue.submit(
            req, now_s=time.monotonic() if now_s is None else now_s)
        self.tickets[t.job_id] = t
        if req.dedup_key is not None:
            self._dedup[req.dedup_key] = t.job_id
        reg = obs.metrics()
        reg.counter("service_jobs_total", event="submitted").inc()
        reg.counter("service_job_lifecycle_total",
                    **{"from": "new", "to": JOB_QUEUED}).inc()
        self._open_job_trace(t)
        self._settle_shed()             # the submit may have evicted a victim
        return t

    def cancel(self, job_id: int) -> bool:
        """Cancel one job: a queued one at once (``cancelled``), a running
        one at its island's next boundary, with the partial result up to
        it.  False for unknown or terminal jobs."""
        t = self.tickets.get(job_id)
        if t is None or t.terminal:
            return False
        if t.status == JOB_QUEUED:
            if self.queue.remove(job_id) is None:
                return False
            t.done_s = time.monotonic()
            self._transition(t, JOB_CANCELLED, "cancelled by client")
            obs.metrics().counter("service_jobs_total",
                                  event="cancelled").inc()
            return True
        self._cancels.add(job_id)       # honored at the next boundary pull
        return True

    # -- lifecycle bookkeeping ------------------------------------------------
    _TERMINAL_STATES = (JOB_DONE, JOB_REJECTED, JOB_CANCELLED, JOB_EXPIRED,
                        JOB_QUARANTINED, JOB_SHED)

    def _open_job_trace(self, t: CampaignTicket, phase: str = JOB_QUEUED):
        """A job's root span and its lifecycle-phase child."""
        tr = obs.tracer()
        root = tr.start("job", job=t.job_id, dim=t.request.dim,
                        priority=t.request.priority)
        ph = tr.start("running" if phase == JOB_RUNNING else "queued",
                      parent=root, job=t.job_id)
        self._job_spans[t.job_id] = {"root": root, "phase": ph}

    def _close_job_trace(self, t: CampaignTicket):
        spans = self._job_spans.pop(t.job_id, None)
        if spans is None:
            return
        tr = obs.tracer()
        ph = spans.get("phase")
        if ph is not None and ph.t1 is None:
            tr.end(ph)
        tr.end(spans["root"], status=t.status, reason=t.reason)

    def _grade(self, island: int) -> str:
        """The island's health grade: the fleet's, or "alive" without
        one."""
        return ("alive" if self.fleet is None
                else self.fleet.health.state(island))

    def note_recovery(self, job_id: int, island: int, mode: str,
                      boundary: int):
        """Fleet hook: stitch a recovered job's trace across the failure.
        Ends the pre-failure "running" phase, drops a "recover" marker and
        opens the post-failure "running" phase, all children of the same
        root span."""
        spans = self._job_spans.get(job_id)
        if spans is None:
            return
        tr = obs.tracer()
        ph = spans.get("phase")
        if ph is not None and ph.t1 is None:
            tr.end(ph, failed_island=island)
        tr.event("recover", parent=spans["root"], job=job_id, mode=mode,
                 failed_island=island, boundary=boundary)
        spans["phase"] = tr.start("running", parent=spans["root"],
                                  job=job_id)

    def _transition(self, t: CampaignTicket, status: str, reason: str = ""):
        """Move a ticket to ``status``: the edge is counted, entering
        ``running`` swaps the phase span, a terminal status ends the root."""
        frm = t.status
        t.status = status
        if reason:
            t.reason = reason
        obs.metrics().counter("service_job_lifecycle_total",
                              **{"from": frm, "to": status}).inc()
        if status in self._TERMINAL_STATES:
            self._close_job_trace(t)
        elif status == JOB_RUNNING:
            spans = self._job_spans.get(t.job_id)
            if spans is not None:
                tr = obs.tracer()
                ph = spans.get("phase")
                if ph is not None and ph.t1 is None:
                    tr.end(ph)
                spans["phase"] = tr.start("running", parent=spans["root"],
                                          job=t.job_id)

    def _settle_shed(self, stats: Optional[StepStats] = None):
        """Account the tickets the queue shed since the last settle."""
        reg = obs.metrics()
        for t in self.queue.drain_shed():
            t.done_s = time.monotonic()
            reg.counter("service_job_lifecycle_total",
                        **{"from": JOB_QUEUED, "to": JOB_SHED}).inc()
            reg.counter("service_shed_total").inc()
            reg.counter("service_jobs_total", event="shed").inc()
            self._close_job_trace(t)
            if stats is not None:
                stats.shed += 1

    def _expire_queued(self, stats: Optional[StepStats] = None):
        """Retire pending tickets whose queue TTL or deadline passed."""
        reg = obs.metrics()
        for t in self.queue.expire(time.monotonic()):
            t.done_s = time.monotonic()
            reg.counter("service_job_lifecycle_total",
                        **{"from": JOB_QUEUED, "to": JOB_EXPIRED}).inc()
            reg.counter("service_jobs_total", event="expired").inc()
            self._close_job_trace(t)
            if stats is not None:
                stats.expired += 1

    # -- lanes ----------------------------------------------------------------
    def _lane_key(self, req: CampaignRequest) -> tuple:
        """The request's dim-class at the right registry generation: the
        newest existing lane of its class at or above the generation its
        callable was born in, else a new lane at the current generation."""
        need = (0 if req.fitness is None
                else self.registry.gen_added(req.fitness))
        base = lane_key(req, lam_start=self.lam_start, kmax_exp=self.kmax_exp,
                        dtype=self.dtype)[:4]
        fits = [k for k in self.lanes if k[:4] == base and k[4] >= need]
        if fits:
            return max(fits, key=lambda k: k[4])
        return base + (max(need, self.registry.generation),)

    def _get_lane(self, key: tuple, create: bool = True) -> Optional[_Lane]:
        lane = self.lanes.get(key)
        if lane is None and create:
            if len(self.lanes) >= self.max_lanes:
                return None
            lane = _Lane(key, self)
            self.lanes[key] = lane
        return lane

    def _create_lanes(self):
        for t in self.queue.pending():
            self._get_lane(self._lane_key(t.request))

    # -- the service loop -----------------------------------------------------
    def step(self) -> StepStats:
        """One service round: every island gets a segment boundary (pull,
        stream, retire, admit, dispatch)."""
        stats = StepStats()
        self._settle_shed(stats)
        self._expire_queued(stats)
        self._create_lanes()
        for lane in self.lanes.values():
            for i, isl in enumerate(lane.islands):
                if i in self.down_islands:
                    continue
                self._island_boundary(lane, i, isl, stats)
        self._boundary_n += 1
        reg = obs.metrics()
        reg.counter("service_boundaries_total").inc()
        reg.gauge("service_queue_depth").set(len(self.queue))
        for lane in self.lanes.values():
            lbl = _lane_label(lane.key)
            al = lane.allocator
            for i in range(al.n_islands):
                reg.gauge("service_slot_occupancy", lane=lbl, island=i).set(
                    1.0 - al.free_rows(i) / al.rows_per_island)
        pc = program_cache_stats()
        if pc["hits"] + pc["traces"]:
            reg.gauge("service_program_cache_hit_rate").set(
                pc["hits"] / (pc["hits"] + pc["traces"]))
        reg.gauge("service_registry_generation").set(
            self.registry.generation)
        if self.metrics_out:
            reg.flush_jsonl(self.metrics_out)
        if (self.snapshot_dir and self.snapshot_every
                and self._boundary_n % self.snapshot_every == 0):
            self.snapshot()
        return stats

    def drain(self, max_steps: int = 10_000) -> List[CampaignTicket]:
        """Run until every submitted job completed (or was rejected)."""
        for _ in range(max_steps):
            stats = self.step()
            if not stats.progressed() and not self._resident_jobs():
                break
        else:
            raise RuntimeError(f"service did not drain in {max_steps} steps")
        # anything still queued at idle can never be placed (lane cap)
        while len(self.queue):
            item = self.queue.take()
            if item is None:
                break
            _req, t = item
            t.done_s = time.monotonic()
            self._transition(t, JOB_REJECTED, "unplaceable at idle")
            obs.metrics().counter("service_jobs_total",
                                  event="rejected").inc()
        return [t for t in self.tickets.values() if t.done]

    def release_ticket(self, job_id: int) -> Optional[CampaignTicket]:
        """Pop a terminal ticket (None if unknown or live), so a long run
        keeps O(resident) tickets; its dedup key is unpinned."""
        t = self.tickets.get(job_id)
        if t is None or not t.terminal:
            return None
        dk = t.request.dedup_key
        if dk is not None and self._dedup.get(dk) == job_id:
            del self._dedup[dk]
        return self.tickets.pop(job_id)

    def _resident_jobs(self) -> int:
        return sum(len(lane.allocator.occupied())
                   for lane in self.lanes.values())

    def _island_boundary(self, lane: _Lane, i: int, isl: _Island,
                         stats: StepStats):
        al = lane.allocator
        reg = obs.metrics()
        lbl = _lane_label(lane.key)
        pull_span = obs.tracer().start("pull", lane=lbl, island=i)
        t0 = time.perf_counter()
        if self.fleet is not None:
            k_idx, active, fevals, best_f = self.fleet.pull(
                i, self._boundary_n,
                lambda: bucketed.pull_schedule(isl.arrays["carry"]),
                lane=lane.key, jobs=al.row_jobs[i].copy())
        else:
            k_idx, active, fevals, best_f = bucketed.pull_schedule(
                isl.arrays["carry"])
        pull_wall = time.perf_counter() - t0
        obs.tracer().end(pull_span, boundary=self._boundary_n)
        reg.histogram("service_boundary_pull_s", lane=lbl).observe(pull_wall)
        lam_cur = lane.engine.lam_start * (2 ** k_idx)

        # -- stream, enforce the lifecycle, collect finished rows: host
        # decisions on the pulled arrays and the host clock only
        now = time.monotonic()
        ran = self._seg_jobs.get((lane.key, i), ())
        finish: List[Tuple[int, int, Optional[Tuple[str, str]]]] = []
        deact: List[int] = []
        for row in np.nonzero(al.row_jobs[i] >= 0)[0]:
            job = int(al.row_jobs[i][row])
            t = self.tickets[job]
            t.best_f = float(best_f[row])
            t.fevals = int(fevals[row])
            if not t.updates and t.submit_s is not None:
                reg.histogram("service_time_to_first_ticket_s").observe(
                    time.monotonic() - t.submit_s)
            t.push({"boundary": self._boundary_n, "fevals": t.fevals,
                    "best_f": t.best_f, "k": int(k_idx[row])})
            target = t.request.target
            hit = target is not None and best_f[row] <= target
            done = (not active[row]
                    or fevals[row] + lam_cur[row] > al.budgets[i][row])
            verdict = None if done else self._row_verdict(
                t, job, int(fevals[row]), float(best_f[row]), job in ran,
                now)
            if (hit or verdict is not None) and not done:
                deact.append(int(row))  # early or lifecycle retirement
                active[row] = False
                done = True
            if done:
                finish.append((int(row), job, None if hit else verdict))
        flight_recorder().observe(
            i, self._boundary_n, lane=lbl,
            wall=round(pull_wall, 6), fevals=int(np.sum(fevals)),
            grade=self._grade(i),
            verdicts=[{"job": job, "status": v[0], "reason": v[1]}
                      for _row, job, v in finish if v is not None])
        for row in deact:               # in place, after the last segment
            isl.arrays["carry"].active[row] = False
        if finish:
            with obs.tracer().span("retire", lane=lbl, island=i,
                                   boundary=self._boundary_n,
                                   rows=len(finish)):
                for row, job, verdict in finish:
                    if verdict is None:
                        self._finalize(lane, i, isl, row, job)
                    else:
                        self._finalize(lane, i, isl, row, job,
                                       status=verdict[0], reason=verdict[1])
                    stats.finalized += 1
        self._prune_traces(isl)

        # -- admission (highest priority first, this island's free rows)
        while al.free_rows(i) > 0:
            item = self.queue.take(lambda r: self._lane_key(r) == lane.key)
            if item is None:
                break
            req, t = item
            row = self._admit(lane, i, isl, req, t)
            k_idx[row], active[row], fevals[row] = 0, True, 0
            stats.admitted += 1

        # -- dispatch the island's next segment
        live, k = bucketed.next_bucket(lane.engine, k_idx, active, fevals,
                                       lane.seg_len, budgets=al.budgets[i])
        if k is None:
            self._seg_jobs[(lane.key, i)] = set()
            return
        self._seg_jobs[(lane.key, i)] = {
            int(al.row_jobs[i][r]) for r in np.nonzero(live)[0]
            if al.row_jobs[i][r] >= 0}
        with obs.tracer().span("dispatch", lane=lbl, island=i, bucket=int(k),
                               boundary=self._boundary_n):
            runner = lane.runner(k, lane.seg_len[k])
            if self.fleet is not None:
                self.fleet.before_dispatch(i, self._boundary_n,
                                           live_rows=int(np.sum(live)))
            a = isl.arrays
            carry, tr = runner(a["keys"], a["budgets"],
                               lane.island_fitness(isl, i), a["carry"])
        isl.arrays["carry"] = carry
        own = np.repeat(al.row_jobs[i].copy()[:, None], lane.seg_len[k],
                        axis=1)
        isl.traces.append((tr, own))
        reg.counter("service_segments_total", lane=lbl, bucket=k).inc()
        stats.dispatched += 1

    def _row_verdict(self, t: CampaignTicket, job: int, fevals: int,
                     best_f: float, ran: bool,
                     now: float) -> Optional[Tuple[str, str]]:
        """The lifecycle verdict of one running row at a boundary:
        ``(status, reason)`` to retire it with, or None.  A cancel beats a
        deadline beats poison."""
        if job in self._cancels:
            return (JOB_CANCELLED, "cancelled by client")
        if t.deadline_at is not None and now >= t.deadline_at:
            return (JOB_EXPIRED, "deadline exceeded while running")
        if self.quarantine_nonfinite and fevals > 0 \
                and not np.isfinite(best_f):
            # a NaN never improves the best (NaN compares False), so a
            # poison callable shows as an infinite best after evaluations
            return (JOB_QUARANTINED,
                    f"non-finite fitness after {fevals} evaluations")
        if self.quarantine_stall_boundaries > 0:
            last, flats = self._noprog.get(job, (-1, 0))
            if ran and fevals == last:
                flats += 1
                if flats >= self.quarantine_stall_boundaries:
                    self._noprog.pop(job, None)
                    return (JOB_QUARANTINED,
                            f"no progress for {flats} dispatched boundaries")
            elif fevals != last:
                flats = 0
            self._noprog[job] = (fevals, flats)
        return None

    def _job_vals(self, lane: _Lane, req: CampaignRequest, device) -> dict:
        """A job's row as a function of its request: key, branch, budget,
        instance, fresh carry (``_write_row``'s structure)."""
        eng = lane.engines[torch.device(device)]
        base_key = (prng.as_key(req.key, device) if req.key is not None
                    else prng.PRNGKey(req.seed, device=device))
        if req.fid is not None:
            fn_idx, fid = 0, int(req.fid)
            inst = bbob.pad_instance(
                bbob.make_instance(req.fid, req.dim, req.instance,
                                   lane.tdtype, device), lane.m_peaks)
        else:
            fn_idx, fid = 1 + self.registry.index(req.fitness), lane.fill_fid
            inst = lane.filler_inst(device)
        return {"keys": base_key, "fn_idx": fn_idx, "budgets": req.budget,
                "insts": inst, "carry": eng.init_carry(base_key),
                "_fid": fid}

    @staticmethod
    def _write_row(isl: _Island, vals: dict, row: int):
        """Write one row in place (stream-ordered after the last segment
        that read the island's tensors)."""
        for name in ("keys", "fn_idx", "budgets", "insts", "carry"):
            dst, src = isl.arrays[name], vals[name]
            if isinstance(dst, tuple):
                for d, s in zip(leaves(dst), leaves(src)):
                    d[row] = s
            else:
                dst[row] = src
        isl.fn_host[row] = vals["fn_idx"]
        isl.fid_host[row] = vals["_fid"]
        isl.fit = None

    def _admit(self, lane: _Lane, i: int, isl: _Island,
               req: CampaignRequest, t: CampaignTicket) -> int:
        al = lane.allocator
        placed = al.alloc(t.job_id, req.budget, island=i)
        assert placed is not None, "admission called without a free row"
        _i, row = placed
        self._write_row(isl, self._job_vals(lane, req, isl.device), row)
        self._transition(t, JOB_RUNNING)
        t.lane, t.island, t.row = lane.key, i, row
        t.admit_s = time.monotonic()
        t.admit_boundary = self._boundary_n
        reg = obs.metrics()
        reg.counter("service_jobs_total", event="admitted").inc()
        if t.submit_s is not None:
            reg.histogram("service_admission_wait_s").observe(
                t.admit_s - t.submit_s)
        return row

    def _finalize(self, lane: _Lane, i: int, isl: _Island, row: int,
                  job: int, status: str = JOB_DONE, reason: str = ""):
        """Retire one resident row: its best and its trace pieces, pulled
        in one transfer, become the ticket's ``IPOPResult``; the slot is
        freed.  A lifecycle ``status`` (cancelled, expired, quarantined)
        gives the partial result up to this boundary."""
        c = isl.arrays["carry"]
        pieces = [(tr, own[row] == job) for tr, own in isl.traces
                  if (own[row] == job).any()]
        parts = [c.best_f[row], c.best_x[row], c.total_fevals[row]]
        for tr, _m in pieces:
            parts += [x[row] for x in tr]
        host = pull_leaves(parts)
        best_f, best_x, total = host[:3]
        nf = len(ladder.LadderTrace._fields)
        if pieces:
            per = [host[3 + j * nf: 3 + (j + 1) * nf]
                   for j in range(len(pieces))]
            trace = ladder.LadderTrace(*(
                torch.from_numpy(np.concatenate(
                    [p[f][m] for p, (_t, m) in zip(per, pieces)], axis=0))
                for f in range(nf)))
        else:
            trace = bucketed._empty_trace(
                tree_map(lambda a: a[row].cpu(), c), time_axis=0)
        carry_row = _row_carry(best_f, best_x, total)
        t = self.tickets[job]
        t.result = ipop_mod._result_from_ladder(lane.engine.full, carry_row,
                                                trace)
        self._transition(t, status, reason)
        t.best_f = t.result.best_f
        t.fevals = t.result.total_fevals
        t.done_s = time.monotonic()
        lane.allocator.release(i, row)
        isl.fit = None
        self._completed.add(job)
        self._cancels.discard(job)
        self._noprog.pop(job, None)
        reg = obs.metrics()
        if status == JOB_DONE:
            reg.counter("service_jobs_total", event="completed").inc()
            if t.submit_s is not None:
                reg.histogram("service_time_to_completion_s").observe(
                    t.done_s - t.submit_s)
        else:
            reg.counter("service_jobs_total", event=status).inc()
            if status == JOB_QUARANTINED:
                kind = ("nonfinite" if "non-finite" in reason
                        else "no_progress")
                reg.counter("service_quarantine_total", reason=kind).inc()
                flight_recorder().dump(
                    i, self._boundary_n, "quarantine",
                    extra={"job": job, "reason": reason,
                           "lane": _lane_label(lane.key), "row": row})

    def _prune_traces(self, isl: _Island):
        def live(own):
            jobs = np.unique(own)
            jobs = jobs[jobs >= 0]
            return any(int(j) not in self._completed for j in jobs)
        isl.traces = [(tr, own) for tr, own in isl.traces if live(own)]

    # -- accounting -----------------------------------------------------------
    def segment_compiles(self) -> int:
        """Distinct segment programs used, ≤ #buckets × #lanes."""
        return sum(len(lane.used_programs) for lane in self.lanes.values())

    def stats(self) -> dict:
        return {
            "lanes": len(self.lanes),
            "boundaries": self._boundary_n,
            "queued": len(self.queue),
            "resident": self._resident_jobs(),
            "done": len(self._completed),
            "segment_compiles": self.segment_compiles(),
            "program_cache": program_cache_stats(),
        }

    def statusz(self) -> dict:
        """Host bookkeeping for the HTTP ``/statusz`` endpoint: lanes with
        per-island occupancy, registry generation, queue depth, open
        spans.  Safe to call from the HTTP thread mid-round."""
        lanes = {}
        for key, lane in self.lanes.items():
            al = lane.allocator
            lanes[_lane_label(key)] = {
                "islands": {
                    str(i): {
                        "occupancy": round(
                            1.0 - al.free_rows(i) / al.rows_per_island, 4),
                        "health": self._grade(i),
                        "down": i in self.down_islands,
                    } for i in range(al.n_islands)},
            }
        return {"boundary": self._boundary_n,
                "lanes": lanes,
                "queue_depth": len(self.queue),
                "resident_jobs": self._resident_jobs(),
                "registry_generation": self.registry.generation,
                "active_traces": obs.tracer().active_count(),
                "down_islands": sorted(self.down_islands)}

    # -- durability -----------------------------------------------------------
    def snapshot(self) -> int:
        """Write a crash-resume snapshot; returns the committed step.

        Through ``checkpoint/store.py`` (arrays and a ``meta.json``
        committed together), in the JAX package's layout: every lane's
        island tensors, the device-resident traces with their job columns,
        the allocator maps, all tickets (completed ones with their
        results) and the config.  Not in it: the tickets' host timestamps
        and the custom callables (a restoring process re-registers them by
        name)."""
        if not self.snapshot_dir:
            raise ValueError("server has no snapshot_dir")
        t0 = time.perf_counter()
        step = self._boundary_n
        tree: dict = {"lanes": {}}
        lanes_meta = []
        for li, (key, lane) in enumerate(self.lanes.items()):
            ltree: dict = {"islands": {}}
            trace_T = {}
            for i, isl in enumerate(lane.islands):
                entry = dict(isl.arrays)
                if isl.traces:
                    entry["trace"] = ladder.LadderTrace(*(
                        torch.cat(xs, dim=1)
                        for xs in zip(*[t for t, _o in isl.traces])))
                    own = np.concatenate([o for _t, o in isl.traces], axis=1)
                    entry["own"] = own
                    trace_T[str(i)] = int(own.shape[1])
                else:
                    trace_T[str(i)] = 0
                ltree["islands"][str(i)] = entry
            tree["lanes"][str(li)] = ltree
            lanes_meta.append({
                "key": list(key),
                "seg_len": {str(k): int(v) for k, v in lane.seg_len.items()},
                "alloc": lane.allocator.to_meta(),
                "trace_T": trace_T,
            })
        jobs_meta = {}
        tree["results"] = {}
        for jid, t in self.tickets.items():
            jobs_meta[str(jid)] = {
                "status": t.status, "reason": t.reason,
                "request": t.request.to_meta(),
                "best_f": None if not np.isfinite(t.best_f) else t.best_f,
                "fevals": t.fevals, "island": t.island, "row": t.row,
                "lane": None if t.lane is None else list(t.lane),
                "admit_boundary": t.admit_boundary,
                "updates": list(t.updates),
            }
            if t.result is not None:
                rtree, rmeta = ipop_mod.result_to_tree(t.result)
                tree["results"][str(jid)] = rtree
                jobs_meta[str(jid)]["result"] = rmeta
        meta = {"config": self.config_meta(), "boundary": self._boundary_n,
                "lanes": lanes_meta, "jobs": jobs_meta,
                "next_job_id": max(self.tickets, default=-1) + 1,
                "cancels": sorted(self._cancels),
                "dedup": dict(self._dedup),
                "registry": {"names": list(self.registry.names),
                             "gens": list(self.registry._gens),
                             "gen": self.registry.generation}}
        store.save(self.snapshot_dir, step, tree, meta=meta)
        obs.metrics().histogram("service_snapshot_s").observe(
            time.perf_counter() - t0)
        return step

    @classmethod
    def restore(cls, ckpt_dir: str,
                registry: Optional[FitnessRegistry] = None,
                mesh=None, devices: Optional[Sequence] = None,
                step: Optional[int] = None,
                snapshot_every: Optional[int] = None) -> "CampaignServer":
        """Rebuild a server from the newest committed snapshot (this
        package's or the JAX package's).  ``registry`` must re-register the
        killed server's custom names.  ``mesh`` / ``devices`` may differ
        from the writing run's: the allocator re-packs the resident rows
        onto the new islands.  The state is restored exactly, so on the
        same shapes the remaining trajectory is the uninterrupted run's."""
        if step is None:
            step = store.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no committed snapshot in {ckpt_dir}")
        meta = store.load_meta(ckpt_dir, step)
        if meta is None:
            raise ValueError(f"snapshot step {step} has no meta.json")
        cfg = dict(meta["config"])
        cfg["bbob_fids"] = tuple(cfg["bbob_fids"])
        cfg["domain"] = tuple(cfg["domain"])
        srv = cls(registry=registry, mesh=mesh, devices=devices,
                  snapshot_dir=ckpt_dir,
                  snapshot_every=(snapshot_every if snapshot_every is not None
                                  else 0), **cfg)
        srv._boundary_n = int(meta["boundary"])
        # both queue counters move past every restored id, so re-queued
        # entries and fresh submissions never share a sequence number
        srv.queue._ids = itertools.count(int(meta["next_job_id"]))
        srv.queue._seq = itertools.count(int(meta["next_job_id"]))
        srv._cancels = set(int(j) for j in meta.get("cancels", []))
        srv._dedup = {k: int(v) for k, v in meta.get("dedup", {}).items()}
        rmeta = meta.get("registry")
        if rmeta is not None:
            srv.registry.align_generations(rmeta["names"], rmeta["gens"],
                                           rmeta["gen"])
            srv.registry.freeze()

        # tickets: update tails always, results of finished jobs; TTL and
        # deadline clocks re-armed with their full allowance
        now = time.monotonic()
        for jid_s, jm in meta["jobs"].items():
            req = CampaignRequest.from_meta(jm["request"])
            t = CampaignTicket(job_id=int(jid_s), request=req,
                               status=jm["status"],
                               reason=jm.get("reason", ""),
                               best_f=(float("inf") if jm["best_f"] is None
                                       else jm["best_f"]),
                               fevals=jm["fevals"],
                               admit_boundary=jm["admit_boundary"])
            t.updates = list(jm.get("updates", []))
            if not t.terminal:
                t.arm(now)
                srv._open_job_trace(t, phase=t.status)
            srv.tickets[t.job_id] = t
            if t.terminal and t.status != JOB_REJECTED:
                srv._completed.add(t.job_id)

        template_tree: dict = {"lanes": {}, "results": {}}
        for li, lmeta in enumerate(meta["lanes"]):
            key = tuple(lmeta["key"])
            if len(key) == 4:           # a snapshot from before generations
                key = key + (0,)
            lane = srv._get_lane(key)
            lane.seg_len = {int(k): v for k, v in lmeta["seg_len"].items()}
            template_tree["lanes"][str(li)] = _lane_template(lane, lmeta)
        for jid_s, jm in meta["jobs"].items():
            if jm.get("result") is not None:
                template_tree["results"][jid_s] = ipop_mod.result_template(
                    jm["result"])
        if not template_tree["results"]:
            del template_tree["results"]
        restored = store.restore(ckpt_dir, step, template_tree, device="cpu")

        for jid_s, jm in meta["jobs"].items():
            if jm.get("result") is not None:
                srv.tickets[int(jid_s)].result = ipop_mod.result_from_tree(
                    restored["results"][jid_s], jm["result"])

        for li, lmeta in enumerate(meta["lanes"]):
            key = tuple(lmeta["key"])
            if len(key) == 4:
                key = key + (0,)
            _repack_lane(srv, srv.lanes[key], lmeta,
                         restored["lanes"][str(li)])

        # re-queue pending jobs (their ids and priority order kept)
        for jid, t in sorted(srv.tickets.items()):
            if t.status == JOB_QUEUED:
                heapq.heappush(srv.queue._heap,
                               (-t.request.priority, jid, t.request, t))
        return srv


def _row_carry(best_f, best_x, total_fevals) -> ladder.LadderCarry:
    """The part of a row's carry that ``ipop._result_from_ladder`` reads,
    as CPU tensors (the other leaves None)."""
    return ladder.LadderCarry(
        states=None, k_idx=None, incarnation=None, active=None,
        total_fevals=torch.as_tensor(total_fevals),
        best_f=torch.as_tensor(best_f), best_x=torch.from_numpy(best_x))


def _lane_template(lane: _Lane, lmeta: dict) -> dict:
    """(shape, dtype) template of one lane's snapshot subtree, for the
    writing run's island grid (which may differ from ``lane``'s)."""
    Sd = ipop_mod.ShapeDtype
    al = lmeta["alloc"]
    Bl = int(al["rows_per_island"])
    blank = lane.blank_arrays(lane.engine.device, Bl)

    def sd(a):
        return Sd(tuple(a.shape), a.dtype)
    out = {"islands": {}}
    for i in range(int(al["n_islands"])):
        entry = {name: tree_map(sd, blank[name])
                 for name in ("keys", "fn_idx", "budgets", "insts", "carry")}
        T = int(lmeta["trace_T"][str(i)])
        if T:
            c = blank["carry"]
            st = c.states
            entry["trace"] = ladder.LadderTrace(
                ran=Sd((Bl, T, 1), torch.bool),
                k_idx=Sd((Bl, T, 1), torch.int32),
                gen=Sd((Bl, T, 1), st.gen.dtype),
                fevals=Sd((Bl, T, 1), st.fevals.dtype),
                best_f=Sd((Bl, T, 1), st.best_f.dtype),
                stop_reason=Sd((Bl, T, 1), st.stop_reason.dtype),
                stopped=Sd((Bl, T, 1), torch.bool),
                total_fevals=Sd((Bl, T), c.total_fevals.dtype),
                global_best=Sd((Bl, T), c.best_f.dtype))
            entry["own"] = Sd((Bl, T), torch.int64)
        out["islands"][str(i)] = entry
    return out


def _repack_lane(srv: CampaignServer, lane: _Lane, lmeta: dict,
                 ltree: dict):
    """Lay a restored lane's rows (CPU tensors) out on the new island grid
    and move each island to its device: the elastic re-shard.  A row holds
    everything its trajectory needs, so moving it is a copy; the traces
    keep their job columns (padding columns own -1, never sliced into a
    result)."""
    old_al = SlotAllocator.from_meta(lmeta["alloc"])
    new_al, moves, layout = old_al.repack(len(srv.devices),
                                          srv.rows_per_island)
    lane.allocator = new_al
    Bl = new_al.rows_per_island
    old = [ltree["islands"][str(i)] for i in range(old_al.n_islands)]
    operand_keys = ("keys", "fn_idx", "budgets", "insts", "carry")

    lane.islands = []
    for ni, dev in enumerate(srv.devices):
        isl = lane._blank_island(dev, Bl)
        srcs = [(nr, layout[ni][nr]) for nr in range(Bl)
                if layout[ni][nr] is not None]
        for nr, (oi, orow) in srcs:
            for kk in operand_keys:
                for d, s in zip(leaves(isl.arrays[kk]),
                                leaves(old[oi][kk])):
                    d[nr] = s[orow].to(d.device)
            isl.fn_host[nr] = int(old[oi]["fn_idx"][orow])
            isl.fid_host[nr] = int(old[oi]["insts"].fid[orow])
        traced = [(nr, oi, orow) for nr, (oi, orow) in srcs
                  if "own" in old[oi]]
        if traced:
            T = max(old[oi]["own"].shape[1] for _nr, oi, _r in traced)
            ref = old[traced[0][1]]["trace"]
            tr = ladder.LadderTrace(*(
                torch.zeros((Bl, T) + tuple(a.shape[2:]), dtype=a.dtype)
                for a in ref))
            own = np.full((Bl, T), -1, np.int64)
            for nr, oi, orow in traced:
                t_src = old[oi]["own"].shape[1]
                own[nr, :t_src] = old[oi]["own"][orow].numpy()
                for d, s in zip(tr, old[oi]["trace"]):
                    d[nr, :t_src] = s[orow]
            isl.traces = [(ladder.LadderTrace(*(x.to(dev) for x in tr)),
                           own)]
        lane.islands.append(isl)

    for job, (ni, nr) in moves.items():
        t = srv.tickets.get(job)
        if t is not None:
            t.lane, t.island, t.row = lane.key, ni, nr


# ---------------------------------------------------------------------------
# one-shot parity wrapper: the `service` backend of ipop.run_ipop
# ---------------------------------------------------------------------------

def run_service_single(fitness_fn: Callable, n: int, key,
                       lam_start: int = 12, kmax_exp: int = 8,
                       max_evals: int = 200_000, domain=(-5.0, 5.0),
                       sigma0_frac: float = 0.25, impl: str = "auto",
                       dtype: str = "float64", fleet=None, *, device=None):
    """One problem through a one-row campaign service: the trajectory of
    ``backend="bucketed"`` on the same key.  ``fitness_fn`` is the row's
    callable branch (a ``FusableEval``'s coefficients are not used: the
    lane samples through the kernel without the fitness epilogue, as the
    JAX package's service does).  ``fleet`` (a ``repro_torch.fleet``
    ``FleetConfig``) drains the server under a ``FleetController`` with a
    throwaway snapshot directory, so fault plans run through the public
    ``run_ipop`` surface."""
    reg = FitnessRegistry()
    reg.register("job", fitness_fn)
    srv = CampaignServer(registry=reg, bbob_fids=(), lam_start=lam_start,
                         kmax_exp=kmax_exp, dtype=dtype, impl=impl,
                         domain=domain, sigma0_frac=sigma0_frac,
                         max_budget=max_evals, rows_per_island=1,
                         devices=[resolve_device(device)])
    ticket = srv.submit(CampaignRequest(dim=n, budget=max_evals,
                                        fitness="job", key=key))
    if fleet is None:
        srv.drain()
        return ticket.result
    import tempfile

    from repro_torch.fleet.controller import FleetController
    with tempfile.TemporaryDirectory() as td:
        srv.snapshot_dir = td
        FleetController(srv, fleet).drain()
    return ticket.result
