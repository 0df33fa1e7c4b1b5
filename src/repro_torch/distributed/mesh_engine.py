"""Mesh campaign engine: the paper's two deployment strategies (§4–5).
Port of ``repro/distributed/mesh_engine.py``.

The rung-bucketed engine (``core/bucketed.py``) runs a campaign as a small
family of per-bucket segments with one host read between them.  This
module deploys it over a campaign mesh (``launch/mesh.py``: islands, each
a device), with both of the paper's strategies:

* ``strategy="ordered"`` (S1, sequential order): every segment runs over
  the whole mesh and all members follow one global segment schedule, with
  a barrier (the host pull that re-buckets) per segment, so the bucketed
  driver's schedule holds exactly.  JAX runs one ``shard_map`` program
  over the mesh; the port makes one segment call per physical device
  (``device_groups``) over the member slices of that device's islands: on
  one card all members in one sample and one update launch a step, as
  ``run_campaign_bucketed`` does.  The budget and best scalars JAX
  reduces with ``psum``/``pmin`` are folded on the host from the boundary
  pull, which already holds every member's evaluations and best.
* ``strategy="concurrent"`` (S2, the paper's winner): each island owns a
  contiguous member slice and drives its own budget-adaptive segment
  schedule.  The host round-robins over the islands: each pulls its own
  schedule, picks its own next bucket and dispatches it; between segments
  the islands share only the global best and budget.  A shard whose
  members finished stops paying for the stragglers' schedule.  With
  ``stop_at`` the shared best also retires every island once any island
  reaches the target.  All decisions run on the host in island order,
  and a bucket's segment length is shared by all islands (the first to
  open it sizes it), so S2's records are reproducible.  JAX's
  dispatch returns before the segment runs; the port's syncs the host at
  every eigen refresh (``torch.linalg.eigh``), so the islands of one card
  run one after another.

Members' trajectories depend only on their own key schedule and the
row-keyed draw, never on the island or segment that ran them, so at
``eigen_interval == 1`` both strategies follow ``backend="bucketed"``
(the update kernel's chunks depend on the slot count on the card, so
there up to the order of floating-point sums), and above it (S2 cuts
segments per island) they agree in ECDF.

The engine emits the ``mesh_*`` series and the ``compile``,
``dispatch`` and ``block`` spans of ``repro_torch.obs`` (S1 also the
bucketed driver's) from host values only.

Both strategies take a ``repro_torch.fleet`` ``IslandSupervisor``
(``supervisor=``): S1 is one island through ``drive_segments``, S2 has
one island a shard, each snapshotted on the host and replayed from its
snapshot when it dies (``fleet/controller.py``).

Waiting (ROADMAP.md): ``lower_ordered_segment`` (item 15).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import bucketed, ladder, prng
from repro_torch.core.eval_dispatch import FusableEval
from repro_torch.distributed.sharding import (join_members, shard_members,
                                              tree_map)
from repro_torch.fitness import bbob
from repro_torch.kernels import ops
from repro_torch.launch.mesh import CampaignMesh, make_campaign_mesh


def _finite_or_none(x: float):
    """A JSON-safe scalar for the records: None until a best exists."""
    x = float(x)
    return x if np.isfinite(x) else None


# ---------------------------------------------------------------------------
# island program cache
# ---------------------------------------------------------------------------
# The port compiles nothing: a "program" is the segment runner of one
# (bucket config, ladder geometry, impl, bucket, length, fid menu or
# closure object, island devices) key, built once and reused across
# islands, campaigns and engines.  ``traces`` counts the runners built,
# ``hits`` the reuses.  Keying a generic fitness by its closure object
# means two calls with distinct closures never share a runner.

def _contains_callable(x) -> bool:
    return callable(x) or (isinstance(x, tuple)
                           and any(_contains_callable(i) for i in x))


class ProgramCache:
    """Process-wide segment-runner cache.  Entries whose key holds a
    callable (a fitness closure) keep it alive, so they are capped at
    ``max_closure_entries`` and evicted first in, first out; keys of
    scalars only (BBOB menus and configs) are bounded by the configuration
    space and never evicted."""

    def __init__(self, max_closure_entries: int = 64):
        self.max_closure_entries = int(max_closure_entries)
        self._programs: Dict[tuple, Callable] = {}
        self.stats = {"traces": 0, "hits": 0}

    def get(self, key: tuple, build: Callable[[], Callable]) -> Callable:
        fn = self._programs.get(key)
        if fn is not None:
            self.stats["hits"] += 1
            return fn
        fn = build()
        self._programs[key] = fn
        self.stats["traces"] += 1
        if _contains_callable(key):
            closure_keys = [k for k in self._programs
                            if _contains_callable(k)]
            for k in closure_keys[:max(0, len(closure_keys)
                                       - self.max_closure_entries)]:
                del self._programs[k]
        return fn

    def snapshot(self) -> dict:
        return {"programs": len(self._programs), **self.stats}

    def clear(self):
        self._programs.clear()
        self.stats.update(traces=0, hits=0)


_ISLAND_CACHE = ProgramCache()


def island_program_key(eng: bucketed.BucketedLadderEngine, k: int,
                       seg_gens: int, branch_fids: Tuple[int, ...],
                       fitness_fn: Optional[Callable], devices) -> tuple:
    """The cache key of one island segment runner (``CMAConfig`` is a
    frozen dataclass of scalars, so the key hashes)."""
    fit_id = tuple(branch_fids) if fitness_fn is None else fitness_fn
    return (eng.bucket_cfgs[k], eng.lam_start, eng.kmax_exp, eng.max_evals,
            tuple(eng.domain), eng.impl, int(k), int(seg_gens), fit_id,
            tuple((d.type, d.index) for d in devices))


def island_cache_stats() -> dict:
    """``{"programs", "traces", "hits"}`` of the island runner cache:
    island bring-up is O(buckets) iff ``traces`` stops growing across
    campaigns."""
    return _ISLAND_CACHE.snapshot()


def clear_island_program_cache():
    """Drop every cached island runner (and the engines they hold)."""
    _ISLAND_CACHE.clear()


# ---------------------------------------------------------------------------
# device groups, the gathered pull
# ---------------------------------------------------------------------------

def device_groups(mesh: CampaignMesh) -> List[List[int]]:
    """S1's segment calls: the island indices of each physical device, in
    island order, one call per device (on one card, every island in one
    call)."""
    groups: Dict[tuple, List[int]] = {}
    for i, d in enumerate(mesh.devices):
        groups.setdefault((d.type, d.index), []).append(i)
    return list(groups.values())


def pull_schedule_allgather(carries: list, mesh: CampaignMesh,
                            groups: List[List[int]], wait: bool = True):
    """``bucketed.pull_schedule`` over a carry split by ``groups`` (one
    part a group, on its first island): one pull a physical device, the
    arrays concatenated in island order.  ``wait=False`` queues every copy
    first and returns the function that waits for them."""
    finishes = [bucketed.pull_schedule(c, wait=False) for c in carries]

    def finish():
        chunks = {}
        for f, g in zip(finishes, groups):
            arrays = f()
            Bl = arrays[0].shape[0] // len(g)
            for j, i in enumerate(g):
                chunks[i] = [a[j * Bl:(j + 1) * Bl] for a in arrays]
        return tuple(np.concatenate([chunks[i][a] for i in sorted(chunks)])
                     for a in range(4))
    return finish() if wait else finish


def member_fitness(fitness_fn: Callable, B: int) -> Callable:
    """One problem's fitness (X (rows, n) → (rows,)) as a campaign's of B
    members (X (B, rows, n) → (B, rows)): every member's rows in one call,
    the separable coefficients, if any, stacked per member."""
    sep = getattr(fitness_fn, "sep", None)
    fn = fitness_fn if sep is None else fitness_fn.fn

    def rows(X):
        return fn(X.reshape(-1, X.shape[-1])).reshape(X.shape[:-1])
    if sep is None:
        return rows
    return FusableEval(rows, type(sep)(*(t.expand((B,) + tuple(t.shape))
                                         for t in sep)))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeshCampaignEngine:
    """Bucketed-ladder campaigns over a campaign mesh.  The wrapped
    ``BucketedLadderEngine`` owns the bucket configs, the segment sizing
    and the one-device semantics; this engine decides where each segment
    runs and how the islands synchronise.  ``mesh`` defaults to one
    island per CUDA device, or one on ``device`` (``make_campaign_mesh``);
    the engine's device is its first island's.  ``overlap`` is JAX's
    speculative S1 segment: on the port it runs after the pull it was to
    hide, since ``eigh`` blocks the host (PERF.md, §5)."""

    n: int
    lam_start: int = 12
    kmax_exp: int = 4
    max_evals: int = 200_000
    domain: Tuple[float, float] = (-5.0, 5.0)
    sigma0_frac: float = 0.25
    impl: str = "auto"
    dtype: str = "float64"
    eigen_interval: Optional[int] = None
    seg_blocks: Optional[int] = None
    policy: str = "cover"
    strategy: str = "ordered"           # "ordered" (S1) | "concurrent" (S2)
    mesh: Optional[CampaignMesh] = None
    axis: str = "camp"
    stop_at: Optional[float] = None     # S2: retire on the shared best
    overlap: bool = True                # S1: speculative next segment
    device: Optional[str] = None        # without a mesh: None is CUDA

    def __post_init__(self):
        if self.strategy not in ("ordered", "concurrent"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.mesh is None:
            self.mesh = make_campaign_mesh(device=self.device)
        self.device = self.mesh.devices[0]
        self.bucketed = bucketed.BucketedLadderEngine(
            n=self.n, lam_start=self.lam_start, kmax_exp=self.kmax_exp,
            max_evals=self.max_evals, domain=self.domain,
            sigma0_frac=self.sigma0_frac, impl=self.impl, dtype=self.dtype,
            eigen_interval=self.eigen_interval, seg_blocks=self.seg_blocks,
            policy=self.policy, overlap=self.overlap, device=self.device)
        # one bucketed engine (its parameter stacks) per physical device
        self._engines = {self.device: self.bucketed}
        for d in self.mesh.devices:
            if d not in self._engines:
                self._engines[d] = dataclasses.replace(self.bucketed,
                                                       device=d)
        self.n_devices = self.mesh.size
        self._runner_cache: dict = {}
        self._island_keys: set = set()

    # -- segment programs -----------------------------------------------------
    def _seg_fn(self, k: int, seg_gens: int) -> Callable:
        """The segment body both strategies share: ``run(keys, fitness,
        carry) -> (carry, trace)`` over one member slice, the trace
        member-major (B, seg_gens, S), on the slice's device."""
        engines = self._engines

        def run(keys, fitness_fn, carry):
            eng = engines[carry.k_idx.device]
            c, tr = eng.segment_scan(k, keys, fitness_fn, carry, seg_gens)
            return c, ladder.member_major(tr)
        return run

    def ordered_runner(self, k: int, seg_gens: int,
                       branch_fids: Tuple[int, ...] = (),
                       fitness_fn: Optional[Callable] = None,
                       cache: Optional[dict] = None) -> Callable:
        """One S1 segment's runner, cached per (bucket, length, menu);
        ``cache`` replaces the engine's (a generic fitness's runs keep
        their own)."""
        cache = self._runner_cache if cache is None else cache
        key = ("ordered", int(k), int(seg_gens), tuple(branch_fids))
        if key not in cache:
            cache[key] = self._seg_fn(k, seg_gens)
        return cache[key]

    def island_runner(self, k: int, seg_gens: int,
                      branch_fids: Tuple[int, ...] = (),
                      fitness_fn: Optional[Callable] = None) -> Callable:
        """One S2 segment's runner from the module-level cache
        (``island_program_key``): one runner per (bucket shape, mesh),
        reused across islands, campaigns and engines."""
        key = island_program_key(self.bucketed, k, seg_gens, branch_fids,
                                 fitness_fn, self.mesh.devices)
        traces0 = _ISLAND_CACHE.stats["traces"]
        with obs.tracer().span("compile", key=f"island.k{k}.g{seg_gens}") \
                as sp:
            fn = _ISLAND_CACHE.get(key, lambda: self._seg_fn(k, seg_gens))
            sp.attrs["hit"] = _ISLAND_CACHE.stats["traces"] == traces0
        self._island_keys.add(key)
        return fn

    def compiles(self) -> int:
        """Distinct segment runners this engine used: the S1 runners it
        cached and the island runner keys it took (counted even on a
        cache hit, so a campaign's count stays ≤ #buckets; reuse across
        campaigns shows in ``island_cache_stats``)."""
        return len(self._island_keys) + sum(
            1 for key in self._runner_cache if key[0] == "ordered")

    def _fitness(self, insts, branch_fids, fitness_fn, B: int):
        """A member slice's fitness, made on its island: the campaign's
        ``StackedFitness`` over the slice's instances (one evaluator call
        per fid present), or a generic fitness over its B members; the
        separable coefficients laid out for its slots."""
        fit = (bbob.campaign_fitness(insts, branch_fids)
               if fitness_fn is None else member_fitness(fitness_fn, B))
        return ops.slot_fitness(fit, self.bucketed.full.n_slots,
                                self.bucketed.full.cfg.tdtype)

    # -- member layout --------------------------------------------------------
    def pad_batch(self, keys: torch.Tensor, carry: ladder.LadderCarry,
                  insts=None):
        """Pad the members to a multiple of the island count with inert
        rows: keys ``fold_in(keys[-1], 1 + j)``, the last member's carry
        and instance, ``active`` False from the start, so they never run a
        generation, spend budget or win a best.  Returns ``(keys, carry,
        insts, B_real, B_pad)``."""
        B = int(keys.shape[0])
        P_n = self.n_devices
        B_pad = -(-B // P_n) * P_n
        if B_pad != B:
            pad = B_pad - B

            def rep(a):
                return torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])])
            js = torch.arange(1, pad + 1, dtype=torch.int64,
                              device=keys.device)
            keys = torch.cat([keys, prng.fold_in(keys[-1], js)])
            carry = tree_map(rep, carry)
            insts = tree_map(rep, insts)
        mask = (torch.arange(B_pad, device=carry.active.device) < B)[:, None]
        carry = carry._replace(active=carry.active & mask)
        return keys, carry, insts, B, B_pad

    # -- drivers --------------------------------------------------------------
    def _drive_ordered(self, keys, insts, carry, branch_fids, fitness_fn,
                       max_segments: int, supervisor=None):
        """S1: the bucketed re-bucketing loop (``drive_segments``) with one
        segment call per device group and the gathered pull.  The exchange
        scalars fold when a pull reads a segment's carry: each accepted
        segment gives one record, a mispredicted speculative one none.
        A ``supervisor`` sees S1 as ONE island: its failure domain is the
        whole mesh program, so recovery restores every member slice, each
        on its own device."""
        mesh = self.mesh
        groups = device_groups(mesh)
        keys_g = shard_members(keys, mesh, groups)
        carries = shard_members(carry, mesh, groups)
        insts_g = (shard_members(insts, mesh, groups) if insts is not None
                   else [None] * len(groups))
        fits = [self._fitness(i, branch_fids, fitness_fn, int(kg.shape[0]))
                for i, kg in zip(insts_g, keys_g)]
        local_cache = None if fitness_fn is None else {}
        exchange: List[dict] = []
        inflight: List[tuple] = []      # (carries, bucket) not yet pulled
        reg = obs.metrics()

        def dispatch(k, seg_gens, cs):
            runner = self.ordered_runner(k, seg_gens, branch_fids,
                                         fitness_fn, cache=local_cache)
            # no island attribute: the driver's island="all" segment span
            # already covers this wall
            sp = obs.tracer().start("dispatch", strategy="ordered",
                                    bucket=int(k))
            t0 = time.perf_counter()
            res = [runner(kg, fit, c) for kg, fit, c in zip(keys_g, fits, cs)]
            obs.tracer().end(sp)
            reg.histogram("mesh_island_dispatch_s", strategy="ordered",
                          island="all").observe(time.perf_counter() - t0)
            out = [r[0] for r in res]
            trace = res[0][1] if len(res) == 1 else join_members(
                [r[1] for r in res], mesh, groups)
            inflight.append((out, int(k)))
            return out, trace

        def pull(cs, wait=True):
            finish = pull_schedule_allgather(cs, mesh, groups, wait=False)

            def done():
                arrays = finish()
                for i, (ref, k) in enumerate(inflight):
                    if ref is cs:
                        t0 = time.perf_counter()
                        exchange.append({
                            "bucket": k,
                            "global_fevals": int(np.sum(arrays[2])),
                            "global_best": _finite_or_none(
                                np.min(arrays[3]))})
                        reg.histogram("mesh_exchange_s", strategy="ordered"
                                      ).observe(time.perf_counter() - t0)
                        reg.counter("mesh_exchange_rounds_total",
                                    strategy="ordered").inc()
                        # what was dispatched before it is never pulled
                        del inflight[:i + 1]
                        break
                return arrays
            return done() if wait else done

        log: dict = {}
        carries, trace, segments, bucket_wall = bucketed.drive_segments(
            self.bucketed, carries, dispatch, max_segments, time_axis=1,
            pull=pull, overlap=self.overlap, supervisor=supervisor, log=log)
        carry = join_members(carries, mesh, groups, device=self.device)
        return dict(carry=carry, trace=trace, segments=segments,
                    bucket_wall=bucket_wall, exchange=exchange,
                    shard_segments=None, pulls=log["pulls"],
                    replayed=log.get("replayed", []))

    def _drive_concurrent(self, keys, insts, carry, branch_fids, fitness_fn,
                          max_segments: int, supervisor=None):
        """S2: one island per member slice, each with its own
        re-bucketing loop.  The host takes the islands in turn: pulls the
        island's schedule, decides and runs its next segment; then folds
        the islands' budget and best into the shared view.

        ``supervisor`` (``repro_torch.fleet``) supervises each island:
        periodic host snapshots of the shard, kill/delay/corrupt faults,
        health grading of the per-island pulls, and recovery by replay
        from the shard's snapshot on a surviving device (the same card
        when every island is on it); the segment records a recovery
        dropped come back as ``replayed``, as S1's do.  ``None`` costs one
        host ``if`` a hook site."""
        eng = self.bucketed
        mesh = self.mesh
        keys_s = shard_members(keys, mesh)
        carry_s = shard_members(carry, mesh)
        insts_s = (shard_members(insts, mesh) if insts is not None
                   else [None] * mesh.size)

        def refit(ins, B):
            # a campaign shard's fitness on another device (the fleet's
            # replacement device); a generic fitness stays where it is
            return lambda dev: self._fitness(tree_map(
                lambda a: a.to(dev), ins), branch_fids, None, B)
        shards = [{"keys": ks, "carry": cs, "traces": [], "segments": [],
                   "fit": self._fitness(ins, branch_fids, fitness_fn,
                                        int(ks.shape[0])),
                   "refit": (None if ins is None
                             else refit(ins, int(ks.shape[0]))),
                   "done": False, "best": np.inf, "fevals": 0}
                  for ks, cs, ins in zip(keys_s, carry_s, insts_s)]
        seg_len: Dict[int, int] = {}    # shared: the first island sizes it
        bucket_wall: Dict[int, float] = {}
        exchange: List[dict] = []
        pulls = 0
        replayed: List[dict] = []       # records a recovery dropped
        reg, tracer = obs.metrics(), obs.tracer()
        devs = list(mesh.devices)
        if supervisor is not None:
            supervisor.mesh_init(shards, devs)

        for rnd in range(max_segments):
            if supervisor is not None:
                before = [sh["segments"] for sh in shards]
                supervisor.mesh_round(rnd, shards, devs)
                for old, sh in zip(before, shards):
                    replayed.extend(old[len(sh["segments"]):])
            dispatched = retired = finished = 0
            for s, sh in enumerate(shards):
                if sh["done"]:
                    continue
                blk = tracer.start("block", island=s, boundary=rnd)
                t0 = time.perf_counter()
                if supervisor is not None:
                    k_idx, active, fevals, best_f = supervisor.pull(
                        s, rnd,
                        lambda _c=sh["carry"]: bucketed.pull_schedule(_c))
                else:
                    k_idx, active, fevals, best_f = bucketed.pull_schedule(
                        sh["carry"])
                tracer.end(blk)
                reg.histogram("mesh_island_block_s", island=s).observe(
                    time.perf_counter() - t0)
                pulls += 1
                sh["best"] = float(best_f.min())
                sh["fevals"] = int(fevals.sum())
                if self.stop_at is not None and \
                        min(x["best"] for x in shards) <= self.stop_at:
                    # the shared best meets the target: this island, and
                    # each other in its turn, retires
                    sh["done"] = True
                    retired += 1
                    reg.counter("mesh_retirements_total",
                                reason="target").inc()
                    continue
                _live, k = bucketed.next_bucket(eng, k_idx, active, fevals,
                                                seg_len)
                if k is None:
                    sh["done"] = True
                    finished += 1
                    reg.counter("mesh_retirements_total",
                                reason="exhausted").inc()
                    continue
                runner = self.island_runner(k, seg_len[k], branch_fids,
                                            fitness_fn)
                if supervisor is not None:
                    supervisor.before_dispatch(s, rnd)
                dsp = tracer.start("dispatch", island=s, bucket=int(k),
                                   boundary=rnd)
                t0 = time.perf_counter()
                sh["carry"], tr = runner(sh["keys"], sh["fit"], sh["carry"])
                wall = time.perf_counter() - t0
                tracer.end(dsp)
                reg.histogram("mesh_island_dispatch_s",
                              strategy="concurrent", island=s).observe(wall)
                sh["traces"].append(tr)
                sh["segments"].append({"shard": s, "bucket": k,
                                       "gens": seg_len[k],
                                       "dispatch_s": round(wall, 5)})
                bucket_wall[k] = bucket_wall.get(k, 0.0) + wall
                dispatched += 1
            # the only cross-island traffic: two scalars
            if dispatched or retired or finished:
                t0 = time.perf_counter()
                entry = {"round": rnd,
                         "global_best": _finite_or_none(
                             min(sh["best"] for sh in shards)),
                         "global_fevals": sum(sh["fevals"] for sh in shards)}
                if retired:
                    entry["stopped_early"] = True
                exchange.append(entry)
                reg.histogram("mesh_exchange_s", strategy="concurrent"
                              ).observe(time.perf_counter() - t0)
                reg.counter("mesh_exchange_rounds_total",
                            strategy="concurrent").inc()
            if not dispatched and all(sh["done"] for sh in shards):
                break
        else:
            raise RuntimeError("island driver did not converge "
                               f"within {max_segments} rounds")

        # -- the (B_pad, T_max, ...) trace, assembled on the host ------------
        host = []
        for sh in shards:
            if sh["traces"]:
                tr = ladder.LadderTrace(*(torch.cat([x.cpu() for x in xs], 1)
                                          for xs in zip(*sh["traces"])))
            else:
                tr = tree_map(lambda a: a.cpu(),
                              bucketed._empty_trace(sh["carry"], 1))
            host.append(tr)
        T_max = max(tr.ran.shape[1] for tr in host)
        trace = ladder.LadderTrace(*(torch.cat(xs) for xs in zip(
            *[_pad_time(tr, T_max) for tr in host])))
        carry = join_members([sh["carry"] for sh in shards], mesh,
                             device=self.device)
        segments = [seg for sh in shards for seg in sh["segments"]]
        return dict(carry=carry, trace=trace, segments=segments,
                    bucket_wall=bucket_wall, exchange=exchange,
                    shard_segments=[sh["segments"] for sh in shards],
                    pulls=pulls, replayed=replayed)

    def drive(self, *args, **kw) -> dict:
        return (self._drive_ordered if self.strategy == "ordered"
                else self._drive_concurrent)(*args, **kw)


def _pad_time(tr: ladder.LadderTrace, T: int) -> ladder.LadderTrace:
    """A shard's (host) trace padded to ``T`` generations along axis 1
    with inert steps: ``ran`` False (every consumer masks on it), the
    budget and best accumulators edge-extended so ``hit_evals`` stays
    monotone."""
    t = int(tr.ran.shape[1])
    if t == T:
        return tr

    def cpad(a, fill):
        pad = torch.full((a.shape[0], T - t) + tuple(a.shape[2:]), fill,
                         dtype=a.dtype)
        return torch.cat([a, pad], 1)

    def epad(a, fill):
        if t == 0:
            return cpad(a, fill)
        return torch.cat([a, a[:, -1:].expand(
            (a.shape[0], T - t) + tuple(a.shape[2:]))], 1)

    return ladder.LadderTrace(
        ran=cpad(tr.ran, False), k_idx=cpad(tr.k_idx, 0),
        gen=cpad(tr.gen, 0), fevals=cpad(tr.fevals, 0),
        best_f=cpad(tr.best_f, np.inf), stop_reason=cpad(tr.stop_reason, 0),
        stopped=cpad(tr.stopped, False),
        total_fevals=epad(tr.total_fevals, 0),
        global_best=epad(tr.global_best, np.inf))


@dataclasses.dataclass
class MeshCampaignResult(bucketed.BucketedCampaignResult):
    """A bucketed campaign result plus the mesh deployment's record:
    ``exchange`` (one record per S1 segment or S2 round) and
    ``shard_segments`` (S2: each island's segments)."""

    strategy: str = "ordered"
    n_devices: int = 1
    exchange: List[dict] = dataclasses.field(default_factory=list)
    shard_segments: Optional[List[List[dict]]] = None


def run_campaign_mesh(engine: MeshCampaignEngine, fids, instances=(1,),
                      runs: int = 1, seed: int = 0,
                      max_segments: int = bucketed.MAX_SEGMENTS,
                      supervisor=None) -> MeshCampaignResult:
    """A whole BBOB campaign through the mesh engine: the member layout,
    instances and keys of ``run_campaign_bucketed``, the members padded to
    the mesh with inert rows and deployed per ``engine.strategy``; the
    pads are sliced off the result.  ``supervisor`` (``repro_torch.fleet``)
    supervises the engine's driver."""
    eng = engine.bucketed
    members = ladder.campaign_members(tuple(fids), instances, runs)
    stacked = ladder.campaign_instances(members, engine.n,
                                        eng.full.cfg.tdtype, eng.device)
    branch_fids = tuple(sorted(set(fids)))
    keys = ladder.member_keys(seed, len(members), eng.device)
    keys, carry, insts, B, B_pad = engine.pad_batch(
        keys, eng.init_carry(keys), stacked)
    out = engine.drive(keys, insts, carry, branch_fids, None, max_segments,
                       supervisor=supervisor)

    carry = out["carry"]
    trace = ladder.LadderTrace(*(x[:B].cpu().numpy() for x in out["trace"]))
    useful = bucketed._useful_evals_per_rung(trace, eng.lam_start,
                                             eng.kmax_exp)
    rows = B_pad if engine.strategy == "ordered" else B_pad // engine.n_devices
    padded = sum(rows * s["gens"] * (2 ** s["bucket"]) * eng.lam_start
                 for s in out["segments"])
    return MeshCampaignResult(
        members=members, f_opt=stacked.f_opt.cpu().numpy().astype(np.float64),
        best_f=carry.best_f[:B].cpu().numpy(),
        best_x=carry.best_x[:B].cpu().numpy(),
        total_fevals=carry.total_fevals[:B].cpu().numpy(), trace=trace,
        compiles=engine.compiles(), segments=out["segments"],
        bucket_wall_s={k: round(v, 5) for k, v in out["bucket_wall"].items()},
        useful_evals=int(sum(useful.values())), padded_evals=int(padded),
        pulls=out["pulls"], strategy=engine.strategy,
        n_devices=engine.n_devices, exchange=out["exchange"],
        shard_segments=out["shard_segments"])


def run_mesh_single(engine: MeshCampaignEngine, key, fitness_fn: Callable,
                    max_segments: int = bucketed.MAX_SEGMENTS,
                    supervisor=None
                    ) -> Tuple[ladder.LadderCarry, ladder.LadderTrace]:
    """One problem through the mesh engine, the ``mesh`` backend behind
    ``ipop.run_ipop``.  ``key`` is an int seed or a (2,) key.  The member
    rides island 0; the other islands carry inert pads.  Returns
    ``(carry, trace)`` in ``run_bucketed_single``'s one-problem layout
    (trace leaves (T, S)).  S1 runners are cached per call, S2's by the
    closure object, so no call replays another's fitness.  ``supervisor``
    supervises the engine's driver."""
    eng = engine.bucketed
    keys = eng.full.base_key(key)[None]
    keys, carry, _insts, _B, _B_pad = engine.pad_batch(
        keys, eng.init_carry(keys))
    out = engine.drive(keys, None, carry, (), fitness_fn, max_segments,
                       supervisor=supervisor)
    return (tree_map(lambda a: a[0], out["carry"]),
            tree_map(lambda a: a[0], out["trace"]))
