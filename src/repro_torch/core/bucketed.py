"""Rung-bucketed execution of the IPOP ladder: work proportional to the
live rung.  Port of ``repro/core/bucketed.py``.

The λ_max-padded ladder (``core/ladder.py``) samples, evaluates and reduces
λ_max rows every generation even when the live rung needs only λ_start:
2^kmax_exp times too many rows on rung 0.  Here bucket k pads only to
λ_k = 2ᵏ·λ_start (``params.bucket_config``) and carries the rung-0..k
parameter stack at that width.  A bucket runs a *segment* of whole eigen
blocks (``BucketedLadderEngine.segment_scan``).  Between segments the host
driver (``drive_segments``) reads the schedule back once
(``pull_schedule``: rung index, active flag, budget spent and best value
of every member, in one transfer) and picks the next bucket
(``next_bucket``, by ``policy``: ``"cover"`` the widest live rung, ``"min"``
the narrowest).  A slot whose rung lies above the bucket is parked for the
segment (``slots_gen_step(bucket_cap=k)``), and the driver stops as soon as
no member can pay for another generation.  ``run_campaign_bucketed`` drives
a campaign's B members (carry leaves (B, S, ...)) through the same loop.

Both sampling tiers are prefix-stable: a member draws the same numbers in
whichever bucket runs it (the row-keyed draw keys each row, the counter
stream each element).  With ``eigen_interval == 1`` the bucketed run is
the padded ladder's trajectory, up to the order of floating-point sums.

The driver emits the ``bucketed_*`` series and the ``pull`` and
``segment`` spans of ``repro_torch.obs`` from values the boundary's one
pull already brought to the host.  ``segment_scan(max_evals=...)`` takes
a (B,) tensor of per-member budgets, which is how the campaign service
runs jobs of different budgets in one segment (``service/server.py``).

``drive_segments(supervisor=...)`` takes a ``repro_torch.fleet``
``IslandSupervisor``: periodic host snapshots of the carry, injected
faults, health grading of the boundary pulls and recovery by replay from
the last snapshot (``fleet/controller.py``); without one each hook site is
one host ``is None`` test.

Waiting (ROADMAP.md): one CUDA graph per bucket segment, which
``torch.linalg.eigh``'s host sync inside a segment rules out for now.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import ladder
from repro_torch.core.params import (bucket_config, default_max_iter,
                                     ladder_params)
from repro_torch.fitness import bbob
from repro_torch.kernels import ops

#: a guard: the driver raises after this many segments
MAX_SEGMENTS = 10_000


@dataclasses.dataclass
class BucketedLadderEngine:
    """Per-rung-bucket segments over a shared ladder state: the sequential
    schedule of ``LadderEngine`` (one slot walking the rungs) and its key
    schedule."""

    n: int
    lam_start: int = 12
    kmax_exp: int = 4
    max_evals: int = 200_000
    domain: Tuple[float, float] = (-5.0, 5.0)
    sigma0_frac: float = 0.25
    impl: str = "auto"                  # sampling tier, see kernels/ops.py
    dtype: str = "float64"
    eigen_interval: Optional[int] = None
    seg_blocks: Optional[int] = None    # segment length cap in eigen blocks
    policy: str = "cover"               # "cover" | "min" (``next_bucket``)
    overlap: bool = False               # speculative next-segment dispatch
    device: Optional[str] = None        # None: CUDA, raising without it

    def __post_init__(self):
        if self.policy not in ("cover", "min"):
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.seg_blocks is None and self.policy == "cover":
            # cover runs the widest live rung, so segments stay short
            # enough to follow a climbing member
            self.seg_blocks = 64
        # the padded engine supplies cfg, sparams, keys and the initial
        # carry; the buckets only narrow the padding
        self.full = ladder.LadderEngine(
            n=self.n, lam_start=self.lam_start, kmax_exp=self.kmax_exp,
            schedule="sequential", max_evals=self.max_evals,
            domain=self.domain, sigma0_frac=self.sigma0_frac, impl=self.impl,
            dtype=self.dtype, eigen_interval=self.eigen_interval,
            device=self.device)
        self.device = self.full.device
        self.lam_max = self.full.lam_max
        self.interval = int(self.full.cfg.eigen_interval)
        self.bucket_cfgs = []
        self.bucket_sparams = []
        for k in range(self.kmax_exp + 1):
            cfg_k = bucket_config(self.full.cfg, (2 ** k) * self.lam_start)
            self.bucket_cfgs.append(cfg_k)
            self.bucket_sparams.append(
                ladder_params(cfg_k, self.lam_start, k, device=self.device))
        self._programs: set = set()

    def bucket_seg_gens(self, k: int, need_gens: Optional[int] = None) -> int:
        """Segment length (generations) of bucket k: whole eigen blocks,
        capped by what a rung-k descent can still run (the budget's
        generations at λ_k; under ``"min"``, whose cohort sits on rung k,
        rung k's MaxIter; the cohort's remaining need when known), the
        block count rounded up to a power of two and capped at
        ``seg_blocks``."""
        lam_k = (2 ** k) * self.lam_start
        most = max(1, self.max_evals // lam_k)
        if self.policy == "min":
            most = min(most, default_max_iter(self.n, lam_k))
        if need_gens is not None:
            most = min(most, max(1, int(need_gens)))
        blocks = -(-most // self.interval)
        blocks = 1 << (blocks - 1).bit_length()          # next power of two
        if self.seg_blocks is not None:
            blocks = min(blocks, max(1, int(self.seg_blocks)))
        return blocks * self.interval

    def init_carry(self, base_key: torch.Tensor) -> ladder.LadderCarry:
        return self.full.init_carry(base_key)

    def segment_scan(self, k: int, base_key: torch.Tensor,
                     fitness_fn: Callable, carry: ladder.LadderCarry,
                     seg_gens: int, max_evals=None
                     ) -> Tuple[ladder.LadderCarry, ladder.LadderTrace]:
        """``seg_gens`` generations of bucket k from ``carry``; the trace
        leaves are stacked (seg_gens, ...).  ``max_evals`` replaces the
        engine's budget: an int, or a campaign's (B,) int64 tensor of
        per-member budgets on the carry's device (the service's rows)."""
        cfg_k = self.bucket_cfgs[k]
        sparams_k = self.bucket_sparams[k]
        budget = self.max_evals if max_evals is None else max_evals

        def step_fn(c, eigen):
            return ladder.slots_gen_step(
                cfg_k, sparams_k, c, base_key, fitness_fn,
                max_evals=budget, kmax_exp=self.kmax_exp,
                schedule="sequential", domain=self.domain, impl=self.impl,
                eigen=eigen, bucket_cap=k)

        return ladder.scan_eigen_blocks(step_fn, carry, self.interval,
                                        int(seg_gens) // self.interval)

    def segment_runner(self, k: int, branch_fids: Tuple[int, ...],
                       seg_gens: int) -> Callable:
        """A campaign's segment program of bucket ``k``, length
        ``seg_gens`` and fid menu: ``run(keys (B, 2), fitness, carry) ->
        (carry, trace)``, the trace member-major (B, seg_gens, ...).  The
        port compiles nothing; the engine records each distinct (bucket,
        length, menu) it hands out, which ``compiles`` counts."""
        self._programs.add((int(k), int(seg_gens), tuple(branch_fids)))

        def run(keys, fitness_fn, carry):
            carry, trace = self.segment_scan(k, keys, fitness_fn, carry,
                                             seg_gens)
            return carry, ladder.member_major(trace)
        return run

    def compiles(self) -> int:
        """Distinct segment programs handed out (``segment_runner``)."""
        return len(self._programs)


@dataclasses.dataclass
class BucketedCampaignResult(ladder.CampaignResult):
    """A campaign result with the driver's record: ``trace`` joins the
    segments' traces along time, each member's generations in its own
    order, parked steps as ``ran`` False."""

    segments: List[dict] = dataclasses.field(default_factory=list)
    bucket_wall_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    useful_evals: int = 0
    padded_evals: int = 0
    pulls: int = 0

    def padding_waste(self) -> float:
        """Padded against useful evaluations the segments paid."""
        return self.padded_evals / max(self.useful_evals, 1)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _useful_evals_per_rung(trace: ladder.LadderTrace, lam_start: int,
                           kmax_exp: int) -> Dict[int, int]:
    """Σ over executed generations of that generation's true λ, by rung."""
    ran, k_idx = _host(trace.ran), _host(trace.k_idx)
    return {k: int(np.sum(ran & (k_idx == k))) * (2 ** k) * lam_start
            for k in range(kmax_exp + 1)}


def padding_report(trace: ladder.LadderTrace, lam_start: int, kmax_exp: int,
                   padded_lam: int) -> dict:
    """Padded against useful evaluations of a fixed-width trace: every
    (step, slot) cell of a ``padded_lam``-wide program pays ``padded_lam``
    rows (masked tail steps included); the useful count is each executed
    generation's true λ."""
    useful = _useful_evals_per_rung(trace, lam_start, kmax_exp)
    padded = int(_host(trace.ran).size) * int(padded_lam)
    total_useful = int(sum(useful.values()))
    return {
        "useful_evals": total_useful,
        "padded_evals": padded,
        "waste": round(padded / max(total_useful, 1), 3),
        "useful_per_rung": {str(k): v for k, v in useful.items()},
    }


def pull_schedule(carry: ladder.LadderCarry, wait: bool = True):
    """The driver's one device→host read per boundary: the rung indices and
    active flags of slot 0, the budget counters and the bests, packed into
    one int64 tensor (the bests as their float64 bits) and copied in one
    transfer.  Returns four 1-d numpy arrays.  With ``wait=False`` the copy
    is only queued (into pinned memory on the card) and a function that
    waits for it and returns the arrays is returned instead."""
    best = carry.best_f.to(torch.float64).reshape(-1).view(torch.int64)
    packed = torch.cat([carry.k_idx[..., 0].reshape(-1).long(),
                        carry.active[..., 0].reshape(-1).long(),
                        carry.total_fevals.reshape(-1).long(), best])
    done = None
    if packed.is_cuda:
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(packed.device))
    else:
        host = packed

    def finish():
        if done is not None:
            done.synchronize()
        rows = host.numpy().reshape(4, -1)
        return (rows[0].astype(np.int32), rows[1].astype(bool), rows[2].copy(),
                rows[3].view(np.float64).copy())
    return finish() if wait else finish


def next_bucket(engine: BucketedLadderEngine, k_idx: np.ndarray,
                active: np.ndarray, fevals: np.ndarray,
                seg_len: Dict[int, int], budgets=None):
    """One re-bucketing decision: ``(live, k)``, with ``k`` None when no
    member can pay for another generation.  Under ``"cover"`` ``k`` is the
    widest live rung (every live member runs every step: fewest steps),
    under ``"min"`` the narrowest (members only move up, so the lowest
    occupied bucket pads least).  A bucket's segment length is sized for
    its cohort when it first opens and kept in ``seg_len``.  ``budgets``
    (B,) replaces the engine's ``max_evals`` per member; the liveness rule
    is the device gate of ``slots_gen_step``."""
    cap = engine.max_evals if budgets is None else np.asarray(budgets)
    lam_cur = engine.lam_start * (2 ** k_idx)
    live = active & (fevals + lam_cur <= cap)
    if not live.any():
        return live, None
    if engine.policy == "min":
        k = int(k_idx[live].min())
    else:
        k = int(k_idx[live].max())
    if k not in seg_len:
        cohort = live if engine.policy == "cover" else live & (k_idx == k)
        need = int(np.max((cap - fevals)[cohort] // lam_cur[cohort]))
        seg_len[k] = engine.bucket_seg_gens(k, need_gens=need)
    return live, k


def drive_segments(engine: BucketedLadderEngine, carry: ladder.LadderCarry,
                   dispatch: Callable, max_segments: int = MAX_SEGMENTS,
                   time_axis: int = 1, pull: Optional[Callable] = None,
                   budgets=None, overlap: Optional[bool] = None,
                   supervisor=None, *, log: Optional[dict] = None):
    """The host re-bucketing loop.  ``dispatch(k, seg_gens, carry) ->
    (carry, trace)`` runs one segment of bucket ``k``.  Between segments
    only ``pull`` reads the device (``pull_schedule`` unless given; the
    mesh engine passes its per-device gather, which takes ``wait`` too);
    segment traces stay on the device until they are concatenated along
    ``time_axis`` at the end (1 for a campaign's (B, T, S) leaves, 0 for
    one problem's (T, S)).  ``budgets`` (B,) replaces the engine's
    ``max_evals`` per member in the bucket choice (``next_bucket``).
    Returns ``(carry, trace, segments, bucket_wall)``: one record per
    segment, and the host seconds per bucket.  ``log``, a dict, receives
    ``"segments"`` and ``"pulls"``, the schedule reads (segments + 1
    without a recovery), and under a supervisor ``"replayed"``, the
    records a recovery dropped (the segments between the snapshot and the
    death, run again); more than ``max_segments`` segments raise.

    With ``overlap`` (default ``engine.overlap``), at each boundary after
    the first the schedule's copy is queued, then the next segment of the
    previous bucket is dispatched speculatively, then the host waits for
    the copy.  If the bucket stays, the speculative output is taken;
    otherwise it is dropped and never touches the accepted carry, so the
    trajectory is bit-identical to ``overlap=False``.  A segment record's
    ``wall_s`` is the host time of dispatching the accepted segment (the
    card may still be running it), ``sync_s`` the wait for the schedule
    and ``spec_s`` that of the speculative dispatch.

    The loop emits the ``bucketed_*`` series and the ``pull`` and
    ``segment`` spans of ``repro_torch.obs`` from the pulled numpy arrays
    and ``perf_counter`` deltas only: no device read of its own.

    ``supervisor`` (a ``repro_torch.fleet`` ``IslandSupervisor``) adds
    fleet supervision at three host-side points: a per-boundary
    snapshot/recovery hook (on a death verdict the carry is restored and
    the traces and segment records taken after the snapshot dropped; the
    speculation and progress anchors are forgotten, so a speculative
    segment from before the kill is never taken), a supervised pull
    (corruption retries + health grading; a retry pulls again
    synchronously), and a pre-dispatch delay hook, called before the
    speculative dispatch too.  ``None`` costs one host ``if`` a site."""
    overlap = bool(engine.overlap) if overlap is None else bool(overlap)
    pull = pull_schedule if pull is None else pull
    reg, tracer = obs.metrics(), obs.tracer()
    seg_traces: List[ladder.LadderTrace] = []
    segments: List[dict] = []
    bucket_wall: Dict[int, float] = {}
    pulls = 0
    replayed: List[dict] = []           # records a recovery dropped
    seg_len: Dict[int, int] = {}        # one segment length per bucket
    k_prev: Optional[int] = None
    fev_prev: Optional[float] = None    # the budget pulled a boundary ago

    for b in range(max_segments):
        if supervisor is not None:
            carry, keep, recovered = supervisor.segment_boundary(
                b, carry, len(seg_traces))
            if recovered:
                # replay from the restored snapshot: drop what came after
                # it and forget the stale speculation/progress anchors
                replayed.extend(segments[keep:])
                del seg_traces[keep:]
                del segments[keep:]
                k_prev = None
                fev_prev = None
        spec = pending = None
        pulls += 1
        if overlap and k_prev is not None:
            pending = pull(carry, wait=False)
            if supervisor is not None:
                supervisor.before_dispatch(0, b)
            t0 = time.perf_counter()
            spec = dispatch(k_prev, seg_len[k_prev], carry)
            spec_s = time.perf_counter() - t0
        pull_span = tracer.start("pull", island="all", boundary=b)
        t0 = time.perf_counter()
        if supervisor is not None:
            k_idx, active, fevals, best_f = supervisor.pull(
                0, b, _reread(pending, pull, carry))
        elif pending is not None:
            k_idx, active, fevals, best_f = pending()
        else:
            k_idx, active, fevals, best_f = pull(carry)
        sync_s = time.perf_counter() - t0
        tracer.end(pull_span)
        reg.histogram("bucketed_sync_s").observe(sync_s)
        fev_sum = float(np.sum(fevals))
        if fev_prev is not None:
            reg.counter("bucketed_useful_evals_total").inc(
                max(0.0, fev_sum - fev_prev))
        fev_prev = fev_sum
        if segments:
            # the pull reflects the previous segment's result
            gb = float(best_f.min())
            segments[-1]["global_best"] = gb if np.isfinite(gb) else None
        _live, k = next_bucket(engine, k_idx, active, fevals, seg_len,
                               budgets=budgets)
        if k is None:
            break
        seg_span = tracer.start("segment", island="all", bucket=int(k),
                                boundary=b)
        hit = spec is not None and k == k_prev
        if hit:
            carry, tr = spec
            wall = spec_s
        else:
            if supervisor is not None:
                supervisor.before_dispatch(0, b)
            t0 = time.perf_counter()
            carry, tr = dispatch(k, seg_len[k], carry)
            wall = time.perf_counter() - t0
        tracer.end(seg_span, spec=("hit" if hit else "miss"
                                   if spec is not None else "sync"))
        seg_traces.append(tr)
        seg = {"bucket": k, "gens": seg_len[k], "wall_s": round(wall, 5)}
        if overlap:
            seg["sync_s"] = round(sync_s, 5)
            seg["spec_hit"] = hit
            if spec is not None:
                seg["spec_s"] = round(spec_s, 5)
        if spec is not None:
            reg.counter("bucketed_spec_dispatch_total",
                        outcome="hit" if hit else "miss").inc()
        reg.counter("bucketed_segments_total", bucket=k).inc()
        reg.histogram("bucketed_segment_wall_s", bucket=k).observe(wall)
        reg.counter("bucketed_padded_evals_total", bucket=k).inc(
            int(np.size(k_idx)) * seg_len[k] * (2 ** k) * engine.lam_start)
        reg.counter("bucketed_eigh_blocks_total", bucket=k).inc(
            seg_len[k] // engine.interval)
        segments.append(seg)
        bucket_wall[k] = bucket_wall.get(k, 0.0) + wall + (
            sync_s if overlap else 0.0)
        k_prev = k
    else:
        raise RuntimeError("segment driver did not converge "
                           f"within {max_segments} segments")

    if log is not None:
        log.update(segments=segments, pulls=pulls)
        if supervisor is not None:
            log["replayed"] = replayed
    if not seg_traces:
        # nothing could run (a budget below one λ_start generation): the
        # padded engine's empty-progress result, with zero generations
        return carry, _empty_trace(carry, time_axis), segments, bucket_wall
    trace = ladder.LadderTrace(*(torch.cat(leaves, dim=time_axis)
                                 for leaves in zip(*seg_traces)))
    return carry, trace, segments, bucket_wall


def _reread(pending: Optional[Callable], pull: Callable, carry) -> Callable:
    """The supervised pull's read: the queued copy (``pending``) the
    first time, where there is one, then ``pull(carry)`` again, so that a
    retry re-reads the device."""
    first = [pending]

    def read():
        fn, first[0] = first[0], None
        return fn() if fn is not None else pull(carry)
    return read


def _empty_trace(carry, time_axis: int) -> ladder.LadderTrace:
    """A zero-generation LadderTrace with the slot (and member) layout of
    ``carry``, its time axis at ``time_axis``.  ``carry`` may also be a
    list of a campaign's member slices (the mesh engine's carry, one slice
    a device), whose member counts add up."""
    parts = carry if isinstance(carry, list) else [carry]
    carry = parts[0]
    k = tuple(carry.k_idx.shape)
    if len(parts) > 1:
        k = (sum(int(p.k_idx.shape[0]) for p in parts),) + k[1:]
    slot = k[:time_axis] + (0,) + k[time_axis:]
    glob = k[:time_axis] + (0,)
    dev = carry.k_idx.device

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return ladder.LadderTrace(
        ran=z(slot, torch.bool), k_idx=z(slot, torch.int32),
        gen=z(slot, torch.int32), fevals=z(slot, carry.states.fevals.dtype),
        best_f=z(slot, carry.best_f.dtype), stop_reason=z(slot, torch.int32),
        stopped=z(slot, torch.bool),
        total_fevals=z(glob, carry.total_fevals.dtype),
        global_best=z(glob, carry.best_f.dtype))


def run_bucketed_single(engine: BucketedLadderEngine, base_key,
                        fitness_fn: Callable,
                        max_segments: int = MAX_SEGMENTS, supervisor=None,
                        *, log: Optional[dict] = None
                        ) -> Tuple[ladder.LadderCarry, ladder.LadderTrace]:
    """One problem through the segment driver, the bucketed backend behind
    ``ipop.run_ipop``.  ``base_key`` is an int seed or a (2,) key.
    Returns ``(carry, trace)`` shaped like ``LadderEngine.run``'s (trace
    leaves (T, 1)); ``log`` receives the driver's segment records and
    pulls (``drive_segments``); ``supervisor`` supervises the run
    (``drive_segments``)."""
    base_key = engine.full.base_key(base_key)
    carry = engine.init_carry(base_key)
    fitness_fn = ops.slot_fitness(fitness_fn, engine.full.n_slots,
                                  engine.full.cfg.tdtype)

    def dispatch(k, seg_gens, c):
        return engine.segment_scan(k, base_key, fitness_fn, c, seg_gens)

    carry, trace, _segs, _walls = drive_segments(
        engine, carry, dispatch, max_segments, time_axis=0,
        supervisor=supervisor, log=log)
    return carry, trace


def run_campaign_bucketed(engine: BucketedLadderEngine, fids,
                          instances=(1,), runs: int = 1, seed: int = 0,
                          max_segments: int = MAX_SEGMENTS
                          ) -> BucketedCampaignResult:
    """A whole BBOB campaign through the rung-bucketed segment driver: the
    members, instances and keys of ``ladder.run_campaign``, whose
    trajectories it follows (bit for bit in the arithmetic of a generation
    at ``eigen_interval == 1``, up to the order of floating-point sums),
    without λ_max padding on the low rungs, stopping as soon as every
    member retired or spent its budget.  The fitness is built once per
    campaign (``bbob.campaign_fitness``, its coefficients laid out per
    slot)."""
    members = ladder.campaign_members(tuple(fids), instances, runs)
    full = engine.full
    stacked = ladder.campaign_instances(members, engine.n, full.cfg.tdtype,
                                        engine.device)
    branch_fids = tuple(sorted(set(fids)))
    keys = ladder.member_keys(seed, len(members), engine.device)
    fit = ops.slot_fitness(bbob.campaign_fitness(stacked, branch_fids),
                           full.n_slots, full.cfg.tdtype)
    fused_menu = getattr(fit, "sep", None) is not None
    reg = obs.metrics()

    def dispatch(k, seg_gens, c):
        if fused_menu:
            # whole-menu separable segments ride the eval-fused sample
            reg.counter("bucketed_eval_fused_generations_total").inc(
                int(seg_gens))
        return engine.segment_runner(k, branch_fids, seg_gens)(keys, fit, c)

    log: dict = {}
    carry, trace, segments, bucket_wall = drive_segments(
        engine, engine.init_carry(keys), dispatch, max_segments, log=log)
    trace = ladder.host_trace(trace)
    B = len(members)
    useful = _useful_evals_per_rung(trace, engine.lam_start, engine.kmax_exp)
    padded = sum(B * sg["gens"] * (2 ** sg["bucket"]) * engine.lam_start
                 for sg in segments)
    return BucketedCampaignResult(
        members=members, f_opt=stacked.f_opt.cpu().numpy().astype(np.float64),
        best_f=carry.best_f.cpu().numpy(), best_x=carry.best_x.cpu().numpy(),
        total_fevals=carry.total_fevals.cpu().numpy(), trace=trace,
        compiles=engine.compiles(), segments=segments,
        bucket_wall_s={k: round(v, 5) for k, v in bucket_wall.items()},
        useful_evals=int(sum(useful.values())), padded_evals=int(padded),
        pulls=log["pulls"])
