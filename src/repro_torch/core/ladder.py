"""The IPOP restart ladder on the device (paper Alg. 2) — port of
``repro/core/ladder.py``.

All rungs K = 2⁰..2^kmax share one λ_max-padded ``CMAConfig`` and a stacked
``CMAParams``; descent slots live in one slot-stacked ``CMAState`` and
advance together, one generation per ``slots_gen_step``.  When a slot's
stop check fires it restarts in place from a fresh key with the doubled-λ
parameters gathered from the stack (``restart_mode="same_k"`` keeps a
concurrent slot on its rung).  Stop, restart and budget gates are
``torch.where`` on per-slot masks: the port's code reads no tensor back to
the host inside the generation loop.  (``torch.linalg.eigh`` checks its
solver status on the host on a CUDA device, once per eigen block.)  The
per-generation trace is stacked once, at the end of ``run_scan``.

A campaign (``run_campaign``) runs B problems at once: the carry's leaves
gain a leading member axis (B, S, ...), and ``slots_gen_step`` lays the
states out as B·S slots for the sample and update ops, so each op is one
launch a generation whatever B is (``torch.func.vmap`` cannot batch the
ctypes-bound kernels).  The budget gate, the best of the slots and the
evaluation count work per member; each member's base key is
``fold_in(PRNGKey(seed), j)``, as in the JAX package.

Schedules: ``sequential`` (one slot walks the ladder) and ``concurrent``
(kmax+1 slots, one per rung).  ``impl`` picks the tier (``kernels/ops.py``):
the row-keyed draw handed to the sample kernel (``"auto"``), the counter
stream drawn inside it (``"kernel_rng"``), or the plain versions on any
device (``"eager"``, and ``"eager_unfused"`` with the moments op soup of
``padded_gen_step``).  ``eigen_schedule="flat"`` runs one generation at a
time with the per-descent ``"lazy"`` eigen cadence; ``"nested"`` runs eigen
blocks (``scan_eigen_blocks``).  ``slots_gen_step(bucket_cap=k)`` is the
step of the rung-bucketed programs (``core/bucketed.py``).
``run_concurrent`` runs all rungs on the K-Distributed strategy instead
(``core/strategies.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cmaes, prng
from repro_torch.core.device import resolve_device
from repro_torch.core.eval_dispatch import FusableEval
from repro_torch.core.params import (CMAConfig, default_max_iter,
                                     ladder_params, select_params)
from repro_torch.fitness import bbob
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# key schedule (the JAX package's, so both draw the same numbers)
# ---------------------------------------------------------------------------

def slot_key(base_key: torch.Tensor, slot_id, incarnation) -> torch.Tensor:
    """Key of one descent incarnation of each slot: (S, 2)."""
    return prng.fold_in(prng.fold_in(base_key, slot_id), incarnation)


def init_keys(kd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k_init, k_x0) for fresh descents keyed by ``kd`` (S, 2)."""
    ks = prng.split(kd)
    return ks[..., 0, :], ks[..., 1, :]


def gen_key(kd: torch.Tensor, gen) -> torch.Tensor:
    """Sampling key of (0-based) generation ``gen`` within an incarnation."""
    return prng.fold_in(kd, gen)


def fresh_state(cfg: CMAConfig, kd: torch.Tensor,
                domain: Tuple[float, float]) -> cmaes.CMAState:
    """Fresh descent states: uniform means in the search domain, reset σ."""
    _, k_x0 = init_keys(kd)
    lo, hi = domain
    x0 = prng.uniform(k_x0, (cfg.n,), cfg.tdtype, lo, hi)
    return cmaes.init_state(cfg, x0)


def _slots_fused_update(cfg: CMAConfig, params_k, states: cmaes.CMAState,
                        kgs: torch.Tensor, fitness_fn: Callable,
                        eigen: str, impl: str = "auto") -> cmaes.CMAState:
    """One fused generation over all slots from their sampling keys ``kgs``
    (S, 2).  Under ``"kernel_rng"`` the keys are the counter stream's seeds
    and the sample kernel draws Z itself; otherwise the row-keyed draw is
    made first and handed to ``fused_generation``."""
    if ops.validate_impl(impl) != "kernel_rng":
        Z = cmaes.sample_z(kgs, cfg.lam_max, cfg.n, cfg.tdtype)
        return fused_generation(cfg, params_k, states, Z, fitness_fn, eigen,
                                impl)
    args = (states.m, states.sigma, states.B, states.D, kgs, cfg.lam_max)
    sep = getattr(fitness_fn, "sep", None)
    if sep is not None:
        Y, F = ops.gen_sample_rng_eval(*args, sep, impl=impl)
        return _generation_from_sample(cfg, params_k, states, Y, None, F,
                                       eigen, impl)
    Y, X = ops.gen_sample_rng(*args, impl=impl)
    return _generation_from_sample(cfg, params_k, states, Y, X,
                                   _evaluate(fitness_fn, X), eigen, impl)


def _evaluate(fitness_fn: Callable, X: torch.Tensor) -> torch.Tensor:
    S, lam, n = X.shape
    return fitness_fn(X.reshape(S * lam, n)).reshape(S, lam)


def fused_generation(cfg: CMAConfig, params_k, states: cmaes.CMAState,
                     Z: torch.Tensor, fitness_fn: Callable, eigen: str,
                     impl: str = "auto") -> cmaes.CMAState:
    """One generation over all slots from a given draw Z (S, λ_max, n): the
    sample op (eval-fused when ``fitness_fn`` carries separable
    coefficients), then ``_generation_from_sample``; ``impl`` is the tier
    of both ops (``kernels/ops.py``)."""
    sep = getattr(fitness_fn, "sep", None)
    if sep is not None:
        Y, F = ops.gen_sample_eval(states.m, states.sigma, states.B, states.D,
                                   Z, sep, impl=impl)
        return _generation_from_sample(cfg, params_k, states, Y, None, F,
                                       eigen, impl)
    Y, X = ops.gen_sample(states.m, states.sigma, states.B, states.D, Z,
                          impl=impl)
    return _generation_from_sample(cfg, params_k, states, Y, X,
                                   _evaluate(fitness_fn, X), eigen, impl)


def _generation_from_sample(cfg: CMAConfig, params_k,
                            states: cmaes.CMAState, Y: torch.Tensor,
                            X: Optional[torch.Tensor], F: torch.Tensor,
                            eigen: str, impl: str = "auto") -> cmaes.CMAState:
    """The rest of a generation once the population is sampled (X is None
    on the eval-fused path): rank weights, the update kernel and the O(n)
    epilogue; stopped slots keep their state."""
    lam_max = cfg.lam_max
    rows = torch.arange(lam_max, device=F.device)
    F = torch.where(rows[None, :] < params_k.lam[:, None], F, torch.inf)
    if X is None:
        W, f_sorted, x_best, n_evals = cmaes.population_stats_from_y(
            F, Y, states.m, states.sigma, params_k, lam_max)
    else:
        W, f_sorted, x_best, n_evals = cmaes.population_stats(
            F, X, params_k, lam_max)
    C_new, ps_new, pc_new, y_w = ops.gen_update(
        states.C, states.B, states.D, states.p_sigma, states.p_c, Y, W,
        cmaes.gen_coef(params_k, states), impl=impl)
    new = cmaes._finish_update(cfg, params_k, states, f_sorted, x_best,
                               n_evals, C_new, ps_new, pc_new, y_w, eigen)
    return cmaes.tree_select(states.stop, states, new)


def padded_gen_step(cfg: CMAConfig, params, states: cmaes.CMAState,
                    kgs: torch.Tensor, fitness_fn: Callable,
                    impl: str = "auto", eigen: str = "lazy") -> cmaes.CMAState:
    """One λ_max-padded generation of every slot of ``states`` from its
    sampling key ``kgs`` (S, 2): rows at or beyond a slot's λ get +inf.
    The fused generation unless ``impl="eager_unfused"``, which keeps the
    moments op soup (``cmaes.compute_moments`` + ``masked_update``); as in
    the fused one, stopped slots keep their state.  The host loop's step,
    and the ladder's."""
    if ops.use_fused(impl):
        return _slots_fused_update(cfg, params, states, kgs, fitness_fn,
                                   eigen, impl)
    lam_max = cfg.lam_max
    Y, X = cmaes.sample_population(states, kgs, lam_max, impl=impl)
    rows = torch.arange(lam_max, device=X.device)
    F = torch.where(rows[None, :] < params.lam[:, None],
                    _evaluate(fitness_fn, X), torch.inf)
    mom = cmaes.compute_moments(Y, F, X, params, lam_max, impl=impl)
    return cmaes.masked_update(cfg, params, states, mom, impl=impl,
                               eigen=eigen)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class LadderCarry(NamedTuple):
    """Leaves (S, ...) for one problem; a campaign's carry has a leading
    member axis: states (B, S, ...), the per-slot leaves (B, S) and the
    per-member ones (B,) / (B, n)."""
    states: cmaes.CMAState      # (S, ...) stacked descent slots
    k_idx: torch.Tensor         # (S,) int32 rung index, λ = 2ᵏ·λ_start
    incarnation: torch.Tensor   # (S,) int32 restarts of this slot so far
    active: torch.Tensor        # (S,) bool, False once a slot retired
    total_fevals: torch.Tensor  # () int64 across all slots and restarts
    best_f: torch.Tensor        # () global best
    best_x: torch.Tensor        # (n,)


class LadderTrace(NamedTuple):
    """Per-generation record; leaves (S,) per generation unless noted (a
    campaign's carry a leading member axis)."""
    ran: torch.Tensor           # bool, slot executed this generation
    k_idx: torch.Tensor         # int32 rung during this generation
    gen: torch.Tensor           # int32 within-descent generation (1-based)
    fevals: torch.Tensor        # within-descent cumulative evaluations
    best_f: torch.Tensor        # within-descent best so far
    stop_reason: torch.Tensor   # int32 bitmask
    stopped: torch.Tensor       # bool, stop fired; slot restarted or retired
    total_fevals: torch.Tensor  # () cumulative across the whole ladder
    global_best: torch.Tensor   # () best across slots and restarts


def _lift(tree):
    """A one-problem carry or trace as a campaign's of one member."""
    return type(tree)(*(_lift(x) if isinstance(x, tuple) else x[None]
                        for x in tree))


def _drop(tree):
    """The inverse of ``_lift``."""
    return type(tree)(*(_drop(x) if isinstance(x, tuple) else x[0]
                        for x in tree))


def flat_slots(states: cmaes.CMAState) -> cmaes.CMAState:
    """(B, S, ...) states as B·S slots."""
    return cmaes.CMAState(*(x.reshape((-1,) + tuple(x.shape[2:]))
                            for x in states))


def member_slots(states: cmaes.CMAState, B: int) -> cmaes.CMAState:
    """B·S slots as (B, S, ...) states."""
    return cmaes.CMAState(*(x.reshape((B, -1) + tuple(x.shape[1:]))
                            for x in states))


def member_rows(fitness_fn: Callable, B: int) -> Callable:
    """A campaign fitness (X (B, rows, n) → (B, rows)) as the step's
    fitness of flat rows: member b's rows are the b-th block of B.  Its
    separable coefficients, if any, ride along."""
    sep = getattr(fitness_fn, "sep", None)
    fn = fitness_fn if sep is None else fitness_fn.fn

    def rows(X):
        return fn(X.reshape((B, -1, X.shape[-1]))).reshape(-1)
    return rows if sep is None else FusableEval(rows, sep)


def slots_gen_step(cfg: CMAConfig, sparams, carry: LadderCarry,
                   base_key: torch.Tensor, fitness_fn: Callable, *,
                   max_evals: int, kmax_exp: int,
                   schedule: str = "sequential", restart_mode: str = "double",
                   domain: Tuple[float, float] = (-5.0, 5.0),
                   impl: str = "auto", eigen: str = "lazy",
                   bucket_cap: Optional[int] = None
                   ) -> Tuple[LadderCarry, LadderTrace]:
    """One generation over all slots: the budget gate, the generation, the
    best value, and the in-place doubled-λ restart or retirement.

    ``carry`` is one problem's (``base_key`` (2,), ``fitness_fn`` of X
    (rows, n)) or a campaign's (member axis; ``base_key`` (B, 2),
    ``fitness_fn`` of X (B, rows, n)).  The sample and update ops run once
    on all B·S slots.  ``eigen`` is ``"lazy"`` (per-descent cadence), or
    ``"defer"`` / ``"always"`` as ``scan_eigen_blocks`` passes them.
    ``bucket_cap`` is the highest rung the executing program holds
    (``cfg``/``sparams`` are then a bucket's, ``core/bucketed.py``): a slot
    on a higher rung is parked (``ran`` False, state frozen) until the
    driver moves it to a wider bucket.  ``None`` means the program spans
    the whole ladder.  ``max_evals`` is an int or, for a campaign, a (B,)
    tensor of per-member budgets."""
    single = carry.k_idx.dim() == 1
    if single:
        carry, base_key = _lift(carry), base_key[None]
    else:
        fitness_fn = member_rows(fitness_fn, carry.k_idx.shape[0])
    B, S = carry.k_idx.shape
    n = carry.best_x.shape[-1]
    dev = carry.k_idx.device
    slot_ids = torch.arange(S, dtype=torch.int64, device=dev)
    states = flat_slots(carry.states)

    gather_idx = (carry.k_idx if bucket_cap is None
                  else torch.clamp(carry.k_idx, max=bucket_cap))
    params_k = select_params(sparams, gather_idx.reshape(-1).long())
    lam_k = params_k.lam.to(carry.total_fevals.dtype).reshape(B, S)

    # budget gate: a slot only starts a generation it can fully pay for;
    # concurrent slots are gated on the cumulative reservation before them
    runnable = carry.active
    if bucket_cap is not None:
        runnable = runnable & (carry.k_idx <= bucket_cap)
    reserve = torch.cumsum(torch.where(runnable, lam_k, 0), 1)
    if isinstance(max_evals, torch.Tensor) and max_evals.dim() == 1:
        max_evals = max_evals[:, None]          # per-member budgets (B,)
    ran = runnable & (carry.total_fevals[:, None] + reserve <= max_evals)

    kds = slot_key(base_key[:, None, :], slot_ids, carry.incarnation)
    kgs = gen_key(kds.reshape(-1, 2), states.gen)
    upd = padded_gen_step(cfg, params_k, states, kgs, fitness_fn, impl,
                          eigen)
    new_states = cmaes.tree_select(ran.reshape(-1), upd, states)

    total_fevals = carry.total_fevals + torch.where(ran, lam_k, 0).sum(1)

    cand = torch.where(ran, new_states.best_f.reshape(B, S), torch.inf)
    i_star = torch.argmin(cand, dim=1, keepdim=True)
    c_star = cand.gather(1, i_star)[:, 0]
    better = c_star < carry.best_f
    best_f = torch.where(better, c_star, carry.best_f)
    x_star = new_states.best_x.reshape(B, S, n).gather(
        1, i_star[..., None].expand(B, 1, n))[:, 0]
    best_x = torch.where(better[:, None], x_star, carry.best_x)

    def per_slot(x):
        return x.reshape(B, S)
    stopped = ran & per_slot(new_states.stop)
    trace = LadderTrace(
        ran=ran, k_idx=carry.k_idx, gen=per_slot(new_states.gen),
        fevals=per_slot(new_states.fevals),
        best_f=per_slot(new_states.best_f),
        stop_reason=per_slot(new_states.stop_reason), stopped=stopped,
        total_fevals=total_fevals, global_best=best_f)

    # -- in-place restart: doubled-λ params gathered from the stack
    if schedule == "concurrent" and restart_mode == "same_k":
        next_k = carry.k_idx
    else:
        next_k = carry.k_idx + 1
    if schedule == "sequential":
        retire = stopped & (next_k > kmax_exp)
    else:
        retire = torch.zeros_like(stopped)
        next_k = torch.clamp(next_k, max=kmax_exp)
    restart = stopped & ~retire
    k_new = torch.where(restart, next_k, carry.k_idx)
    inc_new = carry.incarnation + restart.to(torch.int32)
    active_new = carry.active & ~retire

    fresh = fresh_state(cfg, slot_key(base_key[:, None, :], slot_ids,
                                      inc_new).reshape(-1, 2), domain)
    fresh = fresh._replace(restarts=inc_new.reshape(-1))
    states_out = cmaes.tree_select(restart.reshape(-1), fresh, new_states)

    out = LadderCarry(
        states=member_slots(states_out, B), k_idx=k_new,
        incarnation=inc_new, active=active_new, total_fevals=total_fevals,
        best_f=best_f, best_x=best_x)
    return (_drop(out), _drop(trace)) if single else (out, trace)


def stack_traces(traces):
    """Per-generation NamedTuple traces stacked along a leading time axis."""
    return type(traces[0])(*(torch.stack(leaves) for leaves in zip(*traces)))


def scan(step_fn: Callable, carry, xs):
    """``lax.scan`` in eager torch: ``step_fn(carry, x) -> (carry, trace)``
    for each x along the leading axis of ``xs``; returns the final carry
    and the stacked traces."""
    traces = []
    for x in xs:
        carry, tr = step_fn(carry, x)
        traces.append(tr)
    return carry, stack_traces(traces)


def scan_eigen_blocks(step_fn: Callable, carry, interval: int,
                      n_blocks: int, xs: Optional[torch.Tensor] = None):
    """``n_blocks`` blocks of ``interval`` generations: the first
    ``interval − 1`` keep B/D frozen (``"defer"``), the last refreshes them
    with one batched ``eigh`` (``"always"``).  ``step_fn(carry, eigen) ->
    (carry, trace)``, or with ``xs`` (leading axis ``n_blocks·interval``,
    e.g. the strategies' per-generation keys) ``step_fn(carry, x, eigen)``
    with one slice of ``xs`` per generation.  Returns the final carry and
    the step's own trace type, stacked along a leading axis of length
    ``n_blocks·interval``."""
    interval, n_blocks = int(interval), int(n_blocks)
    traces = []
    for b in range(n_blocks):
        for i in range(interval):
            eigen = "always" if i == interval - 1 else "defer"
            if xs is None:
                carry, tr = step_fn(carry, eigen)
            else:
                carry, tr = step_fn(carry, xs[b * interval + i], eigen)
            traces.append(tr)
    return carry, stack_traces(traces)


def member_major(trace: LadderTrace) -> LadderTrace:
    """A campaign's trace (T, B, ...) as (B, T, ...), the JAX package's
    vmapped layout."""
    return LadderTrace(*(x.movedim(0, 1) for x in trace))


@dataclasses.dataclass
class LadderEngine:
    """Stacked IPOP ladder: all rungs in one padded slot-stacked state."""

    n: int
    lam_start: int = 12
    kmax_exp: int = 4
    schedule: str = "sequential"        # "sequential" | "concurrent"
    max_evals: int = 200_000
    domain: Tuple[float, float] = (-5.0, 5.0)
    sigma0_frac: float = 0.25
    impl: str = "auto"
    dtype: str = "float64"
    restart_mode: str = "double"        # concurrent slots: "double" | "same_k"
    eigen_interval: Optional[int] = None  # None: c-cmaes default (CMAConfig)
    eigen_schedule: str = "nested"      # "nested" | "flat"
    device: Optional[str] = None        # None: CUDA, raising without it

    def __post_init__(self):
        if self.schedule not in ("sequential", "concurrent"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.restart_mode not in ("double", "same_k"):
            raise ValueError(f"unknown restart_mode {self.restart_mode!r}")
        ops.validate_impl(self.impl)
        if self.eigen_schedule not in ("nested", "flat"):
            raise ValueError(f"unknown eigen_schedule {self.eigen_schedule!r}")
        if self.max_evals > torch.iinfo(torch.int64).max:
            raise ValueError(f"max_evals={self.max_evals} overflows int64")
        self.device = resolve_device(self.device)
        self.lam_max = (2 ** self.kmax_exp) * self.lam_start
        width = self.domain[1] - self.domain[0]
        self.cfg = CMAConfig(n=self.n, lam=self.lam_max, lam_max=self.lam_max,
                             sigma0=self.sigma0_frac * width, dtype=self.dtype,
                             eigen_interval=self.eigen_interval)
        self.sparams = ladder_params(self.cfg, self.lam_start, self.kmax_exp,
                                     device=self.device)
        self.n_slots = 1 if self.schedule == "sequential" else self.kmax_exp + 1
        self._programs: set = set()

    def default_gens(self, total_gens: Optional[int] = None) -> int:
        """Upper bound on useful scan length for the sequential schedule."""
        if total_gens is not None:
            return int(total_gens)
        by_budget = self.max_evals // self.lam_start
        by_iter = sum(default_max_iter(self.n, (2 ** k) * self.lam_start)
                      for k in range(self.kmax_exp + 1))
        return max(1, min(by_budget, by_iter))

    def base_key(self, key) -> torch.Tensor:
        """An int seed or a (2,) key tensor, as a key on the engine's device."""
        return prng.as_key(key, self.device)

    def init_carry(self, base_key: torch.Tensor) -> LadderCarry:
        """Fresh carry of one problem (``base_key`` (2,)) or of a campaign's
        members (``base_key`` (B, 2))."""
        keys = base_key.reshape(-1, 2)
        B, S, dev = keys.shape[0], self.n_slots, self.device
        slot_ids = torch.arange(S, dtype=torch.int64, device=dev)
        if self.schedule == "concurrent":
            k0 = slot_ids.to(torch.int32)        # slot i starts on rung i
        else:
            k0 = torch.zeros((S,), dtype=torch.int32, device=dev)
        k0 = k0.expand(B, S).contiguous()
        inc0 = torch.zeros((B, S), dtype=torch.int32, device=dev)
        states = fresh_state(self.cfg, slot_key(keys[:, None, :], slot_ids,
                                                inc0).reshape(-1, 2),
                             self.domain)
        dt = self.cfg.tdtype
        carry = LadderCarry(
            states=member_slots(states, B), k_idx=k0, incarnation=inc0,
            active=torch.ones((B, S), dtype=torch.bool, device=dev),
            total_fevals=torch.zeros((B,), dtype=torch.int64, device=dev),
            best_f=torch.full((B,), torch.inf, dtype=dt, device=dev),
            best_x=torch.zeros((B, self.n), dtype=dt, device=dev))
        return _drop(carry) if base_key.dim() == 1 else carry

    def gen_step(self, carry: LadderCarry, base_key: torch.Tensor,
                 fitness_fn: Callable, eigen: str = "lazy"
                 ) -> Tuple[LadderCarry, LadderTrace]:
        """One generation.  On the card a ``fitness_fn`` with separable
        coefficients must come from ``ops.slot_fitness`` (``run_scan`` lays
        them out once per run)."""
        return slots_gen_step(
            self.cfg, self.sparams, carry, base_key, fitness_fn,
            max_evals=self.max_evals, kmax_exp=self.kmax_exp,
            schedule=self.schedule, restart_mode=self.restart_mode,
            domain=self.domain, impl=self.impl, eigen=eigen)

    def run_scan(self, base_key: torch.Tensor, fitness_fn: Callable,
                 total_gens: int) -> Tuple[LadderCarry, LadderTrace]:
        """The whole ladder of one problem (``base_key`` (2,)) or of a
        campaign (``base_key`` (B, 2), a campaign fitness); nested in eigen
        blocks, its length is ``total_gens`` rounded up to a whole number
        of blocks.  ``eigen_schedule="flat"`` runs ``total_gens``
        generations with the per-descent ``"lazy"`` cadence."""
        fitness_fn = ops.slot_fitness(fitness_fn, self.n_slots,
                                      self.cfg.tdtype)
        carry0 = self.init_carry(base_key)

        def step(c, eigen):
            return self.gen_step(c, base_key, fitness_fn, eigen)
        if self.eigen_schedule == "flat":
            return scan(lambda c, _: step(c, "lazy"), carry0,
                        range(int(total_gens)))
        interval = int(self.cfg.eigen_interval)
        n_blocks = -(-int(total_gens) // interval)
        return scan_eigen_blocks(step, carry0, interval, n_blocks)

    def run(self, key, fitness_fn: Callable,
            total_gens: Optional[int] = None
            ) -> Tuple[LadderCarry, LadderTrace]:
        """Single-problem run; ``key`` is an int seed or a (2,) key."""
        return self.run_scan(self.base_key(key), fitness_fn,
                             self.default_gens(total_gens))

    def campaign_runner(self, branch_fids: Tuple[int, ...],
                        total_gens: int) -> Callable:
        """The campaign program of a fid menu and a scan length:
        ``run(keys (B, 2), stacked instance) -> (carry, trace)``, the trace
        member-major (B, T, ...).  The port compiles nothing; the engine
        records each distinct (menu, length) it hands out, which
        ``compiles`` counts."""
        menu, length = tuple(branch_fids), int(total_gens)
        self._programs.add((menu, length))

        def run(keys, inst):
            carry, trace = self.run_scan(
                keys, bbob.campaign_fitness(inst, menu), length)
            return carry, member_major(trace)
        return run

    def compiles(self) -> int:
        """Distinct campaign programs handed out (``campaign_runner``)."""
        return len(self._programs)


# ---------------------------------------------------------------------------
# campaigns: many (function, instance, run) members in one program
# ---------------------------------------------------------------------------

def campaign_members(fids, instances=(1,), runs: int = 1) -> list:
    """(fid, instance, run) per member, in the JAX package's order."""
    return [(f, i, r) for f in fids for i in instances for r in range(runs)]


def campaign_instances(members, n: int, dtype, device) -> bbob.BBOBInstance:
    """The members' instances stacked (peaks padded); each distinct
    (fid, instance) is made once."""
    made = {}
    for f, i, _r in members:
        if (f, i) not in made:
            made[(f, i)] = bbob.make_instance(f, n, i, dtype, device)
    return bbob.stack_instances([made[(f, i)] for f, i, _r in members])


def member_keys(seed: int, B: int, device) -> torch.Tensor:
    """(B, 2): member j's base key ``fold_in(PRNGKey(seed), j)``."""
    return prng.fold_in(prng.PRNGKey(seed, device=device),
                        torch.arange(B, dtype=torch.int64, device=device))


def host_trace(trace: LadderTrace) -> LadderTrace:
    return LadderTrace(*(x.cpu().numpy() for x in trace))


@dataclasses.dataclass
class CampaignResult:
    members: List[Tuple[int, int, int]]   # (fid, instance, run) per member
    f_opt: np.ndarray                     # (B,)
    best_f: np.ndarray                    # (B,)
    best_x: np.ndarray                    # (B, n)
    total_fevals: np.ndarray              # (B,)
    trace: LadderTrace                    # numpy leaves (B, T, S) / (B, T)
    compiles: int                         # distinct programs dispatched

    def hit_evals(self, targets: np.ndarray) -> np.ndarray:
        """(B, len(targets)) first total-eval count reaching best−f_opt ≤ t
        (+inf where never reached).  The running-best error of a row is
        non-increasing, so the generations that reach a target form a
        suffix, whose length one ``np.searchsorted`` over the reversed row
        finds for all targets at once."""
        gb = np.minimum.accumulate(np.asarray(self.trace.global_best), axis=1)
        fe = np.asarray(self.trace.total_fevals)
        err = gb - np.asarray(self.f_opt)[:, None]
        targets = np.asarray(targets, np.float64)
        T = err.shape[1]
        out = np.full((err.shape[0], targets.shape[0]), np.inf)
        for b, row in enumerate(err):
            n_hit = np.searchsorted(row[::-1], targets, side="right")
            hit = n_hit > 0
            out[b, hit] = fe[b, T - n_hit[hit]]
        return out


def run_campaign(engine: LadderEngine, fids, instances=(1,), runs: int = 1,
                 seed: int = 0,
                 total_gens: Optional[int] = None) -> CampaignResult:
    """A whole BBOB campaign in one ladder program: every (fid, instance,
    run) triple is a member, the instances are stacked, and the fitness
    makes one evaluator call per distinct fid a generation
    (``bbob.StackedFitness``; the eval-fused sample kernel when the menu
    is separable).  ``compiles`` is 1: one (menu, length) program."""
    members = campaign_members(tuple(fids), instances, runs)
    stacked = campaign_instances(members, engine.n, engine.cfg.tdtype,
                                 engine.device)
    runner = engine.campaign_runner(tuple(sorted(set(fids))),
                                    engine.default_gens(total_gens))
    carry, trace = runner(member_keys(seed, len(members), engine.device),
                          stacked)
    return CampaignResult(
        members=members, f_opt=stacked.f_opt.cpu().numpy().astype(np.float64),
        best_f=carry.best_f.cpu().numpy(), best_x=carry.best_x.cpu().numpy(),
        total_fevals=carry.total_fevals.cpu().numpy(),
        trace=host_trace(trace), compiles=engine.compiles())


# ---------------------------------------------------------------------------
# concurrent schedule on the strategies' virtual devices
# ---------------------------------------------------------------------------

def run_concurrent(n: int, n_devices: int, key, fitness_fn: Callable,
                   total_gens: int, lam_start: int = 12,
                   kmax_exp: Optional[int] = None,
                   domain: Tuple[float, float] = (-5.0, 5.0),
                   sigma0_frac: float = 0.25, impl: str = "auto",
                   dtype: str = "float64", drop_prob: float = 0.0,
                   eigen_interval: Optional[int] = None, device=None):
    """All rungs concurrently through K-Distributed's program: one chunk of
    ``total_gens`` generations, nested in eigen blocks when
    ``eigen_interval > 1`` divides ``total_gens``.  ``key`` is an int seed
    or a (2,) key; ``device=None`` runs on the CUDA device and raises
    without one.  Returns ``(kd, carry, trace_dict)``, the trace as numpy,
    as the JAX package's ``run_concurrent`` does."""
    from repro_torch.core.strategies import KDistributed

    kd = KDistributed(n=n, n_devices=n_devices, lam_start=lam_start,
                      lam_slots=lam_start, kmax_exp=kmax_exp, domain=domain,
                      sigma0_frac=sigma0_frac, impl=impl, dtype=dtype,
                      drop_prob=drop_prob, eigen_interval=eigen_interval,
                      device=device)
    key = prng.as_key(key, kd.device)
    carry0 = kd.init_carry(prng.fold_in(key, 0))
    carry, tr = kd.chunk_fn(fitness_fn)(carry0,
                                        prng.split(key, int(total_gens)))
    return kd, carry, {f: v.cpu().numpy() for f, v in zip(tr._fields, tr)}
