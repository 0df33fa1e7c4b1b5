"""The IPOP restart ladder on the device (paper Alg. 2) — port of the
single-problem part of ``repro/core/ladder.py``.

All rungs K = 2⁰..2^kmax share one λ_max-padded ``CMAConfig`` and a stacked
``CMAParams``; descent slots live in one slot-stacked ``CMAState`` and
advance together, one generation per ``slots_gen_step``.  When a slot's
stop check fires it restarts in place from a fresh key with the doubled-λ
parameters gathered from the stack.  Stop, restart and budget gates are
``torch.where`` on per-slot masks: the port's code reads no tensor back to
the host inside the generation loop.  (``torch.linalg.eigh`` checks its
solver status on the host on a CUDA device, once per eigen block.)  The
per-generation trace is stacked once, at the end of ``run_scan``.

Schedules: ``sequential`` (one slot walks the ladder) and ``concurrent``
(kmax+1 slots, one per rung).  ``impl`` picks the sampling tier
(``kernels/ops.py``): the row-keyed draw handed to the sample kernel
(``"auto"``) or the counter stream drawn inside it (``"kernel_rng"``).
``slots_gen_step(bucket_cap=k)`` is the step of the rung-bucketed programs
(``core/bucketed.py``).  ``run_concurrent`` runs all rungs on the
K-Distributed strategy instead (``core/strategies.py``).  Not ported yet
(ROADMAP.md): the flat eigen schedule, campaigns over many problems, the
``eager`` tiers on the ladder.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import cmaes, prng
from repro_torch.core.device import resolve_device
from repro_torch.core.params import (CMAConfig, default_max_iter,
                                     ladder_params, select_params)
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
        return fused_generation(cfg, params_k, states, Z, fitness_fn, eigen)
    args = (states.m, states.sigma, states.B, states.D, kgs, cfg.lam_max)
    sep = getattr(fitness_fn, "sep", None)
    if sep is not None:
        Y, F = ops.gen_sample_rng_eval(*args, sep)
        return _generation_from_sample(cfg, params_k, states, Y, None, F,
                                       eigen)
    Y, X = ops.gen_sample_rng(*args)
    return _generation_from_sample(cfg, params_k, states, Y, X,
                                   _evaluate(fitness_fn, X), eigen)


def _evaluate(fitness_fn: Callable, X: torch.Tensor) -> torch.Tensor:
    S, lam, n = X.shape
    return fitness_fn(X.reshape(S * lam, n)).reshape(S, lam)


def fused_generation(cfg: CMAConfig, params_k, states: cmaes.CMAState,
                     Z: torch.Tensor, fitness_fn: Callable,
                     eigen: str) -> cmaes.CMAState:
    """One generation over all slots from a given draw Z (S, λ_max, n): the
    sample kernel (eval-fused when ``fitness_fn`` carries separable
    coefficients), then ``_generation_from_sample``."""
    sep = getattr(fitness_fn, "sep", None)
    if sep is not None:
        Y, F = ops.gen_sample_eval(states.m, states.sigma, states.B, states.D,
                                   Z, sep)
        return _generation_from_sample(cfg, params_k, states, Y, None, F,
                                       eigen)
    Y, X = ops.gen_sample(states.m, states.sigma, states.B, states.D, Z)
    return _generation_from_sample(cfg, params_k, states, Y, X,
                                   _evaluate(fitness_fn, X), eigen)


def _generation_from_sample(cfg: CMAConfig, params_k,
                            states: cmaes.CMAState, Y: torch.Tensor,
                            X: Optional[torch.Tensor], F: torch.Tensor,
                            eigen: str) -> cmaes.CMAState:
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
        cmaes.gen_coef(params_k, states))
    new = cmaes._finish_update(cfg, params_k, states, f_sorted, x_best,
                               n_evals, C_new, ps_new, pc_new, y_w, eigen)
    return cmaes.tree_select(states.stop, states, new)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class LadderCarry(NamedTuple):
    states: cmaes.CMAState      # (S, ...) stacked descent slots
    k_idx: torch.Tensor         # (S,) int32 rung index, λ = 2ᵏ·λ_start
    incarnation: torch.Tensor   # (S,) int32 restarts of this slot so far
    active: torch.Tensor        # (S,) bool, False once a slot retired
    total_fevals: torch.Tensor  # () int64 across all slots and restarts
    best_f: torch.Tensor        # () global best
    best_x: torch.Tensor        # (n,)


class LadderTrace(NamedTuple):
    """Per-generation record; leaves (S,) per generation unless noted."""
    ran: torch.Tensor           # bool, slot executed this generation
    k_idx: torch.Tensor         # int32 rung during this generation
    gen: torch.Tensor           # int32 within-descent generation (1-based)
    fevals: torch.Tensor        # within-descent cumulative evaluations
    best_f: torch.Tensor        # within-descent best so far
    stop_reason: torch.Tensor   # int32 bitmask
    stopped: torch.Tensor       # bool, stop fired; slot restarted or retired
    total_fevals: torch.Tensor  # () cumulative across the whole ladder
    global_best: torch.Tensor   # () best across slots and restarts


def slots_gen_step(cfg: CMAConfig, sparams, carry: LadderCarry,
                   base_key: torch.Tensor, fitness_fn: Callable, *,
                   max_evals: int, kmax_exp: int,
                   schedule: str = "sequential",
                   domain: Tuple[float, float] = (-5.0, 5.0),
                   impl: str = "auto", eigen: str = "lazy",
                   bucket_cap: Optional[int] = None
                   ) -> Tuple[LadderCarry, LadderTrace]:
    """One generation over all slots: the budget gate, the fused update,
    the global best, and the in-place doubled-λ restart or retirement.

    ``eigen`` is ``"lazy"`` (per-descent cadence), or ``"defer"`` /
    ``"always"`` as ``scan_eigen_blocks`` passes them.  ``bucket_cap`` is
    the highest rung the executing program holds (``cfg``/``sparams`` are
    then a bucket's, ``core/bucketed.py``): a slot on a higher rung is
    parked (``ran`` False, state frozen) until the driver moves it to a
    wider bucket.  ``None`` means the program spans the whole ladder."""
    S = carry.k_idx.shape[0]
    dev = carry.k_idx.device
    slot_ids = torch.arange(S, dtype=torch.int64, device=dev)

    gather_idx = (carry.k_idx if bucket_cap is None
                  else torch.clamp(carry.k_idx, max=bucket_cap))
    params_k = select_params(sparams, gather_idx.long())
    lam_k = params_k.lam.to(carry.total_fevals.dtype)

    # budget gate: a slot only starts a generation it can fully pay for;
    # concurrent slots are gated on the cumulative reservation before them
    runnable = carry.active
    if bucket_cap is not None:
        runnable = runnable & (carry.k_idx <= bucket_cap)
    reserve = torch.cumsum(torch.where(runnable, lam_k, 0), 0)
    ran = runnable & (carry.total_fevals + reserve <= max_evals)

    kds = slot_key(base_key, slot_ids, carry.incarnation)
    kgs = gen_key(kds, carry.states.gen)
    upd = _slots_fused_update(cfg, params_k, carry.states, kgs, fitness_fn,
                              eigen, impl)
    new_states = cmaes.tree_select(ran, upd, carry.states)

    total_fevals = carry.total_fevals + torch.where(ran, lam_k, 0).sum()

    cand = torch.where(ran, new_states.best_f, torch.inf)
    i_star = torch.argmin(cand).reshape(1)
    c_star = cand.index_select(0, i_star)[0]
    better = c_star < carry.best_f
    best_f = torch.where(better, c_star, carry.best_f)
    best_x = torch.where(better, new_states.best_x.index_select(0, i_star)[0],
                         carry.best_x)

    stopped = ran & new_states.stop
    trace = LadderTrace(
        ran=ran, k_idx=carry.k_idx, gen=new_states.gen,
        fevals=new_states.fevals, best_f=new_states.best_f,
        stop_reason=new_states.stop_reason, stopped=stopped,
        total_fevals=total_fevals, global_best=best_f)

    # -- in-place restart: doubled-λ params gathered from the stack
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

    fresh = fresh_state(cfg, slot_key(base_key, slot_ids, inc_new), domain)
    fresh = fresh._replace(restarts=inc_new)
    states_out = cmaes.tree_select(restart, fresh, new_states)

    return LadderCarry(
        states=states_out, k_idx=k_new, incarnation=inc_new,
        active=active_new, total_fevals=total_fevals,
        best_f=best_f, best_x=best_x), trace


def stack_traces(traces):
    """Per-generation NamedTuple traces stacked along a leading time axis."""
    return type(traces[0])(*(torch.stack(leaves) for leaves in zip(*traces)))


def scan(step_fn: Callable, carry, xs: torch.Tensor):
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
    eigen_interval: Optional[int] = None  # None: c-cmaes default (CMAConfig)
    eigen_schedule: str = "nested"
    device: Optional[str] = None        # None: CUDA, raising without it

    def __post_init__(self):
        if self.schedule not in ("sequential", "concurrent"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if ops.validate_impl(self.impl) not in ops.KERNEL_TIERS:
            raise NotImplementedError(
                f"impl={self.impl!r} on the ladder is not ported; the ladder "
                f"takes {ops.KERNEL_TIERS} (ROADMAP.md, queue A item 7)")
        if self.eigen_schedule != "nested":
            raise NotImplementedError(
                f"eigen_schedule={self.eigen_schedule!r} is not ported; only "
                "'nested' (ROADMAP.md, queue A item 7)")
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
        S, dev = self.n_slots, self.device
        slot_ids = torch.arange(S, dtype=torch.int64, device=dev)
        if self.schedule == "concurrent":
            k0 = slot_ids.to(torch.int32)        # slot i starts on rung i
        else:
            k0 = torch.zeros((S,), dtype=torch.int32, device=dev)
        inc0 = torch.zeros((S,), dtype=torch.int32, device=dev)
        states = fresh_state(self.cfg, slot_key(base_key, slot_ids, inc0),
                             self.domain)
        return LadderCarry(
            states=states, k_idx=k0, incarnation=inc0,
            active=torch.ones((S,), dtype=torch.bool, device=dev),
            total_fevals=torch.zeros((), dtype=torch.int64, device=dev),
            best_f=torch.tensor(torch.inf, dtype=self.cfg.tdtype, device=dev),
            best_x=torch.zeros((self.n,), dtype=self.cfg.tdtype, device=dev))

    def gen_step(self, carry: LadderCarry, base_key: torch.Tensor,
                 fitness_fn: Callable, eigen: str = "lazy"
                 ) -> Tuple[LadderCarry, LadderTrace]:
        """One generation.  On the card a ``fitness_fn`` with separable
        coefficients must come from ``ops.slot_fitness`` (``run_scan`` lays
        them out once per run)."""
        return slots_gen_step(
            self.cfg, self.sparams, carry, base_key, fitness_fn,
            max_evals=self.max_evals, kmax_exp=self.kmax_exp,
            schedule=self.schedule, domain=self.domain, impl=self.impl,
            eigen=eigen)

    def run_scan(self, base_key: torch.Tensor, fitness_fn: Callable,
                 total_gens: int) -> Tuple[LadderCarry, LadderTrace]:
        """The whole ladder; its length is ``total_gens`` rounded up to a
        whole number of eigen blocks."""
        interval = int(self.cfg.eigen_interval)
        n_blocks = -(-int(total_gens) // interval)
        fitness_fn = ops.slot_fitness(fitness_fn, self.n_slots,
                                      self.cfg.tdtype)
        return scan_eigen_blocks(
            lambda c, eigen: self.gen_step(c, base_key, fitness_fn, eigen),
            self.init_carry(base_key), interval, n_blocks)

    def run(self, key, fitness_fn: Callable,
            total_gens: Optional[int] = None
            ) -> Tuple[LadderCarry, LadderTrace]:
        """Single-problem run; ``key`` is an int seed or a (2,) key."""
        return self.run_scan(self.base_key(key), fitness_fn,
                             self.default_gens(total_gens))


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
