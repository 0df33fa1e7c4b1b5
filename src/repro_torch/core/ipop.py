"""Sequential IPOP-CMA-ES (paper Alg. 2) — thin host wrapper over the
ladder engine (port of the ``backend="ladder"`` and ``backend="bucketed"``
parts of ``repro/core/ipop.py``).

``run_ipop`` runs descents of population K·λ_start for K = 2⁰ … 2^kmax in
order, restarting in place after each stop; the trace is moved to the host
once, at the end, and sliced into per-descent ``DescentTrace`` records.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import numpy as np

from repro_torch.core import bucketed as bucketed_mod
from repro_torch.core import ladder as ladder_mod
from repro_torch.kernels import ops


class DescentTrace(NamedTuple):
    k_exp: int                 # descent index i (K = 2^i)
    lam: int
    gens: np.ndarray           # (T,)
    fevals: np.ndarray         # (T,) cumulative evals within the descent
    best_f: np.ndarray         # (T,) best-so-far within the descent
    stop_reason: int


@dataclasses.dataclass
class IPOPResult:
    best_f: float
    best_x: np.ndarray
    total_fevals: int
    descents: List[DescentTrace]
    #: ``backend="bucketed"`` only: the segment driver's log, its segment
    #: records and its schedule pulls (``bucketed.drive_segments``)
    driver: Optional[dict] = None

    def hit_evals(self, targets: np.ndarray, f_opt: float) -> np.ndarray:
        """First cumulative evaluation count at which best-f − f_opt ≤ target
        (+inf where never hit; ERT bookkeeping, paper §4.3.1)."""
        hits = np.full(len(targets), np.inf)
        base = 0
        best = np.inf
        for d in self.descents:
            for fe, bf in zip(d.fevals, d.best_f):
                best = min(best, bf)
                err = best - f_opt
                for i, t in enumerate(targets):
                    if np.isinf(hits[i]) and err <= t:
                        hits[i] = base + fe
            base += int(d.fevals[-1]) if len(d.fevals) else 0
        return hits


def _result_from_ladder(engine: ladder_mod.LadderEngine,
                        carry: ladder_mod.LadderCarry,
                        trace: ladder_mod.LadderTrace,
                        driver: Optional[dict] = None) -> IPOPResult:
    """Slice a sequential-ladder trace (leaves (T, 1)) into DescentTraces."""
    tr = ladder_mod.LadderTrace(*(leaf.cpu().numpy() for leaf in trace))
    ran, k = tr.ran[:, 0], tr.k_idx[:, 0]
    descents: List[DescentTrace] = []
    for k_exp in range(engine.kmax_exp + 1):
        idx = np.nonzero(ran & (k == k_exp))[0]
        if idx.size == 0:
            continue
        descents.append(DescentTrace(
            k_exp=k_exp, lam=(2 ** k_exp) * engine.lam_start,
            gens=np.asarray(tr.gen[idx, 0], np.int64),
            fevals=np.asarray(tr.fevals[idx, 0], np.int64),
            best_f=np.asarray(tr.best_f[idx, 0], np.float64),
            stop_reason=int(tr.stop_reason[idx[-1], 0])))
    return IPOPResult(best_f=float(carry.best_f),
                      best_x=carry.best_x.cpu().numpy(),
                      total_fevals=int(carry.total_fevals),
                      descents=descents, driver=driver)


def run_ipop(fitness_fn: Callable, n: int, key, lam_start: int = 12,
             kmax_exp: int = 8, max_evals: int = 200_000, domain=(-5.0, 5.0),
             sigma0_frac: float = 0.25, chunk: int = 32, impl: str = "auto",
             dtype: str = "float64", total_gens: int | None = None,
             backend: str = "ladder", *, device=None) -> IPOPResult:
    """Paper Alg. 2 with multiplicative factor 2 and K_max = 2^kmax_exp.

    The parameters the two packages share keep the JAX package's order.
    ``backend="ladder"`` runs the whole ladder at λ_max padding;
    ``backend="bucketed"`` drives it through the rung-bucketed segments
    (``core/bucketed.py``: work proportional to the live rung, sized by
    the driver, so ``total_gens`` does not apply).  ``impl`` picks the
    sampling tier on both (``kernels/ops.py``) and is validated first, for
    every backend.  ``chunk`` only sizes the host loop of
    ``backend="hostloop"``.  ``key`` is an int seed or a (2,) key tensor
    (``core/prng.py``).  ``device=None`` runs on the CUDA device and raises
    without one.  The JAX package's other backends (``hostloop``, ``mesh``,
    ``service``) raise ``NotImplementedError`` naming their ROADMAP.md
    queue A item."""
    ops.validate_impl(impl)
    if backend == "bucketed":
        if total_gens is not None:
            raise ValueError("total_gens only applies to backend='ladder'; "
                             "the segment driver sizes its own segments")
        engine_b = bucketed_mod.BucketedLadderEngine(
            n=n, lam_start=lam_start, kmax_exp=kmax_exp, max_evals=max_evals,
            domain=domain, sigma0_frac=sigma0_frac, impl=impl, dtype=dtype,
            device=device)
        carry, trace, log = bucketed_mod.run_bucketed_single(
            engine_b, key, fitness_fn)
        return _result_from_ladder(engine_b.full, carry, trace, log)
    if backend == "hostloop":
        raise NotImplementedError(
            "backend='hostloop' is not ported; 'ladder' and 'bucketed' are "
            "(ROADMAP.md, queue A item 7)")
    if backend in ("mesh", "service"):
        raise NotImplementedError(
            f"backend={backend!r} is not ported; 'ladder' and 'bucketed' "
            "are (ROADMAP.md, queue A items 9-11)")
    if backend != "ladder":
        raise ValueError(f"unknown backend {backend!r}")
    engine = ladder_mod.LadderEngine(
        n=n, lam_start=lam_start, kmax_exp=kmax_exp, schedule="sequential",
        max_evals=max_evals, domain=domain, sigma0_frac=sigma0_frac,
        impl=impl, dtype=dtype, device=device)
    carry, trace = engine.run(key, fitness_fn, total_gens)
    return _result_from_ladder(engine, carry, trace)
