"""Sequential IPOP-CMA-ES (paper Alg. 2) — thin host wrappers over the
ladder engine (port of ``repro/core/ipop.py``).

``run_ipop`` runs descents of population K·λ_start for K = 2⁰ … 2^kmax in
order, restarting in place after each stop; the trace is moved to the host
once, at the end, and sliced into per-descent ``DescentTrace`` records.
``run_ipop_hostloop`` keeps the original control flow on the same key
schedule and the same λ_max-padded step (``ladder.padded_gen_step``): one
descent at a time in chunks of generations, with one host read of the
chunk's stop flags and records, and a Python restart between rungs.
``result_to_tree`` / ``result_template`` / ``result_from_tree`` split a
result into arrays and JSON metadata for a checkpoint store and back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bucketed as bucketed_mod
from repro_torch.core import ladder as ladder_mod
from repro_torch.core.params import select_params
from repro_torch.distributed import mesh_engine
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


def _fleet_supervisor(fleet):
    """A fresh engine-level supervisor from a FleetConfig (None passes
    through — the zero-overhead default)."""
    if fleet is None:
        return None
    from repro_torch.fleet.controller import IslandSupervisor
    return IslandSupervisor(fleet)


class ShapeDtype(NamedTuple):
    """The (shape, dtype) record of one array of ``result_template``."""
    shape: tuple
    dtype: np.dtype


def result_to_tree(res: IPOPResult):
    """``(array_tree, json_meta)`` for a checkpoint store: the arrays (the
    best value too, which may be infinite and so stays out of JSON) as
    leaves, the static scalars in the metadata."""
    tree = {"best_x": np.asarray(res.best_x),
            "best_f": np.asarray(res.best_f, np.float64),
            "total_fevals": np.asarray(res.total_fevals, np.int64),
            "descents": {}}
    meta = {"x_shape": [int(s) for s in np.shape(res.best_x)],
            "x_dtype": str(np.asarray(res.best_x).dtype), "descents": []}
    for di, d in enumerate(res.descents):
        tree["descents"][str(di)] = {
            "gens": np.asarray(d.gens, np.int64),
            "fevals": np.asarray(d.fevals, np.int64),
            "best_f": np.asarray(d.best_f, np.float64)}
        meta["descents"].append({"k_exp": int(d.k_exp), "lam": int(d.lam),
                                 "stop_reason": int(d.stop_reason),
                                 "T": int(len(d.gens))})
    return tree, meta


def result_template(meta: dict) -> dict:
    """The (shape, dtype) of every array of ``result_to_tree``'s tree."""
    tree = {"best_x": ShapeDtype(tuple(meta["x_shape"]),
                                 np.dtype(meta["x_dtype"])),
            "best_f": ShapeDtype((), np.dtype(np.float64)),
            "total_fevals": ShapeDtype((), np.dtype(np.int64)),
            "descents": {}}
    for di, dm in enumerate(meta["descents"]):
        T = int(dm["T"])
        tree["descents"][str(di)] = {
            "gens": ShapeDtype((T,), np.dtype(np.int64)),
            "fevals": ShapeDtype((T,), np.dtype(np.int64)),
            "best_f": ShapeDtype((T,), np.dtype(np.float64))}
    return tree


def result_from_tree(tree: dict, meta: dict) -> IPOPResult:
    descents = []
    for di, dm in enumerate(meta["descents"]):
        dt = tree["descents"][str(di)]
        descents.append(DescentTrace(
            k_exp=int(dm["k_exp"]), lam=int(dm["lam"]),
            gens=np.asarray(dt["gens"], np.int64),
            fevals=np.asarray(dt["fevals"], np.int64),
            best_f=np.asarray(dt["best_f"], np.float64),
            stop_reason=int(dm["stop_reason"])))
    return IPOPResult(best_f=float(tree["best_f"]),
                      best_x=np.asarray(tree["best_x"]),
                      total_fevals=int(tree["total_fevals"]),
                      descents=descents)


def run_ipop(fitness_fn: Callable, n: int, key, lam_start: int = 12,
             kmax_exp: int = 8, max_evals: int = 200_000, domain=(-5.0, 5.0),
             sigma0_frac: float = 0.25, chunk: int = 32, impl: str = "auto",
             dtype: str = "float64", total_gens: int | None = None,
             backend: str = "ladder", mesh_strategy: str = "ordered",
             fleet=None, *, device=None) -> IPOPResult:
    """Paper Alg. 2 with multiplicative factor 2 and K_max = 2^kmax_exp.

    The parameters the two packages share keep the JAX package's order.
    ``backend="ladder"`` runs the whole ladder at λ_max padding;
    ``backend="bucketed"`` drives it through the rung-bucketed segments
    (``core/bucketed.py``: work proportional to the live rung, sized by
    the driver, so ``total_gens`` does not apply); ``backend="hostloop"``
    runs ``run_ipop_hostloop`` in chunks of ``chunk`` generations (bounded
    by the budget and the stops, so ``total_gens`` does not apply either);
    ``backend="mesh"`` runs the bucketed segments through the mesh
    campaign engine (``distributed/mesh_engine.py``; one island per CUDA
    device, or one on ``device``) under the paper's S1
    (``mesh_strategy="ordered"``) or S2 (``"concurrent"``), which applies
    to that backend only.  ``backend="service"`` submits the problem as
    one job to a one-row campaign service (``service/server.py``) and
    drains it; the service takes ``fitness_fn`` as a callable branch, so a
    ``FusableEval`` loses its eval fusion there (the sample kernel without
    the fitness epilogue, then the callable), where ``backend="bucketed"``
    samples through the eval-fused kernel.  ``impl`` picks the tier on every backend
    (``kernels/ops.py``) and is validated first.  ``key`` is an int seed
    or a (2,) key tensor (``core/prng.py``).  ``device=None`` runs on the
    CUDA device and raises without one.  ``fleet`` (a
    ``repro_torch.fleet.FleetConfig``) adds fleet supervision — periodic
    island snapshots, health monitoring, optional injected faults,
    snapshot-replay recovery — to the segment-driven backends
    (``bucketed``, ``mesh``, ``service``); the recovered result is the
    unsupervised run's."""
    ops.validate_impl(impl)
    if fleet is not None and backend not in ("bucketed", "mesh", "service"):
        raise ValueError("fleet supervision applies to backend='bucketed', "
                         f"'mesh' or 'service', not {backend!r}")
    if backend in ("bucketed", "hostloop", "mesh", "service") and \
            total_gens is not None:
        raise ValueError(f"total_gens only applies to backend='ladder', not "
                         f"{backend!r}")
    if backend == "bucketed":
        engine_b = bucketed_mod.BucketedLadderEngine(
            n=n, lam_start=lam_start, kmax_exp=kmax_exp, max_evals=max_evals,
            domain=domain, sigma0_frac=sigma0_frac, impl=impl, dtype=dtype,
            device=device)
        log: dict = {}
        carry, trace = bucketed_mod.run_bucketed_single(
            engine_b, key, fitness_fn, supervisor=_fleet_supervisor(fleet),
            log=log)
        return _result_from_ladder(engine_b.full, carry, trace, log)
    if backend == "hostloop":
        return run_ipop_hostloop(
            fitness_fn, n, key, lam_start=lam_start, kmax_exp=kmax_exp,
            max_evals=max_evals, domain=domain, sigma0_frac=sigma0_frac,
            chunk=chunk, impl=impl, dtype=dtype, device=device)
    if backend == "mesh":
        engine_m = mesh_engine.MeshCampaignEngine(
            n=n, lam_start=lam_start, kmax_exp=kmax_exp, max_evals=max_evals,
            domain=domain, sigma0_frac=sigma0_frac, impl=impl, dtype=dtype,
            strategy=mesh_strategy, device=device)
        carry, trace = mesh_engine.run_mesh_single(
            engine_m, key, fitness_fn, supervisor=_fleet_supervisor(fleet))
        return _result_from_ladder(engine_m.bucketed.full, carry, trace)
    if backend == "service":
        from repro_torch.service.server import run_service_single
        return run_service_single(
            fitness_fn, n, key, lam_start=lam_start, kmax_exp=kmax_exp,
            max_evals=max_evals, domain=domain, sigma0_frac=sigma0_frac,
            impl=impl, dtype=dtype, fleet=fleet, device=device)
    if backend != "ladder":
        raise ValueError(f"unknown backend {backend!r}")
    engine = ladder_mod.LadderEngine(
        n=n, lam_start=lam_start, kmax_exp=kmax_exp, schedule="sequential",
        max_evals=max_evals, domain=domain, sigma0_frac=sigma0_frac,
        impl=impl, dtype=dtype, device=device)
    carry, trace = engine.run(key, fitness_fn, total_gens)
    return _result_from_ladder(engine, carry, trace)


def _read_chunk(best_f, fevals, reasons):
    """The per-generation records of a chunk ((m,) tensors each) in one
    device→host transfer: best values, evaluations, stop reasons."""
    m = best_f.shape[0]
    packed = torch.cat([best_f.to(torch.float64).view(torch.int64),
                        fevals.long(), reasons.long()]).cpu().numpy()
    return (packed[:m].view(np.float64), packed[m:2 * m],
            packed[2 * m:].astype(np.int32))


def run_ipop_hostloop(fitness_fn: Callable, n: int, key,
                      lam_start: int = 12, kmax_exp: int = 8,
                      max_evals: int = 200_000, domain=(-5.0, 5.0),
                      sigma0_frac: float = 0.25, chunk: int = 32,
                      impl: str = "auto", dtype: str = "float64", *,
                      device=None) -> IPOPResult:
    """The host-driven baseline: one descent at a time, ``chunk``
    generations of ``ladder.padded_gen_step`` between host reads, the
    descent cut at its first stop, and a Python restart on the next rung.
    The keys are the ladder's (slot 0, incarnation k), so the trajectory is
    the ladder's."""
    engine = ladder_mod.LadderEngine(
        n=n, lam_start=lam_start, kmax_exp=kmax_exp, schedule="sequential",
        max_evals=max_evals, domain=domain, sigma0_frac=sigma0_frac,
        impl=impl, dtype=dtype, device=device)
    cfg, dev = engine.cfg, engine.device
    key = engine.base_key(key)
    fit = ops.slot_fitness(fitness_fn, 1, cfg.tdtype)

    total_evals = 0
    best_f, best_x = np.inf, np.zeros(n)
    descents: List[DescentTrace] = []
    for k_exp in range(kmax_exp + 1):
        lam = (2 ** k_exp) * lam_start
        if total_evals + lam > max_evals:
            break
        params = select_params(engine.sparams, torch.tensor([k_exp],
                                                            device=dev))
        kd = ladder_mod.slot_key(key, 0, k_exp)
        state = ladder_mod.fresh_state(cfg, kd[None], domain)
        budget_gens = (max_evals - total_evals) // lam
        gens_l, fe_l, bf_l = [], [], []
        gen, reason = 0, 0
        while gen < budget_gens:
            m = min(chunk, budget_gens - gen)
            rec = []
            for g in range(gen, gen + m):
                state = ladder_mod.padded_gen_step(
                    cfg, params, state, ladder_mod.gen_key(kd, g)[None], fit,
                    impl)
                rec.append((state.best_f, state.fevals, state.stop_reason))
            bfs, fes, reasons = _read_chunk(*(torch.cat(r) for r in
                                              zip(*rec)))
            stops = reasons > 0
            n_valid = int(np.argmax(stops)) + 1 if stops.any() else m
            gens_l.extend(range(gen + 1, gen + n_valid + 1))
            fe_l.extend(fes[:n_valid])
            bf_l.extend(bfs[:n_valid])
            gen += n_valid
            reason = int(reasons[-1])
            if stops.any():
                break

        total_evals += int(fe_l[-1]) if fe_l else 0
        if bf_l and bf_l[-1] < best_f:
            best_f = float(bf_l[-1])
            best_x = state.best_x[0].cpu().numpy()
        descents.append(DescentTrace(
            k_exp=k_exp, lam=lam, gens=np.asarray(gens_l, np.int64),
            fevals=np.asarray(fe_l, dtype=np.int64),
            best_f=np.asarray(bf_l, dtype=np.float64), stop_reason=reason))

    return IPOPResult(best_f=best_f, best_x=best_x,
                      total_fevals=total_evals, descents=descents)
