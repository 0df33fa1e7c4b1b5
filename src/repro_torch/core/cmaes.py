"""Core CMA-ES in torch, slot-batched — the subset of ``repro/core/cmaes.py``
that the IPOP ladder runs.

Every state, parameter and population tensor carries a leading slot axis S
(the JAX package vmaps per-slot functions over it; here it is written out).
Nothing in this module reads a tensor back to the host.

Port convention for the eigendecomposition: ``eigen_decompose`` makes the
largest-magnitude entry of every eigenvector positive (ties go to the first
such entry), so B does not depend on LAPACK's or cuSOLVER's sign choice and
trajectories agree across devices wherever the eigenvalues are distinct.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import prng, stopping
from repro_torch.core.params import CMAConfig, CMAParams


class CMAState(NamedTuple):
    m: torch.Tensor             # (S, n) distribution mean
    sigma: torch.Tensor         # (S,) step size
    C: torch.Tensor             # (S, n, n) covariance
    B: torch.Tensor             # (S, n, n) eigenvectors of C (refreshed per block)
    D: torch.Tensor             # (S, n) sqrt of eigenvalues of C
    p_sigma: torch.Tensor       # (S, n) evolution path of sigma
    p_c: torch.Tensor           # (S, n) evolution path of C
    gen: torch.Tensor           # (S,) int32 generation counter
    last_eigen_gen: torch.Tensor  # (S,) int32
    best_f: torch.Tensor        # (S,) best fitness of this descent
    best_x: torch.Tensor        # (S, n)
    fevals: torch.Tensor        # (S,) int32
    f_hist: torch.Tensor        # (S, hist_len) per-generation best f ring
    hist_count: torch.Tensor    # (S,) int32
    stop: torch.Tensor          # (S,) bool
    stop_reason: torch.Tensor   # (S,) int32 bitmask (core/stopping.py)
    restarts: torch.Tensor      # (S,) int32


def init_state(cfg: CMAConfig, x0: torch.Tensor) -> CMAState:
    """Fresh states for the slots of ``x0`` (S, n), with σ = ``cfg.sigma0``."""
    S, n = x0.shape
    dt, dev = cfg.tdtype, x0.device
    eye = torch.eye(n, dtype=dt, device=dev).expand(S, n, n)

    def i32(v):
        return torch.full((S,), v, dtype=torch.int32, device=dev)

    return CMAState(
        m=x0.to(dt), sigma=torch.full((S,), cfg.sigma0, dtype=dt, device=dev),
        C=eye.clone(), B=eye.clone(),
        D=torch.ones((S, n), dtype=dt, device=dev),
        p_sigma=torch.zeros((S, n), dtype=dt, device=dev),
        p_c=torch.zeros((S, n), dtype=dt, device=dev),
        gen=i32(0), last_eigen_gen=i32(0),
        best_f=torch.full((S,), torch.inf, dtype=dt, device=dev),
        best_x=x0.to(dt).clone(), fevals=i32(0),
        f_hist=torch.full((S, cfg.hist_len), torch.inf, dtype=dt, device=dev),
        hist_count=i32(0),
        stop=torch.zeros((S,), dtype=torch.bool, device=dev),
        stop_reason=i32(0), restarts=i32(0))


def sample_z(keys: torch.Tensor, lam_slots: int, n: int,
             dtype=torch.float64) -> torch.Tensor:
    """Row-keyed N(0, I) draw (S, λ, n): row i of slot s is
    ``normal(fold_in(keys[s], i), (n,))``, as ``repro``'s ``sample_z`` with
    ``row_keys=True`` — independent of how many rows are drawn."""
    rows = torch.arange(lam_slots, dtype=torch.int64, device=keys.device)
    row_keys = prng.fold_in(keys[:, None, :], rows[None, :])
    return prng.normal(row_keys, (n,), dtype)


def rank_weights(fitness: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Per-point weights by fitness rank (S, λ); non-finite points get 0.
    Stable sort with NaN last, as ``jnp.argsort``."""
    order = torch.argsort(fitness, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    w = weights.gather(-1, torch.clamp(ranks, max=weights.shape[-1] - 1))
    return torch.where(torch.isfinite(fitness), w, 0.0)


def population_stats(fitness: torch.Tensor, x: torch.Tensor,
                     params: CMAParams, lam_max: int):
    """``(w, f_sorted, x_best, n_evals)``: rank weights, the λ_max-padded
    ascending fitness, each slot's best point and its count of finite
    evaluations."""
    S, lam = fitness.shape
    w = rank_weights(fitness, params.weights)
    f_sorted = torch.sort(fitness, dim=-1, stable=True).values
    if lam >= lam_max:
        f_sorted = f_sorted[:, :lam_max]
    else:
        f_sorted = torch.cat([f_sorted, torch.full(
            (S, lam_max - lam), torch.inf, dtype=fitness.dtype,
            device=fitness.device)], dim=1)
    idx = torch.argmin(fitness, dim=-1)
    x_best = x.gather(1, idx[:, None, None].expand(S, 1, x.shape[-1]))[:, 0]
    n_evals = torch.isfinite(fitness).sum(-1).to(torch.int32)
    return w, f_sorted, x_best, n_evals


def population_stats_from_y(fitness, y, m, sigma, params: CMAParams,
                            lam_max: int):
    """``population_stats`` for the eval-fused path: the best point is
    rebuilt from its Y row as m + σ·y."""
    S, lam, n = y.shape
    w, f_sorted, _, n_evals = population_stats(
        fitness, torch.zeros((S, lam, 1), dtype=y.dtype, device=y.device),
        params, lam_max)
    idx = torch.argmin(fitness, dim=-1)
    y_best = y.gather(1, idx[:, None, None].expand(S, 1, n))[:, 0]
    x_best = m + sigma[:, None] * y_best
    return w, f_sorted, x_best, n_evals


def eigen_decompose(C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, D) with C = B·diag(D²)·Bᵀ, column signs normalised (module
    docstring)."""
    evals, evecs = torch.linalg.eigh(C)
    pivot = evecs.abs().argmax(dim=-2, keepdim=True)
    sign = torch.where(evecs.gather(-2, pivot) < 0, -1.0, 1.0).to(C.dtype)
    B = (evecs * sign).contiguous()
    return B, torch.sqrt(torch.clamp(evals, min=1e-300))


def gen_coef(params: CMAParams, state: CMAState) -> dict:
    """Per-slot coefficients of the fused update (``ops.gen_update``)."""
    return {"c_sigma": params.c_sigma, "mu_eff": params.mu_eff,
            "c_c": params.c_c, "c_1": params.c_1, "c_mu": params.c_mu,
            "chi_n": params.chi_n, "gen1": (state.gen + 1).to(state.m.dtype)}


def _finish_update(cfg: CMAConfig, params: CMAParams, state: CMAState,
                   f_sorted, x_best, n_evals, C_new, p_sigma_new, p_c_new,
                   y_w, eigen: str) -> CMAState:
    """The O(n) generation epilogue (``repro``'s ``cmaes._finish_update``):
    mean and step size, the flat-fitness σ bump, the eigen refresh, the
    f_hist ring and the stop check.  ``eigen``: ``"always"`` refreshes B/D,
    ``"defer"`` keeps them, ``"lazy"`` refreshes the slots whose cadence is
    due (``gen + 1 − last_eigen_gen ≥ eigen_interval``).  As JAX's vmapped
    ``lax.cond`` does, ``"lazy"`` decomposes every slot and selects per
    slot; nothing is read back to the host."""
    f_best_gen = f_sorted[:, 0]
    c_sig, d_sig = params.c_sigma, params.d_sigma

    m_new = state.m + state.sigma[:, None] * y_w
    ps_norm = torch.sqrt(torch.sum(p_sigma_new * p_sigma_new, -1))
    sigma_new = state.sigma * torch.exp((c_sig / d_sig)
                                        * (ps_norm / params.chi_n - 1.0))
    kth = torch.clamp(params.lam.long() // 4 + 1, 0, f_sorted.shape[-1] - 1)
    flat = f_sorted[:, 0] == f_sorted.gather(1, kth[:, None])[:, 0]
    sigma_new = torch.where(flat, sigma_new * torch.exp(0.2 + c_sig / d_sig),
                            sigma_new)

    if eigen == "always":
        B_new, D_new = eigen_decompose(C_new)
        last_eigen = state.gen + 1
    elif eigen == "defer":
        B_new, D_new = state.B, state.D
        last_eigen = state.last_eigen_gen
    elif eigen == "lazy":
        due = (state.gen + 1 - state.last_eigen_gen) >= cfg.eigen_interval
        B_e, D_e = eigen_decompose(C_new)
        B_new = torch.where(due[:, None, None], B_e, state.B)
        D_new = torch.where(due[:, None], D_e, state.D)
        last_eigen = torch.where(due, state.gen + 1, state.last_eigen_gen)
    else:
        raise ValueError(f"unknown eigen mode {eigen!r}")

    better = f_best_gen < state.best_f
    best_f = torch.where(better, f_best_gen, state.best_f)
    best_x = torch.where(better[:, None], x_best, state.best_x)
    hist_idx = torch.remainder(state.hist_count.long(), cfg.hist_len)
    f_hist = state.f_hist.scatter(1, hist_idx[:, None], f_best_gen[:, None])

    new = CMAState(
        m=m_new, sigma=sigma_new, C=C_new, B=B_new, D=D_new,
        p_sigma=p_sigma_new, p_c=p_c_new, gen=state.gen + 1,
        last_eigen_gen=last_eigen, best_f=best_f, best_x=best_x,
        fevals=state.fevals + n_evals, f_hist=f_hist,
        hist_count=state.hist_count + 1, stop=state.stop,
        stop_reason=state.stop_reason, restarts=state.restarts)
    reason = stopping.check_stop(cfg, params, new, f_sorted)
    return new._replace(stop=reason > 0, stop_reason=reason)
