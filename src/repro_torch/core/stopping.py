"""CMA-ES stopping criteria (Auger & Hansen 2005; c-cmaes reference defaults).

Port of ``repro/core/stopping.py``, slot-batched: ``check_stop`` takes
states and params whose leaves carry a leading slot axis and returns one
int32 reason mask per slot.  Each criterion sets one bit.
"""
from __future__ import annotations

import torch

TOLFUN = 1
TOLFUNHIST = 2
TOLX = 4
CONDITIONCOV = 8
NOEFFECTAXIS = 16
NOEFFECTCOORD = 32
TOLUPSIGMA = 64
MAXITER = 128

REASON_NAMES = {
    TOLFUN: "TolFun", TOLFUNHIST: "TolFunHist", TOLX: "TolX",
    CONDITIONCOV: "ConditionCov", NOEFFECTAXIS: "NoEffectAxis",
    NOEFFECTCOORD: "NoEffectCoord", TOLUPSIGMA: "TolUpSigma",
    MAXITER: "MaxIter",
}


def reason_to_str(mask: int) -> str:
    names = [name for bit, name in REASON_NAMES.items() if mask & bit]
    return "|".join(names) if names else "none"


def _nan_range(h: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``nanmax − nanmin`` of ``h`` over the entries ``keep`` selects, per
    row: NaN entries are skipped like ``jnp.nanmax`` skips them, and a row
    with nothing left gives NaN, as ``jnp.nanmax`` of an all-NaN row does."""
    keep = keep & ~torch.isnan(h)
    hi = torch.where(keep, h, -torch.inf).amax(-1)
    lo = torch.where(keep, h, torch.inf).amin(-1)
    return torch.where(keep.any(-1), hi - lo, torch.nan)


def check_stop(cfg, params, state, f_sorted: torch.Tensor) -> torch.Tensor:
    """All criteria on post-update slot-stacked states; (S,) int32 masks."""
    n = cfg.n
    hist_len = cfg.hist_len
    S = state.m.shape[0]
    dev = state.m.device
    reason = torch.zeros(S, dtype=torch.int32, device=dev)

    def set_bit(hit, bit):
        return reason | torch.where(hit, bit, 0).to(torch.int32)

    # -- TolFun / TolFunHist over the history window
    idx = torch.arange(hist_len, device=dev)
    window = torch.minimum(params.hist_window,
                           torch.clamp(state.hist_count, max=hist_len))
    newest = torch.remainder(state.hist_count - 1, hist_len)
    age = torch.remainder(newest[:, None] - idx[None, :], hist_len)
    hist_range = _nan_range(state.f_hist, age < window[:, None])
    lam_idx = torch.clamp(params.lam.long() - 1, 0, f_sorted.shape[-1] - 1)
    gen_range = f_sorted.gather(1, lam_idx[:, None])[:, 0] - f_sorted[:, 0]
    enough_hist = state.hist_count >= torch.clamp(params.hist_window,
                                                  max=hist_len)
    reason = set_bit(enough_hist & (torch.maximum(hist_range, gen_range)
                                    < cfg.tolfun), TOLFUN)
    reason = set_bit(enough_hist & (hist_range < cfg.tolfunhist), TOLFUNHIST)

    # -- TolX
    sigma = state.sigma[:, None]
    tolx = (cfg.tolx_factor * params.sigma0)[:, None]
    diagC = torch.diagonal(state.C, dim1=-2, dim2=-1)
    sqrt_diag = torch.sqrt(torch.clamp(diagC, min=0.0))
    tolx_hit = ((sigma * sqrt_diag < tolx).all(-1)
                & (sigma * state.p_c.abs() < tolx).all(-1))
    reason = set_bit(tolx_hit, TOLX)

    # -- ConditionCov
    dmax = state.D.amax(-1)
    dmin = torch.clamp(state.D.amin(-1), min=1e-300)
    reason = set_bit((dmax / dmin) ** 2 > cfg.tol_condition, CONDITIONCOV)

    # -- NoEffectAxis: 0.1σ along principal axis (gen % n) does not move m
    ax = torch.remainder(state.gen.long(), n)
    d_ax = state.D.gather(1, ax[:, None])
    b_ax = state.B.gather(2, ax[:, None, None].expand(S, n, 1))[..., 0]
    axis_step = 0.1 * sigma * d_ax * b_ax
    reason = set_bit((state.m == state.m + axis_step).all(-1), NOEFFECTAXIS)

    # -- NoEffectCoord: 0.2σ√C_ii does not move any single coordinate
    coord_step = 0.2 * sigma * sqrt_diag
    reason = set_bit((state.m == state.m + coord_step).any(-1), NOEFFECTCOORD)

    # -- TolUpSigma
    reason = set_bit(state.sigma / params.sigma0 > cfg.tolupsigma * dmax,
                     TOLUPSIGMA)

    # -- MaxIter
    reason = set_bit(state.gen >= params.max_iter, MAXITER)
    return reason
