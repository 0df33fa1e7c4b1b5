"""CMA-ES strategy parameters (Hansen's defaults, as in the c-cmaes reference code).

Port of ``repro/core/params.py``: the arithmetic is the same numpy code, so
every leaf equals the JAX package's bit for bit; only the final containers
are torch tensors.  A descent of population ``lam`` inside a buffer of width
``lam_max`` carries zero weights for the padding rows.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


def _raw_weights(lam: int) -> np.ndarray:
    """Positive recombination weights w_i ∝ ln((λ+1)/2) − ln(i), i = 1..μ, Σw = 1."""
    mu = lam // 2
    w = np.log((lam + 1.0) / 2.0) - np.log(np.arange(1, mu + 1))
    return w / np.sum(w)


def default_max_iter(n: int, lam: int) -> int:
    """Default per-descent generation allowance."""
    return 100 + int(3000 * n / lam)


@dataclasses.dataclass(frozen=True)
class CMAConfig:
    """Static (Python-level) configuration of a CMA-ES run."""

    n: int
    lam: int
    sigma0: float = 0.25
    lam_max: Optional[int] = None
    hist_len: int = 64
    eigen_interval: Optional[int] = None
    tolfun: float = 1e-12
    tolfunhist: float = 1e-13
    tolx_factor: float = 1e-11
    tol_condition: float = 1e14
    tolupsigma: float = 1e20
    max_iter: Optional[int] = None
    dtype: str = "float64"

    def __post_init__(self):
        object.__setattr__(self, "max_iter_auto", self.max_iter is None)
        if self.lam_max is None:
            object.__setattr__(self, "lam_max", self.lam)
        if self.eigen_interval is None:
            # c-cmaes: update the eigensystem when gen - last > 1/(c1+cmu)/n/10.
            w = _raw_weights(self.lam)
            mu_eff = float(1.0 / np.sum(w ** 2))
            c_1 = 2.0 / ((self.n + 1.3) ** 2 + mu_eff)
            c_mu = min(
                1.0 - c_1,
                2.0 * (mu_eff - 2.0 + 1.0 / mu_eff) / ((self.n + 2.0) ** 2 + mu_eff),
            )
            interval = max(1, int(1.0 / ((c_1 + c_mu) * self.n * 10.0)))
            object.__setattr__(self, "eigen_interval", interval)
        if self.max_iter is None:
            object.__setattr__(self, "max_iter",
                               default_max_iter(self.n, self.lam))

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class CMAParams(NamedTuple):
    """Per-descent strategy parameters; stacked rungs add a leading axis."""

    lam: torch.Tensor          # int32
    weights: torch.Tensor      # (lam_max,) rank-indexed, Σ = 1
    mu: torch.Tensor           # int32
    mu_eff: torch.Tensor
    c_sigma: torch.Tensor
    d_sigma: torch.Tensor
    c_c: torch.Tensor
    c_1: torch.Tensor
    c_mu: torch.Tensor
    chi_n: torch.Tensor        # E||N(0,I)||
    sigma0: torch.Tensor
    hist_window: torch.Tensor  # int32: min(hist_len, 10 + 30n/λ)
    max_iter: torch.Tensor     # int32


def make_params(cfg: CMAConfig, lam: Optional[int] = None,
                device=None) -> CMAParams:
    """CMAParams for a descent of population ``lam`` padded to ``cfg.lam_max``."""
    lam = int(lam if lam is not None else cfg.lam)
    if lam > cfg.lam_max:
        raise ValueError(f"lam={lam} exceeds lam_max={cfg.lam_max}")
    n = cfg.n
    mu = lam // 2
    w = np.zeros(cfg.lam_max, dtype=np.float64)
    w[:mu] = _raw_weights(lam)
    mu_eff = 1.0 / np.sum(w ** 2)
    c_sigma = (mu_eff + 2.0) / (n + mu_eff + 5.0)
    d_sigma = 1.0 + 2.0 * max(0.0, np.sqrt((mu_eff - 1.0) / (n + 1.0)) - 1.0) + c_sigma
    c_c = (4.0 + mu_eff / n) / (n + 4.0 + 2.0 * mu_eff / n)
    c_1 = 2.0 / ((n + 1.3) ** 2 + mu_eff)
    c_mu = min(1.0 - c_1, 2.0 * (mu_eff - 2.0 + 1.0 / mu_eff) / ((n + 2.0) ** 2 + mu_eff))
    chi_n = np.sqrt(n) * (1.0 - 1.0 / (4.0 * n) + 1.0 / (21.0 * n ** 2))
    hist_window = min(cfg.hist_len, 10 + int(np.ceil(30.0 * n / lam)))
    if lam != cfg.lam and getattr(cfg, "max_iter_auto", False):
        max_iter = default_max_iter(n, lam)
    else:
        max_iter = cfg.max_iter
    dt = cfg.tdtype

    def real(v):
        return torch.tensor(np.asarray(v, np.float64), dtype=dt, device=device)

    def i32(v):
        return torch.tensor(int(v), dtype=torch.int32, device=device)

    return CMAParams(
        lam=i32(lam), weights=real(w), mu=i32(mu), mu_eff=real(mu_eff),
        c_sigma=real(c_sigma), d_sigma=real(d_sigma), c_c=real(c_c),
        c_1=real(c_1), c_mu=real(c_mu), chi_n=real(chi_n),
        sigma0=real(cfg.sigma0), hist_window=i32(hist_window),
        max_iter=i32(max_iter))


def stack_params(params: list) -> CMAParams:
    """Per-descent params stacked along a leading descent axis."""
    return CMAParams(*(torch.stack(leaves) for leaves in zip(*params)))


def broadcast_params(params: CMAParams, S: int) -> CMAParams:
    """One descent's params repeated over S slots (leaves (S, ...), views)."""
    return CMAParams(*(leaf.expand((S,) + leaf.shape) for leaf in params))


def ladder_params(cfg: CMAConfig, lam_start: int, kmax_exp: int,
                  device=None) -> CMAParams:
    """Stacked params for the IPOP ladder: rung k has λ = 2ᵏ·lam_start; every
    leaf carries a leading (kmax_exp+1,) rung axis."""
    return stack_params([make_params(cfg, lam=(2 ** k) * lam_start,
                                     device=device)
                         for k in range(kmax_exp + 1)])


def bucket_config(cfg: CMAConfig, lam_bucket: int) -> CMAConfig:
    """``cfg`` narrowed to one rung bucket's padding width: only ``lam`` and
    ``lam_max`` change, every trajectory knob (tolerances, history length,
    eigen cadence) is inherited, and an automatic ``max_iter`` is derived
    again for the bucket's own λ."""
    if lam_bucket > cfg.lam_max:
        raise ValueError(f"lam_bucket={lam_bucket} exceeds "
                         f"lam_max={cfg.lam_max}")
    return dataclasses.replace(
        cfg, lam=lam_bucket, lam_max=lam_bucket,
        max_iter=None if getattr(cfg, "max_iter_auto", False)
        else cfg.max_iter)


def select_params(sparams: CMAParams, idx: torch.Tensor) -> CMAParams:
    """Gather rungs from a stacked ladder by an index tensor (on device)."""
    return CMAParams(*(leaf[idx] for leaf in sparams))
