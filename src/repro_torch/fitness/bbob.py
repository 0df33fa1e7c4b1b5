"""The BBOB noiseless suite f1–f24 in torch, with the campaign forms and the
separable-eval pieces of the sample kernel's fitness epilogue.

Port of ``repro/fitness/bbob.py`` (Hansen, Finck, Ros & Auger, RR-6829):
the instance factory (same PRNG key schedule, so instances equal the JAX
package's), the 24 evaluators, ``stack_instances`` and the stacked
evaluation of a campaign, and the ``SepCoeffs`` form that lets the sample
kernel evaluate f1/f2 without writing X.

Every evaluator maps X (batch, n) → (batch,) and includes f_opt.  An
instance's leaves may also carry a leading member axis (``member_view``):
then X is (B, batch, n), the rotations are batched products against
``R.transpose(-1, -2)``, and the result is (B, batch).  A campaign knows
each member's fid on the host, so ``StackedFitness`` groups the members by
fid once and makes one evaluator call per distinct fid — not the JAX
package's ``lax.switch``, which under ``vmap`` evaluates every branch.
Index-derived constants are made in X's dtype.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.device import resolve_device
from repro_torch.core.eval_dispatch import FusableEval

SEARCH_DOMAIN = (-5.0, 5.0)

#: fids expressible as Σᵢ scaleᵢ·g(xᵢ − shiftᵢ)² + f_opt with an elementwise
#: g, and therefore fusable into the sample kernel's epilogue.
FUSABLE_FIDS = (1, 2)

GROUPS = {  # paper §4.1: the five BBOB difficulty groups
    "separable": (1, 2, 3, 4, 5),
    "low_conditioning": (6, 7, 8, 9),
    "high_conditioning": (10, 11, 12, 13, 14),
    "multimodal_adequate": (15, 16, 17, 18, 19),
    "multimodal_weak": (20, 21, 22, 23, 24),
}

NAMES = {
    1: "Sphere", 2: "Ellipsoidal", 3: "Rastrigin", 4: "BucheRastrigin",
    5: "LinearSlope", 6: "AttractiveSector", 7: "StepEllipsoidal",
    8: "Rosenbrock", 9: "RosenbrockRotated", 10: "EllipsoidalRotated",
    11: "Discus", 12: "BentCigar", 13: "SharpRidge", 14: "DifferentPowers",
    15: "RastriginRotated", 16: "Weierstrass", 17: "SchaffersF7",
    18: "SchaffersF7Ill", 19: "GriewankRosenbrock", 20: "Schwefel",
    21: "Gallagher101", 22: "Gallagher21", 23: "Katsuura", 24: "LunacekBiRastrigin",
}

#: Gallagher peak counts (f21, f22); every other fid carries one dummy peak
PEAKS = {21: 101, 22: 21}


class BBOBInstance(NamedTuple):
    fid: torch.Tensor      # () int32
    x_opt: torch.Tensor    # (n,) location encoding of the optimum
    f_opt: torch.Tensor    # ()
    R: torch.Tensor        # (n, n) orthogonal
    Q: torch.Tensor        # (n, n) orthogonal
    peaks_y: torch.Tensor  # (m, n) Gallagher peak locations (else (1, n) zeros)
    peaks_w: torch.Tensor  # (m,)
    peaks_c: torch.Tensor  # (m, n) per-peak diagonal scalings (permuted)


def _check_fid(fid: int):
    if fid not in NAMES:
        raise ValueError(f"BBOB has fids 1-24, got {fid}")


# ---------------------------------------------------------------------------
# transforms (RR-6829 §0)
# ---------------------------------------------------------------------------

def t_osz(x: torch.Tensor) -> torch.Tensor:
    nz = x != 0.0
    xhat = torch.where(nz, torch.log(torch.where(nz, x, 1.0).abs()), 0.0)
    pos = x > 0.0
    c1 = torch.where(pos, x.new_full((), 10.0), x.new_full((), 5.5))
    c2 = torch.where(pos, x.new_full((), 7.9), x.new_full((), 3.1))
    return torch.sign(x) * torch.exp(
        xhat + 0.049 * (torch.sin(c1 * xhat) + torch.sin(c2 * xhat)))


def _ramp(n: int, like: torch.Tensor) -> torch.Tensor:
    """i / max(n − 1, 1) for i < n, in ``like``'s dtype."""
    return (torch.arange(n, dtype=like.dtype, device=like.device)
            / max(n - 1.0, 1.0))


def t_asy(x: torch.Tensor, beta: float) -> torch.Tensor:
    expo = 1.0 + beta * _ramp(x.shape[-1], x) * torch.sqrt(
        torch.clamp(x, min=0.0))
    return torch.where(x > 0.0, torch.clamp(x, min=0.0) ** expo, x)


def lam_alpha(alpha: float, n: int, like: torch.Tensor) -> torch.Tensor:
    """The diagonal conditioning α^(i/(2(n−1))), in ``like``'s dtype."""
    return like.new_full((), alpha) ** (0.5 * _ramp(n, like))


def f_pen(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.clamp(x.abs() - 5.0, min=0.0) ** 2, -1)


def _orth(key: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """Random orthogonal matrix, Q of a QR with the signs of diag(R) folded
    in, so it does not depend on the QR routine's sign convention."""
    a = prng.normal(key, (n, n), dtype)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))[None, :]


def _signs(key: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return torch.sign(prng.normal(key, (n,), dtype) + 1e-12)


# ---------------------------------------------------------------------------
# instance factory
# ---------------------------------------------------------------------------

def make_instance(fid: int, n: int, instance: int = 0,
                  dtype=torch.float64, device=None) -> BBOBInstance:
    """Instance ``(fid, n, instance)``, equal to ``repro``'s.  ``device=None``
    means the CUDA device, as for the entry points, and raises without one."""
    _check_fid(fid)
    device = resolve_device(device)
    key = prng.PRNGKey(int(np.uint32(1_000_003 * fid + 97 * n + instance)),
                       device=device)
    (k_xopt, k_fopt, k_R, k_Q, k_peaks, k_w, k_alpha,
     k_sign) = prng.split(key, 8).unbind(0)

    if fid == 5:       # optimum at a ±5 corner
        x_opt = 5.0 * _signs(k_sign, n, dtype)
    elif fid == 20:    # x_opt = 4.2096874633/2 · ±1
        x_opt = (4.2096874633 / 2.0) * _signs(k_sign, n, dtype)
    elif fid == 24:    # x_opt = (μ0/2)·±1
        x_opt = (2.5 / 2.0) * _signs(k_sign, n, dtype)
    elif fid == 8:     # plain Rosenbrock: x_opt free in [-3, 3]
        x_opt = prng.uniform(k_xopt, (n,), dtype, -3.0, 3.0)
    else:
        x_opt = prng.uniform(k_xopt, (n,), dtype, -4.0, 4.0)
    # jnp.round(·, 2) as XLA compiles it: scale, round half to even, and
    # unscale by multiplying with the reciprocal constant 0.01
    f_opt = torch.round(prng.uniform(k_fopt, (), dtype, -100.0, 100.0)
                        * 100.0) * 0.01
    R = _orth(k_R, n, dtype)
    Q = _orth(k_Q, n, dtype)
    if fid in (9, 19):  # optimum where z = c·R·x + 1/2 equals 1
        c = max(1.0, np.sqrt(n) / 8.0)
        x_opt = R.T @ torch.full((n,), 0.5 / c, dtype=dtype, device=device)

    if fid in PEAKS:
        m = PEAKS[fid]
        span = 4.0 if fid == 21 else 3.92
        base = 1000.0 if fid == 21 else 1000.0 ** 2
        y = prng.uniform(k_peaks, (m, n), dtype, -4.9, 4.9)
        y[0] = prng.uniform(k_xopt, (n,), dtype, -span, span)
        x_opt = y[0].clone()
        w = torch.cat([
            torch.tensor([10.0], dtype=dtype, device=device),
            1.1 + 8.0 * torch.arange(m - 1, dtype=dtype, device=device)
            / (m - 2.0)])
        # per-peak condition numbers: a random permutation of 1000^{2j/(m-2)}
        j = prng.permutation(k_alpha, m - 1).to(dtype)
        alphas = torch.cat([
            torch.tensor([base], dtype=dtype, device=device),
            1000.0 ** (2.0 * j / max(m - 2.0, 1.0))])
        idx = torch.arange(n, dtype=dtype, device=device) / max(n - 1.0, 1.0)
        peaks_y, peaks_w = y, w
        peaks_c = (alphas[:, None] ** (0.5 * idx[None, :])
                   / (alphas[:, None] ** 0.25))
    else:
        peaks_y = torch.zeros((1, n), dtype=dtype, device=device)
        peaks_w = torch.zeros((1,), dtype=dtype, device=device)
        peaks_c = torch.ones((1, n), dtype=dtype, device=device)

    return BBOBInstance(
        fid=torch.tensor(fid, dtype=torch.int32, device=device),
        x_opt=x_opt, f_opt=f_opt, R=R, Q=Q, peaks_y=peaks_y, peaks_w=peaks_w,
        peaks_c=peaks_c)


# ---------------------------------------------------------------------------
# the 24 functions — raw value, f_opt added by ``evaluate``
# ---------------------------------------------------------------------------

def _rot(X, M):
    """X·Mᵀ, batched over a leading member axis of both."""
    return X @ M.transpose(-1, -2)


def _rastrigin(z, n):
    return (10.0 * (n - torch.sum(torch.cos(2 * math.pi * z), -1))
            + torch.sum(z ** 2, -1))


def _rosenbrock(z):
    return (100.0 * (z[..., :-1] ** 2 - z[..., 1:]) ** 2
            + (z[..., :-1] - 1.0) ** 2)


def _f01(inst, X):
    z = X - inst.x_opt
    return torch.sum(z ** 2, -1)


@functools.lru_cache(maxsize=None)
def _ell_scale(n: int, dtype, device) -> torch.Tensor:
    """Ellipsoid axis weights 10^(6·i/(n−1)), computed in numpy as the JAX
    package computes them; one copy to each device, kept (callers do not
    write to it)."""
    return torch.tensor(
        np.power(10.0, 6.0 * np.arange(n) / max(n - 1.0, 1.0)), dtype=dtype,
        device=device)


def _f02(inst, X):
    z = t_osz(X - inst.x_opt)
    return torch.sum(_ell_scale(X.shape[-1], X.dtype, X.device) * z ** 2, -1)


def _f03(inst, X):
    n = X.shape[-1]
    z = lam_alpha(10.0, n, X) * t_asy(t_osz(X - inst.x_opt), 0.2)
    return _rastrigin(z, n)


def _f04(inst, X):
    n = X.shape[-1]
    t = t_osz(X - inst.x_opt)
    s = 10.0 ** (0.5 * torch.arange(n, dtype=X.dtype, device=X.device)
                 / max(n - 1.0, 1.0))
    odd = (torch.arange(n, device=X.device) % 2) == 0   # 1-based odd indices
    s = torch.where(odd & (t > 0), 10.0 * s, s)
    return _rastrigin(s * t, n) + 100.0 * f_pen(X)


def _f05(inst, X):
    n = X.shape[-1]
    s = torch.sign(inst.x_opt) * 10.0 ** (torch.arange(n, dtype=X.dtype,
                                                       device=X.device)
                                          / max(n - 1.0, 1.0))
    z = torch.where(X * inst.x_opt < 25.0, X, inst.x_opt)
    return torch.sum(5.0 * s.abs() - s * z, -1)


def _f06(inst, X):
    z = _rot(X - inst.x_opt, inst.R) * lam_alpha(10.0, X.shape[-1], X)
    z = _rot(z, inst.Q)
    # sector: s_i = 100 where z_i·x_opt_i > 0 (RR-6829 uses raw x_opt_i)
    s = torch.where(z * inst.x_opt > 0, 100.0, 1.0)
    return t_osz(torch.sum((s * z) ** 2, -1)) ** 0.9


def _f07(inst, X):
    n = X.shape[-1]
    zhat = _rot(X - inst.x_opt, inst.R) * lam_alpha(10.0, n, X)
    ztil = torch.where(zhat.abs() > 0.5, torch.floor(0.5 + zhat),
                       torch.floor(0.5 + 10.0 * zhat) / 10.0)
    z = _rot(ztil, inst.Q)
    scale = 10.0 ** (2.0 * torch.arange(n, dtype=X.dtype, device=X.device)
                     / max(n - 1.0, 1.0))
    body = 0.1 * torch.maximum(zhat[..., 0].abs() / 1e4,
                               torch.sum(scale * z ** 2, -1))
    return body + f_pen(X)


def _f08(inst, X):
    n = X.shape[-1]
    c = max(1.0, np.sqrt(n) / 8.0)
    return torch.sum(_rosenbrock(c * (X - inst.x_opt) + 1.0), -1)


def _f09(inst, X):
    n = X.shape[-1]
    c = max(1.0, np.sqrt(n) / 8.0)
    return torch.sum(_rosenbrock(c * _rot(X, inst.R) + 0.5), -1)


def _f10(inst, X):
    n = X.shape[-1]
    z = t_osz(_rot(X - inst.x_opt, inst.R))
    scale = 10.0 ** (6.0 * torch.arange(n, dtype=X.dtype, device=X.device)
                     / max(n - 1.0, 1.0))
    return torch.sum(scale * z ** 2, -1)


def _f11(inst, X):
    z = t_osz(_rot(X - inst.x_opt, inst.R))
    return 1e6 * z[..., 0] ** 2 + torch.sum(z[..., 1:] ** 2, -1)


def _f12(inst, X):
    z = _rot(t_asy(_rot(X - inst.x_opt, inst.R), 0.5), inst.R)
    return z[..., 0] ** 2 + 1e6 * torch.sum(z[..., 1:] ** 2, -1)


def _f13(inst, X):
    z = _rot(_rot(X - inst.x_opt, inst.R) * lam_alpha(10.0, X.shape[-1], X),
             inst.Q)
    return z[..., 0] ** 2 + 100.0 * torch.sqrt(torch.sum(z[..., 1:] ** 2, -1))


def _f14(inst, X):
    n = X.shape[-1]
    z = _rot(X - inst.x_opt, inst.R)
    expo = 2.0 + 4.0 * torch.arange(n, dtype=X.dtype, device=X.device) \
        / max(n - 1.0, 1.0)
    return torch.sqrt(torch.sum(z.abs() ** expo, -1))


def _f15(inst, X):
    n = X.shape[-1]
    z = _rot(t_asy(t_osz(_rot(X - inst.x_opt, inst.R)), 0.2), inst.Q)
    z = _rot(z * lam_alpha(10.0, n, X), inst.R)
    return _rastrigin(z, n)


def _f16(inst, X):
    n = X.shape[-1]
    z = _rot(t_osz(_rot(X - inst.x_opt, inst.R)), inst.Q)
    z = _rot(z * lam_alpha(0.01, n, X), inst.R)
    k = torch.arange(12, dtype=X.dtype, device=X.device)
    halfk = 0.5 ** k
    threek = 3.0 ** k
    f0 = torch.sum(halfk * torch.cos(math.pi * threek))
    inner = torch.sum(halfk * torch.cos(
        2 * math.pi * threek * (z[..., None] + 0.5)), -1)
    return 10.0 * (torch.mean(inner, -1) - f0) ** 3 + (10.0 / n) * f_pen(X)


def _schaffers(inst, X, alpha):
    n = X.shape[-1]
    z = _rot(t_asy(_rot(X - inst.x_opt, inst.R), 0.5), inst.Q)
    z = z * lam_alpha(alpha, n, X)
    s = torch.sqrt(z[..., :-1] ** 2 + z[..., 1:] ** 2)
    val = torch.mean(torch.sqrt(s) * (1.0 + torch.sin(50.0 * s ** 0.2) ** 2),
                     -1) ** 2
    return val + 10.0 * f_pen(X)


def _f17(inst, X):
    return _schaffers(inst, X, 10.0)


def _f18(inst, X):
    return _schaffers(inst, X, 1000.0)


def _f19(inst, X):
    n = X.shape[-1]
    c = max(1.0, np.sqrt(n) / 8.0)
    s = _rosenbrock(c * _rot(X, inst.R) + 0.5)
    return (10.0 / (n - 1.0)) * torch.sum(s / 4000.0 - torch.cos(s), -1) + 10.0


def _f20(inst, X):
    n = X.shape[-1]
    xhat = 2.0 * torch.sign(inst.x_opt) * X    # ±2 pattern from x_opt signs
    xo = 2.0 * inst.x_opt.abs()
    zhat = torch.cat([
        xhat[..., :1],
        xhat[..., 1:] + 0.25 * (xhat[..., :-1] - xo[..., :-1]),
    ], -1)
    z = 100.0 * (lam_alpha(10.0, n, X) * (zhat - xo) + xo)
    body = -torch.mean(z * torch.sin(torch.sqrt(z.abs())), -1) / 100.0
    return body + 4.189828872724339 + 100.0 * f_pen(z / 100.0)


def _gallagher(inst, X):
    """The peak set in its (rows, m, n) form, as the JAX package computes
    it."""
    n = X.shape[-1]
    d = (_rot(X, inst.R)[..., :, None, :]
         - _rot(inst.peaks_y, inst.R)[..., None, :, :])
    quad = torch.sum(d * d * inst.peaks_c[..., None, :, :], -1)  # (rows, m)
    vals = inst.peaks_w[..., None, :] * torch.exp(-quad / (2.0 * n))
    best = torch.amax(vals, -1)
    return t_osz(10.0 - best) ** 2 + f_pen(X)


def _f23(inst, X):
    n = X.shape[-1]
    z = _rot(_rot(X - inst.x_opt, inst.R) * lam_alpha(100.0, n, X), inst.Q)
    j = 2.0 ** torch.arange(1, 33, dtype=X.dtype, device=X.device)
    zj = z[..., None] * j                                   # (rows, n, 32)
    frac = (zj - torch.round(zj)).abs() / j
    inner = 1.0 + torch.arange(1, n + 1, dtype=X.dtype,
                               device=X.device) * torch.sum(frac, -1)
    prod = torch.prod(inner ** (10.0 / n ** 1.2), -1)
    return (10.0 / n ** 2) * prod - 10.0 / n ** 2 + f_pen(X)


def _f24(inst, X):
    n = X.shape[-1]
    mu0 = 2.5
    s = 1.0 - 1.0 / (2.0 * np.sqrt(n + 20.0) - 8.2)
    mu1 = -np.sqrt((mu0 ** 2 - 1.0) / s)
    xhat = 2.0 * torch.sign(inst.x_opt) * X
    z = _rot(_rot(xhat - mu0, inst.R) * lam_alpha(100.0, n, X), inst.Q)
    term1 = torch.sum((xhat - mu0) ** 2, -1)
    term2 = n + s * torch.sum((xhat - mu1) ** 2, -1)
    ras = 10.0 * (n - torch.sum(torch.cos(2 * math.pi * z), -1))
    return torch.minimum(term1, term2) + ras + 1e4 * f_pen(X)


_EVALS = {1: _f01, 2: _f02, 3: _f03, 4: _f04, 5: _f05, 6: _f06, 7: _f07,
          8: _f08, 9: _f09, 10: _f10, 11: _f11, 12: _f12, 13: _f13, 14: _f14,
          15: _f15, 16: _f16, 17: _f17, 18: _f18, 19: _f19, 20: _f20,
          21: _gallagher, 22: _gallagher, 23: _f23, 24: _f24}


def evaluate(fid: int, inst: BBOBInstance, X: torch.Tensor) -> torch.Tensor:
    """Batch evaluation f(X), f_opt included: X (batch, n) against an
    instance, or (B, batch, n) against a ``member_view`` of B members."""
    _check_fid(fid)
    return _EVALS[fid](inst, torch.atleast_2d(X)) + inst.f_opt


def make_fitness(fid: int, n: int, instance: int = 0, dtype=torch.float64,
                 device=None):
    """(fitness_fn, inst): fitness_fn(X) -> (batch,) closed over inst."""
    inst = make_instance(fid, n, instance, dtype, device)

    def fn(X):
        return evaluate(fid, inst, X)
    return fn, inst


# ---------------------------------------------------------------------------
# stacked campaigns
# ---------------------------------------------------------------------------

def pad_instance(inst: BBOBInstance, m_max: int) -> BBOBInstance:
    """The Gallagher peak set padded to ``m_max`` rows, so that instances
    stack; padding peaks weigh 0 and never win the max in ``_gallagher``
    (real peaks weigh at least 1.1)."""
    m, n = inst.peaks_y.shape
    if m >= m_max:
        return inst
    pad = m_max - m
    y = inst.peaks_y
    return inst._replace(
        peaks_y=torch.cat([y, y.new_zeros((pad, n))]),
        peaks_w=torch.cat([inst.peaks_w, y.new_zeros((pad,))]),
        peaks_c=torch.cat([inst.peaks_c, y.new_ones((pad, n))]))


def stack_instances(instances) -> BBOBInstance:
    """Instances stacked along a leading member axis (peaks padded to a
    common m)."""
    m_max = max(int(i.peaks_y.shape[0]) for i in instances)
    padded = [pad_instance(i, m_max) for i in instances]
    return BBOBInstance(*(torch.stack(leaves) for leaves in zip(*padded)))


def member_view(inst: BBOBInstance) -> BBOBInstance:
    """Stacked leaves shaped to broadcast against X (B, batch, n): x_opt
    (B, 1, n) and f_opt (B, 1); the matrices and peaks keep (B, ...)."""
    return inst._replace(x_opt=inst.x_opt[:, None, :],
                         f_opt=inst.f_opt[:, None])


def _host_fids(inst: BBOBInstance) -> list:
    return [int(f) for f in inst.fid.reshape(-1).tolist()]


def evaluate_dynamic(inst: BBOBInstance, X: torch.Tensor,
                     branch_fids: tuple = tuple(range(1, 25))) -> torch.Tensor:
    """``evaluate`` with the fid taken from the instance (read on the host)
    over the menu ``branch_fids``; a fid outside the menu gives NaN, as the
    JAX package's traced dispatch does."""
    fid = _host_fids(inst)[0]
    if fid not in tuple(branch_fids):
        X = torch.atleast_2d(X)
        return torch.full(X.shape[:-1], torch.nan, dtype=X.dtype,
                          device=X.device)
    return evaluate(fid, inst, X)


class StackedFitness:
    """The fitness of a campaign's B members: X (B, batch, n) → (B, batch).

    Built once per campaign: the members are grouped by fid on the host
    (one read of ``inst.fid``), each group's row indices and instance
    leaves (its Gallagher peaks cut back to its own m) stay on the device,
    and a call makes one evaluator call per distinct fid.  Members whose
    fid lies outside ``branch_fids`` get ``fill`` (NaN).  ``fids``, the
    members' fids in order where the caller knows them on the host, saves
    the read of ``inst.fid``."""

    def __init__(self, inst: BBOBInstance, branch_fids: tuple, fids=None,
                 fill: float = float("nan")):
        fids = _host_fids(inst) if fids is None else [int(f) for f in fids]
        dev = inst.x_opt.device
        self.fill = fill
        self.groups = []
        for f in sorted(set(fids) & set(branch_fids)):
            rows = [j for j, g in enumerate(fids) if g == f]
            m = PEAKS.get(f, 1)
            if rows == list(range(len(fids))):
                sub, idx = inst, None
            else:
                idx = torch.tensor(rows, dtype=torch.int64, device=dev)
                sub = BBOBInstance(*(leaf.index_select(0, idx)
                                     for leaf in inst))
            sub = sub._replace(peaks_y=sub.peaks_y[:, :m],
                               peaks_w=sub.peaks_w[:, :m],
                               peaks_c=sub.peaks_c[:, :m])
            self.groups.append((f, idx, member_view(sub)))

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        if len(self.groups) == 1 and self.groups[0][1] is None:
            f, _, sub = self.groups[0]
            return evaluate(f, sub, X)
        F = torch.full(X.shape[:-1], self.fill, dtype=X.dtype,
                       device=X.device)
        for f, idx, sub in self.groups:
            F.index_copy_(0, idx, evaluate(f, sub, X.index_select(0, idx)))
        return F


def evaluate_stacked(fid_array: torch.Tensor, inst_params: BBOBInstance,
                     X: torch.Tensor,
                     branch_fids: tuple = tuple(range(1, 25))) -> torch.Tensor:
    """A campaign's evaluation: ``fid_array`` (B,), instance leaves
    (B, ...) (``stack_instances``), X (B, batch, n) → (B, batch)."""
    inst = inst_params._replace(fid=fid_array.to(torch.int32))
    return StackedFitness(inst, tuple(branch_fids))(X)


# ---------------------------------------------------------------------------
# separable-fid eval fusion (the sample kernel's fitness epilogue)
# ---------------------------------------------------------------------------

class SepCoeffs(NamedTuple):
    """f(X) = Σᵢ scaleᵢ·g(Xᵢ − shiftᵢ)² + f_opt, g picked by ``mode``
    (0 identity, 1 t_osz); ``valid`` False (0) poisons the value to NaN.
    Leaves may carry a leading member axis (a stacked instance's);
    ``ops.slot_sep`` lays them out per slot for the sample kernel."""
    scale: torch.Tensor    # (n,)
    shift: torch.Tensor    # (n,) x_opt
    f_opt: torch.Tensor    # ()
    mode: torch.Tensor     # () int32
    valid: torch.Tensor    # () bool (int32 when laid out per slot)


def separable_coeffs(inst: BBOBInstance, branch_fids: tuple,
                     fids=None) -> SepCoeffs:
    """SepCoeffs of an instance, or of a stacked one member by member, over
    a fusable fid menu.  The table row is picked on the host: the fids are
    known when the fitness is built (``fids``, the members' fids in order,
    saves reading ``inst.fid``), and a fid outside the menu gives ``valid``
    False (NaN values), as the dispatched menu does."""
    branch_fids = tuple(branch_fids)
    if not all(f in FUSABLE_FIDS for f in branch_fids):
        raise ValueError(f"menu {branch_fids} has a non-separable fid")
    n, dt, dev = inst.x_opt.shape[-1], inst.x_opt.dtype, inst.x_opt.device
    fids = _host_fids(inst) if fids is None else [int(f) for f in fids]
    picks = [f if f in branch_fids else branch_fids[0] for f in fids]
    ones, ell = torch.ones(n, dtype=dt, device=dev), _ell_scale(n, dt, dev)
    scale = torch.stack([ones if p == 1 else ell for p in picks])
    mode = torch.tensor([0 if p == 1 else 1 for p in picks],
                        dtype=torch.int32, device=dev)
    valid = torch.tensor([f in branch_fids for f in fids], device=dev)
    shape = inst.fid.shape
    return SepCoeffs(scale=scale.reshape(shape + (n,)), shift=inst.x_opt,
                     f_opt=inst.f_opt, mode=mode.reshape(shape),
                     valid=valid.reshape(shape))


def separable_eval(X: torch.Tensor, sep: SepCoeffs) -> torch.Tensor:
    """Separable fid from its coefficients; X (..., λ, n) → (..., λ).  Leaves
    of ``sep`` may carry the same leading axes as X, or none."""
    t = X - sep.shift[..., None, :]
    tg = torch.where(sep.mode[..., None, None] == 1, t_osz(t), t)
    val = torch.sum(sep.scale[..., None, :] * tg ** 2, -1) + sep.f_opt[..., None]
    return torch.where(sep.valid[..., None] != 0, val, torch.nan)


def fusable_fitness(inst: BBOBInstance, branch_fids: tuple, fn):
    """``fn`` carrying its separable coefficients when the whole fid menu is
    fusable (the engine then samples through the eval-fused kernel);
    otherwise ``fn`` unchanged.  ``inst`` may be stacked."""
    branch_fids = tuple(branch_fids)
    if not branch_fids or any(f not in FUSABLE_FIDS for f in branch_fids):
        return fn
    return FusableEval(fn, separable_coeffs(inst, branch_fids))


def campaign_fitness(inst: BBOBInstance, branch_fids: tuple):
    """A campaign's fitness over a stacked instance: ``StackedFitness``,
    carrying the members' separable coefficients when the menu is
    fusable."""
    branch_fids = tuple(branch_fids)
    return fusable_fitness(inst, branch_fids,
                           StackedFitness(inst, branch_fids))
