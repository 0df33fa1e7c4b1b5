"""BBOB noiseless functions f1, f2 and f8 in torch, with the separable-eval
pieces of the sample kernel's fitness epilogue.

Port of the subset of ``repro/fitness/bbob.py`` that the first slice of the
port runs: the instance factory (same PRNG key schedule, so instances equal
the JAX package's), the sphere f1, the separable ellipsoid f2 and the
Rosenbrock f8, and the ``SepCoeffs`` form that lets the sample kernel
evaluate f1/f2 without writing X.  The other fids raise
``NotImplementedError`` (ROADMAP.md, queue A item 4).

Every evaluator maps X (batch, n) → (batch,) and includes f_opt.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.device import resolve_device
from repro_torch.core.eval_dispatch import FusableEval

#: fids expressible as Σᵢ scaleᵢ·g(xᵢ − shiftᵢ)² + f_opt with an elementwise
#: g, and therefore fusable into the sample kernel's epilogue.
FUSABLE_FIDS = (1, 2)
PORTED_FIDS = (1, 2, 8)


class BBOBInstance(NamedTuple):
    fid: torch.Tensor      # () int32
    x_opt: torch.Tensor    # (n,)
    f_opt: torch.Tensor    # ()
    R: torch.Tensor        # (n, n) orthogonal
    Q: torch.Tensor        # (n, n) orthogonal


def _check_fid(fid: int):
    if fid not in PORTED_FIDS:
        raise NotImplementedError(
            f"BBOB f{fid} is not ported yet; ported: {PORTED_FIDS} "
            "(ROADMAP.md, queue A item 4)")


def t_osz(x: torch.Tensor) -> torch.Tensor:
    nz = x != 0.0
    xhat = torch.where(nz, torch.log(torch.where(nz, x, 1.0).abs()), 0.0)
    pos = x > 0.0
    c1 = torch.where(pos, x.new_tensor(10.0), x.new_tensor(5.5))
    c2 = torch.where(pos, x.new_tensor(7.9), x.new_tensor(3.1))
    return torch.sign(x) * torch.exp(
        xhat + 0.049 * (torch.sin(c1 * xhat) + torch.sin(c2 * xhat)))


def _orth(key: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """Random orthogonal matrix, Q of a QR with the signs of diag(R) folded
    in, so it does not depend on the QR routine's sign convention."""
    a = prng.normal(key, (n, n), dtype)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))[None, :]


def make_instance(fid: int, n: int, instance: int = 0,
                  dtype=torch.float64, device=None) -> BBOBInstance:
    """Instance ``(fid, n, instance)``, equal to ``repro``'s.  ``device=None``
    means the CUDA device, as for the entry points, and raises without one."""
    _check_fid(fid)
    device = resolve_device(device)
    key = prng.PRNGKey(int(np.uint32(1_000_003 * fid + 97 * n + instance)),
                       device=device)
    k_xopt, k_fopt, k_R, k_Q = prng.split(key, 8)[:4]
    if fid == 8:       # plain Rosenbrock: x_opt free in [-3, 3]
        x_opt = prng.uniform(k_xopt, (n,), dtype, -3.0, 3.0)
    else:
        x_opt = prng.uniform(k_xopt, (n,), dtype, -4.0, 4.0)
    # jnp.round(·, 2) as XLA compiles it: scale, round half to even, and
    # unscale by multiplying with the reciprocal constant 0.01
    f_opt = torch.round(prng.uniform(k_fopt, (), dtype, -100.0, 100.0)
                        * 100.0) * 0.01
    return BBOBInstance(
        fid=torch.tensor(fid, dtype=torch.int32, device=device),
        x_opt=x_opt, f_opt=f_opt, R=_orth(k_R, n, dtype),
        Q=_orth(k_Q, n, dtype))


def _ell_scale(n: int, dtype, device) -> torch.Tensor:
    """Ellipsoid axis weights 10^(6·i/(n−1)), computed in numpy as the JAX
    package computes them."""
    return torch.tensor(
        np.power(10.0, 6.0 * np.arange(n) / max(n - 1.0, 1.0)), dtype=dtype,
        device=device)


def _f01(inst, X):
    z = X - inst.x_opt
    return torch.sum(z ** 2, -1)


def _f02(inst, X):
    z = t_osz(X - inst.x_opt)
    return torch.sum(_ell_scale(X.shape[-1], X.dtype, X.device) * z ** 2, -1)


def _f08(inst, X):
    n = X.shape[-1]
    c = max(1.0, np.sqrt(n) / 8.0)
    z = c * (X - inst.x_opt) + 1.0
    return torch.sum(100.0 * (z[..., :-1] ** 2 - z[..., 1:]) ** 2
                     + (z[..., :-1] - 1.0) ** 2, -1)


_EVALS = {1: _f01, 2: _f02, 8: _f08}


def evaluate(fid: int, inst: BBOBInstance, X: torch.Tensor) -> torch.Tensor:
    """Batch evaluation f(X), f_opt included."""
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
# separable-fid eval fusion (the sample kernel's fitness epilogue)
# ---------------------------------------------------------------------------

class SepCoeffs(NamedTuple):
    """f(X) = Σᵢ scaleᵢ·g(Xᵢ − shiftᵢ)² + f_opt, g picked by ``mode``
    (0 identity, 1 t_osz); ``valid`` False (0) poisons the value to NaN.
    ``ops.slot_sep`` lays the leaves out per slot for the sample kernel."""
    scale: torch.Tensor    # (n,)
    shift: torch.Tensor    # (n,) x_opt
    f_opt: torch.Tensor    # ()
    mode: torch.Tensor     # () int32
    valid: torch.Tensor    # () bool (int32 when laid out per slot)


def separable_coeffs(inst: BBOBInstance, branch_fids: tuple) -> SepCoeffs:
    """SepCoeffs of an instance over a fusable fid menu.  The table row is
    picked on the host: the instance's fid is known when the fitness is
    built, and a fid outside the menu gives ``valid`` False (NaN values),
    as the dispatched menu does."""
    branch_fids = tuple(branch_fids)
    if not all(f in FUSABLE_FIDS for f in branch_fids):
        raise ValueError(f"menu {branch_fids} has a non-separable fid")
    n, dt, dev = inst.x_opt.shape[-1], inst.x_opt.dtype, inst.x_opt.device
    fid = int(inst.fid)
    idx = branch_fids.index(fid) if fid in branch_fids else 0
    pick = branch_fids[idx]
    scale = (torch.ones(n, dtype=dt, device=dev) if pick == 1
             else _ell_scale(n, dt, dev))
    return SepCoeffs(
        scale=scale, shift=inst.x_opt, f_opt=inst.f_opt,
        mode=torch.tensor(0 if pick == 1 else 1, dtype=torch.int32,
                          device=dev),
        valid=torch.tensor(fid in branch_fids, device=dev))


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
    otherwise ``fn`` unchanged."""
    branch_fids = tuple(branch_fids)
    if not branch_fids or any(f not in FUSABLE_FIDS for f in branch_fids):
        return fn
    return FusableEval(fn, separable_coeffs(inst, branch_fids))
