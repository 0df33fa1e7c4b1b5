"""Wrappers of the hand-written CUDA generation kernels (``csrc/*.cu``).

* ``gen_sample`` — replaces ``repro/kernels/cma_gen.py::cma_gen_sample``:
  (Y, X) = (Z·diag(D)·Bᵀ, m + σ·Y), one launch.
* ``gen_sample_eval`` — replaces ``cma_gen_sample_eval``: (Y, F) with the
  separable fitness in the epilogue, X never written; two launches (tile
  GEMM with per-tile row partials, then a fixed-order row reduce).
* ``gen_update`` — replaces ``cma_gen_update``: (C′, p_σ′, p_c′, y_w); four
  vector launches, then the upper-triangle gram-plus-epilogue launch.

The design notes (what bounds each kernel and what the design does about
it) head each source file.  The plain PyTorch versions are in
``kernels/ref.py``.  Every wrapper takes CUDA tensors only — it checks
device, dtype, shape and contiguity and raises, it never falls back — and
launches on the current stream without synchronising.  ``LAUNCHES`` counts
the calls that launched each kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: per-slot scalar coefficients of ``gen_update``, in column order
COEF_FIELDS = ("c_sigma", "mu_eff", "c_c", "c_1", "c_mu", "chi_n", "gen1")

LAUNCHES = {"cma_gen_sample": 0, "cma_gen_sample_eval": 0,
            "cma_gen_update": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    ("cma_gen_sample", "cma_gen_sample"): [_P] * 7 + [_I] * 3 + [_P],
    ("cma_gen_sample", "cma_gen_sample_eval"): [_P] * 13 + [_I] * 3 + [_P],
    ("cma_gen_update", "cma_gen_update"): [_P] * 14 + [_I] * 3 + [_P],
    ("cma_gen_sample", "cma_gen_sample_tile_cols"): [],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn(lib_name: str, fn_name: str, dtype: torch.dtype):
    fn = getattr(_build.library(lib_name), f"{fn_name}_{_SUFFIX[dtype]}")
    fn.argtypes = _SIGNATURES[(lib_name, fn_name)]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> int:
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _launch(fn, label: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{label}: CUDA launch error {err}")
    LAUNCHES[label] += 1


def _sample_operands(m, sigma, B, D, Z):
    if not Z.is_cuda:
        raise ValueError("Z: the CUDA kernel takes CUDA tensors, got one on "
                         f"{Z.device}")
    if Z.dim() != 3 or Z.dtype not in _SUFFIX:
        raise ValueError("Z must be (S, lam, n) float32 or float64")
    S, lam, n = Z.shape
    dt, dev = Z.dtype, Z.device
    ptrs = [_check("m", m, (S, n), dt, dev), _check("sigma", sigma, (S,), dt, dev),
            _check("B", B, (S, n, n), dt, dev), _check("D", D, (S, n), dt, dev),
            _check("Z", Z, (S, lam, n), dt, dev)]
    return (S, lam, n), dt, dev, ptrs


def gen_sample(m, sigma, B, D, Z):
    """Y, X (S, λ, n) from m (S,n), sigma (S,), B (S,n,n), D (S,n), Z (S,λ,n)."""
    (S, lam, n), dt, dev, ptrs = _sample_operands(m, sigma, B, D, Z)
    Y = torch.empty_like(Z)
    X = torch.empty_like(Z)
    _launch(_fn("cma_gen_sample", "cma_gen_sample", dt), "cma_gen_sample",
            dev, *ptrs, Y.data_ptr(), X.data_ptr(), S, lam, n)
    return Y, X


def gen_sample_eval(m, sigma, B, D, Z, scale, shift, fopt, mode, valid):
    """Y (S, λ, n) and F (S, λ) for a separable fid: per-slot ``scale`` and
    ``shift`` (S, n), ``fopt`` (S,) in the state dtype, ``mode`` and
    ``valid`` (S,) int32."""
    (S, lam, n), dt, dev, ptrs = _sample_operands(m, sigma, B, D, Z)
    ptrs += [_check("scale", scale, (S, n), dt, dev),
             _check("shift", shift, (S, n), dt, dev),
             _check("fopt", fopt, (S,), dt, dev),
             _check("mode", mode, (S,), torch.int32, dev),
             _check("valid", valid, (S,), torch.int32, dev)]
    Y = torch.empty_like(Z)
    F = torch.empty((S, lam), dtype=dt, device=dev)
    tile_cols = _fn("cma_gen_sample", "cma_gen_sample_tile_cols", dt)()
    ntiles = -(-n // tile_cols)
    Fpart = torch.empty((S, ntiles, lam), dtype=dt, device=dev)
    _launch(_fn("cma_gen_sample", "cma_gen_sample_eval", dt),
            "cma_gen_sample_eval", dev, *ptrs, Y.data_ptr(), F.data_ptr(),
            Fpart.data_ptr(), S, lam, n)
    return Y, F


def gen_update(C, B, D, p_sigma, p_c, Y, w, coef):
    """(C′, p_σ′, p_c′, y_w) from C, B (S,n,n), D, p_sigma, p_c (S,n),
    Y (S,λ,n), w (S,λ) and ``coef`` (S, 7) in ``COEF_FIELDS`` order."""
    if not C.is_cuda:
        raise ValueError("C: the CUDA kernel takes CUDA tensors, got one on "
                         f"{C.device}")
    if C.dim() != 3 or C.dtype not in _SUFFIX:
        raise ValueError("C must be (S, n, n) float32 or float64")
    S, n, _ = C.shape
    lam = Y.shape[1] if Y.dim() == 3 else -1
    dt, dev = C.dtype, C.device
    ptrs = [_check("C", C, (S, n, n), dt, dev), _check("B", B, (S, n, n), dt, dev),
            _check("D", D, (S, n), dt, dev),
            _check("p_sigma", p_sigma, (S, n), dt, dev),
            _check("p_c", p_c, (S, n), dt, dev),
            _check("Y", Y, (S, lam, n), dt, dev), _check("w", w, (S, lam), dt, dev),
            _check("coef", coef, (S, len(COEF_FIELDS)), dt, dev)]
    C_new = torch.empty_like(C)
    ps_new = torch.empty_like(p_sigma)
    pc_new = torch.empty_like(p_c)
    y_w = torch.empty_like(p_c)
    t = torch.empty_like(p_c)
    scal = torch.empty((S, 2), dtype=dt, device=dev)
    _launch(_fn("cma_gen_update", "cma_gen_update", dt), "cma_gen_update",
            dev, *ptrs, C_new.data_ptr(), ps_new.data_ptr(), pc_new.data_ptr(),
            y_w.data_ptr(), t.data_ptr(), scal.data_ptr(), S, lam, n)
    return C_new, ps_new, pc_new, y_w
