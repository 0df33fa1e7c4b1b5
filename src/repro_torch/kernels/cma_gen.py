"""Wrappers of the hand-written CUDA generation kernels (``csrc/*.cu``).

* ``gen_sample`` — replaces ``repro/kernels/cma_gen.py::cma_gen_sample``:
  (Y, X) = (Z·diag(D)·Bᵀ, m + σ·Y), one launch.
* ``gen_sample_eval`` — replaces ``cma_gen_sample_eval``: (Y, F) with the
  separable fitness in the epilogue, X never written; two launches (tile
  GEMM with per-tile row partials, then a fixed-order row reduce).
* ``gen_update`` — replaces ``cma_gen_update``: (C′, p_σ′, p_c′, y_w); four
  vector launches, then the upper-triangle gram-plus-epilogue launch.
* ``gen_sample_rng`` / ``gen_sample_rng_eval`` — replace
  ``cma_gen_sample_rng`` / ``cma_gen_sample_rng_eval``: the two sample
  kernels with Z drawn inside the kernel from per-slot seeds
  (``csrc/threefry.cuh``); Z is never read or written.
* ``sample_z_rng`` — replaces ``cma_sample_z_rng``: the counter stream Z
  alone, one launch.

The RNG wrappers take ``seeds`` (S, 2) as uint32 words held in int64, and
``lam`` and ``n`` below 2¹⁶ (the counter is ``(row << 16) | col``).

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
from repro_torch.kernels._build import SUFFIX as _SUFFIX
from repro_torch.kernels._build import check as _check
from repro_torch.kernels._build import launch as _launch
from repro_torch.kernels.ref import RNG_MAX_DIM

#: per-slot scalar coefficients of ``gen_update``, in column order
COEF_FIELDS = ("c_sigma", "mu_eff", "c_c", "c_1", "c_mu", "chi_n", "gen1")

LAUNCHES = _build.LAUNCHES
reset_launches = _build.reset_launches

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    ("cma_gen_sample", "cma_gen_sample"): [_P] * 7 + [_I] * 3 + [_P],
    ("cma_gen_sample", "cma_gen_sample_eval"): [_P] * 13 + [_I] * 3 + [_P],
    ("cma_gen_update", "cma_gen_update"): [_P] * 14 + [_I] * 3 + [_P],
    ("cma_gen_sample", "cma_gen_sample_rng"): [_P] * 7 + [_I] * 3 + [_P],
    ("cma_gen_sample", "cma_gen_sample_rng_eval"): [_P] * 13 + [_I] * 3 + [_P],
    ("cma_gen_sample", "cma_sample_z_rng"): [_P] * 2 + [_I] * 3 + [_P],
    ("cma_gen_sample", "cma_gen_sample_tile_cols"): [],
}


def _fn(lib_name: str, fn_name: str, dtype: torch.dtype):
    return _build.function(lib_name, fn_name, dtype,
                           _SIGNATURES[(lib_name, fn_name)])


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


def _seed_words(seeds: torch.Tensor, lam: int, n: int) -> torch.Tensor:
    """Checks the counter's range, then ``seeds`` (S, 2) int64 on CUDA;
    returns the words as int32 with the uint32 bit patterns the kernel
    reads (a word ≥ 2³¹ wraps to a negative int32)."""
    if not (0 < lam < RNG_MAX_DIM and 0 < n < RNG_MAX_DIM):
        raise ValueError(f"lam={lam} and n={n} must lie in [1, 2^16): the "
                         "counter is (row << 16) | col")
    if not seeds.is_cuda:
        raise ValueError("seeds: the CUDA kernel takes CUDA tensors, got one "
                         f"on {seeds.device}")
    if seeds.dtype != torch.int64 or seeds.dim() != 2 or seeds.shape[1] != 2:
        raise ValueError("seeds must be (S, 2) int64-held uint32 words, got "
                         f"{tuple(seeds.shape)} {seeds.dtype}")
    w = seeds & 0xFFFFFFFF
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32).contiguous()


def _rng_operands(m, sigma, B, D, seeds, lam: int):
    if B.dim() != 3 or B.dtype not in _SUFFIX:
        raise ValueError("B must be (S, n, n) float32 or float64")
    S, n, _ = B.shape
    lam = int(lam)
    words = _seed_words(seeds, lam, n)
    dt, dev = B.dtype, B.device
    ptrs = [_check("m", m, (S, n), dt, dev), _check("sigma", sigma, (S,), dt, dev),
            _check("B", B, (S, n, n), dt, dev), _check("D", D, (S, n), dt, dev),
            _check("seeds", words, (S, 2), torch.int32, dev)]
    # the caller holds ``words`` until the launch: freed earlier, its block
    # could be handed to an output allocated before the kernel runs
    return (S, lam, n), dt, dev, ptrs, words


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


def gen_sample_rng(m, sigma, B, D, seeds, lam: int):
    """Y, X (S, λ, n) from m (S,n), sigma (S,), B (S,n,n), D (S,n) and the
    counter stream of ``seeds`` (S, 2); Z is drawn inside the kernel."""
    (S, lam, n), dt, dev, ptrs, words = _rng_operands(m, sigma, B, D, seeds,
                                                      lam)
    Y = torch.empty((S, lam, n), dtype=dt, device=dev)
    X = torch.empty_like(Y)
    _launch(_fn("cma_gen_sample", "cma_gen_sample_rng", dt),
            "cma_gen_sample_rng", dev, *ptrs, Y.data_ptr(), X.data_ptr(), S,
            lam, n)
    del words
    return Y, X


def gen_sample_rng_eval(m, sigma, B, D, seeds, lam: int, scale, shift, fopt,
                        mode, valid):
    """Y (S, λ, n) and F (S, λ) from the counter stream of ``seeds`` (S, 2)
    for a separable fid laid out as in ``gen_sample_eval``."""
    (S, lam, n), dt, dev, ptrs, words = _rng_operands(m, sigma, B, D, seeds,
                                                      lam)
    ptrs += [_check("scale", scale, (S, n), dt, dev),
             _check("shift", shift, (S, n), dt, dev),
             _check("fopt", fopt, (S,), dt, dev),
             _check("mode", mode, (S,), torch.int32, dev),
             _check("valid", valid, (S,), torch.int32, dev)]
    Y = torch.empty((S, lam, n), dtype=dt, device=dev)
    F = torch.empty((S, lam), dtype=dt, device=dev)
    tile_cols = _fn("cma_gen_sample", "cma_gen_sample_tile_cols", dt)()
    Fpart = torch.empty((S, -(-n // tile_cols), lam), dtype=dt, device=dev)
    _launch(_fn("cma_gen_sample", "cma_gen_sample_rng_eval", dt),
            "cma_gen_sample_rng_eval", dev, *ptrs, Y.data_ptr(), F.data_ptr(),
            Fpart.data_ptr(), S, lam, n)
    del words
    return Y, F


def sample_z_rng(seeds, lam: int, n: int, dtype=torch.float64):
    """The counter stream Z (S, λ, n) of ``seeds`` (S, 2) in ``dtype``."""
    lam, n = int(lam), int(n)
    words = _seed_words(seeds, lam, n)
    if dtype not in _SUFFIX:
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    S = words.shape[0]
    Z = torch.empty((S, lam, n), dtype=dtype, device=words.device)
    _launch(_fn("cma_gen_sample", "cma_sample_z_rng", dtype),
            "cma_sample_z_rng", words.device, words.data_ptr(), Z.data_ptr(),
            S, lam, n)
    return Z


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
