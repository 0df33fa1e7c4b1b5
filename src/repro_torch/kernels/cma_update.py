"""Wrapper of the hand-written rank-μ update kernel (``csrc/cma_update.cu``).

``rank_mu_update`` replaces ``repro/kernels/cma_update.py::
cma_rank_mu_update``: C′ = decay·C + c_μ·Yᵀdiag(w)Y + c₁·p_c p_cᵀ, per
slot, one launch, C′ exactly symmetric (its upper triangle mirrored).  The
plain PyTorch version is ``ref.rank_mu_update``.

The wrapper takes CUDA tensors only — it checks device, dtype, shape and
contiguity and raises, it never falls back — and launches on the current
stream without synchronising.  The launch is counted under
``"cma_rank_mu_update"`` in ``_build.LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_UPDATE_ARGS = [_P] * 6 + [_I] * 3 + [_P]
#: columns of ``coef``
COEF_FIELDS = ("decay", "c_mu", "c_1")


def rank_mu_update(C, Y, w, p_c, coef):
    """C′ (S, n, n) from C (S, n, n), Y (S, λ, n), w (S, λ), p_c (S, n) and
    ``coef`` (S, 3) in ``COEF_FIELDS`` order."""
    if not C.is_cuda:
        raise ValueError("C: the CUDA kernel takes CUDA tensors, got one on "
                         f"{C.device}")
    if C.dim() != 3 or C.dtype not in _build.CMA_DTYPES or Y.dim() != 3:
        raise ValueError("C must be (S, n, n) and Y (S, lam, n), float32 or "
                         "float64")
    S, n, _ = C.shape
    lam = Y.shape[1]
    if S < 1 or n < 1:
        raise ValueError(f"empty problem: S={S}, n={n}")
    dt, dev = C.dtype, C.device
    ptrs = [_build.check("C", C, (S, n, n), dt, dev),
            _build.check("Y", Y, (S, lam, n), dt, dev),
            _build.check("w", w, (S, lam), dt, dev),
            _build.check("p_c", p_c, (S, n), dt, dev),
            _build.check("coef", coef, (S, len(COEF_FIELDS)), dt, dev)]
    C_new = torch.empty_like(C)
    _build.launch(_build.function("cma_update", "cma_rank_mu_update", dt,
                                  _UPDATE_ARGS),
                  "cma_rank_mu_update", dev, *ptrs, C_new.data_ptr(), S, lam,
                  n)
    return C_new
