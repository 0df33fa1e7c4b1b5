"""Wrapper of the hand-written grouped sample kernel (``csrc/cma_sample.cu``).

``sample_groups`` replaces ``repro/kernels/cma_sample.py::cma_sample``:
X = m + σ·(Z·diag D)·Bᵀ, or Y = (Z·diag D)·Bᵀ without m and σ (the
``sample_transform`` form), over a population whose contiguous row ranges
belong to different state slots (the descents of the strategies path).
One launch of the plan ``sample_plan.py`` picks from the largest group
(the design it shares with rows 1-4 is ``csrc/sample_gemm.cuh``).  The
plain PyTorch version is ``ref.sample_groups``.

The wrapper takes CUDA tensors only — it checks device, dtype, shape and
contiguity and raises, it never falls back — and launches on the current
stream without synchronising.  The launch is counted under ``"cma_sample"``
in ``_build.LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, sample_plan

_P, _I = ctypes.c_void_p, ctypes.c_int
_SAMPLE_ARGS = [_P] * 7 + [_I] * 5 + [_P]
_LIB = "cma_sample"


def check_starts(starts, G: int, R: int) -> tuple:
    """``starts`` as a tuple of G + 1 ints from 0 to R, never decreasing."""
    starts = tuple(int(s) for s in starts)
    if (len(starts) != G + 1 or starts[0] != 0 or starts[-1] != R
            or any(b < a for a, b in zip(starts, starts[1:]))):
        raise ValueError(f"starts {starts} must run from 0 to {R} in {G} "
                         "non-decreasing steps")
    return starts


def sample_groups(B, D, Z, starts, m=None, sigma=None):
    """X (R, n): row r of Z (R, n) with the state of group g, where
    ``starts[g] <= r < starts[g + 1]``: ``m[g] + sigma[g]·(Z[r]·D[g])·B[g]ᵀ``,
    or ``(Z[r]·D[g])·B[g]ᵀ`` when m and sigma are None.  B (G, n, n),
    D (G, n), m (G, n), sigma (G,); ``starts`` G + 1 row offsets."""
    if not Z.is_cuda:
        raise ValueError("Z: the CUDA kernel takes CUDA tensors, got one on "
                         f"{Z.device}")
    if Z.dim() != 2 or Z.dtype not in _build.CMA_DTYPES or B.dim() != 3:
        raise ValueError("Z must be (R, n) and B (G, n, n), float32 or "
                         "float64")
    if (m is None) != (sigma is None):
        raise ValueError("give both m and sigma, or neither")
    R, n = Z.shape
    G = B.shape[0]
    dt, dev = Z.dtype, Z.device
    starts = check_starts(starts, G, R)
    ptrs = [0 if m is None else _build.check("m", m, (G, n), dt, dev),
            0 if sigma is None else _build.check("sigma", sigma, (G,), dt,
                                                 dev),
            _build.check("B", B, (G, n, n), dt, dev),
            _build.check("D", D, (G, n), dt, dev),
            _build.check("Z", Z, (R, n), dt, dev)]
    X = torch.empty_like(Z)
    if R == 0:
        return X
    lay = sample_plan.layout(_LIB, starts, n, dt, dev)
    _build.launch(_build.function(_LIB, "cma_sample", dt, _SAMPLE_ARGS),
                  "cma_sample", dev, *ptrs, lay.tiles.data_ptr(),
                  X.data_ptr(), lay.ntiles, R, n, lay.plan.code,
                  lay.tile_rows)
    return X
