"""Wrapper of the hand-written rank-μ update kernel (``csrc/cma_update.cu``).

``rank_mu_update`` replaces ``repro/kernels/cma_update.py::
cma_rank_mu_update``: C′ = decay·C + c_μ·Yᵀdiag(w)Y + c₁·p_c p_cᵀ, per
slot, C′ exactly symmetric (its upper triangle mirrored).  One call is two
launches: row 6's gram (``csrc/gram_gemm.cuh``) split over chunks of
population rows by ``rank_mu_plan``, then an epilogue that sums the chunks
in order; where the plan takes one chunk, the gram's blocks write C′
themselves in one launch.  The plain PyTorch version is
``ref.rank_mu_update``.

The wrapper takes CUDA tensors only — it checks device, dtype, shape and
contiguity and raises, it never falls back — and launches on the current
stream without synchronising.  The call is counted under
``"cma_rank_mu_update"`` in ``_build.LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build, cma_gen

_P, _I = ctypes.c_void_p, ctypes.c_int
_UPDATE_ARGS = [_P] * 7 + [_I] * 6 + [_P]
#: columns of ``coef``
COEF_FIELDS = ("decay", "c_mu", "c_1")


#: up to this many chunks, one epilogue thread sums an element's partials
#: alone, so that an epilogue block holds four whole rows of a tile and
#: writes their mirror as 32-byte runs
SERIAL_CHUNKS = 4
#: up to this many population rows a call takes one chunk: a gram block
#: walks at most 16 stages, and writes C′ from its registers (one launch,
#: no partial tiles to write and read back)
ONE_CHUNK_ROWS = 256


@functools.lru_cache(maxsize=256)
def rank_mu_plan(S: int, lam: int, n: int) -> cma_gen.UpdatePlan:
    """The gram split of one call at (S, λ, n): one chunk up to
    ``ONE_CHUNK_ROWS`` rows, else row 6's chunks (``cma_gen.update_plan``)
    with one chunk lane in the epilogue up to ``SERIAL_CHUNKS`` chunks."""
    plan = cma_gen.update_plan(S, lam, n)
    if lam <= ONE_CHUNK_ROWS:
        rows = max(1, -(-lam // cma_gen.STAGE_ROWS)) * cma_gen.STAGE_ROWS
        return dataclasses.replace(plan, chunk_rows=rows, chunks=1, lanes=1)
    if plan.chunks <= SERIAL_CHUNKS:
        plan = dataclasses.replace(plan, lanes=1)
    return plan


def gram_scratch(plan: cma_gen.UpdatePlan) -> int:
    """Elements of a call's partial-gram scratch: a 64 × 64 tile a gram
    block, none with one chunk."""
    return plan.gram_blocks * cma_gen.TILE ** 2 if plan.chunks > 1 else 0


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
    plan = rank_mu_plan(S, lam, n)
    C_new = torch.empty_like(C)
    size = gram_scratch(plan)
    gram = torch.empty(size, dtype=dt, device=dev) if size else None
    _build.launch(_build.function("cma_update", "cma_rank_mu_update", dt,
                                  _UPDATE_ARGS),
                  "cma_rank_mu_update", dev, *ptrs, C_new.data_ptr(),
                  gram.data_ptr() if size else None, S, lam, n,
                  plan.chunk_rows, plan.chunks, plan.lanes)
    return C_new
