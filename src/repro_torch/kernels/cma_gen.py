"""Wrappers of the hand-written CUDA generation kernels (``csrc/*.cu``).

* ``gen_sample`` — replaces ``repro/kernels/cma_gen.py::cma_gen_sample``:
  (Y, X) = (Z·diag(D)·Bᵀ, m + σ·Y), one launch of the plan
  ``sample_plan.py`` picks (FP64 tensor-core tiles, or the stream plan for
  few rows a slot).
* ``gen_sample_eval`` — replaces ``cma_gen_sample_eval``: (Y, F) with the
  separable fitness in the epilogue, X never written; one launch where one
  block spans all n columns (n ≤ 64), else two (per-block row partials,
  then a fixed-order row reduce).
* ``gen_update`` — replaces ``cma_gen_update``: (C′, p_σ′, p_c′, y_w); a
  gram pass split over tiles and chunks of population rows (FP64 tensor
  cores in float64), the vector phase (one launch up to n = 128, three
  above), then a fixed-order sum of the chunks with the C′ epilogue.  The
  split is ``update_plan``'s; the call counts as one launch.
* ``gen_sample_rng`` / ``gen_sample_rng_eval`` — replace
  ``cma_gen_sample_rng`` / ``cma_gen_sample_rng_eval``: the two sample
  kernels above on the counter stream of per-slot seeds
  (``csrc/threefry.cuh``).  Where one block spans all n columns (n ≤ 64,
  ``sample_plan.draws_z``) the kernel draws Z itself: no Z scratch, the
  launches of the Z-operand call, counted under the call's own label.  On
  wider rows the Z-only kernel first draws Z into scratch, each element
  once, then the sample kernel reads it; one call, counted under both
  kernels' labels.
* ``sample_z_rng`` — replaces ``cma_sample_z_rng``: the counter stream Z
  alone, one launch.

The RNG wrappers take ``seeds`` (S, 2) as uint32 words held in int64 (the
kernels read the low 32 bits, so a word's negative twin gives the same
stream), and ``lam`` and ``n`` below 2¹⁶ (the counter is
``(row << 16) | col``).

The design notes (what bounds each kernel and what the design does about
it) head each source file.  The plain PyTorch versions are in
``kernels/ref.py``.  Every wrapper takes CUDA tensors only — it checks
device, dtype, shape and contiguity and raises, it never falls back — and
launches on the current stream without synchronising.  ``LAUNCHES`` counts
the calls that launched each kernel.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build, sample_plan
from repro_torch.kernels._build import CMA_DTYPES as _DTYPES
from repro_torch.kernels._build import check as _check
from repro_torch.kernels._build import launch as _launch
from repro_torch.kernels.ref import RNG_MAX_DIM

#: per-slot scalar coefficients of ``gen_update``, in column order
COEF_FIELDS = ("c_sigma", "mu_eff", "c_c", "c_1", "c_mu", "chi_n", "gen1")

LAUNCHES = _build.LAUNCHES
reset_launches = _build.reset_launches

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    ("cma_gen_sample", "cma_gen_sample"): [_P] * 8 + [_I] * 5 + [_P],
    ("cma_gen_sample", "cma_gen_sample_eval"): [_P] * 14 + [_I] * 6 + [_P],
    ("cma_gen_update", "cma_gen_update"): [_P] * 17 + [_I] * 8 + [_P],
    ("cma_gen_sample", "cma_gen_sample_rng"): [_P] * 9 + [_I] * 6 + [_P],
    ("cma_gen_sample", "cma_gen_sample_rng_eval"): [_P] * 15 + [_I] * 6
    + [_P],
    ("cma_gen_sample", "cma_sample_z_rng"): [_P] * 2 + [_I] * 3 + [_P],
}
_LIB = "cma_gen_sample"


def _fn(lib_name: str, fn_name: str, dtype: torch.dtype):
    return _build.function(lib_name, fn_name, dtype,
                           _SIGNATURES[(lib_name, fn_name)])


def _sample_operands(m, sigma, B, D, Z):
    if not Z.is_cuda:
        raise ValueError("Z: the CUDA kernel takes CUDA tensors, got one on "
                         f"{Z.device}")
    if Z.dim() != 3 or Z.dtype not in _DTYPES:
        raise ValueError("Z must be (S, lam, n) float32 or float64")
    S, lam, n = Z.shape
    dt, dev = Z.dtype, Z.device
    ptrs = [_check("m", m, (S, n), dt, dev), _check("sigma", sigma, (S,), dt, dev),
            _check("B", B, (S, n, n), dt, dev), _check("D", D, (S, n), dt, dev),
            _check("Z", Z, (S, lam, n), dt, dev)]
    return (S, lam, n), dt, dev, ptrs


def _seed_words(seeds: torch.Tensor, S: int, lam: int, n: int, device) -> int:
    """Checks the counter's range, then ``seeds`` (S, 2) int64 on CUDA
    ``device``; returns its pointer (the kernels read each word's low 32
    bits)."""
    if not (0 < lam < RNG_MAX_DIM and 0 < n < RNG_MAX_DIM):
        raise ValueError(f"lam={lam} and n={n} must lie in [1, 2^16): the "
                         "counter is (row << 16) | col")
    if not seeds.is_cuda:
        raise ValueError("seeds: the CUDA kernel takes CUDA tensors, got one "
                         f"on {seeds.device}")
    if seeds.dtype != torch.int64 or seeds.dim() != 2 or seeds.shape[1] != 2:
        raise ValueError("seeds must be (S, 2) int64-held uint32 words, got "
                         f"{tuple(seeds.shape)} {seeds.dtype}")
    return _check("seeds", seeds, (S, 2), torch.int64, device)


def _rng_operands(m, sigma, B, D, seeds, lam: int):
    if B.dim() != 3 or B.dtype not in _DTYPES:
        raise ValueError("B must be (S, n, n) float32 or float64")
    S, n, _ = B.shape
    lam = int(lam)
    dt, dev = B.dtype, B.device
    seed_ptr = _seed_words(seeds, S, lam, n, dev)
    ptrs = [_check("m", m, (S, n), dt, dev), _check("sigma", sigma, (S,), dt, dev),
            _check("B", B, (S, n, n), dt, dev), _check("D", D, (S, n), dt, dev),
            seed_ptr]
    return (S, lam, n), dt, dev, ptrs


def _sep_operands(scale, shift, fopt, mode, valid, S, n, dt, dev):
    return [_check("scale", scale, (S, n), dt, dev),
            _check("shift", shift, (S, n), dt, dev),
            _check("fopt", fopt, (S,), dt, dev),
            _check("mode", mode, (S,), torch.int32, dev),
            _check("valid", valid, (S,), torch.int32, dev)]


def _f_outputs(S, lam, dt, dev, partials: int):
    """F (S, λ) and, where the plan has them, the eval partials' scratch."""
    F = torch.empty((S, lam), dtype=dt, device=dev)
    Fpart = (torch.empty(partials * S * lam, dtype=dt, device=dev)
             if partials else None)
    return F, Fpart


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def gen_sample(m, sigma, B, D, Z):
    """Y, X (S, λ, n) from m (S,n), sigma (S,), B (S,n,n), D (S,n), Z (S,λ,n)."""
    (S, lam, n), dt, dev, ptrs = _sample_operands(m, sigma, B, D, Z)
    lay = sample_plan.slot_layout(_LIB, S, lam, n, dt, dev)
    Y = torch.empty_like(Z)
    X = torch.empty_like(Z)
    _launch(_fn(_LIB, "cma_gen_sample", dt), "cma_gen_sample", dev, *ptrs,
            lay.tiles.data_ptr(), Y.data_ptr(), X.data_ptr(), lay.ntiles,
            S * lam, n, lay.plan.code, lay.tile_rows)
    return Y, X


def gen_sample_eval(m, sigma, B, D, Z, scale, shift, fopt, mode, valid):
    """Y (S, λ, n) and F (S, λ) for a separable fid: per-slot ``scale`` and
    ``shift`` (S, n), ``fopt`` (S,) in the state dtype, ``mode`` and
    ``valid`` (S,) int32."""
    (S, lam, n), dt, dev, ptrs = _sample_operands(m, sigma, B, D, Z)
    ptrs += _sep_operands(scale, shift, fopt, mode, valid, S, n, dt, dev)
    lay = sample_plan.slot_layout(_LIB, S, lam, n, dt, dev)
    Y = torch.empty_like(Z)
    F, Fpart = _f_outputs(S, lam, dt, dev, lay.plan.eval_partials)
    _launch(_fn(_LIB, "cma_gen_sample_eval", dt), "cma_gen_sample_eval", dev,
            *ptrs, lay.tiles.data_ptr(), Y.data_ptr(), F.data_ptr(),
            _ptr(Fpart), lay.ntiles, S * lam, n, lam, lay.plan.code,
            lay.tile_rows)
    return Y, F


def _rng_z(label: str, S: int, lam: int, n: int, dt, dev):
    """The Z scratch of an RNG call (None where the sample kernel draws Z)
    and the labels its launches count under."""
    if sample_plan.draws_z(n):
        return None, label
    return (torch.empty((S, lam, n), dtype=dt, device=dev),
            ("cma_sample_z_rng", label))


def gen_sample_rng(m, sigma, B, D, seeds, lam: int):
    """Y, X (S, λ, n) from m (S,n), sigma (S,), B (S,n,n), D (S,n) and the
    counter stream of ``seeds`` (S, 2), drawn on the card."""
    (S, lam, n), dt, dev, ptrs = _rng_operands(m, sigma, B, D, seeds, lam)
    lay = sample_plan.slot_layout(_LIB, S, lam, n, dt, dev, rng=True)
    Zs, labels = _rng_z("cma_gen_sample_rng", S, lam, n, dt, dev)
    Y = torch.empty((S, lam, n), dtype=dt, device=dev)
    X = torch.empty_like(Y)
    _launch(_fn(_LIB, "cma_gen_sample_rng", dt), labels, dev, *ptrs,
            _ptr(Zs), lay.tiles.data_ptr(), Y.data_ptr(), X.data_ptr(),
            lay.ntiles, S, lam, n, lay.plan.code, lay.tile_rows)
    return Y, X


def gen_sample_rng_eval(m, sigma, B, D, seeds, lam: int, scale, shift, fopt,
                        mode, valid):
    """Y (S, λ, n) and F (S, λ) from the counter stream of ``seeds`` (S, 2)
    for a separable fid laid out as in ``gen_sample_eval``."""
    (S, lam, n), dt, dev, ptrs = _rng_operands(m, sigma, B, D, seeds, lam)
    sep = _sep_operands(scale, shift, fopt, mode, valid, S, n, dt, dev)
    lay = sample_plan.slot_layout(_LIB, S, lam, n, dt, dev, rng=True)
    Zs, labels = _rng_z("cma_gen_sample_rng_eval", S, lam, n, dt, dev)
    Y = torch.empty((S, lam, n), dtype=dt, device=dev)
    F, Fpart = _f_outputs(S, lam, dt, dev, lay.plan.eval_partials)
    _launch(_fn(_LIB, "cma_gen_sample_rng_eval", dt), labels, dev, *ptrs,
            _ptr(Zs), *sep, lay.tiles.data_ptr(), Y.data_ptr(), F.data_ptr(),
            _ptr(Fpart), lay.ntiles, S, lam, n, lay.plan.code,
            lay.tile_rows)
    return Y, F


def sample_z_rng(seeds, lam: int, n: int, dtype=torch.float64):
    """The counter stream Z (S, λ, n) of ``seeds`` (S, 2) in ``dtype``."""
    lam, n = int(lam), int(n)
    S = seeds.shape[0] if seeds.dim() == 2 else -1
    ptr = _seed_words(seeds, S, lam, n, seeds.device)
    if dtype not in _DTYPES:
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    Z = torch.empty((S, lam, n), dtype=dtype, device=seeds.device)
    _launch(_fn(_LIB, "cma_sample_z_rng", dtype), "cma_sample_z_rng",
            seeds.device, ptr, Z.data_ptr(), S, lam, n)
    return Z


#: ``update_plan``'s constants, mirrored in ``csrc/gram_gemm.cuh`` (the
#: gram split that rows 6 and 8 share) and ``csrc/cma_gen_update.cu``: the
#: C′ tile edge, the population rows of a stage, the most rows a chunk may
#: hold, the largest n of the one-block vector phase, the rows of B per
#: block of its two-launch form (Bᵀy_w, then whiten), and the gram blocks
#: the split aims for (two per SM of an H100)
TILE, STAGE_ROWS, MAX_CHUNK_ROWS = 64, 16, 1024
SMALL_N, T_ROWS, W_ROWS = 128, 128, 8
TARGET_BLOCKS = 2 * 132
EPI_THREADS = 256


@dataclass(frozen=True)
class UpdatePlan:
    """How ``gen_update`` cuts one call: chunk c covers population rows
    [c·chunk_rows, min(λ, (c+1)·chunk_rows)); the gram pass runs one block
    per (upper-triangle tile, chunk, slot).  ``t_splits`` is 0 when one
    block per slot does the vector phase; ``psq_parts`` is the number of
    |p_σ′|² partials; ``lanes`` the chunk lanes of an epilogue block."""
    S: int
    lam: int
    n: int
    tiles: int
    chunk_rows: int
    chunks: int
    t_splits: int
    psq_parts: int
    lanes: int

    @property
    def gram_blocks(self) -> int:
        return self.S * self.tiles * self.chunks

    def scratch(self) -> dict[str, int]:
        """Elements of each scratch array, in the order they are laid out
        in one buffer: the partial tiles, the partial y_w, the row-split
        partials of Bᵀy_w, the |p_σ′|² partials and (decay, pull)."""
        S, n = self.S, self.n
        return {"gram": S * self.chunks * self.tiles * TILE * TILE,
                "y_w": S * self.chunks * n,
                "t": S * max(self.t_splits, 1) * n,
                "psq": S * self.psq_parts, "scal": S * 2}

    def chunk_bounds(self) -> list[tuple[int, int]]:
        return [(c * self.chunk_rows, min(self.lam, (c + 1) * self.chunk_rows))
                for c in range(self.chunks)]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def update_plan(S: int, lam: int, n: int) -> UpdatePlan:
    """The split of one ``gen_update`` call at (S, λ, n): as many chunks
    (whole stages of rows, at most ``MAX_CHUNK_ROWS`` each) as it takes to
    reach ``TARGET_BLOCKS`` gram blocks, no more than one a stage."""
    nt = _cdiv(n, TILE)
    tiles = nt * (nt + 1) // 2
    want = max(_cdiv(TARGET_BLOCKS, S * tiles), _cdiv(lam, MAX_CHUNK_ROWS))
    chunks = max(1, min(want, _cdiv(lam, STAGE_ROWS)))
    chunk_rows = _cdiv(_cdiv(lam, chunks), STAGE_ROWS) * STAGE_ROWS
    chunks = _cdiv(lam, chunk_rows)
    small = n <= SMALL_N
    lanes = 1
    while lanes < min(chunks, 8):
        lanes *= 2
    return UpdatePlan(S=S, lam=lam, n=n, tiles=tiles, chunk_rows=chunk_rows,
                      chunks=chunks, t_splits=0 if small else _cdiv(n, T_ROWS),
                      psq_parts=1 if small else _cdiv(n, W_ROWS), lanes=lanes)


def gen_update(C, B, D, p_sigma, p_c, Y, w, coef):
    """(C′, p_σ′, p_c′, y_w) from C, B (S,n,n), D, p_sigma, p_c (S,n),
    Y (S,λ,n), w (S,λ) and ``coef`` (S, 7) in ``COEF_FIELDS`` order."""
    if not C.is_cuda:
        raise ValueError("C: the CUDA kernel takes CUDA tensors, got one on "
                         f"{C.device}")
    if C.dim() != 3 or C.dtype not in _DTYPES:
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
    plan = update_plan(S, lam, n)
    C_new = torch.empty_like(C)
    ps_new, pc_new, y_w = torch.empty((3, S, n), dtype=dt,
                                      device=dev).unbind(0)
    sizes = plan.scratch()
    scratch = torch.empty(sum(sizes.values()), dtype=dt, device=dev)
    offsets = [0]
    for size in list(sizes.values())[:-1]:
        offsets.append(offsets[-1] + size)
    base, esz = scratch.data_ptr(), scratch.element_size()
    _launch(_fn("cma_gen_update", "cma_gen_update", dt), "cma_gen_update",
            dev, *ptrs, C_new.data_ptr(), ps_new.data_ptr(), pc_new.data_ptr(),
            y_w.data_ptr(), *(base + esz * o for o in offsets), S, lam, n,
            plan.chunk_rows, plan.chunks, plan.t_splits, plan.psq_parts,
            plan.lanes)
    return C_new, ps_new, pc_new, y_w
