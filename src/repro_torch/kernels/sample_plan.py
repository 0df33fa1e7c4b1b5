"""How one call of the sample kernels is cut: rows 1-4 (``cma_gen.py``,
slot-batched) and row 7 (``cma_sample.py``, grouped rows) share one design
(``csrc/sample_gemm.cuh``) and this plan.

* The **tile plan** — one block per ``TILE_ROWS`` × ``TILE_COLS`` output
  tile, FP64 tensor cores in float64 — when some group has more than
  ``STREAM_ROWS`` rows, or when one tile spans all n columns
  (n ≤ ``TILE_COLS``: each row is finished in one block).
* The **stream plan** — one block per ``STREAM_COLS`` rows of B (output
  columns) and group, holding all of its group's rows — when every group
  has at most ``STREAM_ROWS`` rows and n > ``TILE_COLS``: the call is then
  a batched GEMV bound by reading each group's B once.

Both plans compute every element in the same steps, so the plan a call
takes does not change its bits: a call of λ rows gives the first rows of a
wider call, as the RNG tier's bucket property needs.

The RNG calls (rows 3-4) draw Z inside the kernel where one block spans
the row (``draws_z``: n ≤ ``TILE_COLS``, always the tile plan); wider rows
take row 5's Z from device memory.  Since every element's bits depend only
on (seed, row, column), a drawing call may cut its row tiles shorter than
the Z-operand call (``rng_tile_rows``): a block then draws its whole tile
alone, so the tiles hold ``RNG_ROWS`` rows and a call has more blocks to
draw in.

Pure Python, so the CPU tests check it.  The four constants mirror the
kernel's: ``check_library`` reads them back from each built library
through its query entry point before the first launch of a shape, and a
CPU test reads them from the source.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

TILE_ROWS, TILE_COLS = 64, 64
STREAM_ROWS, STREAM_COLS = 96, 8
#: the constants in the order of the kernels' ``*_constant(which)`` query
CONSTANTS = ("TILE_ROWS", "TILE_COLS", "STREAM_ROWS", "STREAM_COLS")
#: the row tiles of an RNG call that draws Z in the kernel
RNG_ROWS = 8
#: the plans, in the order of the kernels' ``kind`` code
KINDS = ("tile", "stream")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class SamplePlan:
    """``kind`` is ``"tile"`` or ``"stream"`` at width ``n``; a row tile
    (an entry of the table) holds at most ``rows`` rows of one group, a
    block ``cols`` output columns, ``col_tiles`` blocks cover n."""
    kind: str
    n: int
    rows: int
    cols: int
    col_tiles: int

    @property
    def code(self) -> int:
        return KINDS.index(self.kind)

    @property
    def eval_partials(self) -> int:
        """Row partials of the eval form: 0 where one block spans all
        columns and finishes F itself, else one per F group of
        ``STREAM_COLS`` columns (both plans sum F over the same groups, so
        a row's F has the same bits in either)."""
        return 0 if self.col_tiles == 1 else _cdiv(self.n, STREAM_COLS)


@functools.lru_cache(maxsize=256)
def sample_plan(rows_per_group: int, groups: int, n: int,
                dtype: torch.dtype) -> SamplePlan:
    """The plan of a call whose largest group has ``rows_per_group`` rows,
    over ``groups`` groups (slots or descents) of width n in ``dtype``."""
    if dtype not in _build.CMA_DTYPES:
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    if rows_per_group <= STREAM_ROWS and n > TILE_COLS:
        kind, rows, cols = "stream", STREAM_ROWS, STREAM_COLS
    else:
        kind, rows, cols = "tile", TILE_ROWS, TILE_COLS
    return SamplePlan(kind=kind, n=n, rows=rows, cols=cols,
                      col_tiles=_cdiv(n, cols))


def draws_z(n: int) -> bool:
    """Whether an RNG call at width n draws Z inside the sample kernel (one
    column block spans the row), as the kernel's ``draws_z``."""
    return n <= TILE_COLS


def rng_tile_rows(plan: SamplePlan) -> int:
    """The row tiles of an RNG call: ``RNG_ROWS`` where it draws Z in the
    kernel, else the plan's."""
    return RNG_ROWS if draws_z(plan.n) else plan.rows


@functools.lru_cache(maxsize=64)
def tile_table(starts: tuple, tile_rows: int, device: torch.device):
    """(group, first row, end row) of every row tile, at most ``tile_rows``
    rows each and none crossing a group boundary: (ntiles, 3) int32 on
    ``device``, made once per layout."""
    rows = [(g, r, min(r + tile_rows, b))
            for g, (a, b) in enumerate(zip(starts, starts[1:]))
            for r in range(a, b, tile_rows)]
    return torch.tensor(rows, dtype=torch.int32,
                        device=device).reshape(-1, 3)


class Layout(NamedTuple):
    """One shape's plan, its row-tile table, the table's length and the
    most rows of an entry (the stream plan sizes its shared memory by
    it)."""
    plan: SamplePlan
    tiles: torch.Tensor
    ntiles: int
    tile_rows: int


def check_library(lib_name: str, dtype: torch.dtype) -> None:
    """Raise unless library ``lib_name`` was built with this module's
    constants (its ``<lib_name>_constant`` entry point)."""
    query = _build.function(lib_name, f"{lib_name}_constant", dtype,
                            [ctypes.c_int])
    got = {name: query(i) for i, name in enumerate(CONSTANTS)}
    want = {name: globals()[name] for name in CONSTANTS}
    if got != want:
        raise RuntimeError(f"{lib_name} was built with the plan constants "
                           f"{got}; sample_plan.py has {want}")


@functools.lru_cache(maxsize=256)
def layout(lib_name: str, starts: tuple, n: int, dtype: torch.dtype,
           device: torch.device, rng: bool = False) -> Layout:
    """The layout of a call over the row ranges ``starts`` (G + 1 offsets)
    at width n, for the kernels of ``lib_name`` on ``device``, with the
    RNG calls' row tiles where ``rng``; the library's constants are checked
    once per shape."""
    sizes = [b - a for a, b in zip(starts, starts[1:])]
    largest = max(sizes, default=0)
    plan = sample_plan(largest, len(sizes), n, dtype)
    if device.type == "cuda":
        check_library(lib_name, dtype)
    rows = rng_tile_rows(plan) if rng else plan.rows
    tiles = tile_table(starts, rows, device)
    return Layout(plan, tiles, tiles.shape[0], min(largest, rows))


@functools.lru_cache(maxsize=256)
def slot_layout(lib_name: str, S: int, lam: int, n: int, dtype: torch.dtype,
                device: torch.device, rng: bool = False) -> Layout:
    """``layout`` of S slots of λ rows each."""
    return layout(lib_name, tuple(range(0, S * lam + 1, lam)), n, dtype,
                  device, rng)
