"""The split of the generation update kernel (row 6) over population rows.

``cma_gen.update_plan`` sizes the scratch of ``gen_update`` and the grid
of its gram pass from (S, λ, n) alone; the CUDA kernel takes the plan as
it is.  Checked at every shape ``chip_smoke.py`` phase 2 launches the
kernel at: the full-size ladder paths (n = 1000 and n = 40, λ = 3072), the
two ragged shapes, and every bucket of the bucketed paths."""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import cma_gen

LAM_START, KMAX = 12, 8
SHAPES = ([(1, LAM_START << KMAX, 1000), (1, LAM_START << KMAX, 40),
           (3, 37, 45), (2, 37, 101), (1, LAM_START, 1000)]
          + [(1, LAM_START << k, 40) for k in range(KMAX)])
#: SMs of an H100: the full-size shapes must fill them
SMS = 132
SOURCE = (Path(cma_gen.__file__).parent / "csrc" / "cma_gen_update.cu")
#: the plan's constants and their names in the CUDA source
MIRRORED = {"TILE": "BT", "STAGE_ROWS": "BK",
            "MAX_CHUNK_ROWS": "MAX_CHUNK_ROWS", "T_ROWS": "T_ROWS",
            "W_ROWS": "W_ROWS", "EPI_THREADS": "EPI_THREADS"}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_every_row_in_exactly_one_chunk_in_order(shape):
    S, lam, n = shape
    plan = cma_gen.update_plan(S, lam, n)
    bounds = plan.chunk_bounds()
    assert len(bounds) == plan.chunks >= 1
    rows = [r for lo, hi in bounds for r in range(lo, hi)]
    assert rows == list(range(lam))
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_chunks_fit_the_kernel(shape):
    """Whole stages of rows, a chunk's row list fits its shared memory,
    the epilogue's chunk lanes divide its threads, and the vector phase
    takes one block per slot exactly up to ``SMALL_N``."""
    S, lam, n = shape
    plan = cma_gen.update_plan(S, lam, n)
    assert plan.chunk_rows % cma_gen.STAGE_ROWS == 0
    assert plan.chunk_rows <= cma_gen.MAX_CHUNK_ROWS
    assert plan.chunks * plan.chunk_rows >= lam
    assert (plan.chunks - 1) * plan.chunk_rows < lam
    assert cma_gen.EPI_THREADS % plan.lanes == 0
    assert plan.lanes >= min(plan.chunks, 8)
    nt = -(-n // cma_gen.TILE)
    assert plan.tiles == nt * (nt + 1) // 2
    if n <= cma_gen.SMALL_N:
        assert (plan.t_splits, plan.psq_parts) == (0, 1)
    else:
        assert plan.t_splits == -(-n // cma_gen.T_ROWS)
        assert plan.psq_parts == -(-n // cma_gen.W_ROWS)


@pytest.mark.parametrize("n", [40, 1000])
def test_full_population_fills_the_card(n):
    plan = cma_gen.update_plan(1, LAM_START << KMAX, n)
    assert plan.gram_blocks >= SMS
    assert plan.t_splits * -(-n // 32) >= SMS or n <= cma_gen.SMALL_N


@pytest.mark.parametrize("name", MIRRORED)
def test_plan_constants_match_the_kernel(name):
    """``update_plan`` and the kernel it sizes read the same constant."""
    cu = dict(re.findall(r"constexpr int (\w+) = (\d+);",
                         SOURCE.read_text()))
    assert int(cu[MIRRORED[name]]) == getattr(cma_gen, name)
