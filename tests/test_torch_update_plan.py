"""The split of the generation update kernel (row 6) and of the rank-μ
update kernel (row 8) over population rows.

``cma_gen.update_plan`` sizes the scratch of ``gen_update`` and the grid
of its gram pass from (S, λ, n) alone; ``cma_update.rank_mu_plan`` is the
same split for row 8, whose gram is row 6's (``csrc/gram_gemm.cuh``); the
CUDA kernels take the plan as it is.  Checked at every shape
``chip_smoke.py`` phase 2 launches the kernels at: for row 6 the full-size
ladder paths (n = 1000 and n = 40, λ = 3072), the two ragged shapes, and
every bucket of the bucketed paths; for row 8 (λ, n) = (12, 1000),
(3072, 1000) and (192, 40), with one slot and with a second slot of zero
weights."""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import cma_gen, cma_update
from torch_threads import one_thread  # noqa: F401

LAM_START, KMAX = 12, 8
SHAPES = ([(1, LAM_START << KMAX, 1000), (1, LAM_START << KMAX, 40),
           (3, 37, 45), (2, 37, 101), (1, LAM_START, 1000)]
          + [(1, LAM_START << k, 40) for k in range(KMAX)])
RANK_MU_SHAPES = [(S, lam, n) for S in (1, 2)
                  for lam, n in ((12, 1000), (3072, 1000), (192, 40))]
#: SMs of an H100: the full-size shapes must fill them
SMS = 132
CSRC = Path(cma_gen.__file__).parent / "csrc"
#: the shared gram (rows 6 and 8) and row 6's vector phase
HEADER = CSRC / "gram_gemm.cuh"
SOURCE = CSRC / "cma_gen_update.cu"
#: the plan's constants and their names in the CUDA sources
MIRRORED = {"TILE": "BT", "STAGE_ROWS": "BK",
            "MAX_CHUNK_ROWS": "MAX_CHUNK_ROWS", "T_ROWS": "T_ROWS",
            "W_ROWS": "W_ROWS", "EPI_THREADS": "EPI_THREADS"}


def _constants(*paths):
    """Every namespace-scope ``constexpr int NAME = VALUE;`` of the files,
    by name; a name defined twice would be two values of one constant."""
    found = [m for p in paths
             for m in re.findall(r"^constexpr int (\w+) = (\d+);",
                                 p.read_text(), flags=re.MULTILINE)]
    names = [name for name, _ in found]
    assert len(names) == len(set(names)), names
    return dict(found)


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
    """``update_plan`` and the kernels it sizes read the same constant,
    defined once: the gram's in ``gram_gemm.cuh``, the vector phase's in
    ``cma_gen_update.cu``."""
    cu = _constants(HEADER, SOURCE)
    assert int(cu[MIRRORED[name]]) == getattr(cma_gen, name)


@pytest.mark.parametrize("source", ["cma_gen_update.cu", "cma_update.cu"])
def test_rows_6_and_8_share_one_gram(source):
    """Both update kernels take the gram and its epilogue from the shared
    header and define none of its constants themselves."""
    text = (CSRC / source).read_text()
    assert '#include "gram_gemm.cuh"' in text
    assert "gram::launch_gram" in text and "gram::epilogue_tile" in text
    assert not set(_constants(CSRC / source)) & set(_constants(HEADER))


@pytest.mark.parametrize("shape", RANK_MU_SHAPES, ids=str)
def test_rank_mu_rows_in_exactly_one_chunk_in_order(shape):
    plan = cma_update.rank_mu_plan(*shape)
    bounds = plan.chunk_bounds()
    assert len(bounds) == plan.chunks >= 1
    assert [r for lo, hi in bounds for r in range(lo, hi)] == \
        list(range(shape[1]))
    assert all(lo < hi for lo, hi in bounds)


@pytest.mark.parametrize("shape", RANK_MU_SHAPES, ids=str)
def test_rank_mu_plan_fits_the_kernels(shape):
    """Row 8 cuts a large population as row 6 does and a small one into a
    single chunk, fits the kernel's row list and epilogue, sums a few
    chunks in one lane (so an epilogue block holds whole rows) and sizes
    its scratch as one partial tile per gram block, none with one chunk."""
    plan = cma_update.rank_mu_plan(*shape)
    six = cma_gen.update_plan(*shape)
    assert plan.tiles == six.tiles
    if shape[1] > cma_update.ONE_CHUNK_ROWS:
        assert (plan.chunk_rows, plan.chunks) == (six.chunk_rows, six.chunks)
    else:
        assert plan.chunks == 1 and plan.chunk_rows >= shape[1]
    assert plan.chunk_rows % cma_gen.STAGE_ROWS == 0
    assert plan.chunk_rows <= cma_gen.MAX_CHUNK_ROWS
    assert cma_gen.EPI_THREADS % plan.lanes == 0
    assert plan.lanes == (1 if plan.chunks <= cma_update.SERIAL_CHUNKS
                          else six.lanes)
    assert cma_update.gram_scratch(plan) == (
        plan.scratch()["gram"] if plan.chunks > 1 else 0)


@pytest.mark.parametrize("lam", [1, 12, 192, 256, 257, 3072], ids=str)
def test_rank_mu_one_chunk_up_to_its_rows(lam):
    """Up to ``ONE_CHUNK_ROWS`` population rows one chunk holds them all
    (one launch, no scratch); above, row 6's split decides."""
    plan = cma_update.rank_mu_plan(1, lam, 40)
    assert (plan.chunks == 1) == (lam <= cma_update.ONE_CHUNK_ROWS
                                  or cma_gen.update_plan(1, lam, 40).chunks
                                  == 1)
    assert (cma_update.gram_scratch(plan) == 0) == (plan.chunks == 1)
    assert plan.chunks * plan.chunk_rows >= lam


def test_rank_mu_full_population_fills_the_card():
    """At (1, 3072, 1000) the gram runs at least one block per SM."""
    plan = cma_update.rank_mu_plan(1, LAM_START << KMAX, 1000)
    assert plan.chunks > 1
    assert plan.gram_blocks >= SMS
