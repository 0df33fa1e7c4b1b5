"""The plan of the sample kernels (rows 1-4 and 7, ``kernels/sample_plan.py``).

``sample_plan`` picks the kernel's plan from (rows of the largest group,
groups, n, dtype) alone, and the wrappers cut the row-tile table by it.
Checked at every shape ``chip_smoke.py`` phase 5 times the two kernels at:
the stream plan for few rows a group at n = 1000 (λ ≤ 48 and every
K-Replicated phase), the tile plan at λ = 3072 and wherever one tile spans
the row (n ≤ 64).  The plan's constants are the kernel's: read here from
``csrc/sample_gemm.cuh``, and on the card from each library's query entry
point (``sample_plan.check_library``).

The RNG calls (rows 3-4) draw Z inside the kernel where one column block
spans the row (``sample_plan.draws_z``), in row tiles of their own
(``rng_tile_rows``); wider rows take the Z-operand call's layout on row
5's Z.  Checked here: where a call draws, the kernel's draw policy may run
(the tile plan, one column block, every k of the row in its slab ring), and
every row tile covers the slot."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import sample_plan
from torch_threads import one_thread  # noqa: F401

SOURCE = Path(sample_plan.__file__).parent / "csrc" / "sample_gemm.cuh"
CPU = torch.device("cpu")
#: SMs of an H100
SMS = 132
LAM_START, KMAX = 12, 8
#: (label, rows of the largest group, groups, n, plan): rows 1-4 at the
#: paths' shapes, row 7 at K-Distributed's heap (nine descents of 12 to
#: 3072 rows), K-Replicated's phases at n = 1000 (8 x 12 ... 1 x 96 rows)
#: and the small card runs (n = 8)
SHAPES = ([("main_path_f8", 3072, 1, 1000, "tile"),
           ("ipop_f1_restarts", 3072, 1, 40, "tile"),
           ("bucketed_rng_f8", 12, 1, 1000, "stream")]
          + [(f"bucket_lam{LAM_START << k}", LAM_START << k, 1, 40, "tile")
             for k in range(KMAX)]
          + [(f"lam{lam}_n1000", lam, 1, 1000, "stream")
             for lam in (12, 24, 48)]
          + [("strategies_kdist_f8", 3072, 9, 1000, "tile")]
          + [(f"krep_n1000_G{8 >> k}", 12 << k, 8 >> k, 1000, "stream")
             for k in range(4)]
          + [("kdist_small", 64, 3, 8, "tile"),
             ("krep_small", 16, 8, 8, "tile")])


def blocks(plan, rows, groups):
    """The blocks of a launch whose ``groups`` groups have ``rows`` rows."""
    return groups * -(-rows // plan.rows) * plan.col_tiles


@pytest.mark.parametrize("label,rows,groups,n,kind", SHAPES,
                         ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plan_at_every_path_shape(label, rows, groups, n, kind, dtype):
    plan = sample_plan.sample_plan(rows, groups, n, dtype)
    assert plan.kind == kind
    assert plan.code == sample_plan.KINDS.index(kind)
    assert plan.col_tiles * plan.cols >= n > (plan.col_tiles - 1) * plan.cols
    if kind == "stream":
        # every group fits one block's rows, and B's rows are spread over
        # blocks of STREAM_COLS: 125 a group at n = 1000
        assert rows <= plan.rows == sample_plan.STREAM_ROWS
        assert plan.col_tiles == -(-n // sample_plan.STREAM_COLS)
        assert blocks(plan, rows, groups) >= 0.9 * SMS
    else:
        assert plan.rows == sample_plan.TILE_ROWS
    # one block spans the row exactly where the eval form needs no
    # partials; otherwise one per 8-column F group, whatever the plan
    assert (plan.eval_partials == 0) == (n <= plan.cols)
    assert plan.eval_partials in (0, -(-n // sample_plan.STREAM_COLS))


def test_full_width_tile_plan_fills_the_card():
    for rows, groups in ((3072, 1), (3072, 9)):
        plan = sample_plan.sample_plan(rows, groups, 1000, torch.float64)
        assert blocks(plan, rows, groups) >= 4 * SMS


def test_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        sample_plan.sample_plan(12, 1, 1000, torch.float16)


@pytest.mark.parametrize("starts,n", [((0, 12, 36, 84, 92), 1000),
                                      ((0, 0, 130, 131), 1000),
                                      ((0, 96, 192), 1000),
                                      ((0, 12, 24, 3096), 1000),
                                      ((0, 37, 74, 111), 45)])
def test_layout_table_follows_the_plan(starts, n):
    """Every row of every group in exactly one table entry of at most the
    plan's rows, in order; the stream plan holds each non-empty group in
    one entry, and ``tile_rows`` is the largest entry."""
    lay = sample_plan.layout("cma_sample", starts, n, torch.float64, CPU)
    covered = []
    for g, r0, r1 in lay.tiles.tolist():
        assert starts[g] <= r0 < r1 <= starts[g + 1]
        assert r1 - r0 <= lay.plan.rows
        covered += list(range(r0, r1))
    assert covered == list(range(starts[-1]))
    assert lay.ntiles == lay.tiles.shape[0]
    assert lay.tile_rows == max(r1 - r0 for _, r0, r1 in lay.tiles.tolist())
    if lay.plan.kind == "stream":
        assert lay.ntiles == sum(b > a for a, b in zip(starts, starts[1:]))


def test_slot_layout_is_the_slot_ranges():
    lay = sample_plan.slot_layout("cma_gen_sample", 3, 37, 45, torch.float32,
                                  CPU)
    assert lay.plan.kind == "tile"
    assert [tuple(t) for t in lay.tiles.tolist()] == [(0, 0, 37), (1, 37, 74),
                                                      (2, 74, 111)]
    lay = sample_plan.slot_layout("cma_gen_sample", 2, 12, 1000,
                                  torch.float64, CPU)
    assert lay.plan.kind == "stream" and lay.tile_rows == 12
    assert [tuple(t) for t in lay.tiles.tolist()] == [(0, 0, 12), (1, 12, 24)]


@pytest.mark.parametrize("name", sample_plan.CONSTANTS)
def test_plan_constants_match_the_kernel(name):
    """The plan and the kernel it cuts for read the same constant, and the
    kernel's query entry point answers in ``CONSTANTS`` order."""
    text = SOURCE.read_text()
    cu = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(cu[name]) == getattr(sample_plan, name)
    query = re.search(r"case (\d+): return " + name + ";", text)
    assert int(query.group(1)) == sample_plan.CONSTANTS.index(name)


#: the widths and rows an RNG call may have
DRAW_NS = (8, 40, 64, 65, 101, 1000)
DRAW_LAMS = (1, 12, 37, 96, 192, 3072)


def header_constants():
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", SOURCE.read_text())}


@pytest.mark.parametrize("n", DRAW_NS)
@pytest.mark.parametrize("lam", DRAW_LAMS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rng_call_draws_where_one_block_spans_the_row(n, lam, dtype):
    """An RNG call draws Z in the kernel exactly where the kernel's draw
    policy may run: the tile plan with one column block, every k of the
    row in the ring's ``STAGES`` slabs of ``BK`` columns, and the eval form
    finishing F in the block (one launch, as its Z-operand call).
    Elsewhere its layout is the Z-operand call's, which reads row 5's Z."""
    cu = header_constants()
    plain = sample_plan.slot_layout("cma_gen_sample", 1, lam, n, dtype, CPU)
    lay = sample_plan.slot_layout("cma_gen_sample", 1, lam, n, dtype, CPU,
                                  rng=True)
    assert lay.plan == plain.plan
    if sample_plan.draws_z(n):
        assert n <= cu["TILE_COLS"] <= cu["STAGES"] * cu["BK"]
        assert lay.plan.kind == "tile" and lay.plan.col_tiles == 1
        assert lay.plan.eval_partials == 0
        assert lay.tile_rows <= sample_plan.RNG_ROWS <= cu["TILE_ROWS"]
    else:
        assert n > cu["TILE_COLS"]
        assert lay.tile_rows == plain.tile_rows
        assert torch.equal(lay.tiles, plain.tiles)


def test_draw_rule_matches_the_kernel():
    """``draws_z`` is the kernel's rule, and the kernel's ring holds a
    whole row where it draws."""
    text = SOURCE.read_text()
    rule = re.search(r"constexpr bool draws_z\(int n\) \{ return ([^;]*);",
                     text)
    assert rule.group(1) == "n <= TILE_COLS"
    assert "static_assert(STAGES * BK >= TILE_COLS" in text
    cols = sample_plan.TILE_COLS
    assert sample_plan.draws_z(cols) and not sample_plan.draws_z(cols + 1)


@pytest.mark.parametrize("lam", DRAW_LAMS)
@pytest.mark.parametrize("n", [40, 64, 65, 1000])
def test_rng_row_tiles_cover_the_slot(lam, n):
    """An RNG call's table covers every row once, in order; where it draws
    Z in the kernel its tiles hold ``RNG_ROWS`` rows, elsewhere the plan's,
    as the Z-operand call's table does."""
    plain = sample_plan.slot_layout("cma_gen_sample", 1, lam, n,
                                    torch.float64, CPU)
    lay = sample_plan.slot_layout("cma_gen_sample", 1, lam, n, torch.float64,
                                  CPU, rng=True)
    rows = sample_plan.rng_tile_rows(lay.plan)
    covered = []
    for _, r0, r1 in lay.tiles.tolist():
        assert r1 - r0 <= rows
        covered += list(range(r0, r1))
    assert covered == list(range(lam))
    if n <= sample_plan.TILE_COLS:
        assert rows == sample_plan.RNG_ROWS
        assert lay.ntiles == -(-lam // sample_plan.RNG_ROWS)
    else:
        assert rows == lay.plan.rows and lay.ntiles == plain.ntiles
