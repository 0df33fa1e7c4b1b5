"""The layout of the RWKV-6 WKV kernel (row 10, ``csrc/rwkv6_wkv.cu``).

A block holds a 16-column slice of one head's state, D/32 warps of 32 key
dims each, and stages each chunk of 16 tokens in a two-stage ring.  The
constants are read from the source; checked: the chunk is the plain
version's, every head dim the wrapper takes splits into whole warps and
slices, every block fits in shared memory, and at rwkv6-3b's prefill
(B = 4, H = 40, D = 64) the grid runs in one wave of five blocks an SM."""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import ref, rwkv6_wkv
from torch_threads import one_thread  # noqa: F401

SOURCE = Path(rwkv6_wkv.__file__).parent / "csrc" / "rwkv6_wkv.cu"
#: an H100's SMs, and the shared memory of an SM and of a block (bytes;
#: CUDA reserves 1 KB of an SM's for each block)
SMS, SM_SMEM, BLOCK_SMEM, RESERVED = 132, 228 * 1024, 227 * 1024, 1024
SERVE = dict(B=4, H=40, D=64)


def _constants():
    return {name: int(value) for name, value in re.findall(
        r"^constexpr int (\w+) = (\d+);", SOURCE.read_text(),
        flags=re.MULTILINE)}


def _smem(D, esz):
    """Bytes of shared memory a block takes (the source's ``Smem``)."""
    k = _constants()
    C, VT, DW, STAGES = k["C"], k["VT"], k["DW"], k["STAGES"]
    stage = C * D * 4 + 2 * C * D * esz + C * VT * esz
    warp = (2 * C * DW + DW + 2 * (2 * C * VT + C)) * 4
    return STAGES * stage + D // DW * warp


def test_chunk_and_head_dims_fit_the_kernel():
    k = _constants()
    assert k["C"] == ref.WKV_CHUNK
    for D in rwkv6_wkv.HEAD_DIMS:
        assert D % k["DW"] == 0 and D % k["VT"] == 0
        assert 1 <= D // k["DW"] <= 32              # warps a block


@pytest.mark.parametrize("esz", [2, 4], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("D", rwkv6_wkv.HEAD_DIMS)
def test_block_fits_shared_memory(D, esz):
    assert _smem(D, esz) <= BLOCK_SMEM


def test_serving_prefill_runs_in_one_wave():
    k = _constants()
    D = SERVE["D"]
    blocks = D // k["VT"] * SERVE["B"] * SERVE["H"]
    per_sm = SM_SMEM // (_smem(D, 2) + RESERVED)
    assert per_sm >= 5 and blocks <= per_sm * SMS
