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


# The backward (row 12, ``csrc/rwkv6_wkv_bwd.cu``): a sweep block holds 16
# key dims of one head's state, the D/16 blocks of a head form a cluster,
# and a pair block takes one chunk.
BWD_SOURCE = SOURCE.parent / "rwkv6_wkv_bwd.cu"
TRAIN = dict(B=4, H=40, D=64)
#: a thread-block cluster's portable size limit
CLUSTER_MAX = 8


def _bwd_constants():
    return {name: int(value) for name, value in re.findall(
        r"^constexpr int (\w+) = (\d+);", BWD_SOURCE.read_text(),
        flags=re.MULTILINE)}


def _pair_floats(C):
    """A chunk's pair terms: A, the bonus and its gradient (the source's
    ``PAIR``)."""
    return C * C + 2 * C


def _sweep_smem(D, esz):
    """Bytes of shared memory a sweep block takes (the source's ``Sweep``)."""
    k = _bwd_constants()
    C, KD = k["C"], k["KD"]
    PD, P16 = D + 4, 20
    stage = (C * KD * 4 + 2 * C * KD * esz + KD * PD * 4
             + _pair_floats(C) * 4 + 2 * C * P16 * 4)
    v_row = D + 16 // esz                    # v and do in the inputs' type
    floats = 2 * C * v_row * esz // 4 + KD * PD + 4 * C * P16 + KD * P16 \
        + 2 * KD + 2 * C * D
    return 2 * stage + 4 * floats


def test_bwd_split_fits_head_dims():
    k = _bwd_constants()
    assert k["C"] == ref.WKV_CHUNK
    assert rwkv6_wkv.BWD_PAIR == _pair_floats(k["C"])
    assert rwkv6_wkv.BWD_PAIR % 4 == 0           # whole 16-byte copies
    for D in rwkv6_wkv.HEAD_DIMS:
        assert D % k["KD"] == 0 and 1 <= D // k["KD"] <= CLUSTER_MAX
        assert D % 32 == 0                  # a tile's columns: D / 32
        # each sweep thread prefetches a whole number of 8-byte words of v
        assert k["C"] * D % k["NT"] == 0 and k["C"] * D // k["NT"] % 4 == 0
    # a pair block: A and dA as 4 x 4 tiles of (t, j), 8 lanes a tile
    assert k["PT"] == 2 * (k["C"] // 4) ** 2 * 8
    for D in rwkv6_wkv.HEAD_DIMS:
        assert D % 32 == 0                  # a lane's float4s: 4 lane + 32 s


@pytest.mark.parametrize("esz", [2, 4], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("D", rwkv6_wkv.HEAD_DIMS)
def test_bwd_sweep_block_fits_shared_memory(D, esz):
    assert _sweep_smem(D, esz) <= BLOCK_SMEM
    # the pair block: seven chunk arrays of rows of D + 4 floats, u, and
    # dA and its transpose in rows of 20
    C = ref.WKV_CHUNK
    assert (7 * C * (D + 4) + D + 2 * C * 20) * 4 <= BLOCK_SMEM


@pytest.mark.parametrize("esz", [2, 4], ids=["bfloat16", "float32"])
def test_bwd_training_sweep_shares_sms(esz):
    """At rwkv6-3b's training shape four sweep blocks share an SM (the
    kernel's launch bound): 640 blocks in 1.2 waves."""
    k = _bwd_constants()
    D = TRAIN["D"]
    blocks = D // k["KD"] * TRAIN["B"] * TRAIN["H"]
    per_sm = SM_SMEM // (_sweep_smem(D, esz) + RESERVED)
    assert per_sm >= 4 and blocks <= 2 * per_sm * SMS
