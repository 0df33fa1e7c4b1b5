"""The audio family in the port (musicgen-large's backbone: frame inputs
from a stub frontend, sinusoidal positions, LayerNorm, a GELU MLP without
gate) against the JAX package's: ``sinusoidal_positions``, and the whole
model at the smoke config, float32 to 1e-4 and bfloat16 to 2e-2
(``torch_lm_parity``), whose decode steps subtract position 0's table and
add the step's, as the JAX package does."""
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl
from torch_lm_parity import cfg_pair, check_model, close
from torch_threads import one_thread  # noqa: F401


def test_sinusoidal_positions():
    """To 2e-5 (the ops' float32 tolerance): at position 2048 the two
    packages' f32 exp and sin differ in the last places."""
    pos = np.array([[0, 1, 7, 300], [5, 2048, 0, 31]], np.int32)
    got = tl.sinusoidal_positions(torch.tensor(pos), 64)
    want = jl.sinusoidal_positions(pos, 64)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, 64)
    close(got, want, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_model(dtype):
    jc, tc = cfg_pair("musicgen-large", dtype, attn_impl="flash")
    check_model(jc, tc)
