"""gemma3's local/global pattern in the port (``repro_torch.models.lm``)
against the JAX package's, and the other dense arch the port gained with
it (phi3-mini): whole models at the smoke configs, the JAX package's
weights carried across, inputs made with numpy (``torch_lm_parity``).

gemma3-4b's smoke config has a unit of 5 sliding-window layers (window 32)
and a global one.  At 14 layers it has two units and a 2-layer local tail;
a 45-token prompt is longer than the window, so the prefill's
``_window_tail`` takes its ring branch and the decode steps wrap the ring;
a 20-token prompt leaves it padded.  float32 is held to 1e-4 of each
output's largest |value|, bfloat16 to 2e-2 at 8 layers (a unit and the
tail): at 12 layers both packages' bf16 forwards lie 1.6e-2 from their f32
forward and 2.2e-2 from each other (qwen2-0.5b's smoke cut at 12 layers
alike), rounding alone."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.models import lm as tlm
from torch_lm_parity import cfg_pair, check_model
from torch_threads import one_thread  # noqa: F401

GEMMA_CASES = [
    # (dtype, n_layers, prompt, attention)
    ("float32", 14, 45, "flash"),      # tail; ring filled and wrapped
    ("float32", 12, 20, "naive"),      # no tail; prompt inside the window
    ("bfloat16", 8, 45, "flash"),
    ("bfloat16", 8, 20, "naive"),
]


@pytest.mark.parametrize("dtype,n_layers,S,attn", GEMMA_CASES)
def test_gemma_model(dtype, n_layers, S, attn):
    jc, tc = cfg_pair("gemma3-4b", dtype, n_layers=n_layers, attn_impl=attn)
    assert tlm.gemma_units(tc) == jlm.gemma_units(jc)
    _, cache = check_model(jc, tc, S=S, max_len=S + 11)
    assert ("tail_k" in cache) == (n_layers % 6 != 0)
    assert cache["local_k"].shape[3] == min(tc.sliding_window, S + 11)


@pytest.mark.parametrize("S", [20, 32, 45, 77])
def test_window_tail(S):
    """The w-ring of a prefill: slot i holds token t ≡ i (mod w) of the
    last min(S, w) tokens; a short prompt is zero-padded."""
    rng = np.random.default_rng(S)
    k = rng.standard_normal((2, S, 2, 4)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 4)).astype(np.float32)
    jk, jv = jlm._window_tail((jnp.asarray(k), jnp.asarray(v)), 32)
    tk, tv = tlm._window_tail((torch.tensor(k), torch.tensor(v)), 32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phi3_mini_model(dtype):
    jc, tc = cfg_pair("phi3-mini-3.8b", dtype, attn_impl="flash")
    check_model(jc, tc)
