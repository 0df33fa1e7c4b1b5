"""The port's Mamba-2 mixer (``repro_torch.models.mamba2``) and the hybrid
family (zamba2) against the JAX package's.

The ops on the same inputs, float32 to 2e-5 of the largest |value| and
bfloat16 to 2e-2: ``ssd_chunked`` over three chunks from a carried state,
``mamba_layer`` at a length that is not a multiple of CHUNK (the pad
path) from a carried state (SSM and conv history), ``mamba_decode``.
Whole zamba2 models in float32 to 1e-4 (``torch_lm_parity``): at 10
layers (three units of 3 Mamba2 layers and the shared block, and a tail
layer) over 150 tokens, and at 9.  bfloat16 is not held to the JAX
package's bf16 at 2e-2 through the whole model: the two packages' bf16
models lie 2.0e-2 apart at 2 Mamba2 layers, 4.3e-2 at one unit (3 layers
and the shared block) and 4.2-4.9e-2 at one unit and a tail layer
(``python tests/test_torch_mamba2.py`` prints these readings), each
about as far from the f32 model (the port's at most 1.73 times the JAX
package's at 4 layers).  The bf16 model is instead held against
the JAX package's f32 model: no output of the port's lies more than
``BF16_DRIFT`` times as far from it as the JAX package's own bf16 output
does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models import mamba2 as jm
from repro_torch import convert
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tm
from torch_lm_parity import (OP_TOL, cfg_pair, check_model, close, inputs,
                             jax_params, np64, pair)
from torch_threads import one_thread  # noqa: F401

D_MODEL, N, P, EXPAND = 64, 16, 16, 2
H = EXPAND * D_MODEL // P
CONV_DIM = EXPAND * D_MODEL + 2 * N
#: the bf16 model: the port's distance from the JAX package's f32 outputs
#: over the JAX package's own bf16 distance (read at most 1.73 at 4 layers
#: over two seeds and S = 37 and 150, 2.08 at 10 layers: ``__main__``)
BF16_DRIFT = 2.5


def _params(dtype, seed=0):
    p = jax.tree_util.tree_map(np.asarray, jm.init_mamba_params(
        jax.random.PRNGKey(seed), D_MODEL, N, P, EXPAND))
    rng = np.random.default_rng(seed)
    p = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in p.items()}
    return ({k: jnp.asarray(v).astype(jnp.dtype(dtype)) for k, v in p.items()},
            {k: pair(v, dtype)[1] for k, v in p.items()})


def _state(B, dtype, rng):
    ssm = 0.3 * rng.standard_normal((B, H, N, P))
    conv = rng.standard_normal((B, tm.CONV_K - 1, CONV_DIM))
    js, ts = pair(ssm, "float32")
    jc, tc = pair(conv, dtype)
    return jm.MambaState(ssm=js, conv=jc), tm.MambaState(ssm=ts, conv=tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked(dtype):
    """Three chunks from a carried state: y and the final state."""
    rng = np.random.default_rng(2)
    B, S = 2, 3 * tm.CHUNK
    jx, tx = pair(rng.standard_normal((B, S, H, P)), dtype)
    jdt, tdt = pair(np.log1p(np.exp(rng.standard_normal((B, S, H)))),
                    "float32")
    jA, tA = pair(-np.exp(0.3 * rng.standard_normal(H)), "float32")
    jB, tB = pair(rng.standard_normal((B, S, N)), dtype)
    jC, tC = pair(rng.standard_normal((B, S, N)), dtype)
    js, ts = pair(0.3 * rng.standard_normal((B, H, N, P)), "float32")
    jy, jst = jax.jit(jm.ssd_chunked)(jx, jdt, jA, jB, jC, js)
    ty, tst = tm.ssd_chunked(tx, tdt, tA, tB, tC, ts)
    assert ty.dtype == tx.dtype and tst.dtype == torch.float32
    close(ty, jy, OP_TOL[dtype], what="y")
    close(tst, jst, OP_TOL[dtype], what="state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [150, 64])
def test_mamba_layer(dtype, S):
    """From a carried state; S = 150 pads to three chunks."""
    jp, tp = _params(dtype)
    rng = np.random.default_rng(S)
    jx, tx = pair(rng.standard_normal((2, S, D_MODEL)), dtype)
    jst, tst = _state(2, dtype, rng)
    jo, jnew = jax.jit(lambda p, x, s: jm.mamba_layer(
        p, x, D_MODEL, N, P, EXPAND, s))(jp, jx, jst)
    to, tnew = tm.mamba_layer(tp, tx, D_MODEL, N, P, EXPAND, tst)
    tol = OP_TOL[dtype]
    close(to, jo, tol, what="out")
    close(tnew.ssm, jnew.ssm, tol, what="ssm")
    close(tnew.conv, jnew.conv, tol, what="conv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode(dtype):
    jp, tp = _params(dtype, seed=1)
    rng = np.random.default_rng(9)
    jx, tx = pair(rng.standard_normal((3, 1, D_MODEL)), dtype)
    jst, tst = _state(3, dtype, rng)
    jo, jnew = jax.jit(lambda p, x, s: jm.mamba_decode(
        p, x, s, D_MODEL, N, P, EXPAND))(jp, jx, jst)
    to, tnew = tm.mamba_decode(tp, tx, tst, D_MODEL, N, P, EXPAND)
    tol = OP_TOL[dtype]
    close(to, jo, tol, what="out")
    close(tnew.ssm, jnew.ssm, tol, what="ssm")
    close(tnew.conv, jnew.conv, tol, what="conv")


def test_init_mamba_params_and_state_shapes():
    from repro_torch.models import layers as tl
    pt = tm.init_mamba_params(tl.generator(0, "cpu"), D_MODEL, N, P, EXPAND,
                              "float32", "cpu", lead=(3,))
    pj = jm.init_mamba_params(jax.random.PRNGKey(0), D_MODEL, N, P, EXPAND)
    assert {k: tuple(v.shape) for k, v in pt.items()} == \
        {k: (3,) + v.shape for k, v in pj.items()}
    st = tm.init_mamba_state(2, D_MODEL, N, P, EXPAND, device="cpu")
    sj = jm.init_mamba_state(2, D_MODEL, N, P, EXPAND)
    assert tuple(st.ssm.shape) == sj.ssm.shape
    assert tuple(st.conv.shape) == sj.conv.shape


@pytest.mark.parametrize("n_layers,S", [(10, 150), (9, 37)])
def test_zamba2_model(n_layers, S):
    jc, tc = cfg_pair("zamba2-7b", "float32", n_layers=n_layers,
                      attn_impl="flash")
    _, cache = check_model(jc, tc, S=S, max_len=S + 11)
    assert ("tail_ssm" in cache) == (n_layers % 3 != 0)


def _jax_outputs(cfg, params, batch, steps, max_len):
    pre = {k: v for k, v in batch.items() if k != "labels"}
    out = {"hidden": jax.jit(lambda q, b: jlm.forward(cfg, q, b)[0])(
        params, batch)}
    logits, cache = jax.jit(lambda q, b: jlm.prefill(cfg, q, b, max_len))(
        params, pre)
    out["prefill logits"] = logits
    out.update({f"cache.{k}": v for k, v in cache.items()})
    dec = jax.jit(lambda q, c, b: jlm.decode_step(cfg, q, c, b))
    for t, (d, _) in enumerate(steps):
        out[f"decode {t} logits"], cache = dec(params, cache, d)
    return out


def _port_outputs(cfg, params, batch, steps, max_len):
    pre = {k: v for k, v in batch.items() if k != "labels"}
    out = {"hidden": tlm.forward(cfg, params, batch)[0]}
    logits, cache = tlm.prefill(cfg, params, pre, max_len)
    out["prefill logits"] = logits
    # decode updates the cache in place
    out.update({f"cache.{k}": v.clone() for k, v in cache.items()})
    for t, (_, d) in enumerate(steps):
        out[f"decode {t} logits"], cache = tlm.decode_step(cfg, params,
                                                           cache, d)
    return out


def _bf16_readings(n_layers, S, seed):
    """zamba2 in bfloat16 at ``n_layers`` over S tokens, the port from its
    own prefill cache: per output (the forward's hidden state, the
    prefill's logits and every cache leaf, 3 decode steps' logits), the
    port's and the JAX package's distances from the JAX package's float32
    model and from each other, relative to the largest |f32 value|."""
    jf, _ = cfg_pair("zamba2-7b", "float32", n_layers=n_layers,
                     attn_impl="flash")
    jc, tc = cfg_pair("zamba2-7b", "bfloat16", n_layers=n_layers,
                      attn_impl="flash")
    p = jax_params(jc)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = convert.lm_params(tc, p, device="cpu")
    rng = np.random.default_rng(seed)
    jb, tb = inputs(jc, 2, S, rng)
    steps = [inputs(jc, 2, 1, rng, decode=True) for _ in range(3)]
    want = _jax_outputs(jf, jp, jb, steps, S + 11)
    jax_bf16 = _jax_outputs(jc, jp, jb, steps, S + 11)
    got = _port_outputs(tc, tp, tb, steps, S + 11)
    assert set(got) == set(want)
    out = {}
    for k, w in want.items():
        w, g, j = np64(w), np64(got[k]), np64(jax_bf16[k])
        assert g.shape == w.shape, k
        if w.size:
            s = max(np.abs(w).max(), 1e-30)
            out[k] = (np.abs(g - w).max() / s, np.abs(j - w).max() / s,
                      np.abs(g - j).max() / s)
    return out


@pytest.mark.parametrize("S,seed", [(37, 3), (150, 8)])
def test_zamba2_model_bf16(S, seed):
    """One unit and a tail layer (4 layers) in bfloat16: no output of the
    port lies farther from the JAX package's float32 model than
    ``BF16_DRIFT`` times the JAX package's bf16 output does (plus 1e-3 of
    the largest |value|), ``_bf16_readings``."""
    for k, (e_port, e_jax, _) in _bf16_readings(4, S, seed).items():
        assert e_port <= BF16_DRIFT * e_jax + 1e-3, (
            f"{k}: bf16 {e_port:.3e} from f32, the JAX package's "
            f"{e_jax:.3e}")


if __name__ == "__main__":
    # the readings behind the module docstring and BF16_DRIFT:
    #   JAX_PLATFORMS=cpu PYTHONPATH=src:tests python tests/test_torch_mamba2.py
    torch.set_num_threads(1)
    for n_layers, S, seed in [(2, 37, 8), (3, 37, 8), (4, 37, 8), (4, 37, 3),
                              (4, 150, 8), (10, 150, 8)]:
        r = _bf16_readings(n_layers, S, seed)
        k = max(r, key=lambda k: r[k][2])
        print(f"n_layers={n_layers} S={S} seed={seed}: port vs JAX bf16 "
              f"{r[k][2]:.3e} ({k}); port/JAX distance from f32 at most "
              f"{max(a / b for a, b, _ in r.values() if b):.2f}")
