"""The vlm family in the port (llama-3.2-vision's pattern: units of 4
self-attention layers and a gated cross-attention layer over stub image
embeddings) against the JAX package's: the cross-attention ops on the same
inputs (float32 to 2e-5, bfloat16 to 2e-2) and the whole model at the
smoke config, float32 to 1e-4 and bfloat16 to 2e-2 (``torch_lm_parity``):
the prefill fills ``cross_k``/``cross_v`` with ``precompute_cross_kv``,
decode reads them through ``cross_decode``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import attention as ja
from repro_torch.models import attention as ta
from torch_lm_parity import OP_TOL, cfg_pair, check_model, close, pair
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_cross_decode_and_precompute_cross_kv(dtype, bias):
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
              qkv_bias=bias, pos="none", causal=False, q_chunk=8)
    jcfg, tcfg = ja.AttnConfig(**kw), ta.AttnConfig(**kw)
    rng = np.random.default_rng(3)
    p = jax.tree_util.tree_map(np.asarray, ja.init_attn_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32))
    p = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in p.items()}
    jp = {k: pair(v, dtype)[0] for k, v in p.items()}
    tp = {k: pair(v, dtype)[1] for k, v in p.items()}
    jimg, timg = pair(rng.standard_normal((2, 17, 32)), dtype)
    jx, tx = pair(rng.standard_normal((2, 5, 32)), dtype)
    jk, jv = ja.precompute_cross_kv(jp, jcfg, jimg)
    tk, tv = ta.precompute_cross_kv(tp, tcfg, timg)
    close(tk, jk, OP_TOL[dtype], what="k")
    close(tv, jv, OP_TOL[dtype], what="v")
    jo = ja.cross_decode(jp, jcfg, jx, jk, jv)
    to = ta.cross_decode(tp, tcfg, tx, tk, tv)
    assert to.dtype == tx.dtype
    close(to, jo, OP_TOL[dtype], what="out")
    # the training path's query-chunked cross attention agrees with it
    zq = np.zeros((2, 5), np.int32)
    zk = np.zeros((2, 17), np.int32)
    import torch
    tf = ta.attend_full(tp, tcfg, tx, torch.tensor(zq), kv_x=timg,
                        kv_positions=torch.tensor(zk))
    close(tf, jo, OP_TOL[dtype], what="attend_full")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_model(dtype):
    jc, tc = cfg_pair("llama-3.2-vision-90b", dtype, attn_impl="flash")
    _, cache = check_model(jc, tc)
    assert cache["cross_k"].shape[2] == tc.n_img_tokens
