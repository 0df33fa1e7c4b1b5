"""The port's LM substrate (repro_torch.models, configs, convert) against the
JAX package's on the same inputs, at the smoke configs (2 layers, d_model
64).  Inputs and weights are made with numpy and the JAX package's init,
then carried across with ``convert.lm_params``.

Tolerances: float32 2e-5 for single ops, 1e-4 relative to the largest
|logit| for whole models; bfloat16 2e-2 (relative to the largest |value|):
the two frameworks round bf16 intermediates at different places."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.models import attention as ja
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.models import rwkv6 as jr
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.models import rwkv6 as tr
from torch_lm_parity import OP_TOL, check_model
from torch_lm_parity import cfg_pair as _cfg_pair
from torch_lm_parity import close as _close
from torch_lm_parity import pair as _pair
from torch_threads import one_thread  # noqa: F401

DTYPES = ["float32", "bfloat16"]


def _tree_pair(tree, dtype="float32"):
    """A nested dict of numpy leaves as (JAX tree, port tree)."""
    jt = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32).astype(jnp.dtype(dtype)), tree)
    return jt, convert.lm_params(tconfigs.smoke_config("qwen2-0.5b"),
                                 jax.tree_util.tree_map(np.asarray, jt),
                                 device="cpu")


# ---------------------------------------------------------------------------
# layers and mlp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_layers(dtype):
    rng = np.random.default_rng(0)
    tol = OP_TOL[dtype]
    x = rng.standard_normal((2, 5, 3, 16))
    jx, tx = _pair(x, dtype)
    jx3, tx3 = _pair(x.reshape(2, 5, 48), dtype)
    scale, bias = rng.standard_normal(48), rng.standard_normal(48)
    js, ts = _pair(scale, "float32")
    jb, tb = _pair(bias, "float32")
    _close(tl.rmsnorm({"scale": ts}, tx3), jl.rmsnorm({"scale": js}, jx3),
           tol)
    _close(tl.layernorm({"scale": ts, "bias": tb}, tx3),
           jl.layernorm({"scale": js, "bias": jb}, jx3), tol)
    for kind in ("rmsnorm", "layernorm"):
        pj = jl.make_norm(kind)[0](48, jnp.float32)
        pt = tl.make_norm(kind)[0](48, "float32", "cpu")
        assert {k: v.shape for k, v in pj.items()} == \
            {k: tuple(v.shape) for k, v in pt.items()}
        _close(tl.make_norm(kind)[1](pt, tx3), jl.make_norm(kind)[1](pj, jx3),
               tol)
    gs, gb = rng.standard_normal((3, 16)), rng.standard_normal((3, 16))
    _close(tl.groupnorm_heads(tx, *_pair(gs, "float32")[1:],
                              *_pair(gb, "float32")[1:]),
           jl.groupnorm_heads(jx, _pair(gs, "float32")[0],
                              _pair(gb, "float32")[0]), tol)
    _close(tl.rope_freqs(16, 1e6), jl.rope_freqs(16, 1e6), 2e-6)
    pos = rng.integers(0, 4096, size=(2, 5)).astype(np.int32)
    _close(tl.apply_rope(tx, torch.tensor(pos), 1e6),
           jl.apply_rope(jx, jnp.asarray(pos), 1e6), tol)
    for name in ("silu", "gelu", "relu", "sqrelu"):
        _close(tl.activation(name)(tx), jl.activation(name)(jx), tol)


def test_dense_and_embed_init_statistics():
    """Init draws differ from jax.random's; their law does not: a truncated
    (±2σ) fan-in normal and an N(0, 1/d) embedding."""
    g = tl.generator(3, "cpu")
    w = tl.dense_init(g, (256, 64, 8), "float32", "cpu", in_axis=(0, 1))
    assert w.dtype == torch.float32 and tuple(w.shape) == (256, 64, 8)
    assert float(w.abs().max()) <= 2.0 / np.sqrt(256 * 64) + 1e-7
    std_trunc = np.sqrt(1 - 4 * np.exp(-2) / np.sqrt(2 * np.pi)
                        / 0.9544997) / np.sqrt(256 * 64)
    assert abs(float(w.std()) / std_trunc - 1) < 0.02
    e = tl.embed_init(g, (4096, 64), "bfloat16", "cpu")
    assert e.dtype == torch.bfloat16
    assert abs(float(e.float().std()) * 8 - 1) < 0.02


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("glu", [True, False])
def test_mlp(dtype, glu):
    rng = np.random.default_rng(1)
    p = {"wi": rng.standard_normal((32, 48)) * 0.2,
         "wo": rng.standard_normal((48, 32)) * 0.2}
    if glu:
        p["wg"] = rng.standard_normal((32, 48)) * 0.2
    jp, tp = _tree_pair(p)
    jx, tx = _pair(rng.standard_normal((2, 7, 32)), dtype)
    _close(tmlp.mlp(tp, tx, "silu"), jmlp.mlp(jp, jx, "silu"),
           OP_TOL[dtype])
    pt = tmlp.init_mlp_params(tl.generator(0, "cpu"), 32, 48, glu, "float32",
                              "cpu")
    pj = jmlp.init_mlp_params(jax.random.PRNGKey(0), 32, 48, glu,
                              jnp.float32)
    assert {k: tuple(v.shape) for k, v in pt.items()} == \
        {k: v.shape for k, v in pj.items()}


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_params(acfg, seed):
    rng = np.random.default_rng(seed)
    d, H, Hk, Dh = acfg.d_model, acfg.n_heads, acfg.n_kv_heads, acfg.head_dim
    p = {"wq": rng.standard_normal((d, H, Dh)) / np.sqrt(d),
         "wk": rng.standard_normal((d, Hk, Dh)) / np.sqrt(d),
         "wv": rng.standard_normal((d, Hk, Dh)) / np.sqrt(d),
         "wo": rng.standard_normal((H, Dh, d)) / np.sqrt(H * Dh)}
    if acfg.qkv_bias:
        p.update(bq=0.1 * rng.standard_normal((H, Dh)),
                 bk=0.1 * rng.standard_normal((Hk, Dh)),
                 bv=0.1 * rng.standard_normal((Hk, Dh)))
    return p


ATTN_CASES = [("naive", 0), ("flash", 0), ("naive", 8), ("flash", 8)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl,window", ATTN_CASES)
def test_attend_full(dtype, impl, window):
    """Both branches, full causal and windowed: with S = 40, q_chunk 8 and
    window 8 the naive branch takes its sliced-KV path."""
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
              qkv_bias=True, rope_theta=1e6, sliding_window=window,
              q_chunk=8, impl=impl)
    jcfg, tcfg = ja.AttnConfig(**kw), ta.AttnConfig(**kw)
    jp, tp = _tree_pair(_attn_params(jcfg, 2))
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng.standard_normal((2, 40, 32)), dtype)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    jy, (jk, jv) = ja.attend_full(jp, jcfg, jx, jnp.asarray(pos),
                                  return_kv=True)
    ty, (tk, tv) = ta.attend_full(tp, tcfg, tx, torch.tensor(pos),
                                  return_kv=True)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        _close(got, want, OP_TOL[dtype])
    pt = ta.init_attn_params(tl.generator(0, "cpu"), tcfg, "float32", "cpu")
    pj = ja.init_attn_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    assert {k: tuple(v.shape) for k, v in pt.items()} == \
        {k: v.shape for k, v in pj.items()}


def test_attend_full_batch_tp_raises():
    cfg = ta.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
                        impl="flash", batch_tp=True)
    p = convert.lm_params(tconfigs.smoke_config("qwen2-0.5b"),
                          _attn_params(cfg, 0), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ta.attend_full(p, cfg, torch.zeros(1, 4, 32),
                       torch.zeros(1, 4, dtype=torch.int32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 6])
def test_attention_decode_step(dtype, window):
    """Six cached steps after a 5-token prefill; with window 6 the cache is
    a 6-slot ring that wraps."""
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
              qkv_bias=True, sliding_window=window)
    jcfg, tcfg = ja.AttnConfig(**kw), ta.AttnConfig(**kw)
    jp, tp = _tree_pair(_attn_params(jcfg, 4))
    rng = np.random.default_rng(5)
    jc = ja.init_kv_cache(jcfg, 2, 16, jnp.dtype(dtype))
    tc = ta.init_kv_cache(tcfg, 2, 16, dtype, "cpu")
    S0 = 5
    kv0 = rng.standard_normal((2, 2, tc.k.shape[1], 2, 16))
    kv0[:, :, S0:] = 0.0
    jc = jc._replace(k=_pair(kv0[0], dtype)[0], v=_pair(kv0[1], dtype)[0],
                     length=jnp.asarray(S0, jnp.int32))
    tc = tc._replace(k=_pair(kv0[0], dtype)[1], v=_pair(kv0[1], dtype)[1],
                     length=torch.tensor(S0, dtype=torch.int32))
    for t in range(6):
        jx, tx = _pair(rng.standard_normal((2, 1, 32)), dtype)
        pos = np.full((2, 1), S0 + t, np.int32)
        jy, jc = ja.decode_step(jp, jcfg, jx, jnp.asarray(pos), jc)
        ty, tc = ta.decode_step(tp, tcfg, tx, torch.tensor(pos), tc)
        _close(ty, jy, OP_TOL[dtype])
        _close(tc.k, jc.k, OP_TOL[dtype])
        _close(tc.v, jc.v, OP_TOL[dtype])
        assert int(tc.length) == int(jc.length)


# ---------------------------------------------------------------------------
# rwkv6
# ---------------------------------------------------------------------------

def _rwkv_params(d, Dh, d_ff, seed):
    rng = np.random.default_rng(seed)
    H = d // Dh
    n = lambda *s: rng.standard_normal(s)                 # noqa: E731
    tm = {"mu_base": 0.3 * n(5, d), "mu_x": 0.3 * n(d),
          "maa_w1": n(d, 5 * jr.LORA_MIX) / np.sqrt(d),
          "maa_w2": 0.1 * n(5, jr.LORA_MIX, d),
          "wr": n(d, d) / np.sqrt(d), "wk": n(d, d) / np.sqrt(d),
          "wv": n(d, d) / np.sqrt(d), "wg": n(d, d) / np.sqrt(d),
          "wo": n(d, d) / np.sqrt(d), "w0": -1.0 + 0.5 * n(d),
          "dec_w1": n(d, jr.LORA_DECAY) / np.sqrt(d),
          "dec_w2": 0.2 * n(jr.LORA_DECAY, d), "u": 0.3 * n(H, Dh),
          "ln_x_scale": 1.0 + 0.1 * n(H, Dh), "ln_x_bias": 0.1 * n(H, Dh)}
    cm = {"mu_k": 0.5 + 0.1 * n(d), "mu_r": 0.5 + 0.1 * n(d),
          "wk": n(d, d_ff) / np.sqrt(d), "wv": n(d_ff, d) / np.sqrt(d_ff),
          "wr": n(d, d) / np.sqrt(d)}
    return tm, cm


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [32, 23])
def test_time_mix_and_channel_mix(dtype, S):
    """S = 23 pads the last chunk with logw = −1e−6; the returned state must
    carry that decay as the JAX package's does."""
    d, Dh = 32, 16
    tm, cm = _rwkv_params(d, Dh, 48, 6)
    (jtm, ttm), (jcm, tcm) = _tree_pair(tm), _tree_pair(cm)
    rng = np.random.default_rng(7)
    jx, tx = _pair(rng.standard_normal((2, S, d)), dtype)
    jsh, tsh = _pair(rng.standard_normal((2, d)), dtype)
    st = 0.3 * rng.standard_normal((2, d // Dh, Dh, Dh))
    jst, tst = _pair(st, "float32")
    jo, jlast, jnew = jax.jit(jr.time_mix, static_argnums=4)(jtm, jx, jsh,
                                                             jst, Dh)
    to, tlast, tnew = tr.time_mix(ttm, tx, tsh, tst, Dh)
    tol = OP_TOL[dtype]
    _close(to, jo, tol)
    _close(tlast, jlast, 0.0)
    _close(tnew, jnew, tol)
    jc, jcl = jr.channel_mix(jcm, jx, jsh)
    tc, tcl = tr.channel_mix(tcm, tx, tsh)
    _close(tc, jc, tol)
    _close(tcl, jcl, 0.0)
    jd, _, jdst = jax.jit(jr.time_mix_decode, static_argnums=4)(
        jtm, jx[:, :1], jsh, jst, Dh)
    td, _, tdst = tr.time_mix_decode(ttm, tx[:, :1], tsh, tst, Dh)
    _close(td, jd, tol)
    _close(tdst, jdst, tol)
    pt = tr.init_rwkv_params(tl.generator(0, "cpu"), d, Dh, "float32", "cpu")
    pj = jr.init_rwkv_params(jax.random.PRNGKey(0), d, Dh, jnp.float32)
    assert {k: tuple(v.shape) for k, v in pt.items()} == \
        {k: v.shape for k, v in pj.items()}


# ---------------------------------------------------------------------------
# the assembled LM
# ---------------------------------------------------------------------------

LM_CASES = [("qwen2-0.5b", "flash"), ("qwen2-0.5b", "naive"),
            ("rwkv6-3b", "naive")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,attn", LM_CASES)
def test_lm_forward_loss_prefill_decode(arch, attn, dtype):
    """forward, chunked_ce, loss, prefill (logits and every cache leaf) and
    three decode steps, through ``convert.lm_params`` and
    ``convert.lm_cache`` (``torch_lm_parity.check_model``)."""
    check_model(*_cfg_pair(arch, dtype, attn_impl=attn))


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_init_params_full_tree(arch):
    """At the published config: the port's tree (built on the meta device,
    nothing allocated) has the JAX package's keys, shapes and dtypes, and
    the config's parameter counts and layer pattern are JAX's."""
    want = jax.eval_shape(lambda k: jlm.init_params(j_get_config(arch), k),
                          jax.random.PRNGKey(0))
    cfg = tconfigs.get_config(arch)
    got = tlm.init_params(cfg, 0, "meta")
    flat_w = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert set(flat_g) == set(flat_w)
    for k, w in flat_w.items():
        assert tuple(flat_g[k].shape) == w.shape, k
        assert flat_g[k].dtype == torch.float32 and w.dtype == jnp.float32
        assert flat_g[k].device.type == "meta"
    assert sum(v.numel() for v in flat_g.values()) == sum(
        int(np.prod(w.shape)) for w in flat_w.values())
    assert cfg.n_params() == j_get_config(arch).n_params()
    assert cfg.n_active_params() == j_get_config(arch).n_active_params()
    assert cfg.layer_pattern == j_get_config(arch).layer_pattern


def test_registry_and_unported_families_raise():
    """The registry is the JAX package's ten archs in its order, every
    config and smoke config equal to JAX's; what is still refused is
    attention's mesh resharding (queue A item 16)."""
    from repro import configs as jconfigs
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for name in tconfigs.ARCHS:
        assert tconfigs.get_config(name) == _port_cfg(j_get_config(name))
        assert tconfigs.smoke_config(name) == _port_cfg(j_smoke_config(name))
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-2")
    cfg = tconfigs.override(tconfigs.smoke_config("qwen2-0.5b"),
                            attn_batch_tp=True)
    for call in (lambda: tlm.init_params(cfg, 0, "cpu"),
                 lambda: tlm.init_cache(cfg, 1, 8, device="cpu"),
                 lambda: convert.lm_params(cfg, {}, "cpu")):
        with pytest.raises(NotImplementedError, match="queue A item 16"):
            call()


def test_lm_converters_require_a_device():
    """``lm_params`` and ``lm_cache`` take the device as every other
    converter does: leaving it out raises instead of landing on the CPU."""
    cfg = tconfigs.smoke_config("qwen2-0.5b")
    tree = {"w": np.zeros((2, 3), np.float32)}
    with pytest.raises(TypeError):
        convert.lm_params(cfg, tree)
    with pytest.raises(TypeError):
        convert.lm_cache(tree)
    assert convert.lm_cache(tree, "cpu")["w"].device == torch.device("cpu")


def _port_cfg(jcfg):
    return tconfigs.base.ModelConfig(**dataclasses.asdict(jcfg))
