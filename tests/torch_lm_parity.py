"""Helpers of the port's per-family LM parity tests (``test_torch_lm_*.py``,
``test_torch_moe.py``, ``test_torch_mamba2.py``): the same inputs, made
with numpy, through the JAX package's model and the port's, with the JAX
package's weights carried across (``convert.lm_params``).

``check_model`` holds forward, loss, the prefill's last logits and every
cache leaf, and ``steps`` decode steps from JAX's cache carried across
(``convert.lm_cache``), each relative to its largest |value| (logits: the
largest |prefill logit|)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm

#: whole models: relative to the largest |value|
MODEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: one op on the same inputs
OP_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def np64(x):
    """A JAX array or a tensor as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def close(got, want, tol, scale=None, what=""):
    """max |got − want| ≤ tol · (largest |want|, or ``scale``)."""
    got, want = np64(got), np64(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    s = np.abs(want).max() if scale is None else scale
    err = np.abs(got - want).max() / max(s, 1e-30)
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol:.0e}"


def pair(a, dtype):
    """One numpy array as (JAX array, tensor) in ``dtype``."""
    return (jnp.asarray(a, jnp.float32).astype(jnp.dtype(dtype)),
            torch.tensor(np.asarray(a, np.float32)).to(tl.dtype_of(dtype)))


def jax_params(cfg, seed=0, noise=0.05):
    """The JAX package's init at ``cfg``, every leaf nudged by seeded noise
    (so zero-initialised leaves — biases, gates, conv biases — take part),
    as numpy."""
    p = jax.tree_util.tree_map(np.asarray, jlm.init_params(
        cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + noise * rng.standard_normal(a.shape)).astype(a.dtype),
        p)


def cfg_pair(arch, dtype, **kw):
    """The arch's smoke config in both packages, with ``kw`` applied."""
    jc = dataclasses.replace(j_smoke_config(arch), dtype=dtype, **kw)
    tc = tconfigs.override(tconfigs.smoke_config(arch), dtype=dtype, **kw)
    return jc, tc


def inputs(cfg, B, S, rng, decode=False):
    """A batch for ``cfg`` as (JAX dict, port dict): tokens, or frames for
    frame-input archs; image embeddings for vlm (not at decode); labels
    unless ``decode``."""
    out = {}
    if cfg.embed_inputs:
        out["tokens"] = rng.integers(0, cfg.vocab, size=(B, S)).astype(
            np.int32)
    else:
        out["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm" and not decode:
        out["img_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if not decode:
        labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
        labels[0, :3] = -1
        out["labels"] = labels
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def check_model(jc, tc, B=2, S=37, max_len=48, steps=3, seed=8):
    """The whole model in both packages (module docstring)."""
    p = jax_params(jc)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = convert.lm_params(tc, p, device="cpu")
    rng = np.random.default_rng(seed)
    jb, tb = inputs(jc, B, S, rng)
    tol = MODEL_TOL[jc.dtype]

    # the JAX side jitted: one compile per function beats op-by-op dispatch
    j_loss = jax.jit(lambda q, b: (jlm.forward(jc, q, b)[0],
                                   *jlm.loss(jc, q, b)))
    j_prefill = jax.jit(lambda q, b: jlm.prefill(jc, q, b, max_len))
    j_decode = jax.jit(lambda q, c, b: jlm.decode_step(jc, q, c, b))
    jh, jloss, jm = j_loss(jp, jb)
    th, taux = tlm.forward(tc, tp, tb)
    close(th, jh, tol, what="hidden")
    tloss, tm = tlm.loss(tc, tp, tb)
    close(tloss, jloss, tol, what="loss")
    close(tm["ce"], jm["ce"], tol, what="ce")
    close(tm["moe_aux"], jm["moe_aux"], tol, what="moe_aux")

    pre = {k: v for k, v in jb.items() if k != "labels"}
    jl_, jcache = j_prefill(jp, pre)
    tl_, tcache = tlm.prefill(tc, tp, {k: v for k, v in tb.items()
                                       if k != "labels"}, max_len)
    scale = np.abs(np64(jl_)).max()
    close(tl_, jl_, tol, scale, what="prefill logits")
    assert set(tcache) == set(jcache)
    for k in jcache:
        assert tuple(tcache[k].shape) == jcache[k].shape, k
        assert str(tcache[k].dtype) == f"torch.{jcache[k].dtype}", k
        close(tcache[k], jcache[k], tol, what=f"cache.{k}")
    # decode from the JAX package's cache carried across
    tcache = convert.lm_cache(jax.tree_util.tree_map(np.asarray, jcache),
                              device="cpu")
    for t in range(steps):
        jd, td = inputs(jc, B, 1, rng, decode=True)
        jl_, jcache = j_decode(jp, jcache, jd)
        tl_, tcache = tlm.decode_step(tc, tp, tcache, td)
        close(tl_, jl_, tol, scale, what=f"decode {t} logits")
        for k in jcache:
            close(tcache[k], jcache[k], tol, what=f"decode {t} cache.{k}")
    return tp, tcache
