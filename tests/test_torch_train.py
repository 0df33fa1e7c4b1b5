"""The port's training pieces (``repro_torch.train``,
``distributed/compression.py``) against the JAX package's, on the CPU, at
the smoke configs in float32, from the JAX package's weights carried
across with ``convert.lm_params``.

Tolerances: the loss to 1e-5 of its value; each gradient leaf to 1e-4 of
its largest |value| (f32 sums in other orders through two layers, the
chunked cross-entropy and, on the flash path, the JAX package's blockwise
custom VJP against autograd of the port's plain attention); AdamW's
parameters and moments to 1e-6 relative (f32 ``cos`` and ``pow`` of two
libraries).  The int8 codes are equal bit for bit.

The JAX package's ``adamw_update`` pairs the leaves in ``jax.tree_util``
order (sorted keys) with the decay mask's paths in insertion order; the
trees handed to it here are in sorted key order, where the two agree
(ROADMAP.md, queue C).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.distributed import compression as jcomp
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.distributed import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from torch_threads import one_thread  # noqa: F401

LOSS_TOL, GRAD_TOL, ADAM_TOL = 1e-5, 1e-4, 1e-6


def _sorted(tree):
    """Nested dicts rebuilt in sorted key order."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}" if prefix else k)]
    return [(prefix, np.asarray(tree.detach().numpy()
                                if isinstance(tree, torch.Tensor) else tree,
                                np.float64))]


def _close_tree(got, want, tol, what=""):
    for (pg, g), (pw, w) in zip(_leaves(got), _leaves(want)):
        assert pg == pw
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, f"{what}{pg}: relative error {err:.3e} > {tol}"


def _model(arch, **kw):
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32", **kw)
    tcfg = dataclasses.replace(t_smoke(arch), dtype="float32", **kw)
    jp = _sorted(jax.tree_util.tree_map(
        np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0))))
    tp = convert.lm_params(tcfg, jp, "cpu")
    batch = SyntheticTokens(tcfg, seq_len=32, global_batch=4,
                            seed=3).batch_at(5)
    return jcfg, tcfg, jp, tp, batch


def _tbatch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# AdamW and compression on one tree
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"ln1": {"scale": rng.standard_normal(6).astype(np.float32)},
            "attn": {"wq": rng.standard_normal((6, 4)).astype(np.float32),
                     "bq": rng.standard_normal(4).astype(np.float32)},
            "tok_embed": rng.standard_normal((10, 6)).astype(np.float32),
            "u": rng.standard_normal((2, 3)).astype(np.float32),
            "zero": np.zeros((3,), np.float32)}


def test_decay_mask_and_schedule_match_jax():
    for path in ("tok_embed", "segments/unit/attn/wq",
                 "segments/unit/ln1/scale", "final_norm/scale",
                 "segments/unit/attn/bq", "tmix/u", "tmix/w0", "x/gate_w",
                 "mamba/A_log", "b", "bias_big", "lm_head",
                 "tmix/ln_x_bias", "mamba/dt_bias"):
        assert topt._decayable(path) == jopt._decayable(path), path
    cfg = topt.AdamWConfig(lr=3e-3, warmup_steps=4, total_steps=20)
    jcfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=4, total_steps=20)
    steps = np.arange(0, 25, dtype=np.int32)
    got = topt.lr_schedule(cfg, torch.from_numpy(steps)).numpy()
    want = np.asarray(jopt.lr_schedule(jcfg, jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=ADAM_TOL, atol=0)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_jax(clip):
    params = _sorted(_tree(0))
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                           grad_clip=clip)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                            grad_clip=clip)
    tp = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
              {kk: torch.from_numpy(vv) for kk, vv in v.items()})
          for k, v in params.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ts, js = topt.init_opt_state(tp), jopt.init_opt_state(jp)
    for i in range(3):
        g = _sorted(_tree(10 + i))
        tg = convert.lm_params(t_smoke("qwen2-0.5b"), g, "cpu")
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        np.testing.assert_allclose(float(topt.global_norm(tg)),
                                   float(jopt.global_norm(jg)), rtol=1e-6)
        tp, ts, tm = topt.adamw_update(cfg, tp, tg, ts)
        jp, js, jm = jopt.adamw_update(jcfg, jp, jg, js)
        _close_tree(tp, jp, ADAM_TOL, "params ")
        _close_tree(ts.mu, js.mu, ADAM_TOL, "mu ")
        _close_tree(ts.nu, js.nu, ADAM_TOL, "nu ")
        assert int(ts.step) == int(js.step) == i + 1
        assert ts.step.dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=ADAM_TOL)
    # the argument trees are left as they were
    tp2, _, _ = topt.adamw_update(cfg, tp, tg, ts)
    assert tp2["tok_embed"] is not tp["tok_embed"]


def test_int8_codes_and_error_feedback_match_jax():
    rng = np.random.default_rng(4)
    x = (30.0 * rng.standard_normal((64, 33))).clip(-126, 126).astype(
        np.float32)
    x[0, :5] = [127.0, 0.5, -0.5, 1.5, 2.5]     # scale 1: halves to even
    q, s = tcomp.quantize_int8(torch.from_numpy(x))
    assert q[0, 1:5].tolist() == [0, 0, 2, 2]
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    zq, zs = tcomp.quantize_int8(torch.zeros(5))
    assert float(zs) == 1.0 and not zq.any()
    np.testing.assert_array_equal(
        tcomp.dequantize_int8(q, s).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js)))
    tree = _sorted(_tree(5))
    tt = convert.lm_params(t_smoke("qwen2-0.5b"), tree, "cpu")
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    _close_tree(tcomp.compress_decompress(tt),
                jcomp.compress_decompress(jt), 0.0)
    tef, jef = tcomp.init_error_feedback(tt), jcomp.init_error_feedback(jt)
    for i in range(3):
        g = _sorted(_tree(20 + i))
        tg2, tef = tcomp.compress_with_feedback(
            convert.lm_params(t_smoke("qwen2-0.5b"), g, "cpu"), tef)
        jg2, jef = jcomp.compress_with_feedback(
            jax.tree_util.tree_map(jnp.asarray, g), jef)
        _close_tree(tg2, jg2, 0.0)
        _close_tree(tef.residual, jef.residual, 0.0)


# ---------------------------------------------------------------------------
# gradients and one step at the smoke configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", ["none", "int8"])
def test_train_step_matches_jax(compress):
    jcfg, tcfg, jp, tp, batch = _model("qwen2-0.5b", attn_impl="flash")
    adam = dict(lr=3e-3, warmup_steps=2, total_steps=6)
    jstep = jax.jit(jts.make_train_step(jcfg, jts.TrainConfig(
        grad_compress=compress, adamw=jopt.AdamWConfig(**adam))))
    tstep = tts.make_train_step(tcfg, tts.TrainConfig(
        grad_compress=compress, adamw=topt.AdamWConfig(**adam)))
    jo = jopt.init_opt_state(jp)
    to = topt.init_opt_state(tp)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jp2, jo2, jm = jstep(jp, jo, jb)
    tp2, to2, tm = tstep(tp, to, _tbatch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=GRAD_TOL)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=ADAM_TOL)
    # Adam's first move is about lr·sign(g): hold it where g stands above
    # rounding (an element whose gradient is at rounding level moves by
    # up to ±lr on either side, by chance)
    g_max = max(np.abs(m).max() for _, m in _leaves(jo2.mu))
    for (path, g), (_, w), (_, p0), (_, m) in zip(
            _leaves(tp2), _leaves(jp2), _leaves(tp), _leaves(jo2.mu)):
        live = np.abs(m) > 1e-4 * g_max
        err = np.abs((g - p0) - (w - p0))[live]
        assert err.size == 0 or err.max() <= 1e-3 * float(tm["lr"]), path
    _close_tree(to2.mu, jo2.mu, GRAD_TOL, "mu ")
    # a second step from JAX's parameters and AdamW state, carried across
    jnp_tree = jax.tree_util.tree_map(np.asarray, (jp2, jo2))
    tp3 = convert.lm_params(tcfg, jnp_tree[0], "cpu")
    to3 = convert.opt_state(jnp_tree[1], "cpu")
    assert to3.step.dtype == torch.int32 and int(to3.step) == 1
    _, jo4, jm4 = jstep(jp2, jo2, jb)
    _, to4, tm4 = tstep(tp3, to3, _tbatch(batch))
    np.testing.assert_allclose(float(tm4["loss"]), float(jm4["loss"]),
                               rtol=LOSS_TOL)
    assert int(to4.step) == int(jo4.step) == 2
    _close_tree(to4.nu, jo4.nu, GRAD_TOL, "nu ")


def test_mesh_and_sharding_raise():
    with pytest.raises(NotImplementedError, match="item 16"):
        tts.make_train_step(t_smoke("qwen2-0.5b"), tts.TrainConfig(),
                            mesh=object())
    with pytest.raises(NotImplementedError, match="item 16"):
        tts.shardings_for(t_smoke("qwen2-0.5b"), object())
    _, tcfg, _, tp, batch = _model("qwen2-0.5b")
    with pytest.raises(NotImplementedError, match="item 16"):
        tts.grads_and_loss(tcfg, tp, _tbatch(batch), shard_accum=True,
                           mesh=object())
