"""The port's gradients (``train_step.grads_and_loss``, autograd through
the models and the plain kernels) against ``jax.value_and_grad`` of the
JAX package's ``lm.loss``, on the CPU at the smoke configs in float32,
from the JAX package's weights carried across with ``convert.lm_params``
(the helpers and tolerances of ``tests/test_torch_train.py``): the loss
to 1e-5 of its value, each gradient leaf to 1e-4 of its largest |value|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import train_step as jts
from repro_torch.train import train_step as tts
from test_torch_train import (GRAD_TOL, LOSS_TOL, _close_tree, _model,
                              _tbatch)
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("arch,impl,mb", [
    ("qwen2-0.5b", "naive", 1), ("qwen2-0.5b", "naive", 2),
    ("qwen2-0.5b", "flash", 1), ("qwen2-0.5b", "flash", 2),
    ("rwkv6-3b", "naive", 1),
])
def test_grads_and_loss_match_jax(arch, impl, mb):
    jcfg, tcfg, jp, tp, batch = _model(arch, attn_impl=impl)
    jgrad = jax.jit(lambda p, b: jts.grads_and_loss(jcfg, p, b, mb))
    jg, jl, jmet = jgrad(jp, jax.tree_util.tree_map(jnp.asarray, batch))
    tg, tl, tmet = tts.grads_and_loss(tcfg, tp, _tbatch(batch), mb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]),
                               rtol=LOSS_TOL)
    _close_tree(tg, jg, GRAD_TOL, f"{arch} {impl} mb={mb} ")
    for leaf in tts.leaves(tg):
        assert leaf.dtype == torch.float32


def test_remat_changes_nothing_but_memory():
    """``cfg.remat`` (checkpoint a layer and a CE chunk) gives the
    gradients of the plain forward, bit for bit on the CPU."""
    _, tcfg, _, tp, batch = _model("qwen2-0.5b", attn_impl="flash")
    on = tts.grads_and_loss(tcfg, tp, _tbatch(batch))
    off = tts.grads_and_loss(dataclasses.replace(tcfg, remat=False), tp,
                             _tbatch(batch))
    assert float(on[1]) == float(off[1])
    for a, b in zip(tts.leaves(on[0]), tts.leaves(off[0])):
        assert torch.equal(a, b)
