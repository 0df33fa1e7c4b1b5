"""The port's neural-fitness objective (repro_torch.fitness.nn_fitness) and
its data (repro_torch.data.pipeline) against the JAX package's, and driven
by the port's ``run_ipop``.

``SyntheticTokens`` is numpy on both sides: bit for bit.  The fitness of the
smoke qwen2 (float32 compute, flash attention, the JAX package's weights
carried across) agrees with JAX's on the same X within 1e-4 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.fitness import nn_fitness as jnn
from repro.models import lm as jlm
from repro_torch import configs, convert
from repro_torch.core import ipop
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.fitness import nn_fitness as tnn
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 2)])
def test_synthetic_tokens_bit_identical(shard, num_shards):
    for arch in configs.ARCHS:
        jd = JTokens(j_smoke_config(arch), seq_len=24, global_batch=4,
                     shard_index=shard, num_shards=num_shards, seed=3)
        td = SyntheticTokens(configs.smoke_config(arch), seq_len=24,
                             global_batch=4, shard_index=shard,
                             num_shards=num_shards, seed=3)
        cfg = configs.smoke_config(arch)
        inputs = "tokens" if cfg.embed_inputs else "frames"
        keys = {inputs, "labels"} | ({"img_embeds"} if cfg.family == "vlm"
                                     else set())
        for step in (0, 7, 999):
            jb, tb = jd.batch_at(step), td.batch_at(step)
            assert set(jb) == set(tb) == keys
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(jb[k], tb[k])
        it = td.iterate(start_step=7)
        np.testing.assert_array_equal(next(it)[inputs],
                                      td.batch_at(7)[inputs])
        it.close()


def _fitness_pair(dtype="float32"):
    kw = dict(dtype=dtype, attn_impl="flash")
    jc = dataclasses.replace(j_smoke_config("qwen2-0.5b"), **kw)
    tc = configs.override(configs.smoke_config("qwen2-0.5b"), **kw)
    p = jax.tree_util.tree_map(np.asarray,
                               jlm.init_params(jc, jax.random.PRNGKey(0)))
    batch = JTokens(jc, seq_len=32, global_batch=4, seed=1).batch_at(999)
    jfit, jspace = jnn.make_nn_fitness(
        jc, jax.tree_util.tree_map(jnp.asarray, p),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tfit, tspace = tnn.make_nn_fitness(tc, convert.lm_params(tc, p, device="cpu"),
                                       batch,
                                       device="cpu")
    return jfit, jspace, tfit, tspace


def test_nn_fitness_matches_jax():
    jfit, jspace, tfit, tspace = _fitness_pair()
    assert tspace.dim == jspace.dim == 4 and tspace.n_scales == 2
    X = np.random.default_rng(4).uniform(-3, 3, size=(5, tspace.dim))
    X[0] = 0.0
    want = np.asarray(jfit(jnp.asarray(X, jnp.float32)), np.float64)
    got = tfit(torch.tensor(X))
    assert got.dtype == torch.float64 and tuple(got.shape) == (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=0)
    # float32 in, float32 out; the adapter moves the loss
    got32 = tfit(torch.tensor(X, dtype=torch.float32))
    assert got32.dtype == torch.float32
    assert len(set(np.round(want, 6))) == 5


def test_apply_adapter_scales_only_output_projections():
    cfg = configs.smoke_config("rwkv6-3b")
    params = convert.lm_params(cfg, jax.tree_util.tree_map(
        np.asarray, jlm.init_params(j_smoke_config("rwkv6-3b"),
                                    jax.random.PRNGKey(1))), device="cpu")
    space = tnn.adapter_space(cfg)
    theta = torch.tensor([1.0, -2.0, 0.5, 0.3])
    p2, ls, eg = tnn._apply_adapter(space, params, theta)
    assert float(ls) == 0.5 and float(eg) == pytest.approx(0.3)
    unit, unit2 = params["segments"]["unit"], p2["segments"]["unit"]
    g = torch.tensor([1.1, 0.8]).reshape(2, 1, 1)
    torch.testing.assert_close(unit2["tmix"]["wo"], unit["tmix"]["wo"] * g)
    assert unit2["tmix"]["wr"] is unit["tmix"]["wr"]
    assert unit2["cmix"]["wv"] is unit["cmix"]["wv"]
    assert p2["tok_embed"] is params["tok_embed"]


def test_run_ipop_over_nn_fitness():
    """The port's entry point for the objective (JAX's example uses the
    dense ``cmaes.run``, not ported): the bucketed backend pays for whole
    generations only, and its evaluation count follows the budget rule."""
    _, _, tfit, tspace = _fitness_pair()
    rows = []

    def counted(X):
        rows.append(X.shape[0])
        assert X.dtype == torch.float64
        return tfit(X)
    budget = 72
    res = ipop.run_ipop(counted, tspace.dim, 5, lam_start=8, kmax_exp=1,
                        max_evals=budget, backend="bucketed", device="cpu")
    lam_last = res.descents[-1].lam
    assert res.total_fevals == sum(len(d.gens) * d.lam for d in res.descents)
    assert budget - lam_last < res.total_fevals <= budget
    assert sum(rows) >= res.total_fevals        # padded tail steps included
    assert np.isfinite(res.best_f)
    assert res.best_f == min(min(d.best_f) for d in res.descents)
