"""The port's Mixture-of-Experts FFN (``repro_torch.models.moe``) and the
moe family against the JAX package's.

The op on the same inputs, both dispatches, at a capacity factor of 0.5,
where tokens are dropped: float32 to 2e-5 of the largest |value|,
bfloat16 to 2e-2.  bfloat16 is held here, on identical bf16 inputs, and
not through a whole model: there the two packages' activations differ by
rounding, and a near-tie between two experts' probabilities can then send
a token elsewhere.  Whole models (moonshot-v1-16b-a3b, phi3.5-moe, and
the row-local dispatch) in float32 to 1e-4 (``torch_lm_parity``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from torch_lm_parity import OP_TOL, cfg_pair, check_model, close, pair
from torch_threads import one_thread  # noqa: F401


def _params(d, ff, E, glu, seed=0):
    p = jax.tree_util.tree_map(np.asarray, jmoe.init_moe_params(
        jax.random.PRNGKey(seed), d, ff, E, glu, jnp.float32))
    rng = np.random.default_rng(seed)
    return {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["global", "rowwise"])
@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu")])
def test_moe_op(dtype, dispatch, glu, act):
    d, ff, E, k = 32, 48, 8, 3
    p = _params(d, ff, E, glu)
    jp = {n: jnp.asarray(v).astype(jnp.dtype(dtype)) for n, v in p.items()}
    tp = {n: torch.tensor(v).to(tl.dtype_of(dtype)) for n, v in p.items()}
    x = np.random.default_rng(1).standard_normal((3, 20, d))
    jx, tx = pair(x, dtype)
    jo, jaux = jax.jit(lambda p, x: jmoe.moe(p, x, k, 0.5, act,
                                             dispatch=dispatch))(jp, jx)
    to, taux = tmoe.moe(tp, tx, k, 0.5, act, dispatch=dispatch)
    assert to.dtype == tx.dtype and taux.dtype == torch.float32
    close(to, jo, OP_TOL[dtype], what="out")
    close(taux, jaux, OP_TOL["float32"], what="aux")
    # capacity 0.5: some assignments were dropped, in both
    T = 60 if dispatch == "global" else 20
    C = max(1, int(T * k / E * 0.5 + 0.999))
    assert C * E < T * k


def test_moe_drops_by_jax_rule():
    """A token whose every expert is past capacity keeps only its residual:
    its output row is zero in both packages, at the same tokens."""
    d, ff, E, k = 16, 24, 4, 2
    p = _params(d, ff, E, True, seed=3)
    x = np.random.default_rng(4).standard_normal((1, 40, d))
    jo, _ = jmoe.moe({n: jnp.asarray(v) for n, v in p.items()},
                     jnp.asarray(x, jnp.float32), k, 0.25)
    to, _ = tmoe.moe({n: torch.tensor(v) for n, v in p.items()},
                     torch.tensor(x, dtype=torch.float32), k, 0.25)
    j_zero = np.all(np.asarray(jo) == 0, axis=-1)
    t_zero = torch.all(to == 0, dim=-1).numpy()
    assert j_zero.any() and np.array_equal(j_zero, t_zero)
    close(to, jo, OP_TOL["float32"])


def test_moe_sum_is_repeatable():
    """The k outputs of a token are added in a fixed order: two calls give
    the same bits."""
    p = {n: torch.tensor(v) for n, v in _params(32, 48, 8, True).items()}
    x = torch.tensor(np.random.default_rng(5).standard_normal((2, 30, 32)),
                     dtype=torch.float32)
    a, _ = tmoe.moe(p, x, 3)
    b, _ = tmoe.moe(p, x, 3)
    assert torch.equal(a, b)


def test_init_moe_params_shapes():
    pt = tmoe.init_moe_params(tl.generator(0, "cpu"), 32, 48, 8, True,
                              "float32", "cpu", lead=(2,))
    pj = jmoe.init_moe_params(jax.random.PRNGKey(0), 32, 48, 8, True,
                              jnp.float32)
    assert {n: tuple(v.shape) for n, v in pt.items()} == \
        {n: (2,) + v.shape for n, v in pj.items()}


@pytest.mark.parametrize("arch,dispatch", [
    ("moonshot-v1-16b-a3b", "global"), ("phi3.5-moe-42b-a6.6b", "global"),
    ("moonshot-v1-16b-a3b", "rowwise")])
def test_moe_model(arch, dispatch):
    jc, tc = cfg_pair(arch, "float32", moe_dispatch=dispatch,
                      attn_impl="flash")
    check_model(jc, tc)
