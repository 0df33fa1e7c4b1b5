"""The port's jax.random rebuild (repro_torch/core/prng.py) against jax.

Key words, random bits and uniforms must match bit for bit; float64 normals
to 3 ulp (XLA's erf_inv polynomial is ported, the device's ``log`` is not).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 7, 123456789, 2 ** 33 + 5]


def _np(t):
    return t.cpu().numpy()


def _jkey(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_bit_exact(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_jkey(kj), _np(kt))
    for d in (0, 1, 17, 2 ** 32 - 1):
        np.testing.assert_array_equal(_jkey(jax.random.fold_in(kj, d)),
                                      _np(prng.fold_in(kt, d)))
    for num in (2, 3, 8):
        np.testing.assert_array_equal(_jkey(jax.random.split(kj, num)),
                                      _np(prng.split(kt, num)))
    # batched fold_in over a row of data, as the row-keyed draw uses it
    rows = jnp.arange(13, dtype=jnp.uint32)
    want = jax.vmap(jax.random.fold_in, (None, 0))(kj, rows)
    got = prng.fold_in(kt[None, :], torch.arange(13))
    np.testing.assert_array_equal(_jkey(want), _np(got))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(5,), (3, 7), (64,)])
def test_random_bits_bit_exact(seed, shape):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = np.asarray(jax.random.bits(kj, shape, jnp.uint32))
    np.testing.assert_array_equal(want.astype(np.int64),
                                  _np(prng.random_bits(kt, 32, shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("lohi", [(0.0, 1.0), (-4.0, 4.0), (-5.0, 5.0),
                                  (-100.0, 100.0)])
def test_uniform_bit_exact(seed, dtype, lohi):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    lo, hi = lohi
    for shape in [(), (5,), (3, 7), (257,)]:
        want = np.asarray(jax.random.uniform(kj, shape, dtype, lo, hi))
        got = _np(prng.uniform(kt, shape, getattr(torch, dtype), lo, hi))
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5])
def test_normal_f64_within_3_ulp(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = np.asarray(jax.random.normal(kj, (100_000,), jnp.float64))
    got = _np(prng.normal(kt, (100_000,), torch.float64))
    assert np.abs(want).max() > 4.0          # the tails are covered
    ulp = np.abs(want - got) / np.spacing(np.abs(want))
    assert ulp.max() <= 3.0
    assert (want == got).mean() > 0.999


def test_normal_rows_batched_like_vmap():
    """Row-keyed draw: per-row keys broadcast through ``normal``."""
    kj, kt = jax.random.PRNGKey(3), prng.PRNGKey(3)
    ks = jax.vmap(jax.random.fold_in, (None, 0))(
        kj, jnp.arange(6, dtype=jnp.uint32))
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (9,)))(ks))
    got = _np(prng.normal(prng.fold_in(kt[None], torch.arange(6)), (9,)))
    np.testing.assert_allclose(got, want, rtol=4 * np.finfo(float).eps)


def test_erf_inv_f64_matches_xla_on_edges():
    x = np.concatenate([[-1.0, 1.0, 0.0, -0.0, 1e-300, -1e-300],
                        np.linspace(-0.999999, 0.999999, 2001),
                        1.0 - np.logspace(-16, -1, 200)])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    got = _np(prng.erf_inv_f64(torch.tensor(x)))
    np.testing.assert_array_equal(np.isinf(want), np.isinf(got))
    fin = np.isfinite(want)
    scale = np.spacing(np.maximum(np.abs(want[fin]), 1e-300))
    assert (np.abs(want[fin] - got[fin]) <= 3 * scale).all()


def test_normal_float32_not_ported():
    with pytest.raises(NotImplementedError):
        prng.normal(prng.PRNGKey(0), (4,), torch.float32)
