"""The port's counter stream (repro_torch/kernels/ref.py, the plain version
of the ``impl="kernel_rng"`` sample kernels) against the JAX package's
``pallas_rng`` tier.

Threefry words and uniforms must be bit-exact.  Z may differ by the few
ulp that separate two math libraries' ``log1p`` and ``cos``: the stated
tolerance is 4 ulp of |z| (the largest seen is 2 in float64 and 3 in
float32).  Sampled (Y, X) and (Y, F) agree with the JAX refs to 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fitness import bbob as jb
from repro.kernels import cma_gen as jcg
from repro.kernels import ref as jref
from repro_torch.core import prng
from repro_torch.fitness import bbob as tb
from repro_torch.kernels import cma_gen, ops
from repro_torch.kernels import ref as tref
from torch_threads import one_thread  # noqa: F401

RNG_SHAPES = [(1, 8, 4), (3, 12, 10), (2, 6, 7), (2, 9, 130)]
DTYPES = [(jnp.float64, torch.float64), (jnp.float32, torch.float32)]
ULP_TOL = 4


def _seeds(S, seed):
    """(S, 2) uint32 seed words with high bits set, from numpy."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=(S, 2), dtype=np.uint64).astype(
        np.uint32)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a)).to(dtype)


def _gen_inputs(S, n, seed=0):
    rng = np.random.default_rng(seed)
    return dict(m=rng.normal(size=(S, n)), sigma=rng.uniform(0.1, 0.5, S),
                B=np.linalg.qr(rng.normal(size=(S, n, n)))[0],
                D=rng.uniform(0.5, 2.0, (S, n)))


def test_threefry_words_and_units_bit_exact():
    rng = np.random.default_rng(1)
    k = rng.integers(0, 2 ** 32, size=(2, 64), dtype=np.uint64).astype(
        np.uint32)
    c = rng.integers(0, 2 ** 32, size=(2, 64), dtype=np.uint64).astype(
        np.uint32)
    want = jax.jit(jref._threefry2x32)(k[0], k[1], c[0], c[1])
    got = prng.threefry2x32(*(torch.tensor(a.astype(np.int64))
                              for a in (k[0], k[1], c[0], c[1])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    bits = np.concatenate([c[0], [0, 1, 511, 512, 2 ** 31, 2 ** 32 - 1]]
                          ).astype(np.uint32)
    for jdt, tdt in DTYPES:
        want = np.asarray(jref._bits_to_unit(jnp.asarray(bits), jdt))
        got = tref.bits_to_unit(torch.tensor(bits.astype(np.int64)), tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.numpy(), want)


def _assert_ulp(got, want, tol=ULP_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    ulp = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulp.max() <= tol, ulp.max()


@pytest.mark.parametrize("S,lam,n", RNG_SHAPES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f64", "f32"])
def test_sample_z_rng_matches_jax(S, lam, n, dtypes):
    jdt, tdt = dtypes
    seeds = _seeds(S, seed=S * 100 + lam)
    zr = jax.jit(lambda s: jref.sample_z_rng(s, lam, n, jdt))(seeds)
    zk = jax.jit(lambda s: jcg.cma_sample_z_rng(
        s, lam=lam, n=n, dtype=jdt, interpret=True))(seeds)
    got = tref.sample_z_rng(_t(seeds, torch.int64), lam, n, tdt)
    assert got.shape == (S, lam, n) and got.dtype == tdt
    _assert_ulp(got.numpy(), zr)
    _assert_ulp(got.numpy(), zk)


@pytest.mark.parametrize("S,lam,n", [(2, 12, 10), (1, 8, 33)])
def test_gen_sample_rng_matches_jax_ref(S, lam, n):
    a = _gen_inputs(S, n, seed=lam)
    seeds = _seeds(S, seed=3)
    ks = ("m", "sigma", "B", "D")
    want = jref.gen_sample_rng(*(jnp.asarray(a[k]) for k in ks),
                               jnp.asarray(seeds), lam)
    got = tref.gen_sample_rng(*(_t(a[k]) for k in ks), _t(seeds, torch.int64),
                              lam)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-14)


@pytest.mark.parametrize("fid", [1, 2])
def test_gen_sample_rng_eval_matches_jax_ref(fid):
    S, lam, n = 2, 12, 10
    a = _gen_inputs(S, n, seed=fid)
    seeds = _seeds(S, seed=7)
    jsep = jb.separable_coeffs(jb.make_instance(fid, n, 1), (1, 2))
    tsep = tb.separable_coeffs(tb.make_instance(fid, n, 1, device="cpu"),
                               (1, 2))
    ks = ("m", "sigma", "B", "D")
    want = jref.gen_sample_rng_eval(*(jnp.asarray(a[k]) for k in ks),
                                    jnp.asarray(seeds), lam, jsep)
    got = tref.gen_sample_rng_eval(*(_t(a[k]) for k in ks),
                                   _t(seeds, torch.int64), lam, tsep)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-14)


@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
def test_z_is_prefix_stable(tdt):
    """Z at (row, col) depends on the seed and the counter alone: a small
    call is the leading block of a large one, bit for bit.  (The CPU's
    GEMM may block a 12-row and a 40-row product differently, so the
    sampled rows are held bit for bit only kernel against kernel, on the
    card, by chip_smoke.py.)"""
    seeds = _t(_seeds(3, seed=11), torch.int64)
    big = tref.sample_z_rng(seeds, 48, 20, tdt)
    assert torch.equal(tref.sample_z_rng(seeds, 12, 7, tdt), big[:, :12, :7])
    assert torch.equal(tref.sample_z_rng(seeds[1:], 48, 20, tdt), big[1:])


def test_auto_never_resolves_to_kernel_rng_and_cpu_takes_plain():
    assert ops.validate_impl("auto") != "kernel_rng"
    assert ops.validate_impl("kernel_rng") == "kernel_rng"
    with pytest.raises(ValueError):
        ops.validate_impl("pallas_rng")
    a = {k: _t(v) for k, v in _gen_inputs(2, 6).items()}
    seeds = _t(_seeds(2, seed=5), torch.int64)
    before = dict(cma_gen.LAUNCHES)
    for g, w in zip(ops.gen_sample_rng(*a.values(), seeds, 9),
                    tref.gen_sample_rng(*a.values(), seeds, 9)):
        assert torch.equal(g, w)
    fn, inst = tb.make_fitness(2, 6, 1, device="cpu")
    sep = ops.slot_fitness(tb.fusable_fitness(inst, (2,), fn), 2,
                           torch.float64).sep
    for g, w in zip(ops.gen_sample_rng_eval(*a.values(), seeds, 9, sep),
                    tref.gen_sample_rng_eval(*a.values(), seeds, 9, sep)):
        assert torch.equal(g, w)
    assert cma_gen.LAUNCHES == before


def test_cuda_wrappers_refuse_cpu_tensors_and_wide_counters():
    a = {k: _t(v) for k, v in _gen_inputs(1, 4).items()}
    seeds = _t(_seeds(1, seed=2), torch.int64)
    sep = (a["m"], a["m"], a["sigma"], torch.ones(1, dtype=torch.int32),
           torch.ones(1, dtype=torch.int32))
    before = dict(cma_gen.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cma_gen.gen_sample_rng(*a.values(), seeds, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cma_gen.gen_sample_rng_eval(*a.values(), seeds, 8, *sep)
    with pytest.raises(ValueError, match="CUDA"):
        cma_gen.sample_z_rng(seeds, 8, 4)
    for lam, n in ((2 ** 16, 4), (8, 2 ** 16)):
        with pytest.raises(ValueError, match="2\\^16"):
            cma_gen.sample_z_rng(seeds, lam, n)
    with pytest.raises(ValueError, match="2\\^16"):
        cma_gen.gen_sample_rng(*a.values(), seeds, 2 ** 16)
    with pytest.raises(ValueError, match="2\\^16"):
        cma_gen.gen_sample_rng_eval(*a.values(), seeds, 2 ** 16, *sep)
    assert cma_gen.LAUNCHES == before
