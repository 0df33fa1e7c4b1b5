"""The port's plain generation ops (repro_torch/kernels/ref.py) against
repro.kernels.ref in float64, and in float32 against the JAX package's
Pallas kernels in interpret mode; the CUDA wrappers refuse CPU tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fitness import bbob as jb
from repro.kernels import cma_gen as jcg
from repro.kernels import ref as jref
from repro_torch.fitness import bbob as tb
from repro_torch.kernels import cma_gen, ops
from repro_torch.kernels import ref as tref

# (S, lam, n): odd n, λ < 8, S > 1
SHAPES = [(1, 5, 7), (3, 16, 9), (2, 7, 13)]
COEF = ("c_sigma", "mu_eff", "c_c", "c_1", "c_mu", "chi_n", "gen1")


def _inputs(S, lam, n, seed=0):
    rng = np.random.default_rng(seed)
    B = np.linalg.qr(rng.normal(size=(S, n, n)))[0]
    D = rng.uniform(0.5, 2.0, (S, n))
    C = B @ (D[..., None] ** 2 * np.swapaxes(B, -1, -2))
    C = np.triu(C) + np.swapaxes(np.triu(C, 1), -1, -2)
    w = np.zeros((S, lam))
    mu = lam // 2
    raw = np.log((lam + 1) / 2) - np.log(np.arange(1, mu + 1))
    for s in range(S):
        w[s, rng.permutation(lam)[:mu]] = raw / raw.sum()  # zero-weight rows
    if S > 1:
        w[-1] = 0.0                                        # an inactive slot
    coef = np.stack([rng.uniform(0.05, 0.4, S), rng.uniform(2, 5, S),
                     rng.uniform(0.05, 0.4, S), rng.uniform(1e-3, 0.05, S),
                     rng.uniform(1e-3, 0.1, S), np.full(S, np.sqrt(n)),
                     rng.integers(1, 9, S).astype(float)], axis=1)
    return dict(m=rng.normal(size=(S, n)), sigma=rng.uniform(0.1, 0.5, S),
                B=B, D=D, Z=rng.normal(size=(S, lam, n)), C=C,
                p_sigma=0.3 * rng.normal(size=(S, n)),
                p_c=0.3 * rng.normal(size=(S, n)),
                Y=rng.normal(size=(S, lam, n)), w=w, coef=coef)


def _t(a, dtype=torch.float64):
    return torch.tensor(a).to(dtype)


def _port_update(a, dtype=torch.float64):
    return tref.fused_gen_update(
        *(_t(a[k], dtype) for k in ("C", "B", "D", "p_sigma", "p_c", "Y",
                                    "w")),
        *_t(a["coef"], dtype).unbind(1))


@pytest.mark.parametrize("S,lam,n", SHAPES)
def test_gen_sample_matches_jax_ref(S, lam, n):
    a = _inputs(S, lam, n)
    ks = ("m", "sigma", "B", "D", "Z")
    want = jref.gen_sample(*(jnp.asarray(a[k]) for k in ks))
    got = tref.gen_sample(*(_t(a[k]) for k in ks))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


@pytest.mark.parametrize("S,lam,n", SHAPES)
@pytest.mark.parametrize("fid", [1, 2])
def test_gen_sample_eval_matches_jax_ref(S, lam, n, fid):
    a = _inputs(S, lam, n, seed=fid)
    ji = jb.make_instance(fid, n, 1)
    jsep = jb.separable_coeffs(ji, (1, 2))
    tsep = tb.separable_coeffs(tb.make_instance(fid, n, 1, device="cpu"),
                               (1, 2))
    ks = ("m", "sigma", "B", "D", "Z")
    want = jref.gen_sample_eval(*(jnp.asarray(a[k]) for k in ks), jsep)
    got = tref.gen_sample_eval(*(_t(a[k]) for k in ks), tsep)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


@pytest.mark.parametrize("S,lam,n", SHAPES)
def test_fused_gen_update_matches_jax_ref(S, lam, n):
    a = _inputs(S, lam, n)
    ks = ("C", "B", "D", "p_sigma", "p_c", "Y", "w")
    want = jax.vmap(jref.fused_gen_update)(
        *(jnp.asarray(a[k]) for k in ks),
        *(jnp.asarray(a["coef"][:, i]) for i in range(7)))
    got = _port_update(a)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-15)
    # C' is bitwise symmetric
    assert torch.equal(got[0], got[0].transpose(-1, -2))
    if S > 1:                      # the inactive slot pulled nothing in
        assert torch.equal(got[3][-1], torch.zeros(n, dtype=torch.float64))


def test_zero_weight_rows_are_inert():
    a = _inputs(2, 9, 6)
    pad = dict(a)
    pad["Y"] = np.concatenate([a["Y"], np.random.default_rng(5).normal(
        size=(2, 7, 6))], axis=1)
    pad["w"] = np.concatenate([a["w"], np.zeros((2, 7))], axis=1)
    for g, w in zip(_port_update(pad), _port_update(a)):
        torch.testing.assert_close(g, w, rtol=1e-14, atol=1e-15)


def test_f32_matches_pallas_interpret():
    S, lam, n = 2, 8, 8
    a = _inputs(S, lam, n, seed=3)
    f = {k: np.asarray(v, np.float32) for k, v in a.items()}
    ks = ("m", "sigma", "B", "D", "Z")
    Yk, Xk = jcg.cma_gen_sample(*(jnp.asarray(f[k]) for k in ks),
                                interpret=True)
    Yt, Xt = tref.gen_sample(*(_t(f[k], torch.float32) for k in ks))
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yk), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xk), rtol=1e-5,
                               atol=1e-6)

    ji = jb.make_instance(2, n, 1, jnp.float32)
    jsep = jb.separable_coeffs(ji, (1, 2))
    rows = lambda v: np.broadcast_to(np.asarray(v), (S, n)).astype(np.float32)  # noqa: E731
    Yk, Fk = jcg.cma_gen_sample_eval(
        *(jnp.asarray(f[k]) for k in ks), rows(jsep.scale), rows(jsep.shift),
        np.full(S, float(jsep.f_opt), np.float32), np.ones(S, np.int32),
        np.ones(S, np.int32), interpret=True)
    tsep = tb.SepCoeffs(torch.tensor(rows(jsep.scale)),
                        torch.tensor(rows(jsep.shift)),
                        torch.full((S,), float(jsep.f_opt)),
                        torch.ones(S, dtype=torch.int32),
                        torch.ones(S, dtype=torch.bool))
    Yt, Ft = tref.gen_sample_eval(*(_t(f[k], torch.float32) for k in ks),
                                  tsep._replace(f_opt=tsep.f_opt.float()))
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fk), rtol=1e-5)

    want = jcg.cma_gen_update(
        *(jnp.asarray(f[k]) for k in ("C", "B", "D", "p_sigma", "p_c", "Y",
                                      "w")), jnp.asarray(f["coef"]),
        interpret=True)
    got = _port_update(f, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_ops_on_cpu_take_the_plain_version():
    a = _inputs(2, 6, 5)
    ks = ("m", "sigma", "B", "D", "Z")
    for g, w in zip(ops.gen_sample(*(_t(a[k]) for k in ks)),
                    tref.gen_sample(*(_t(a[k]) for k in ks))):
        assert torch.equal(g, w)
    coef = {f: _t(a["coef"][:, i]) for i, f in enumerate(COEF)}
    got = ops.gen_update(*(_t(a[k]) for k in ("C", "B", "D", "p_sigma",
                                             "p_c", "Y", "w")), coef)
    for g, w in zip(got, _port_update(a)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fid", [1, 2])
def test_slot_sep_layout_gives_the_same_values(fid):
    """``ops.slot_sep`` lays a fitness's coefficients out per slot once per
    run, as the eval-fused kernel takes them; the plain path gives the same
    values from either layout, and ``slot_fitness`` leaves other closures
    alone."""
    S, lam, n = 3, 5, 6
    a = _inputs(S, lam, n, seed=fid)
    fn, inst = tb.make_fitness(fid, n, 1, device="cpu")
    fit = tb.fusable_fitness(inst, (fid,), fn)
    slot = ops.slot_fitness(fit, S, torch.float64)
    for leaf, shape, dt in zip(slot.sep, [(S, n), (S, n), (S,), (S,), (S,)],
                               [torch.float64] * 3 + [torch.int32] * 2):
        assert leaf.shape == shape and leaf.dtype == dt
        assert leaf.is_contiguous()
    assert slot.fn is fn
    assert ops.slot_fitness(fn, S, torch.float64) is fn
    ks = ("m", "sigma", "B", "D", "Z")
    got = ops.gen_sample_eval(*(_t(a[k]) for k in ks), slot.sep)
    want = tref.gen_sample_eval(*(_t(a[k]) for k in ks), fit.sep)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cuda_wrappers_refuse_cpu_tensors():
    a = _inputs(1, 4, 3)
    ks = ("m", "sigma", "B", "D", "Z")
    before = dict(cma_gen.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cma_gen.gen_sample(*(_t(a[k]) for k in ks))
    with pytest.raises(ValueError, match="CUDA"):
        cma_gen.gen_sample_eval(*(_t(a[k]) for k in ks), _t(a["m"]),
                                _t(a["m"]), _t(a["sigma"]),
                                torch.ones(1, dtype=torch.int32),
                                torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        cma_gen.gen_update(*(_t(a[k]) for k in ("C", "B", "D", "p_sigma",
                                                "p_c", "Y", "w", "coef")))
    assert cma_gen.LAUNCHES == before


def test_impl_vocabulary_is_auto_only():
    assert ops.validate_impl("auto") == "auto"
    with pytest.raises(ValueError):
        ops.validate_impl("xla")
