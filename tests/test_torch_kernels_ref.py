"""The port's plain kernel ops (repro_torch/kernels/ref.py) against
repro.kernels.ref in float64, and in float32 against the JAX package's
Pallas kernels in interpret mode; the dispatch of kernels/ops.py by tier
and device; the CUDA wrappers refuse CPU tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fitness import bbob as jb
from repro.kernels import cma_gen as jcg
from repro.kernels import ref as jref
from repro.kernels.cma_sample import cma_sample as j_cma_sample
from repro.kernels.cma_update import cma_rank_mu_update as j_rank_mu_update
from repro_torch.fitness import bbob as tb
from repro_torch.kernels import (cma_gen, cma_sample, cma_update, ops,
                                 sample_plan)
from repro_torch.kernels import ref as tref
from torch_threads import one_thread  # noqa: F401

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
    """The port's vocabulary: the kernel tiers ``auto`` and ``kernel_rng``
    and the plain tiers ``eager`` and ``eager_unfused``; each validates to
    itself (``auto`` never to ``kernel_rng``), and the JAX package's names
    are refused."""
    assert ops.IMPL_CHOICES == ("auto", "kernel_rng", "eager",
                                "eager_unfused")
    assert ops.KERNEL_TIERS == ("auto", "kernel_rng")
    for impl in ops.IMPL_CHOICES:
        assert ops.validate_impl(impl) == impl
    for impl in ("xla", "xla_unfused", "pallas", "pallas_rng"):
        with pytest.raises(ValueError):
            ops.validate_impl(impl)


# ---------------------------------------------------------------------------
# the strategies path's ops: sample_transform … rank_mu_update (kernels 7, 8)
# ---------------------------------------------------------------------------

def _ops_inputs(lam, n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = _inputs(1, lam, n, seed)
    w = rng.permutation(np.where(np.arange(lam) < lam // 2,
                                 rng.uniform(0.01, 1.0, lam), 0.0))
    out = dict(m=a["m"][0], sigma=np.float64(a["sigma"][0]), B=a["B"][0],
               D=a["D"][0], Z=a["Z"][0], C=a["C"][0], Y=a["Y"][0], w=w,
               p_c=a["p_c"][0], decay=0.7, c_mu=0.2, c_1=0.05)
    return {k: np.asarray(v, dtype) for k, v in out.items()}


OPS_SHAPES = [(5, 7), (12, 9), (3, 13), (16, 4)]       # (λ, n): odd n, λ < 8


@pytest.mark.parametrize("lam,n", OPS_SHAPES)
def test_strategy_ops_match_jax_ref(lam, n):
    """The five ops of ``repro.kernels.ref`` (:15-46), float64, to 1e-12."""
    a = _ops_inputs(lam, n)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.tensor(v) for k, v in a.items()}
    pairs = [
        (tref.sample_transform(t["B"], t["D"], t["Z"]),
         jref.sample_transform(j["B"], j["D"], j["Z"])),
        (tref.sample_points(t["m"], t["sigma"], t["B"], t["D"], t["Z"]),
         jref.sample_points(j["m"], j["sigma"], j["B"], j["D"], j["Z"])),
        (tref.rank_mu_gram(t["Y"], t["w"]), jref.rank_mu_gram(j["Y"], j["w"])),
        (tref.covariance_combine(t["C"], t["Y"].T @ t["Y"], t["p_c"],
                                 0.7, 0.2, 0.05),
         jref.covariance_combine(j["C"], j["Y"].T @ j["Y"], j["p_c"],
                                 0.7, 0.2, 0.05)),
        (tref.rank_mu_update(t["C"], t["Y"], t["w"], t["p_c"], 0.7, 0.2,
                             0.05),
         jref.rank_mu_update(j["C"], j["Y"], j["w"], j["p_c"], 0.7, 0.2,
                             0.05))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-14)
    # every tier's op on the CPU is the plain version
    for impl in ops.IMPL_CHOICES:
        assert torch.equal(ops.sample_transform(t["B"], t["D"], t["Z"],
                                                impl=impl), pairs[0][0])
        assert torch.equal(ops.rank_mu_update(
            t["C"], t["Y"], t["w"], t["p_c"], 0.7, 0.2, 0.05, impl=impl),
            pairs[4][0])


def test_sample_groups_is_the_per_group_op():
    """The grouped form (kernel 7's function): each group's rows are the
    unbatched op on that group's state, row for row; empty groups too."""
    G, n, starts = 4, 6, (0, 12, 12, 36, 40)
    rng = np.random.default_rng(3)
    B = torch.tensor(np.linalg.qr(rng.normal(size=(G, n, n)))[0])
    D = torch.tensor(rng.uniform(0.5, 2.0, (G, n)))
    m, sigma = torch.tensor(rng.normal(size=(G, n))), torch.rand(G).double()
    Z = torch.tensor(rng.normal(size=(starts[-1], n)))
    Y = ops.sample_transform(B, D, Z, starts)
    X = ops.sample_points(m, sigma, B, D, Z, starts)
    for g, (a, b) in enumerate(zip(starts, starts[1:])):
        assert torch.equal(Y[a:b], tref.sample_transform(B[g], D[g], Z[a:b]))
        assert torch.equal(X[a:b], tref.sample_points(m[g], sigma[g], B[g],
                                                      D[g], Z[a:b]))
    with pytest.raises(ValueError):
        ops.sample_transform(B, D, Z)                # starts is needed
    with pytest.raises(ValueError):
        cma_sample.check_starts((0, 12, 5, 36, 40), G, 40)
    with pytest.raises(ValueError):
        cma_sample.check_starts((0, 12, 40), G, 40)


@pytest.mark.parametrize("starts,rows", [((0, 12, 36, 84, 92), 64),
                                         ((0, 0, 130, 131), 64),
                                         ((0, 6144), 64)])
def test_sample_tile_table_covers_each_group(starts, rows):
    """The kernel's row tiles cover every group's rows exactly once, hold at
    most ``rows`` rows and never cross a group boundary."""
    tiles = sample_plan.tile_table(starts, rows, torch.device("cpu"))
    assert tiles.dtype == torch.int32 and tiles.shape[1] == 3
    covered = []
    for g, r0, r1 in tiles.tolist():
        assert starts[g] <= r0 < r1 <= starts[g + 1] and r1 - r0 <= rows
        covered += list(range(r0, r1))
    assert covered == list(range(starts[-1]))


def test_strategy_ops_f32_match_pallas_interpret():
    """float32: the plain versions against the TPU kernels 7 and 8 in
    interpret mode (which compute in float32), to 1e-4 relative."""
    lam, n = 12, 9
    a = _ops_inputs(lam, n, seed=4, dtype=np.float32)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.tensor(v) for k, v in a.items()}
    want = j_cma_sample(j["m"], j["sigma"], j["B"], j["D"], j["Z"],
                        interpret=True)
    got = ops.sample_points(t["m"], t["sigma"], t["B"], t["D"], t["Z"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    want = j_cma_sample(jnp.zeros(n, jnp.float32), jnp.float32(1.0), j["B"],
                        j["D"], j["Z"], interpret=True)
    got = ops.sample_transform(t["B"], t["D"], t["Z"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    want = j_rank_mu_update(j["C"], j["Y"], j["w"], j["p_c"], 0.7, 0.2, 0.05,
                            interpret=True)
    got = ops.rank_mu_update(t["C"], t["Y"], t["w"], t["p_c"], 0.7, 0.2, 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    want = j_rank_mu_update(jnp.zeros((n, n), jnp.float32), j["Y"], j["w"],
                            jnp.zeros(n, jnp.float32), 0.0, 1.0, 0.0,
                            interpret=True)
    got = ops.rank_mu_gram(t["Y"], t["w"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_zero_weight_rows_leave_rank_mu_update_unchanged():
    a = _ops_inputs(9, 6)
    t = {k: torch.tensor(v) for k, v in a.items()}
    Yp = torch.cat([t["Y"], torch.randn(5, 6, dtype=torch.float64)])
    wp = torch.cat([t["w"], torch.zeros(5, dtype=torch.float64)])
    torch.testing.assert_close(
        ops.rank_mu_update(t["C"], Yp, wp, t["p_c"], 0.7, 0.2, 0.05),
        ops.rank_mu_update(t["C"], t["Y"], t["w"], t["p_c"], 0.7, 0.2, 0.05),
        rtol=1e-14, atol=1e-15)


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor looks like a CUDA tensor to ``ops``, and the kernel
    wrappers of kernels 7 and 8 record their calls instead of launching."""
    calls = []
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)

    def fake_sample(B, D, Z, starts, m=None, sigma=None):
        calls.append("cma_sample")
        return tref.sample_groups(B, D, Z, starts, m, sigma)

    def fake_update(C, Y, w, p_c, coef):
        calls.append("cma_rank_mu_update")
        assert coef.shape == (C.shape[0], 3)
        return tref.rank_mu_update(C, Y, w, p_c, *coef.unbind(1))

    monkeypatch.setattr(cma_sample, "sample_groups", fake_sample)
    monkeypatch.setattr(cma_update, "rank_mu_update", fake_update)
    return calls


def test_eager_tiers_take_the_plain_version_on_the_card(fake_card):
    """On a CUDA tensor the kernel tiers launch kernels 7 and 8 and the
    eager tiers never do: ``eager_unfused``'s ``rank_mu_update`` is the
    plain version (the JAX package sends ``xla_unfused`` to its kernel)."""
    a = _ops_inputs(8, 5)
    t = {k: torch.tensor(v) for k, v in a.items()}

    def run_all(impl):
        return [ops.sample_transform(t["B"], t["D"], t["Z"], impl=impl),
                ops.sample_points(t["m"], t["sigma"], t["B"], t["D"], t["Z"],
                                  impl=impl),
                ops.rank_mu_gram(t["Y"], t["w"], impl=impl),
                ops.rank_mu_update(t["C"], t["Y"], t["w"], t["p_c"], 0.7,
                                   0.2, 0.05, impl=impl)]

    for impl in ("eager", "eager_unfused"):
        plain = run_all(impl)
        assert fake_card == []
    assert plain[3].equal(tref.rank_mu_update(t["C"], t["Y"], t["w"],
                                              t["p_c"], 0.7, 0.2, 0.05))
    for impl in ops.KERNEL_TIERS:
        fake_card.clear()
        got = run_all(impl)
        assert fake_card == ["cma_sample", "cma_sample", "cma_rank_mu_update",
                             "cma_rank_mu_update"]
        for g, p in zip(got, plain):
            torch.testing.assert_close(g, p, rtol=1e-13, atol=1e-14)
    assert ops.use_fused("auto") and ops.use_fused("eager")
    assert not ops.use_fused("eager_unfused")


@pytest.mark.parametrize("fid", [1, 2])
def test_sample_ops_honour_the_tier_on_the_card(fake_card, monkeypatch, fid):
    """The four fused sample ops (kernels 1-4) route through the tier as
    ``gen_update`` does: on a CUDA tensor the kernel tiers call the kernel
    wrappers, ``eager`` and ``eager_unfused`` the plain versions, with the
    same values."""
    S, lam, n = 2, 6, 5
    a = _inputs(S, lam, n, seed=fid)
    fn, inst = tb.make_fitness(fid, n, 1, device="cpu")
    sep = ops.slot_fitness(tb.fusable_fitness(inst, (fid,), fn), S,
                           torch.float64).sep
    seeds = torch.tensor([[7, 2 ** 31 + 3], [11, 5]])
    state = [_t(a[k]) for k in ("m", "sigma", "B", "D")]
    Z = _t(a["Z"])

    def fake(name, n_lead):
        plain = getattr(tref, name)

        def call(*args):
            fake_card.append(name)
            lead, rest = args[:n_lead], args[n_lead:]
            return plain(*lead, tb.SepCoeffs(*rest)) if rest else plain(*lead)
        monkeypatch.setattr(cma_gen, name, call)
    for name, n_lead in (("gen_sample", 5), ("gen_sample_eval", 5),
                         ("gen_sample_rng", 6), ("gen_sample_rng_eval", 6)):
        fake(name, n_lead)

    def run_all(impl):
        return [ops.gen_sample(*state, Z, impl=impl),
                ops.gen_sample_eval(*state, Z, sep, impl=impl),
                ops.gen_sample_rng(*state, seeds, lam, impl=impl),
                ops.gen_sample_rng_eval(*state, seeds, lam, sep, impl=impl)]

    plain = run_all("eager")
    assert fake_card == []
    assert run_all("eager_unfused") and fake_card == []
    for impl in ops.KERNEL_TIERS:
        fake_card.clear()
        got = run_all(impl)
        assert fake_card == ["gen_sample", "gen_sample_eval",
                             "gen_sample_rng", "gen_sample_rng_eval"]
        for g, p in zip(got, plain):
            for x, y in zip(g, p):
                assert torch.equal(x, y)
    with pytest.raises(ValueError):
        ops.gen_sample(*state, Z, impl="xla")


def test_kernel_7_and_8_wrappers_refuse_cpu_tensors():
    a = _ops_inputs(6, 4)
    t = {k: torch.tensor(v) for k, v in a.items()}
    before = dict(cma_gen.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cma_sample.sample_groups(t["B"][None], t["D"][None], t["Z"], (0, 6))
    with pytest.raises(ValueError, match="CUDA"):
        cma_update.rank_mu_update(t["C"][None], t["Y"][None], t["w"][None],
                                  t["p_c"][None],
                                  torch.ones(1, 3, dtype=torch.float64))
    assert cma_gen.LAUNCHES == before
    assert {"cma_sample", "cma_rank_mu_update"} <= set(cma_gen.LAUNCHES)
