"""The port's BBOB suite (f1–f24, the campaign forms, the separable-eval
pieces, the cost surrogates) against repro's: instances from the same key
schedule, values on the same X.

Instances: x_opt, f_opt and the Gallagher peaks' locations and weights bit
for bit (x_opt of f9 and f19 is Rᵀ·(0.5/c), so to 1e-12 as R); R, Q and
the peaks' scalings (a QR, and ``pow``) to 1e-12.

Values to rtol 1e-12, except where the function multiplies a last-ulp
difference of the rotated z (torch's and XLA's products X·Rᵀ sum in other
orders): f16's cosines of 2π·3¹¹·z (1e-9; up to 3.4e-10 at n = 40), f19's
cos(s) of s = 100·(z_i² − z_{i+1})² + … (1e-9; measured 1.4e-10 at n = 40
on the CPU) and f17/f18's sin(50·s^0.2) (1e-11; measured 1.2e-12 at
n = 5).  f7 and f23 round and floor: a mismatch is allowed only on a row
where JAX's z lies within 1e-12 of a rounding boundary, and such rows are
counted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fitness import bbob as jb
from repro.fitness import surrogates as jsur
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.fitness import bbob as tb
from repro_torch.fitness import surrogates as tsur
from torch_threads import one_thread  # noqa: F401

FIDS = list(range(1, 25))
RTOL = {16: 1e-9, 19: 1e-9, 17: 1e-11, 18: 1e-11}
#: rows of f7/f23 allowed to differ (near a rounding boundary), per case
BOUNDARY_ROWS = {}


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("fid", FIDS)
@pytest.mark.parametrize("n", [2, 5, 40])
def test_make_instance_matches(fid, n):
    _assert_instance_matches(fid, jb.make_instance(fid, n, 1),
                             tb.make_instance(fid, n, 1, device="cpu"))


def _assert_instance_matches(fid, ji, ti):
    exact = ("f_opt", "peaks_y", "peaks_w") + (
        () if fid in (9, 19) else ("x_opt",))
    for f in exact:
        np.testing.assert_array_equal(np.asarray(getattr(ji, f)),
                                      _np(getattr(ti, f)), err_msg=f)
    assert int(ji.fid) == int(ti.fid)
    # orthogonal matrices and the derived x_opt: entries O(1), to 1e-12;
    # peak scalings relative to the largest
    for f in ("R", "Q", "x_opt", "peaks_c"):
        want = np.asarray(getattr(ji, f))
        np.testing.assert_allclose(_np(getattr(ti, f)), want, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(want).max(), 1.0),
                                   err_msg=f)


def _near_rounding(fid, ji, X):
    """Rows of X where JAX's z of f7 (floor of zhat + 1/2 and of
    10·zhat + 1/2, the |zhat| = 1/2 switch) or of f23 (round of z·2ʲ)
    lies within 1e-12 of a boundary."""
    n = X.shape[-1]
    z = (X - ji.x_opt) @ ji.R.T
    if fid == 7:
        zh = z * jb.lam_alpha(10.0, n)
        d = jnp.minimum(jnp.minimum(
            jnp.abs(zh + 0.5 - jnp.round(zh + 0.5)),
            jnp.abs(10 * zh + 0.5 - jnp.round(10 * zh + 0.5)) / 10),
            jnp.abs(jnp.abs(zh) - 0.5))
    else:
        z = (z * jb.lam_alpha(100.0, n)) @ ji.Q.T
        j = 2.0 ** jnp.arange(1, 33)
        zj = z[..., None] * j
        d = jnp.abs(zj - jnp.floor(zj) - 0.5) / j
    return np.asarray(jnp.any(d.reshape(d.shape[0], -1) < 1e-12, -1))


@pytest.mark.parametrize("fid", FIDS)
@pytest.mark.parametrize("n", [2, 5, 40])
def test_evaluate_matches(fid, n):
    ji = jb.make_instance(fid, n, 3)
    ti = convert.bbob_instance(ji, "cpu")
    X = np.random.default_rng(fid * 100 + n).uniform(-5, 5, (65, n))
    X[0] = np.asarray(ji.x_opt)                        # the optimum itself
    X[1, 0] = 0.0 + np.asarray(ji.x_opt)[0]            # t_osz at exactly 0
    want = np.asarray(jb.evaluate(fid, ji, jnp.asarray(X)))
    got = _np(tb.evaluate(fid, ti, torch.tensor(X)))
    bad = ~(np.abs(got - want) <= RTOL.get(fid, 1e-12) * np.abs(want))
    if fid in (7, 23):
        near = _near_rounding(fid, ji, jnp.asarray(X))
        BOUNDARY_ROWS[(fid, n)] = int(np.sum(bad & near))
        bad &= ~near
    assert not bad.any(), (np.flatnonzero(bad), got[bad], want[bad])
    if fid in (1, 2, 8):         # the optimum's value is f_opt exactly
        assert got[0] == float(ji.f_opt)
    # make_fitness on the port's own instance 3: its leaves against JAX's,
    # then its values against JAX's evaluator on the port's rotations (the
    # two QRs may differ in the last ulp, which f16/f19/f23 amplify)
    fn, inst = tb.make_fitness(fid, n, 3, device="cpu")
    _assert_instance_matches(fid, ji, inst)
    own = ji._replace(R=jnp.asarray(_np(inst.R)), Q=jnp.asarray(_np(inst.Q)),
                      x_opt=jnp.asarray(_np(inst.x_opt)))
    want = np.asarray(jb.evaluate(fid, own, jnp.asarray(X)))
    got = _np(fn(torch.tensor(X)))
    bad = ~(np.abs(got - want) <= RTOL.get(fid, 1e-12) * np.abs(want))
    if fid in (7, 23):
        bad &= ~_near_rounding(fid, own, jnp.asarray(X))
    assert not bad.any(), (np.flatnonzero(bad), got[bad], want[bad])
    if fid in (1, 2, 8):         # no rotation: JAX's own instance exactly
        np.testing.assert_allclose(got, np.asarray(
            jb.evaluate(fid, ji, jnp.asarray(X))), rtol=1e-12)


@pytest.mark.parametrize("m", [1, 2, 20, 100, 2000])
@pytest.mark.parametrize("seed", [0, 7, 1234567])
def test_permutation_matches_jax(seed, m):
    """Bit for bit; m = 2000 takes two rounds of sorting."""
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), m))
    got = prng.permutation(prng.PRNGKey(seed), m).numpy()
    np.testing.assert_array_equal(got, want)


def _stacked_pair(fids, n, instance=2):
    jis = [jb.make_instance(f, n, instance) for f in fids]
    return jis, jb.stack_instances(jis), convert.bbob_instances(jis, "cpu")


def test_pad_and_stack_instances():
    fids = (1, 21, 22, 8)
    jis, js, ts = _stacked_pair(fids, 5)
    for f in js._fields:
        a, b = np.asarray(getattr(js, f)), _np(getattr(ts, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    ti = convert.bbob_instance(jis[2], "cpu")           # f22, 21 peaks
    padded = tb.pad_instance(ti, 101)
    want = jb.pad_instance(jis[2], 101)
    for f in ("peaks_y", "peaks_w", "peaks_c"):
        np.testing.assert_array_equal(_np(getattr(padded, f)),
                                      np.asarray(getattr(want, f)))
    assert tb.pad_instance(ti, 21) is ti


@pytest.mark.parametrize("menu", [(1, 21, 22, 8), (21, 22), (1, 22)])
def test_evaluate_stacked_matches_jax(menu):
    """A mixed menu with both Gallagher functions; members outside the menu
    (f8 in the last two) give NaN."""
    fids = (1, 21, 22, 8, 22)
    n = 6
    jis, js, ts = _stacked_pair(fids, n)
    X = np.random.default_rng(len(menu)).uniform(-5, 5, (len(fids), 9, n))
    X[1, 0] = np.asarray(jis[1].x_opt)
    want = np.asarray(jax.jit(jb.evaluate_stacked, static_argnums=3)(
        js.fid, js, jnp.asarray(X), menu))
    got = _np(tb.evaluate_stacked(ts.fid, ts, torch.tensor(X), menu))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any() == (8 not in menu)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12)
    for b, f in enumerate(fids):                      # one member at a time
        ti = convert.bbob_instance(jis[b], "cpu")
        one = _np(tb.evaluate_dynamic(ti, torch.tensor(X[b]), menu))
        np.testing.assert_array_equal(np.isnan(one), f not in menu)
        if f in menu:
            np.testing.assert_allclose(one, want[b], rtol=1e-12)


def test_stacked_fitness_groups_by_fid():
    """One evaluator call per distinct fid of the menu, and the separable
    coefficients of a stacked f1/f2 campaign equal per member."""
    _, _, ts = _stacked_pair((2, 1, 2, 1), 4)
    fit = tb.campaign_fitness(ts, (1, 2))
    assert [g[0] for g in fit.fn.groups] == [1, 2]
    X = torch.tensor(np.random.default_rng(0).uniform(-5, 5, (4, 7, 4)))
    np.testing.assert_allclose(_np(fit(X)),
                               _np(tb.separable_eval(X, fit.sep)), rtol=1e-12)
    for b in range(4):
        one = tb.separable_coeffs(tb.BBOBInstance(*(x[b] for x in ts)),
                                  (1, 2))
        for a, w in zip(one, fit.sep):
            np.testing.assert_array_equal(_np(a), _np(w[b]))


def test_groups_names_and_costs_match_jax():
    assert tb.GROUPS == jb.GROUPS and tb.NAMES == jb.NAMES
    assert tb.SEARCH_DOMAIN == jb.SEARCH_DOMAIN
    jm, tm = jsur.CostModel(), tsur.CostModel()
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    for lam, n, dev in ((12, 40, 1), (3072, 1000, 8), (96, 10, 512)):
        assert tm.t_iter(lam, n, dev) == jm.t_iter(lam, n, dev)
        assert tm.t_iter(lam, n, dev, 2, False) == jm.t_iter(lam, n, dev, 2,
                                                             False)
        assert tm.t_linalg(lam, n, dev) == jm.t_linalg(lam, n, dev)
    ji = jb.make_instance(3, 5, 1)
    ti = convert.bbob_instance(ji, "cpu")
    X = np.random.default_rng(3).uniform(-5, 5, (6, 5))
    want = np.asarray(jsur.with_flops_cost(
        lambda x: jb.evaluate(3, ji, x), 3 * 2 * 8 ** 3, width=8)(
            jnp.asarray(X)))
    tfn = lambda x: tb.evaluate(3, ti, x)              # noqa: E731
    got = _np(tsur.with_flops_cost(tfn, 3 * 2 * 8 ** 3, width=8)(
        torch.tensor(X)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_array_equal(got, _np(tfn(torch.tensor(X))))
    assert tsur.with_flops_cost(tfn, 0.0) is tfn


@pytest.mark.parametrize("fid", [1, 2])
@pytest.mark.parametrize("n", [2, 5, 40])
def test_separable_eval_matches(fid, n):
    ji = jb.make_instance(fid, n, 2)
    ti = tb.make_instance(fid, n, 2, device="cpu")
    jsep = jb.separable_coeffs(ji, (1, 2))
    tsep = tb.separable_coeffs(ti, (1, 2))
    np.testing.assert_array_equal(np.asarray(jsep.scale), _np(tsep.scale))
    assert int(jsep.mode) == int(tsep.mode) and bool(tsep.valid)
    X = np.random.default_rng(n).uniform(-5, 5, (3, 17, n))
    want = np.asarray(jb.separable_eval(jnp.asarray(X), jsep))
    got = _np(tb.separable_eval(torch.tensor(X), tsep))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # the dispatched evaluator agrees with the separable form
    np.testing.assert_allclose(
        got[0], _np(tb.evaluate(fid, ti, torch.tensor(X[0]))), rtol=1e-12)


def test_fid_outside_menu_is_nan():
    ji = jb.make_instance(2, 5, 1)
    ti = tb.make_instance(2, 5, 1, device="cpu")
    X = np.random.default_rng(0).uniform(-5, 5, (4, 5))
    want = np.asarray(jb.separable_eval(jnp.asarray(X),
                                        jb.separable_coeffs(ji, (1,))))
    got = _np(tb.separable_eval(torch.tensor(X),
                                tb.separable_coeffs(ti, (1,))))
    assert np.isnan(want).all() and np.isnan(got).all()


def test_fusable_fitness_wraps_only_separable_menus():
    fn, inst = tb.make_fitness(8, 4, 1, device="cpu")
    assert tb.fusable_fitness(inst, (8,), fn) is fn
    f1, i1 = tb.make_fitness(1, 4, 1, device="cpu")
    wrapped = tb.fusable_fitness(i1, (1,), f1)
    assert wrapped.sep is not None
    X = torch.zeros((2, 4), dtype=torch.float64)
    torch.testing.assert_close(wrapped(X), f1(X))


@pytest.mark.parametrize("fid", [0, 25])
def test_unknown_fid_raises(fid):
    with pytest.raises(ValueError):
        tb.make_instance(fid, 4, 1, device="cpu")
    with pytest.raises(ValueError):
        tb.evaluate(fid, tb.make_instance(1, 4, 1, device="cpu"),
                    torch.zeros((2, 4), dtype=torch.float64))
