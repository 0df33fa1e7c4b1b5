"""The port's BBOB subset (f1, f2, f8 and the separable-eval pieces) against
repro's: instances from the same key schedule, values on the same X."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fitness import bbob as jb
from repro_torch import convert
from repro_torch.fitness import bbob as tb


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("fid", [1, 2, 8])
@pytest.mark.parametrize("n", [2, 5, 40])
def test_make_instance_matches(fid, n):
    ji = jb.make_instance(fid, n, 1)
    ti = tb.make_instance(fid, n, 1, device="cpu")
    np.testing.assert_array_equal(np.asarray(ji.x_opt), _np(ti.x_opt))
    np.testing.assert_array_equal(np.asarray(ji.f_opt), _np(ti.f_opt))
    assert int(ji.fid) == int(ti.fid)
    # orthogonal matrices: entries are O(1), compared to 1e-12
    for f in ("R", "Q"):
        np.testing.assert_allclose(_np(getattr(ti, f)),
                                   np.asarray(getattr(ji, f)),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fid", [1, 2, 8])
@pytest.mark.parametrize("n", [2, 5, 40])
def test_evaluate_matches(fid, n):
    ji = jb.make_instance(fid, n, 3)
    ti = convert.bbob_instance(ji, "cpu")
    X = np.random.default_rng(fid * 100 + n).uniform(-5, 5, (33, n))
    X[0] = np.asarray(ji.x_opt)                        # the optimum itself
    X[1, 0] = 0.0 + np.asarray(ji.x_opt)[0]            # t_osz at exactly 0
    want = np.asarray(jb.evaluate(fid, ji, jnp.asarray(X)))
    got = _np(tb.evaluate(fid, ti, torch.tensor(X)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got[0] == float(ji.f_opt)
    fn, _ = tb.make_fitness(fid, n, 3, device="cpu")
    np.testing.assert_allclose(_np(fn(torch.tensor(X))), want, rtol=1e-12)


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


def test_unported_fid_raises():
    with pytest.raises(NotImplementedError):
        tb.make_instance(3, 4, 1, device="cpu")
