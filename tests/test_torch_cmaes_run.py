"""The port's dense single descent (``cmaes.step``, ``cmaes.run``) against
the JAX package's, in float64 on the CPU.

Both sides take the same key, x0 and σ₀; the JAX side's
``eigen_decompose`` carries the port's column-sign convention (as in
``tests/test_torch_ladder.py``), so B agrees wherever the eigenvalues are
distinct.  Integers must be equal and the bests within 1e-12.  At n = 8
the population is λ = 16 (μ = 8): with μ < n the first covariances have a
repeated eigenvalue, whose eigenvectors no sign convention pins.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cmaes as jcmaes
from repro.core.params import CMAConfig as JConfig
from repro.core.params import make_params as jmake_params
from repro.fitness import bbob as jb
from repro_torch import convert
from repro_torch.core import cmaes as tcmaes
from repro_torch.core import stopping
from repro_torch.core.params import CMAConfig, make_params
from repro_torch.fitness import bbob as tb
from torch_threads import one_thread  # noqa: F401

INT_FIELDS = ("gen", "last_eigen_gen", "fevals", "hist_count", "stop",
              "stop_reason", "restarts")


def _signed_eigen(C):
    evals, evecs = jnp.linalg.eigh(C)
    pivot = jnp.argmax(jnp.abs(evecs), axis=-2, keepdims=True)
    sign = jnp.where(jnp.take_along_axis(evecs, pivot, axis=-2) < 0,
                     -1.0, 1.0)
    return evecs * sign, jnp.sqrt(jnp.maximum(evals, 1e-300))


@pytest.fixture(autouse=True)
def _canonical_signs(monkeypatch):
    monkeypatch.setattr(jcmaes, "eigen_decompose", _signed_eigen)


def _fitness(name, n):
    if name == "sphere":
        return (lambda X: jnp.sum(X * X, axis=-1),
                lambda X: torch.sum(X * X, dim=-1))
    fid = int(name[1:])
    ji = jb.make_instance(fid, n, 1)
    ti = tb.make_instance(fid, n, 1, device="cpu")
    return (lambda X: jb.evaluate(fid, ji, X),
            lambda X: tb.evaluate(fid, ti, X))


def _dense(state):
    return tcmaes.CMAState(*(convert.tensor(np.asarray(x), "cpu")
                             for x in state))


def _assert_states(t, j, best_tol=1e-12, float_rtol=None):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert abs(float(t.best_f) - float(j.best_f)) <= best_tol * max(
        1.0, abs(float(j.best_f)))
    if float_rtol is not None:
        for f in ("m", "sigma", "C", "p_sigma", "p_c", "best_x"):
            np.testing.assert_allclose(getattr(t, f).numpy(),
                                       np.asarray(getattr(j, f)),
                                       rtol=float_rtol, atol=1e-14,
                                       err_msg=f)


@pytest.mark.parametrize("impl,jimpl", [("auto", "xla"),
                                        ("eager_unfused", "xla_unfused")])
def test_step_matches_jax(impl, jimpl):
    n, lam = 8, 16
    jf, tf = _fitness("f8", n)
    jcfg, cfg = JConfig(n=n, lam=lam), CMAConfig(n=n, lam=lam)
    x0 = np.linspace(-1.0, 1.0, n)
    js = jcmaes.init_state(jcfg, jax.random.PRNGKey(0), jnp.asarray(x0), 0.7)
    ts = tcmaes.init_dense_state(cfg, None, torch.from_numpy(x0), 0.7)
    for f in js._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    jp, tp = jmake_params(jcfg), make_params(cfg, device="cpu")
    for g in range(3):
        key = jax.random.PRNGKey(10 + g)
        one = tcmaes.step(cfg, tp, _dense(js), tf,
                          convert.tensor(np.asarray(key), "cpu"), impl=impl)
        js = jcmaes.step(jcfg, jp, js, jf, key, impl=jimpl)
        ts = tcmaes.step(cfg, tp, ts, tf,
                         convert.tensor(np.asarray(key), "cpu"), impl=impl)
        _assert_states(one, js, float_rtol=1e-12)
        _assert_states(ts, js, float_rtol=1e-10)


@pytest.mark.parametrize("impl,jimpl", [("auto", "xla"),
                                        ("eager_unfused", "xla_unfused")])
@pytest.mark.parametrize("n,lam,fn_name,sigma0,seed", [
    (4, 8, "sphere", 0.5, 42),
    (4, 8, "f8", None, 3),
    (8, 16, "f1", 1.5, 7),
])
def test_run_matches_jax(n, lam, fn_name, sigma0, seed, impl, jimpl):
    """Default ``max_gens`` (``cfg.max_iter``): the port stops at JAX's
    stop generation with JAX's evaluations."""
    jf, tf = _fitness(fn_name, n)
    jcfg, cfg = JConfig(n=n, lam=lam), CMAConfig(n=n, lam=lam)
    x0 = np.random.default_rng(seed).uniform(-3.0, 3.0, n)
    j = jcmaes.run(jcfg, jmake_params(jcfg), jf, jax.random.PRNGKey(seed),
                   jnp.asarray(x0), sigma0, impl=jimpl)
    t = tcmaes.run(cfg, make_params(cfg), tf, seed, torch.from_numpy(x0),
                   sigma0, impl=impl, device="cpu")
    assert bool(j.stop) and bool(t.stop)
    _assert_states(t, j)
    assert t.m.shape == (n,) and t.C.shape == (n, n) and t.sigma.shape == ()


def test_run_max_gens_and_key_forms():
    """A cut ``max_gens`` stops on MaxIter nowhere: the state is JAX's after
    exactly that many generations; a (2,) key equals the int seed."""
    n, lam = 4, 8
    jf, tf = _fitness("f8", n)
    jcfg, cfg = JConfig(n=n, lam=lam), CMAConfig(n=n, lam=lam)
    x0 = np.zeros(n)
    j = jcmaes.run(jcfg, jmake_params(jcfg), jf, jax.random.PRNGKey(5),
                   jnp.asarray(x0), 2.0, max_gens=17)
    t = tcmaes.run(cfg, make_params(cfg), tf, 5, x0, 2.0, max_gens=17,
                   device="cpu")
    t2 = tcmaes.run(cfg, make_params(cfg), tf,
                    np.asarray(jax.random.PRNGKey(5)), x0, 2.0, max_gens=17,
                    device="cpu")
    assert int(t.gen) == 17 and not bool(t.stop)
    _assert_states(t, j, float_rtol=1e-9)
    for a, b in zip(t, t2):
        assert torch.equal(a, b)
    assert (stopping.reason_to_str(int(t.stop_reason))
            == stopping.reason_to_str(int(j.stop_reason)))
