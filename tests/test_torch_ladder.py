"""Trajectory parity of the port's IPOP ladder with repro's.

* ``LadderEngine`` with ``eigen_interval = T``: no eigen refresh before the
  last generation, so B is the identity in both packages and the whole
  trace must agree (ints exact, floats to 1e-9), for the eval-fused path
  (f1, f2) and the X path (f8), sequential and concurrent.
* whole ``run_ipop`` at n = 4 on f1/f2: the JAX side's ``eigen_decompose``
  is wrapped with the port's sign convention, so the per-descent λ, fevals
  and stop reasons must be exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import cmaes as jcmaes
from repro.core import ipop as jipop
from repro.core import ladder as jladder
from repro.fitness import bbob as jb
from repro_torch.core import ipop as tipop
from repro_torch.core import ladder as tladder
from repro_torch.fitness import bbob as tb

T = 24


def _fitness(fid, n, instance=1):
    ji = jb.make_instance(fid, n, instance)
    ti = tb.make_instance(fid, n, instance, device="cpu")
    jf = lambda X: jb.evaluate(fid, ji, X)            # noqa: E731
    tf = lambda X: tb.evaluate(fid, ti, X)            # noqa: E731
    if fid in jb.FUSABLE_FIDS:
        jf = jb.fusable_fitness(ji, (fid,), jf)
        tf = tb.fusable_fitness(ti, (fid,), tf)
    return jf, tf, ji


@pytest.mark.parametrize("schedule", ["sequential", "concurrent"])
@pytest.mark.parametrize("fid", [1, 2, 8])
def test_ladder_trace_parity_deferred_eigen(schedule, fid):
    jf, tf, _ = _fitness(fid, 8)
    kw = dict(n=8, lam_start=8, kmax_exp=2, eigen_interval=T,
              schedule=schedule, max_evals=100_000)
    jc, jt = jladder.LadderEngine(**kw).run(jax.random.PRNGKey(3), jf, T)
    tc, tt = tladder.LadderEngine(**kw, device="cpu").run(3, tf, T)
    for f in jt._fields:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-9, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_allclose(tc.best_x.numpy(), np.asarray(jc.best_x),
                               rtol=1e-9)
    assert int(tc.total_fevals) == int(jc.total_fevals)


def _signed_eigen(C):
    """repro's eigen_decompose with the port's column-sign convention."""
    evals, evecs = jnp.linalg.eigh(C)
    pivot = jnp.argmax(jnp.abs(evecs), axis=-2, keepdims=True)
    sign = jnp.where(jnp.take_along_axis(evecs, pivot, axis=-2) < 0,
                     -1.0, 1.0)
    return evecs * sign, jnp.sqrt(jnp.maximum(evals, 1e-300))


@pytest.mark.parametrize("fid", [1, 2])
def test_run_ipop_exact_descents(fid, monkeypatch):
    monkeypatch.setattr(jcmaes, "eigen_decompose", _signed_eigen)
    n = 4
    jf, tf, ji = _fitness(fid, n)
    kw = dict(lam_start=8, kmax_exp=2, max_evals=4000)
    rj = jipop.run_ipop(jf, n, jax.random.PRNGKey(7), **kw)
    rt = tipop.run_ipop(tf, n, 7, device="cpu", **kw)
    assert rt.total_fevals == rj.total_fevals
    assert len(rt.descents) == len(rj.descents) >= 2
    for dt, dj in zip(rt.descents, rj.descents):
        assert (dt.k_exp, dt.lam, dt.stop_reason) == (dj.k_exp, dj.lam,
                                                      dj.stop_reason)
        np.testing.assert_array_equal(dt.gens, dj.gens)
        np.testing.assert_array_equal(dt.fevals, dj.fevals)
        np.testing.assert_allclose(dt.best_f, dj.best_f, rtol=1e-6)
    np.testing.assert_allclose(rt.best_f, rj.best_f, rtol=1e-6)
    assert rt.best_f - float(ji.f_opt) < 1e-8
    targets = np.array([1e2, 1.0, 1e-8])
    np.testing.assert_array_equal(rt.hit_evals(targets, float(ji.f_opt)),
                                  rj.hit_evals(targets, float(ji.f_opt)))


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        tladder.LadderEngine(n=3, eigen_schedule="flat", device="cpu")
    with pytest.raises(ValueError):
        tladder.LadderEngine(n=3, impl="xla", device="cpu")
    fn, _ = tb.make_fitness(1, 3, 1, device="cpu")
    with pytest.raises(NotImplementedError):
        tipop.run_ipop(fn, 3, 0, backend="bucketed", device="cpu")
