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
from repro_torch.fleet import FleetConfig

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


def test_run_ipop_signature_matches_jax():
    """The parameters both packages' ``run_ipop`` take come in JAX's order
    with JAX's defaults; the port adds only the keyword ``device``."""
    import inspect
    jp = inspect.signature(jipop.run_ipop).parameters
    tp = inspect.signature(tipop.run_ipop).parameters
    shared = [p for p in jp if p in tp]
    assert shared == ["fitness_fn", "n", "key", "lam_start", "kmax_exp",
                      "max_evals", "domain", "sigma0_frac", "chunk", "impl",
                      "dtype", "total_gens", "backend", "mesh_strategy",
                      "fleet"]
    assert list(tp)[:len(shared)] == shared
    for p in shared[3:]:
        if p != "impl":                  # the two packages' tier names
            assert tp[p].default == jp[p].default, p
    assert tp["impl"].default == jp["impl"].default == "auto"
    assert [p for p in tp if p not in jp] == ["device"]
    assert tp["device"].kind is inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("backend", ["ladder", "bucketed", "hostloop",
                                     "mesh", "service"])
def test_run_ipop_validates_impl_first(backend):
    """As the JAX package does, ``impl`` is checked at entry for every
    backend, before an unported backend raises."""
    fn, _ = tb.make_fitness(1, 3, 1, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        tipop.run_ipop(fn, 3, 0, impl="pallas", backend=backend,
                       device="cpu")


def test_unported_options_raise():
    """The flat eigen schedule, the plain tiers, the host loop, the mesh
    and the service backends are ported; unknown options raise ValueError,
    and so does a fleet on the ladder, as in JAX (fleet supervision runs on
    the segment-driven backends only)."""
    with pytest.raises(ValueError):
        tladder.LadderEngine(n=3, eigen_schedule="blocked", device="cpu")
    with pytest.raises(ValueError):
        tladder.LadderEngine(n=3, impl="xla", device="cpu")
    with pytest.raises(ValueError):
        tladder.LadderEngine(n=3, restart_mode="half", device="cpu")
    fn, _ = tb.make_fitness(1, 3, 1, device="cpu")
    with pytest.raises(ValueError, match="fleet supervision"):
        tipop.run_ipop(fn, 3, 0, backend="ladder", fleet=FleetConfig(),
                       device="cpu")
    with pytest.raises(ValueError, match="total_gens"):
        tipop.run_ipop(fn, 3, 0, backend="service", total_gens=5,
                       device="cpu")
    with pytest.raises(ValueError, match="strategy"):
        tipop.run_ipop(fn, 3, 0, backend="mesh", mesh_strategy="barrier",
                       device="cpu")
    with pytest.raises(ValueError, match="total_gens"):
        tipop.run_ipop(fn, 3, 0, backend="mesh", total_gens=5, device="cpu")


@pytest.mark.parametrize("strategy", ["ordered", "concurrent"])
def test_run_ipop_mesh_backend_runs(strategy):
    """``backend="mesh"`` now runs, under both strategies, and gives the
    bucketed backend's run on f8 (the JAX package's own check,
    ``tests/test_mesh_engine.py``)."""
    fn, _ = tb.make_fitness(8, 4, 1, device="cpu")
    kw = dict(lam_start=8, kmax_exp=2, max_evals=2000, device="cpu")
    r_b = tipop.run_ipop(fn, 4, 7, backend="bucketed", **kw)
    r_m = tipop.run_ipop(fn, 4, 7, backend="mesh", mesh_strategy=strategy,
                         **kw)
    assert r_m.total_fevals == r_b.total_fevals > 0
    assert [(d.k_exp, d.lam, d.stop_reason) for d in r_m.descents] == \
        [(d.k_exp, d.lam, d.stop_reason) for d in r_b.descents]
    for dm, db in zip(r_m.descents, r_b.descents):
        np.testing.assert_array_equal(dm.fevals, db.fevals)
    np.testing.assert_allclose(r_m.best_f, r_b.best_f, rtol=1e-12)
