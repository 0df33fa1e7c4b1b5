"""The port's host-loop backend, the ladder's plain tiers, its flat eigen
schedule, ``restart_mode="same_k"`` and the result trees, against repro.

At n = 4 on f1/f2 the JAX side's ``eigen_decompose`` takes the port's sign
convention (``_signed_eigen``), so evaluations, descent lengths and stop
reasons must be exact:

* ``run_ipop(backend="hostloop")`` against JAX's host loop and against the
  port's own ladder;
* the ladder under ``impl="eager"`` and ``"eager_unfused"`` against JAX's
  ``"xla"`` and ``"xla_unfused"``;
* ``eigen_schedule="flat"`` (per-descent lazy eigen cadence) and the
  concurrent schedule under ``restart_mode="same_k"``, trace by trace;
* ``result_to_tree`` / ``result_template`` / ``result_from_tree``: the
  tree and metadata equal JAX's, the template its (shape, dtype) records,
  and the round trip gives the result back.
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
from torch_threads import one_thread  # noqa: F401

KW = dict(lam_start=8, kmax_exp=2, max_evals=4000)


def _signed_eigen(C):
    """repro's eigen_decompose with the port's column-sign convention."""
    evals, evecs = jnp.linalg.eigh(C)
    pivot = jnp.argmax(jnp.abs(evecs), axis=-2, keepdims=True)
    sign = jnp.where(jnp.take_along_axis(evecs, pivot, axis=-2) < 0,
                     -1.0, 1.0)
    return evecs * sign, jnp.sqrt(jnp.maximum(evals, 1e-300))


@pytest.fixture(autouse=True)
def signed_eigen(monkeypatch):
    monkeypatch.setattr(jcmaes, "eigen_decompose", _signed_eigen)


def _fitness(fid, n, instance=1):
    ji = jb.make_instance(fid, n, instance)
    ti = tb.make_instance(fid, n, instance, device="cpu")
    jf = jb.fusable_fitness(ji, (fid,), lambda X: jb.evaluate(fid, ji, X))
    tf = tb.fusable_fitness(ti, (fid,), lambda X: tb.evaluate(fid, ti, X))
    return jf, tf, ji


def _same_descents(got, want, rtol=1e-6):
    assert got.total_fevals == want.total_fevals
    assert len(got.descents) == len(want.descents) >= 2
    for dg, dw in zip(got.descents, want.descents):
        assert (dg.k_exp, dg.lam, dg.stop_reason) == (dw.k_exp, dw.lam,
                                                      dw.stop_reason)
        np.testing.assert_array_equal(dg.gens, dw.gens)
        np.testing.assert_array_equal(dg.fevals, dw.fevals)
        np.testing.assert_allclose(dg.best_f, dw.best_f, rtol=rtol)


@pytest.mark.parametrize("fid", [1, 2])
def test_hostloop_matches_jax_and_ladder(fid):
    jf, tf, ji = _fitness(fid, 4)
    rj = jipop.run_ipop(jf, 4, jax.random.PRNGKey(7), backend="hostloop",
                        chunk=16, **KW)
    rt = tipop.run_ipop(tf, 4, 7, backend="hostloop", chunk=16,
                        device="cpu", **KW)
    _same_descents(rt, rj)
    _same_descents(rt, tipop.run_ipop(tf, 4, 7, device="cpu", **KW), 1e-9)
    assert rt.best_f - float(ji.f_opt) < 1e-8
    with pytest.raises(ValueError):
        tipop.run_ipop(tf, 4, 7, backend="hostloop", total_gens=5,
                       device="cpu", **KW)


@pytest.mark.parametrize("impl,jax_impl", [("eager", "xla"),
                                           ("eager_unfused", "xla_unfused")])
@pytest.mark.parametrize("fid", [1, 2])
def test_plain_tiers_match_jax(fid, impl, jax_impl):
    jf, tf, _ = _fitness(fid, 4)
    rj = jipop.run_ipop(jf, 4, jax.random.PRNGKey(7), impl=jax_impl, **KW)
    rt = tipop.run_ipop(tf, 4, 7, impl=impl, device="cpu", **KW)
    _same_descents(rt, rj)


def _same_trace(tt, jt, rtol=1e-9):
    for f in jt._fields:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=rtol, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("fid", [1, 2])
def test_flat_schedule_matches_jax(fid):
    """The flat scan with the lazy per-descent eigen cadence (every third
    generation of each descent), restarts included."""
    jf, tf, _ = _fitness(fid, 4)
    kw = dict(n=4, **KW, eigen_interval=3, eigen_schedule="flat")
    jc, jt = jladder.LadderEngine(**kw).run(jax.random.PRNGKey(5), jf, 280)
    tc, tt = tladder.LadderEngine(**kw, device="cpu").run(5, tf, 280)
    assert np.asarray(jt.stopped).any()
    _same_trace(tt, jt)
    assert int(tc.total_fevals) == int(jc.total_fevals)


@pytest.mark.parametrize("restart_mode", ["same_k", "double"])
def test_concurrent_restart_mode_matches_jax(restart_mode):
    jf, tf, _ = _fitness(1, 4)
    kw = dict(n=4, **dict(KW, max_evals=20_000), schedule="concurrent",
              restart_mode=restart_mode, eigen_interval=1)
    jc, jt = jladder.LadderEngine(**kw).run(jax.random.PRNGKey(2), jf, 240)
    tc, tt = tladder.LadderEngine(**kw, device="cpu").run(2, tf, 240)
    assert np.asarray(jt.stopped).any()
    _same_trace(tt, jt)
    np.testing.assert_array_equal(tc.k_idx.numpy(), np.asarray(jc.k_idx))
    if restart_mode == "same_k":
        np.testing.assert_array_equal(tt.k_idx.numpy(), np.arange(3)[None]
                                      .repeat(tt.k_idx.shape[0], 0))


def test_result_tree_roundtrip():
    jf, tf, _ = _fitness(2, 4)
    rj = jipop.run_ipop(jf, 4, jax.random.PRNGKey(7), backend="hostloop",
                        **KW)
    rt = tipop.run_ipop(tf, 4, 7, backend="hostloop", device="cpu", **KW)
    tree_t, meta_t = tipop.result_to_tree(rt)
    tree_j, meta_j = jipop.result_to_tree(rj)
    assert meta_t == meta_j
    leaves_t = jax.tree_util.tree_leaves_with_path(tree_t)
    leaves_j = jax.tree_util.tree_leaves_with_path(tree_j)
    assert [p for p, _ in leaves_t] == [p for p, _ in leaves_j]
    for (p, a), (_, b) in zip(leaves_t, leaves_j):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=str(p))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(p))
    tmpl_t = tipop.result_template(meta_t)
    tmpl_j = jipop.result_template(meta_j)
    is_rec = lambda x: isinstance(x, tipop.ShapeDtype)    # noqa: E731
    recs = jax.tree_util.tree_leaves(tmpl_t, is_leaf=is_rec)
    assert [(r.shape, r.dtype) for r in recs] == [
        (s.shape, s.dtype) for s in jax.tree_util.tree_leaves(tmpl_j)]
    assert [(r.shape, r.dtype) for r in recs] == [
        (a.shape, a.dtype) for a in jax.tree_util.tree_leaves(tree_t)]
    back = tipop.result_from_tree(tree_t, meta_t)
    assert back.best_f == rt.best_f and back.total_fevals == rt.total_fevals
    np.testing.assert_array_equal(back.best_x, rt.best_x)
    for a, b in zip(back.descents, rt.descents):
        assert (a.k_exp, a.lam, a.stop_reason) == (b.k_exp, b.lam,
                                                   b.stop_reason)
        for x, y in zip(a[2:5], b[2:5]):
            np.testing.assert_array_equal(x, y)
