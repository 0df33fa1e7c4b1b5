"""Whole runs of the port's K-Distributed against repro's, on the CPU.

``KDistributed.run_sim`` and ``ladder.run_concurrent`` at n = 4 with 3 and 7
virtual devices, f1 and f2, both ``comm`` schedules, ``eigen_interval`` 1
and 4 (the nested eigen blocks, and a ragged last chunk that takes the
flat lazy scan), ``drop_prob`` 0 and 0.2, the ``eager`` and
``eager_unfused`` tiers: the evaluations, restarts and stop flags of every
generation exactly, best values to 1e-9 relative.  The JAX side's
``eigen_decompose`` carries the port's sign convention.
"""
import jax
import numpy as np
import pytest
import torch
from test_torch_ladder import _signed_eigen

from repro.core import cmaes as jcmaes
from repro.core import ladder as jladder
from repro.core import strategies as jst
from repro.fitness import bbob as jb
from repro_torch.core import ladder as tladder
from repro_torch.core import strategies as tst
from repro_torch.fitness import bbob as tb

N = 4
JAX_IMPL = {"eager": "xla", "eager_unfused": "xla_unfused", "auto": "auto"}
BEST = ("best_f", "gen_best", "descent_best")


@pytest.fixture(autouse=True)
def signed_jax_eigen(monkeypatch):
    monkeypatch.setattr(jcmaes, "eigen_decompose", _signed_eigen)


def _fitness(fid):
    ji = jb.make_instance(fid, N, 1)
    ti = tb.make_instance(fid, N, 1, device="cpu")
    return (lambda X: jb.evaluate(fid, ji, X),
            lambda X: tb.evaluate(fid, ti, X))


def _same_trace(got: dict, want: dict):
    assert set(got) == set(want)
    for k, a in want.items():
        a, b = np.asarray(a), np.asarray(got[k])
        assert a.shape == b.shape, k
        if k in BEST:
            np.testing.assert_allclose(b, a, rtol=1e-9, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def _same_carry(got, want):
    np.testing.assert_array_equal(got.fevals.numpy(), np.asarray(want.fevals))
    np.testing.assert_array_equal(got.restarts.numpy(),
                                  np.asarray(want.restarts))
    np.testing.assert_array_equal(got.states.stop.numpy(),
                                  np.asarray(want.states.stop))
    np.testing.assert_allclose(float(got.best_f), float(want.best_f),
                               rtol=1e-9)


# fid, devices, comm, eigen_interval, drop_prob, impl, generations
RUNS = [
    (1, 3, "stacked", None, 0.0, "eager", 60),
    (2, 7, "central", 4, 0.2, "eager_unfused", 42),   # chunks 16, 16, 10
    (1, 7, "stacked", 4, 0.0, "eager_unfused", 48),
    (1, 3, "central", None, 0.2, "eager", 150),
    (1, 7, "central", None, 0.0, "eager", 150),
    (2, 7, "stacked", 4, 0.2, "eager", 42),
]


@pytest.mark.parametrize("fid,P,comm,interval,drop,impl,T", RUNS)
def test_kdist_run_sim_matches_jax(fid, P, comm, interval, drop, impl, T):
    jf, tf = _fitness(fid)
    kw = dict(n=N, n_devices=P, comm=comm, eigen_interval=interval,
              drop_prob=drop)
    jc, jt = jst.KDistributed(impl=JAX_IMPL[impl], **kw).run_sim(
        jax.random.PRNGKey(3), jf, T)
    kd = tst.KDistributed(impl=impl, device="cpu", **kw)
    tc, tt = kd.run_sim(3, tf, T)
    _same_trace(tt, jt)
    _same_carry(tc, jc)
    if T == 150:                      # long enough for stops and restarts
        assert tt["stopped"].any() and int(tc.restarts.sum()) > 0


@pytest.mark.parametrize("fid,P,interval,impl,T", [
    (1, 7, None, "auto", 40), (2, 3, 4, "eager_unfused", 40)])
def test_run_concurrent_matches_jax(fid, P, interval, impl, T):
    """One chunk of every generation's keys; ``"auto"`` takes the plain
    versions on CPU tensors (and the kernels on the card)."""
    jf, tf = _fitness(fid)
    kw = dict(lam_start=12, eigen_interval=interval)
    jk, jc, jt = jladder.run_concurrent(N, P, jax.random.PRNGKey(6), jf, T,
                                        impl=JAX_IMPL[impl], **kw)
    tk, tc, tt = tladder.run_concurrent(N, P, 6, tf, T, impl=impl,
                                        device="cpu", **kw)
    assert tk.n_descents == jk.n_descents and tk.impl == impl
    assert tk.cfg.eigen_interval == jk.cfg.eigen_interval
    _same_trace(tt, jt)
    _same_carry(tc, jc)
    assert isinstance(tc.best_f, torch.Tensor)
