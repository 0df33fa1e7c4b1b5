"""Port's strategy parameters and stopping criteria against repro's.

Every CMAParams leaf is numpy arithmetic in both packages, so they must be
equal bit for bit; the stop bitmask must be equal on reference states built
to fire each of the 8 reasons (plus an empty history window).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cmaes as jcmaes
from repro.core import params as jparams
from repro.core import stopping as jstop
from repro_torch import convert
from repro_torch.core import params as tparams
from repro_torch.core import stopping as tstop
from torch_threads import one_thread  # noqa: F401


def _assert_params_equal(jp, tp):
    for f in jp._fields:
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("n", [2, 5, 40])
@pytest.mark.parametrize("lam,lam_max", [(4, 4), (6, 24), (12, 96), (37, 37)])
def test_make_params_exact(n, lam, lam_max):
    jc = jparams.CMAConfig(n=n, lam=lam, lam_max=lam_max)
    tc = tparams.CMAConfig(n=n, lam=lam, lam_max=lam_max)
    assert jc.eigen_interval == tc.eigen_interval
    assert jc.max_iter == tc.max_iter
    _assert_params_equal(jparams.make_params(jc), tparams.make_params(tc))
    _assert_params_equal(jparams.make_params(jc, lam=2),
                         tparams.make_params(tc, lam=2))


@pytest.mark.parametrize("n", [2, 5, 40])
def test_ladder_params_and_select_exact(n):
    jc = jparams.CMAConfig(n=n, lam=64, lam_max=64)
    tc = tparams.CMAConfig(n=n, lam=64, lam_max=64)
    js, ts = jparams.ladder_params(jc, 8, 3), tparams.ladder_params(tc, 8, 3)
    _assert_params_equal(js, ts)
    _assert_params_equal(js, convert.cma_params(
        jax.tree_util.tree_map(np.asarray, js), "cpu"))
    idx = np.array([2, 0, 3], np.int32)
    _assert_params_equal(jparams.select_params(js, jnp.asarray(idx)),
                         tparams.select_params(ts, torch.tensor(idx).long()))


# ---------------------------------------------------------------------------
# stop criteria
# ---------------------------------------------------------------------------

N, LAM, HIST = 5, 16, 64


def _cases():
    """(name, state overrides, f_sorted) per slot; each fires one reason."""
    lam_f = np.linspace(1.0, 2.0, LAM)
    flat_hist = np.full(HIST, np.inf)
    flat_hist[:30] = 3.0
    nan_hist = flat_hist.copy()
    nan_hist[3] = np.nan
    return [
        ("none", {}, lam_f),
        ("tolfun", dict(f_hist=flat_hist, hist_count=30),
         np.full(LAM, 3.0)),
        ("tolfunhist", dict(f_hist=flat_hist, hist_count=30), lam_f),
        ("tolfunhist_nan", dict(f_hist=nan_hist, hist_count=30), lam_f),
        ("tolx", dict(sigma=1e-20), lam_f),
        ("condition", dict(D=np.array([1e8, 1, 1, 1, 1.0])), lam_f),
        ("noeffectaxis", dict(m=np.full(N, 1e20)), lam_f),
        ("noeffectcoord", dict(m=np.array([1e20, 0, 0, 0, 0.0])), lam_f),
        ("tolupsigma", dict(sigma=1e25), lam_f),
        ("maxiter", dict(gen=10 ** 6), lam_f),
        ("empty_window", dict(hist_count=0), np.full(LAM, 3.0)),
    ]


def _states():
    cfg = jparams.CMAConfig(n=N, lam=LAM, sigma0=2.5)
    base = jcmaes.init_state(cfg, jax.random.PRNGKey(0),
                             jnp.linspace(-1.0, 1.0, N))
    base = jax.tree_util.tree_map(np.asarray, base)
    rows, fs = [], []
    for _, over, f in _cases():
        st = base._replace(gen=np.int32(5), hist_count=np.int32(40),
                           f_hist=np.linspace(1.0, 2.0, HIST))
        st = st._replace(**{k: np.asarray(v, getattr(st, k).dtype)
                            for k, v in over.items()})
        rows.append(st)
        fs.append(f)
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *rows)
    return cfg, stacked, np.stack(fs)


def test_check_stop_bitmask_matches_each_reason():
    cfg, st, fs = _states()
    S = fs.shape[0]
    jp = jparams.make_params(cfg)
    jsp = jax.tree_util.tree_map(lambda a: jnp.stack([a] * S), jp)
    want = np.asarray(jstop.check_stop_stacked(
        cfg, jsp, jax.tree_util.tree_map(jnp.asarray, st), jnp.asarray(fs)))

    tcfg = tparams.CMAConfig(n=N, lam=LAM, sigma0=2.5)
    tp = tparams.make_params(tcfg)
    tsp = tparams.CMAParams(*(torch.stack([a] * S) for a in tp))
    got = tstop.check_stop(tcfg, tsp, convert.cma_state(st, "cpu"),
                           torch.tensor(fs)).numpy()
    np.testing.assert_array_equal(got, want)

    names = [c[0] for c in _cases()]
    expect = {"tolfun": tstop.TOLFUN, "tolfunhist": tstop.TOLFUNHIST,
              "tolfunhist_nan": tstop.TOLFUNHIST, "tolx": tstop.TOLX,
              "condition": tstop.CONDITIONCOV,
              "noeffectaxis": tstop.NOEFFECTAXIS,
              "noeffectcoord": tstop.NOEFFECTCOORD,
              "tolupsigma": tstop.TOLUPSIGMA, "maxiter": tstop.MAXITER}
    for name, bit in expect.items():
        assert got[names.index(name)] & bit, name
    # every one of the 8 bits fired somewhere
    assert np.bitwise_or.reduce(got) == 255
    assert got[names.index("none")] == 0
    assert got[names.index("empty_window")] == 0


def test_reason_to_str():
    assert tstop.reason_to_str(0) == "none"
    assert (tstop.reason_to_str(tstop.TOLX | tstop.MAXITER)
            == jstop.reason_to_str(jstop.TOLX | jstop.MAXITER))
