"""The port's rung-bucketed engine (repro_torch/core/bucketed.py) against
the JAX package's, and against the port's own padded ladder.

* sizing and scheduling (``bucket_config``, ``bucket_seg_gens``,
  ``next_bucket``, ``padding_report``) equal JAX's over a grid of inputs;
* ``run_ipop(backend="bucketed")`` equals ``backend="ladder"`` at n = 4 on
  f1, f2 and f8, and on f8 under ``kernel_rng`` too (ints exact, floats to
  1e-9; on f1/f2 both tiers of both backends are held against JAX below);
* it equals JAX's ``run_ipop(backend="bucketed")`` at n = 4 on f1/f2, and
  under ``impl="kernel_rng"`` JAX's ``impl="pallas_rng"`` on both backends
  (exact descents, fevals, stop reasons, ``hit_evals``).  The JAX side's
  ``eigen_decompose`` takes the port's sign convention, and its
  ``pallas_rng`` update, a float32 Pallas kernel off a TPU, is routed to
  its float64 ref: the port updates in the state dtype;
* the speculative driver is bit-identical, a budget below one generation
  gives empty progress, the schedule is read once per boundary, and a JAX
  carry converted to the port runs a bucketed segment.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucketed as jbucketed
from repro.core import cmaes as jcmaes
from repro.core import ipop as jipop
from repro.core import ladder as jladder
from repro.core import params as jparams
from repro.fitness import bbob as jb
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import bucketed as tbucketed
from repro_torch.core import ipop as tipop
from repro_torch.core import params as tparams
from repro_torch.fitness import bbob as tb
from torch_threads import one_thread  # noqa: F401

KW = dict(lam_start=8, kmax_exp=2, max_evals=2600)
JAX_IMPL = {"auto": "auto", "kernel_rng": "pallas_rng"}


def _fitness(fid, n, instance=1):
    ji = jb.make_instance(fid, n, instance)
    ti = tb.make_instance(fid, n, instance, device="cpu")
    jf = lambda X: jb.evaluate(fid, ji, X)            # noqa: E731
    tf = lambda X: tb.evaluate(fid, ti, X)            # noqa: E731
    if fid in jb.FUSABLE_FIDS:
        jf = jb.fusable_fitness(ji, (fid,), jf)
        tf = tb.fusable_fitness(ti, (fid,), tf)
    return jf, tf, ji


def _signed_eigen(C):
    """repro's eigen_decompose with the port's column-sign convention."""
    evals, evecs = jnp.linalg.eigh(C)
    pivot = jnp.argmax(jnp.abs(evecs), axis=-2, keepdims=True)
    sign = jnp.where(jnp.take_along_axis(evecs, pivot, axis=-2) < 0,
                     -1.0, 1.0)
    return evecs * sign, jnp.sqrt(jnp.maximum(evals, 1e-300))


@pytest.fixture
def jax_like_port(monkeypatch):
    monkeypatch.setattr(jcmaes, "eigen_decompose", _signed_eigen)
    # the update kernel is the only op _kernel_tier routes on this path;
    # its float64 ref is what the port computes
    monkeypatch.setattr(jops, "_kernel_tier", lambda impl: False)


# ---------------------------------------------------------------------------
# sizing and scheduling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,lam,lam_b,max_iter,interval", [
    (10, 128, 16, None, 7), (10, 128, 128, None, None), (3, 96, 24, 50, 2),
    (40, 3072, 12, None, None)])
def test_bucket_config_matches_jax(n, lam, lam_b, max_iter, interval):
    kw = dict(n=n, lam=lam, lam_max=lam, sigma0=2.5, tolfun=1e-9,
              max_iter=max_iter, eigen_interval=interval)
    want = jparams.bucket_config(jparams.CMAConfig(**kw), lam_b)
    got = tparams.bucket_config(tparams.CMAConfig(**kw), lam_b)
    for f in ("n", "lam", "lam_max", "sigma0", "hist_len", "eigen_interval",
              "tolfun", "max_iter", "max_iter_auto"):
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(ValueError):
        tparams.bucket_config(tparams.CMAConfig(**kw), 2 * lam)


def _engines(**kw):
    return (jbucketed.BucketedLadderEngine(**kw),
            tbucketed.BucketedLadderEngine(**kw, device="cpu"))


@pytest.mark.parametrize("interval", [None, 2, 3, 7])
def test_bucket_seg_gens_matches_jax(interval):
    for n, lam_start, kmax, budget in itertools.product(
            (4, 40), (8, 12), (2, 4), (100, 5000, 200_000)):
        je, te = _engines(n=n, lam_start=lam_start, kmax_exp=kmax,
                          max_evals=budget, eigen_interval=interval)
        for k in range(kmax + 1):
            for need in (None, 1, 7, 64, 10_000):
                assert te.bucket_seg_gens(k, need) == \
                    je.bucket_seg_gens(k, need), (n, lam_start, kmax, k, need)


@pytest.mark.parametrize("kmax", [1, 3])
@pytest.mark.parametrize("with_budgets", [False, True])
def test_next_bucket_matches_jax(kmax, with_budgets):
    rng = np.random.default_rng(4)
    je, te = _engines(n=4, lam_start=8, kmax_exp=kmax, max_evals=4000)
    for _ in range(40):
        B = int(rng.integers(1, 7))
        k_idx = rng.integers(0, kmax + 1, B).astype(np.int32)
        active = rng.random(B) < 0.8
        fevals = rng.integers(0, 4200, B)
        budgets = rng.integers(100, 5000, B) if with_budgets else None
        jl, tl = {}, {}
        for _step in range(2):        # the second call reuses seg_len
            want = jbucketed.next_bucket(je, k_idx, active, fevals, jl,
                                         budgets=budgets)
            got = tbucketed.next_bucket(te, k_idx, active, fevals, tl,
                                        budgets=budgets)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1] and tl == jl


def test_padding_report_matches_jax():
    rng = np.random.default_rng(2)
    for T, S in ((0, 1), (17, 1), (40, 3)):
        ran = rng.random((T, S)) < 0.7
        k_idx = rng.integers(0, 3, (T, S)).astype(np.int32)
        rest = {f: np.zeros((T, S)) for f in jladder.LadderTrace._fields
                if f not in ("ran", "k_idx")}
        jt = jladder.LadderTrace(ran=ran, k_idx=k_idx, **rest)
        tt = jt._replace(ran=torch.tensor(ran), k_idx=torch.tensor(k_idx))
        for padded in (8, 32):
            assert tbucketed.padding_report(tt, 8, 2, padded) == \
                jbucketed.padding_report(jt, 8, 2, padded)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

def _assert_same_run(got, want, float_rtol):
    assert got.total_fevals == want.total_fevals
    assert len(got.descents) == len(want.descents) >= 2
    for dg, dw in zip(got.descents, want.descents):
        assert (dg.k_exp, dg.lam, dg.stop_reason) == (dw.k_exp, dw.lam,
                                                      dw.stop_reason)
        np.testing.assert_array_equal(dg.gens, dw.gens)
        np.testing.assert_array_equal(dg.fevals, dw.fevals)
        np.testing.assert_allclose(dg.best_f, dw.best_f, rtol=float_rtol)
    np.testing.assert_allclose(got.best_f, want.best_f, rtol=float_rtol)


@pytest.mark.parametrize("fid,impl", [(1, "auto"), (2, "auto"), (8, "auto"),
                                      (8, "kernel_rng")])
def test_bucketed_equals_ladder(fid, impl):
    _, tf, _ = _fitness(fid, 4)
    kw = dict(KW, impl=impl, device="cpu")
    r_l = tipop.run_ipop(tf, 4, 7, **kw)
    r_b = tipop.run_ipop(tf, 4, 7, backend="bucketed", **kw)
    _assert_same_run(r_b, r_l, 1e-9)
    np.testing.assert_allclose(r_b.best_x, r_l.best_x, rtol=1e-9)


@pytest.mark.parametrize("backend,impl", [("bucketed", "auto"),
                                          ("bucketed", "kernel_rng"),
                                          ("ladder", "kernel_rng")])
@pytest.mark.parametrize("fid", [1, 2])
def test_run_ipop_matches_jax(fid, backend, impl, jax_like_port):
    jf, tf, ji = _fitness(fid, 4)
    rj = jipop.run_ipop(jf, 4, jax.random.PRNGKey(7), backend=backend,
                        impl=JAX_IMPL[impl], **KW)
    rt = tipop.run_ipop(tf, 4, 7, backend=backend, impl=impl, device="cpu",
                        **KW)
    _assert_same_run(rt, rj, 1e-6)
    assert rt.best_f - float(ji.f_opt) < 1e-8
    targets = np.array([1e2, 1.0, 1e-8])
    np.testing.assert_array_equal(rt.hit_evals(targets, float(ji.f_opt)),
                                  rj.hit_evals(targets, float(ji.f_opt)))


@pytest.mark.parametrize("impl", ["auto", "kernel_rng"])
def test_overlap_is_bit_identical(impl):
    _, tf, _ = _fitness(8, 4)
    kw = dict(n=4, **KW, impl=impl, device="cpu")
    log0, log1 = {}, {}
    c0, t0 = tbucketed.run_bucketed_single(
        tbucketed.BucketedLadderEngine(**kw), 7, tf, log=log0)
    c1, t1 = tbucketed.run_bucketed_single(
        tbucketed.BucketedLadderEngine(**kw, overlap=True), 7, tf, log=log1)
    s0, s1 = log0["segments"], log1["segments"]
    for a, b in zip(t0, t1):
        assert torch.equal(a, b)
    for a, b in zip(convert.to_numpy(c0), convert.to_numpy(c1)):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)
    assert [s["bucket"] for s in s0] == [s["bucket"] for s in s1]
    assert len(s1) > 3 and any(s["spec_hit"] for s in s1)
    assert not s1[0]["spec_hit"] and all("sync_s" in s for s in s1)
    assert not any("spec_hit" in s for s in s0)


def test_budget_below_one_generation_returns_empty_progress():
    fn, _ = tb.make_fitness(1, 3, 1, device="cpu")
    kw = dict(lam_start=8, kmax_exp=1, max_evals=4, device="cpu")
    r_l = tipop.run_ipop(fn, 3, 0, **kw)
    r_b = tipop.run_ipop(fn, 3, 0, backend="bucketed", **kw)
    assert r_l.total_fevals == r_b.total_fevals == 0
    assert r_l.descents == r_b.descents == []
    eng = tbucketed.BucketedLadderEngine(n=3, lam_start=8, kmax_exp=1,
                                         max_evals=4, device="cpu")
    log = {}
    _, trace = tbucketed.run_bucketed_single(eng, 0, fn, log=log)
    assert log == {"segments": [], "pulls": 1}
    assert trace.ran.shape == (0, 1)
    with pytest.raises(ValueError):
        tipop.run_ipop(fn, 3, 0, backend="bucketed", total_gens=5, **kw)


@pytest.mark.parametrize("overlap", [False, True])
def test_pull_schedule_once_per_boundary(overlap, monkeypatch):
    calls = []
    pull = tbucketed.pull_schedule

    def counting(carry, **kw):
        calls.append(kw.get("wait", True))
        return pull(carry, **kw)
    monkeypatch.setattr(tbucketed, "pull_schedule", counting)
    _, tf, _ = _fitness(1, 4)
    eng = tbucketed.BucketedLadderEngine(n=4, **KW, overlap=overlap,
                                         device="cpu")
    log = {}
    _, trace = tbucketed.run_bucketed_single(eng, 7, tf, log=log)
    segments = log["segments"]
    assert len(segments) >= 3
    assert len(calls) == log["pulls"] == len(segments) + 1
    assert sum(s["gens"] for s in segments) == trace.ran.shape[0]


def test_jax_carry_runs_a_bucketed_segment(jax_like_port):
    """A JAX carry, converted (repro_torch/convert.py), runs one bucket-0
    segment in the port as it does in JAX."""
    n, seg = 4, 24
    jf, tf, _ = _fitness(2, n)
    je = jbucketed.BucketedLadderEngine(n=n, **KW)
    te = tbucketed.BucketedLadderEngine(n=n, **KW, device="cpu")
    key = jax.random.PRNGKey(3)
    carry = je.init_carry(key)
    carry, _ = je.segment_scan(0, key, jf, carry, 8)
    jc, jt = je.segment_scan(0, key, jf, carry, seg)
    tc, tt = te.segment_scan(
        0, convert.tensor(np.asarray(key), "cpu"), tf,
        convert.ladder_carry(jax.tree_util.tree_map(np.asarray, carry), "cpu"),
        seg)
    for f in jt._fields:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-9, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert int(tc.total_fevals) == int(jc.total_fevals)
    np.testing.assert_allclose(tc.states.m.numpy(), np.asarray(jc.states.m),
                               rtol=1e-9)
