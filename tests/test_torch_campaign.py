"""The port's campaigns (``ladder.run_campaign``,
``bucketed.run_campaign_bucketed`` under both policies) against repro's,
on the CPU at n = 4 with ``eigen_interval`` 1 (the JAX tests'
configuration), the JAX side's ``eigen_decompose`` in the port's sign
convention.

* menus (1, 2) and (1, 8, 21), 2 runs: on f1/f2 members the evaluations,
  every executed generation's rung, length and stop reason exactly, best
  values within 1e-9 of |f| + |f − f_opt|; on the chaotic members (f8,
  f21) the budget spent and the order of the rungs, and one generation
  from a loaded JAX campaign state to 1e-12;
* ``hit_evals``, ``padding_waste`` and ``compiles`` as JAX's; a budget
  below one generation gives JAX's empty trace; a campaign's member equals
  the same key run alone.

Each JAX campaign runs once per module (``jax_runs``): its vmapped
programs take seconds each to compile.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucketed as jbucketed
from repro.core import cmaes as jcmaes
from repro.core import ladder as jladder
from repro.fitness import bbob as jb
from repro_torch import convert
from repro_torch.core import bucketed as tbucketed
from repro_torch.core import ladder as tladder
from repro_torch.fitness import bbob as tb
from repro_torch.kernels import ops
from torch_threads import one_thread  # noqa: F401

KW = dict(n=4, lam_start=8, kmax_exp=1, max_evals=1600, eigen_interval=1)
MENUS = {"sep": (1, 2), "mixed": (1, 8, 21)}
ENGINES = ("ladder", "cover", "min")
TARGETS = 10.0 ** np.arange(2, -9, -1)


def _signed_eigen(C):
    """repro's eigen_decompose with the port's column-sign convention."""
    evals, evecs = jnp.linalg.eigh(C)
    pivot = jnp.argmax(jnp.abs(evecs), axis=-2, keepdims=True)
    sign = jnp.where(jnp.take_along_axis(evecs, pivot, axis=-2) < 0,
                     -1.0, 1.0)
    return evecs * sign, jnp.sqrt(jnp.maximum(evals, 1e-300))


def _campaign(pkg, engine, fids, **kw):
    if engine == "ladder":
        mod = jladder if pkg == "jax" else tladder
        eng = mod.LadderEngine(**KW, **kw) if pkg == "jax" else \
            mod.LadderEngine(**KW, **kw, device="cpu")
        return mod.run_campaign(eng, fids, runs=2)
    mod = jbucketed if pkg == "jax" else tbucketed
    eng = mod.BucketedLadderEngine(**KW, policy=engine, **kw) \
        if pkg == "jax" else mod.BucketedLadderEngine(
            **KW, policy=engine, **kw, device="cpu")
    return mod.run_campaign_bucketed(eng, fids, runs=2)


@pytest.fixture(scope="module")
def jax_runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcmaes, "eigen_decompose", _signed_eigen)
        return {(e, m): _campaign("jax", e, fids)
                for e in ENGINES for m, fids in MENUS.items()}


@pytest.fixture(scope="module")
def torch_runs():
    return {(e, m): _campaign("torch", e, fids)
            for e in ENGINES for m, fids in MENUS.items()}


def _rungs(trace, b):
    """The rungs member b ran, in order, each once."""
    k = np.asarray(trace.k_idx)[b, :, 0][np.asarray(trace.ran)[b, :, 0]]
    return [int(x) for i, x in enumerate(k) if i == 0 or x != k[i - 1]]


@pytest.mark.parametrize("menu", list(MENUS))
@pytest.mark.parametrize("engine", ENGINES)
def test_campaign_matches_jax(engine, menu, jax_runs, torch_runs):
    rj, rt = jax_runs[(engine, menu)], torch_runs[(engine, menu)]
    assert rt.members == rj.members
    np.testing.assert_array_equal(rt.f_opt, rj.f_opt)
    np.testing.assert_array_equal(rt.total_fevals, rj.total_fevals)
    assert rt.trace.ran.shape == np.asarray(rj.trace.ran).shape
    for b, (fid, _i, _r) in enumerate(rj.members):
        assert _rungs(rt.trace, b) == _rungs(rj.trace, b)
        if fid not in jb.FUSABLE_FIDS:
            continue
        for f in ("ran", "k_idx", "gen", "fevals", "stop_reason", "stopped",
                  "total_fevals"):
            np.testing.assert_array_equal(getattr(rt.trace, f)[b],
                                          np.asarray(getattr(rj.trace, f))[b],
                                          err_msg=f"member {b} {f}")
        for got, want in ((rt.best_f[b], rj.best_f[b]),
                          (rt.trace.global_best[b],
                           np.asarray(rj.trace.global_best)[b])):
            want = np.asarray(want)
            scale = np.abs(want) + np.abs(want - rj.f_opt[b])
            assert np.all(np.abs(got - want) <= 1e-9 * scale), b
        if fid == 1:
            assert rt.best_f[b] - rt.f_opt[b] < 1e-8


@pytest.mark.parametrize("engine", ENGINES)
def test_campaign_records_match_jax(engine, jax_runs, torch_runs):
    """``hit_evals`` on the separable menu, ``compiles`` and, for the
    bucketed driver, its padding and segments, as JAX's."""
    rj, rt = jax_runs[(engine, "sep")], torch_runs[(engine, "sep")]
    np.testing.assert_array_equal(rt.hit_evals(TARGETS),
                                  rj.hit_evals(TARGETS))
    for menu in MENUS:
        rj, rt = jax_runs[(engine, menu)], torch_runs[(engine, menu)]
        assert rt.compiles == rj.compiles
        if engine == "ladder":
            assert rt.compiles == 1
            continue
        assert rt.compiles <= KW["kmax_exp"] + 1
        assert (rt.useful_evals, rt.padded_evals) == (rj.useful_evals,
                                                      rj.padded_evals)
        assert rt.padding_waste() == rj.padding_waste()
        assert [(s["bucket"], s["gens"]) for s in rt.segments] == \
            [(s["bucket"], s["gens"]) for s in rj.segments]
        assert rt.pulls == len(rt.segments) + 1


def test_generation_from_loaded_jax_state(jax_runs, monkeypatch):
    """One campaign generation of the mixed menu (f8 and f21 members,
    evaluated through ``StackedFitness``) from a JAX carry after 12
    generations: the new states to 1e-12."""
    monkeypatch.setattr(jcmaes, "eigen_decompose", _signed_eigen)
    fids = MENUS["mixed"]
    members = [(f, 1, r) for f in fids for r in range(2)]
    eng_j = jladder.LadderEngine(**KW)
    insts = [jb.make_instance(f, 4, i) for f, i, _r in members]
    stacked_j = jb.stack_instances(insts)
    base = jax.random.PRNGKey(0)
    keys = jnp.stack([jax.random.fold_in(base, j)
                      for j in range(len(members))])

    def one(k, inst):
        def fit(X):
            return jb.evaluate_dynamic(inst, X, fids)
        carry, _ = eng_j.run_scan(k, fit, 12)
        return carry, eng_j.gen_step(carry, k, fit)[0]

    carry, want = jax.jit(jax.vmap(one))(keys, stacked_j)

    eng_t = tladder.LadderEngine(**KW, device="cpu")
    stacked_t = convert.bbob_instances(insts, "cpu")
    carry_t = convert.ladder_carry(jax.tree_util.tree_map(np.asarray, carry),
                                   "cpu")
    fit_t = ops.slot_fitness(tb.campaign_fitness(stacked_t, fids), 1,
                             torch.float64)
    got, _ = eng_t.gen_step(carry_t, convert.tensor(np.asarray(keys), "cpu"),
                            fit_t)
    np.testing.assert_array_equal(got.total_fevals.numpy(),
                                  np.asarray(want.total_fevals))
    for f in ("m", "sigma", "C", "p_sigma", "p_c", "best_f"):
        a, b = getattr(got.states, f).numpy(), np.asarray(
            getattr(want.states, f))
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max(), err_msg=f)


@pytest.mark.parametrize("engine", ["cover", "min"])
def test_budget_below_one_generation(engine):
    kw = dict(KW, max_evals=4)
    je = jbucketed.BucketedLadderEngine(**kw, policy=engine)
    te = tbucketed.BucketedLadderEngine(**kw, policy=engine, device="cpu")
    rj = jbucketed.run_campaign_bucketed(je, (1, 8), runs=2)
    rt = tbucketed.run_campaign_bucketed(te, (1, 8), runs=2)
    assert rt.segments == rj.segments == []
    for f in rj.trace._fields:
        a, b = np.asarray(getattr(rj.trace, f)), getattr(rt.trace, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
    assert rt.trace.ran.shape == (4, 0, 1)
    np.testing.assert_array_equal(rt.total_fevals, 0)
    assert np.isinf(rt.best_f).all() and rt.padding_waste() == 0.0


@pytest.mark.parametrize("engine", ENGINES)
def test_member_equals_run_alone(engine, torch_runs):
    """Member j of a campaign is the problem run alone on the key
    ``fold_in(PRNGKey(0), j)``."""
    res = torch_runs[(engine, "sep")]
    j = 3
    fid, inst, _r = res.members[j]
    fn, ti = tb.make_fitness(fid, 4, inst, device="cpu")
    fit = tb.fusable_fitness(ti, (1, 2), fn)
    key = tladder.member_keys(0, len(res.members), "cpu")[j]
    if engine == "ladder":
        eng = tladder.LadderEngine(**KW, device="cpu")
        carry, trace = eng.run(key, fit)
    else:
        eng = tbucketed.BucketedLadderEngine(**KW, policy=engine,
                                             device="cpu")
        carry, trace = tbucketed.run_bucketed_single(eng, key, fit)
    ran = trace.ran.numpy()[:, 0]
    got = res.trace.ran[j, :, 0]
    for f in ("k_idx", "gen", "fevals", "stop_reason"):
        np.testing.assert_array_equal(getattr(res.trace, f)[j, got, 0],
                                      getattr(trace, f).numpy()[ran, 0],
                                      err_msg=f)
    np.testing.assert_array_equal(getattr(res.trace, "best_f")[j, got, 0],
                                  trace.best_f.numpy()[ran, 0])
    assert res.total_fevals[j] == int(carry.total_fevals)
    assert res.best_f[j] == float(carry.best_f)
