"""The port's mesh engine where S2's segment cuts and whole IPOP runs meet
the reference: ECDF equivalence of both strategies with JAX's bucketed
campaign at ``eigen_interval`` 4, and ``run_ipop(backend="mesh")`` against
JAX's own mesh backend on f1 and f2 at n = 4 (the JAX side's
``eigen_decompose`` in the port's sign convention).  The engine's other
checks are in ``tests/test_torch_mesh.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_mesh import one_intra_op_thread  # noqa: F401

from repro.core import bucketed as jbucketed
from repro.core import cmaes as jcmaes
from repro.core import ipop as jipop
from repro.fitness import bbob as jb
from repro_torch.core import ipop as tipop
from repro_torch.distributed import mesh_engine as tmesh
from repro_torch.fitness import bbob as tb
from repro_torch.launch.mesh import make_campaign_mesh
from torch_threads import one_thread  # noqa: F401

STRATEGIES = ("ordered", "concurrent")
ECDF_KW = dict(n=8, lam_start=8, kmax_exp=1, max_evals=4000,
               eigen_interval=4)
ECDF_FIDS = (1, 8)


def _signed_eigen(C):
    """repro's eigen_decompose with the port's column-sign convention."""
    evals, evecs = jnp.linalg.eigh(C)
    pivot = jnp.argmax(jnp.abs(evecs), axis=-2, keepdims=True)
    sign = jnp.where(jnp.take_along_axis(evecs, pivot, axis=-2) < 0,
                     -1.0, 1.0)
    return evecs * sign, jnp.sqrt(jnp.maximum(evals, 1e-300))


@pytest.fixture(scope="module")
def jax_ecdf_campaign():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcmaes, "eigen_decompose", _signed_eigen)
        return jbucketed.run_campaign_bucketed(
            jbucketed.BucketedLadderEngine(**ECDF_KW), ECDF_FIDS, runs=4)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_ecdf_equivalence_eigen_interval_4(strategy, jax_ecdf_campaign):
    """At ``eigen_interval`` 4 (n = 8, kmax_exp = 1, 4 000 evaluations,
    fids 1 and 8, 4 runs on 4 islands) the strategies agree with JAX's
    bucketed campaign in ECDF: per target, the share of members that hit
    it within one member."""
    eng = tmesh.MeshCampaignEngine(
        **ECDF_KW, strategy=strategy,
        mesh=make_campaign_mesh(4, device="cpu"))
    rt = tmesh.run_campaign_mesh(eng, ECDF_FIDS, runs=4)
    targets = np.array([1e2, 1e0, 1e-4])
    hits_j = np.isfinite(jax_ecdf_campaign.hit_evals(targets)).mean(axis=0)
    hits_t = np.isfinite(rt.hit_evals(targets)).mean(axis=0)
    B = len(rt.members)
    assert np.all(np.abs(hits_j - hits_t) <= 1.0 / B + 1e-9), (hits_j,
                                                                 hits_t)
    for (fid, _i, _r), err in zip(rt.members, rt.best_f - rt.f_opt):
        if fid == 1:
            assert err < 1e-6
    assert (rt.total_fevals <= ECDF_KW["max_evals"]).all()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("fid", [1, 2])
def test_run_ipop_mesh_matches_jax(fid, strategy, monkeypatch):
    """Evaluations, descents and stop reasons exactly; the descents' bests
    to 1e-10 (1.9e-11 on f2)."""
    monkeypatch.setattr(jcmaes, "eigen_decompose", _signed_eigen)
    ji = jb.make_instance(fid, 4, 1)
    ti = tb.make_instance(fid, 4, 1, device="cpu")
    jf = jb.fusable_fitness(ji, (fid,), lambda X: jb.evaluate(fid, ji, X))
    tf = tb.fusable_fitness(ti, (fid,), lambda X: tb.evaluate(fid, ti, X))
    kw = dict(lam_start=8, kmax_exp=2, max_evals=4000)
    rj = jipop.run_ipop(jf, 4, jax.random.PRNGKey(7), backend="mesh",
                        mesh_strategy=strategy, **kw)
    rt = tipop.run_ipop(tf, 4, 7, backend="mesh", mesh_strategy=strategy,
                        device="cpu", **kw)
    assert rt.total_fevals == rj.total_fevals
    assert len(rt.descents) == len(rj.descents) >= 2
    for dt, dj in zip(rt.descents, rj.descents):
        assert (dt.k_exp, dt.lam, dt.stop_reason) == (dj.k_exp, dj.lam,
                                                      dj.stop_reason)
        np.testing.assert_array_equal(dt.gens, dj.gens)
        np.testing.assert_array_equal(dt.fevals, dj.fevals)
        np.testing.assert_allclose(dt.best_f, dj.best_f, rtol=1e-10)
    assert rt.best_f - float(ji.f_opt) < 1e-8
    rb = tipop.run_ipop(tf, 4, 7, backend="bucketed", device="cpu", **kw)
    assert rt.total_fevals == rb.total_fevals
    np.testing.assert_array_equal(rt.best_x, rb.best_x)
