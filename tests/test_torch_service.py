"""The port's campaign service (``repro_torch/service``) against the JAX
package's and against the port's own bucketed backend.

* per job, heterogeneous mid-flight admission gives the trajectory of
  ``run_ipop(backend="bucketed")`` on the same key and budget, exactly;
  against JAX's server, f1, f2 and the custom sphere agree exactly in
  their ints and to 1e-10 in their bests, f8 (chaotic) at the best value;
* no new program after a later admission, and at most buckets ×
  dim-classes programs;
* a snapshot JAX's server wrote restores into the port's server and
  drains to the JAX run's ints; the port's own snapshot resumes bit for
  bit, onto another island count too (two CPU islands, as the 8-device
  JAX suite is here);
* target retirement, re-queued pending jobs, unplaceable requests, the
  queue, request validation, the allocator, zero budgets.

At n = 4 the JAX side's ``eigen_decompose`` takes the port's sign
convention and its program cache is cleared around each use.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cmaes as jcmaes
from repro.service import CampaignRequest as JRequest
from repro.service import CampaignServer as JServer
from repro.service import FitnessRegistry as JRegistry
from repro.service import server as jserver
from repro.service import SlotAllocator as JAllocator
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.core import bucketed as tbucketed
from repro_torch.core import ipop as tipop
from repro_torch.distributed.mesh_engine import ProgramCache
from repro_torch.fitness import bbob as tb
from repro_torch.launch.mesh import make_campaign_mesh
from repro_torch.service import (AdmissionQueue, CampaignRequest,
                                 CampaignServer, FitnessRegistry, QueueFull,
                                 SlotAllocator)
from repro_torch.service import server as tserver

KW = dict(lam_start=8, kmax_exp=2)


@pytest.fixture(autouse=True)
def one_thread():
    """n = 4 ops are too small to split: one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def shifted_sphere(X):
    return torch.sum((X - 1.2) ** 2, dim=-1)


def make_registry():
    reg = FitnessRegistry()
    reg.register("shifted_sphere", shifted_sphere)
    return reg


def make_server(**extra):
    kw = dict(registry=make_registry(), bbob_fids=(1, 8), max_budget=5000,
              rows_per_island=2, **KW)
    if "mesh" not in extra:
        kw["devices"] = ["cpu"]
    kw.update(extra)
    return CampaignServer(**kw)


def _fitness(req):
    if req.fitness is not None:
        return shifted_sphere
    return tb.make_fitness(req.fid, req.dim, req.instance, device="cpu")[0]


def assert_same_result(got, want, rtol=0.0):
    """Evaluations, descents (rung, λ, stop reason, generations,
    evaluations) exactly; bests to ``rtol`` (0: bit for bit)."""
    assert got.total_fevals == want.total_fevals
    assert [(d.k_exp, d.lam, d.stop_reason) for d in got.descents] == \
        [(d.k_exp, d.lam, d.stop_reason) for d in want.descents]
    for dg, dw in zip(got.descents, want.descents):
        np.testing.assert_array_equal(dg.gens, dw.gens)
        np.testing.assert_array_equal(dg.fevals, dw.fevals)
        np.testing.assert_allclose(dg.best_f, dw.best_f, rtol=rtol,
                                   atol=rtol)
    np.testing.assert_allclose(got.best_f, want.best_f, rtol=rtol, atol=rtol)


def assert_matches_bucketed(ticket):
    """The job's result is ``run_ipop(backend="bucketed")``'s on its key
    and budget, bit for bit."""
    req = ticket.request
    want = tipop.run_ipop(_fitness(req), req.dim, req.seed,
                          backend="bucketed", max_evals=req.budget,
                          device="cpu", **KW)
    assert ticket.done and ticket.updates
    assert_same_result(ticket.result, want)


# ---------------------------------------------------------------------------
# the JAX side, computed once per module
# ---------------------------------------------------------------------------

JOBS = [dict(dim=4, fid=1, budget=2000, seed=3),
        dict(dim=4, fid=2, budget=1500, seed=4),
        dict(dim=4, fitness="shifted_sphere", budget=1200, seed=5),
        dict(dim=4, fid=8, budget=2000, seed=7)]
JAX_KW = dict(bbob_fids=(1, 2, 8), max_budget=5000, rows_per_island=2, **KW)


def _signed_eigen(C):
    """repro's eigen_decompose with the port's column-sign convention."""
    evals, evecs = jnp.linalg.eigh(C)
    pivot = jnp.argmax(jnp.abs(evecs), axis=-2, keepdims=True)
    sign = jnp.where(jnp.take_along_axis(evecs, pivot, axis=-2) < 0,
                     -1.0, 1.0)
    return evecs * sign, jnp.sqrt(jnp.maximum(evals, 1e-300))


def _jregistry():
    reg = JRegistry()
    reg.register("shifted_sphere",
                 lambda X: jnp.sum((X - 1.2) ** 2, axis=-1))
    return reg


def _stream(srv, Req):
    """Two jobs, two boundaries, then the other two mid-flight."""
    tickets = [srv.submit(Req(**j)) for j in JOBS[:2]]
    for _ in range(2):
        srv.step()
    tickets += [srv.submit(Req(**j)) for j in JOBS[2:]]
    return tickets


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's server on ``JOBS`` drained, and a second one snapshotted at
    boundary 3 (its directory)."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcmaes, "eigen_decompose", _signed_eigen)
        jserver.clear_program_cache()
        try:
            srv = JServer(registry=_jregistry(), **JAX_KW)
            tickets = _stream(srv, JRequest)
            srv.drain()
            snap = JServer(registry=_jregistry(), snapshot_dir=d, **JAX_KW)
            _stream(snap, JRequest)
            snap.step()
            snap.snapshot()
        finally:
            jserver.clear_program_cache()
    return [t.result for t in tickets], d


@pytest.fixture(scope="module")
def port_stream():
    """The port's server on ``JOBS``, drained."""
    torch.set_num_threads(1)
    srv = CampaignServer(registry=make_registry(), devices=["cpu"], **JAX_KW)
    tickets = _stream(srv, CampaignRequest)
    srv.drain()
    return [t.result for t in tickets]


def test_end_to_end_heterogeneous_mid_flight_admission():
    srv = make_server()
    t_a = srv.submit(CampaignRequest(dim=4, fid=8, budget=2000, seed=7))
    t_b = srv.submit(CampaignRequest(dim=4, fid=1, budget=1500, seed=3))
    for _ in range(2):
        srv.step()
    # mid-flight: a callable, a new dim-class, and a job that must wait
    # for a freed row
    t_c = srv.submit(CampaignRequest(dim=4, fitness="shifted_sphere",
                                     budget=1200, seed=5))
    t_d = srv.submit(CampaignRequest(dim=6, fid=8, budget=1500, seed=11))
    t_e = srv.submit(CampaignRequest(dim=4, fid=1, budget=1000, seed=13))
    srv.drain()
    for t in (t_a, t_b, t_c, t_d, t_e):
        assert t.fevals <= t.request.budget
        assert_matches_bucketed(t)
    n_buckets = KW["kmax_exp"] + 1
    compiles = srv.segment_compiles()
    assert 1 <= compiles <= n_buckets * len(srv.lanes) == 2 * n_buckets
    t_f = srv.submit(CampaignRequest(dim=4, fid=8, budget=1000, seed=17))
    srv.drain()
    assert t_f.done
    assert srv.segment_compiles() == compiles   # zero new programs


@pytest.mark.parametrize("j", range(len(JOBS)))
def test_service_matches_jax_server(jax_runs, port_stream, j):
    """Per job against JAX's server on the same stream: f1, f2 and the
    sphere exactly in their ints and to 1e-10 in their bests; f8 at the
    best value (1e-5, the JAX package's own tolerance)."""
    want, got = jax_runs[0][j], port_stream[j]
    if JOBS[j].get("fid") == 8:
        np.testing.assert_allclose(got.best_f, want.best_f, rtol=1e-5)
    else:
        assert_same_result(got, want, rtol=1e-10)


def test_jax_snapshot_restores_into_port(jax_runs):
    """A snapshot of JAX's server restores into the port's and drains to
    the JAX uninterrupted run's evaluations, generations and stops."""
    want, d = jax_runs
    srv = CampaignServer.restore(d, registry=make_registry(),
                                 devices=["cpu"])
    assert srv._boundary_n == 3 and srv._resident_jobs() == 2
    assert [t.status for t in srv.queue.pending()] == ["queued"] * 2
    srv.drain()
    for j, w in enumerate(want):
        t = srv.tickets[j]
        assert t.done
        assert_same_result(t.result, w, rtol=1e-5 if JOBS[j].get("fid") == 8
                           else 1e-10)


def test_snapshot_leaf_map_names_every_differing_leaf(jax_runs, tmp_path):
    """``convert.SNAPSHOT_LEAVES`` names each leaf whose dtype differs
    between the two packages' snapshots of the same stream."""
    _want, d = jax_runs
    srv = CampaignServer(registry=make_registry(), devices=["cpu"],
                         snapshot_dir=str(tmp_path), **JAX_KW)
    _stream(srv, CampaignRequest)
    srv.step()
    srv.snapshot()

    def manifest(root):
        with open(os.path.join(root, "step_00000003", "manifest.json")) as f:
            return json.load(f)["leaves"]
    mj, mt = manifest(d), manifest(str(tmp_path))
    assert set(mj) == set(mt)
    differ = {}
    for k in mj:
        assert mj[k]["shape"] == mt[k]["shape"], k
        if mj[k]["dtype"] != mt[k]["dtype"]:
            differ[k.split("/")[-1]] = (mj[k]["dtype"], mt[k]["dtype"])
    assert differ == convert.SNAPSHOT_LEAVES


# ---------------------------------------------------------------------------
# the port's own durability
# ---------------------------------------------------------------------------

def _submit_resume_jobs(srv):
    return [srv.submit(CampaignRequest(dim=4, fid=8, budget=2000, seed=7)),
            srv.submit(CampaignRequest(dim=4, fid=1, budget=1500, seed=3)),
            srv.submit(CampaignRequest(dim=4, fitness="shifted_sphere",
                                       budget=1200, seed=5))]


@pytest.fixture(scope="module")
def uninterrupted():
    torch.set_num_threads(1)
    ref = make_server(rows_per_island=3)
    tickets = _submit_resume_jobs(ref)
    ref.drain()
    return [t.result for t in tickets]


@pytest.mark.parametrize("islands", [1, 2])
def test_snapshot_kill_resume_reproduces_trajectory(uninterrupted, islands,
                                                    tmp_path):
    """Snapshot at boundary 3, drop the server, restore (onto 1 island or,
    re-packed, 2) and drain: every job as the uninterrupted run, bit for
    bit."""
    d = str(tmp_path / "ckpt")
    srv = make_server(rows_per_island=3, snapshot_dir=d)
    _submit_resume_jobs(srv)
    for _ in range(3):
        srv.step()
    step = srv.snapshot()
    assert store.latest_step(d) == step
    assert store.load_meta(d, step)["boundary"] == 3
    del srv
    srv2 = CampaignServer.restore(
        d, registry=make_registry(),
        mesh=make_campaign_mesh(islands, device="cpu"))
    assert srv2._resident_jobs() == 3
    assert len(next(iter(srv2.lanes.values())).islands) == islands
    srv2.drain()
    for j, want in enumerate(uninterrupted):
        assert srv2.tickets[j].done
        assert_same_result(srv2.tickets[j].result, want)


def test_two_islands_give_each_job_its_bucketed_run():
    """Two CPU islands (the JAX package's multi-device suite, cut to two):
    the jobs spread over both, each its bucketed run."""
    srv = make_server(mesh=make_campaign_mesh(2, device="cpu"),
                      rows_per_island=1)
    ts = [srv.submit(CampaignRequest(dim=4, fid=f, budget=800, seed=s))
          for f, s in ((1, 0), (8, 1), (1, 2))]
    srv.drain()
    lane = next(iter(srv.lanes.values()))
    assert len(lane.islands) == 2
    assert {t.island for t in ts} == {0, 1}
    for t in ts:
        assert_matches_bucketed(t)


def test_restore_requeues_pending_and_accepts_new_jobs(tmp_path):
    d = str(tmp_path / "ckpt")
    srv = make_server(rows_per_island=1, snapshot_dir=d)
    srv.submit(CampaignRequest(dim=4, fid=1, budget=1200, seed=0))
    t1 = srv.submit(CampaignRequest(dim=4, fid=8, budget=1200, seed=1))
    srv.step()                          # t0 admitted; t1 queued (1 row)
    assert t1.status == "queued"
    srv.snapshot()
    del srv
    srv2 = CampaignServer.restore(d, registry=make_registry(),
                                  devices=["cpu"])
    assert [t.job_id for t in srv2.queue.pending()] == [t1.job_id]
    t2 = srv2.submit(CampaignRequest(dim=4, fid=1, budget=1000, seed=2))
    t3 = srv2.submit(CampaignRequest(dim=4, fid=1, budget=1000, seed=3))
    assert len(srv2.queue.pending()) == 3
    srv2.drain()
    for t in (t2, t3):
        assert t.done and t.latency_s() is not None
    resumed = srv2.tickets[t1.job_id]
    assert resumed.done and resumed.latency_s() is None


def test_target_early_retirement():
    srv = make_server()
    t = srv.submit(CampaignRequest(dim=4, fid=1, budget=5000, seed=0,
                                   target=1e3))
    srv.drain()
    assert t.done and t.best_f <= 1e3 and t.fevals < 5000


def test_unplaceable_job_is_rejected_not_hung():
    srv = make_server(max_lanes=1)
    t_ok = srv.submit(CampaignRequest(dim=4, fid=1, budget=1000, seed=0))
    t_no = srv.submit(CampaignRequest(dim=6, fid=1, budget=1000, seed=1))
    srv.drain()
    assert t_ok.done and t_no.status == "rejected"


def test_zero_budget_job_completes_empty():
    srv = make_server()
    t = srv.submit(CampaignRequest(dim=4, fid=1, budget=4, seed=0))
    srv.drain()
    assert t.done and t.fevals == 0 and t.result.descents == []


def test_fleet_hooks_are_inert_and_fleet_raises():
    srv = make_server()
    assert srv.fleet is None and srv.down_islands == set()
    with pytest.raises(NotImplementedError, match="item 12"):
        tserver.run_service_single(shifted_sphere, 4, 0, fleet=object(),
                                   device="cpu")


@pytest.mark.parametrize("menu", [(1, 2, 8), ()])
def test_service_fitness_rows_against_jax_evaluate(menu):
    """An island's fitness: branch-0 rows as JAX evaluates each fid (f1,
    f2 and f8 carry no rotation, so JAX's own instances hold to 1e-12),
    +inf on free rows and on branch 0 without a menu, each callable on its
    own rows only: a poison NaN reaches no other row."""
    from repro.fitness import bbob as jb
    n = 4
    fids = np.array([1, 8, 2, 1, 1, 1])
    fn_idx = np.array([0, 0, 0, 0, 1, 2])
    occupied = np.array([True, True, True, False, True, True])
    insts = tb.stack_instances([tb.make_instance(int(f), n, 1, device="cpu")
                                for f in fids])
    X = torch.as_tensor(np.random.default_rng(3).uniform(-5, 5, (6, 7, n)))
    poison = lambda Y: torch.full(Y.shape[:-1], torch.nan,  # noqa: E731
                                  dtype=Y.dtype)
    fit = tserver.ServiceFitness(insts, fn_idx, fids, occupied, menu,
                                 (poison, shifted_sphere))
    F = fit(X).numpy()
    for r in range(3):
        want = np.asarray(jb.evaluate(int(fids[r]),
                                      jb.make_instance(int(fids[r]), n, 1),
                                      jnp.asarray(X[r].numpy())))
        if menu:
            np.testing.assert_allclose(F[r], want, rtol=1e-12)
        else:
            assert np.all(F[r] == np.inf)
    assert np.all(F[3] == np.inf) and np.all(np.isnan(F[4]))
    np.testing.assert_array_equal(F[5], shifted_sphere(X[5]).numpy())


def test_server_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CampaignServer(bbob_fids=(1,))


# ---------------------------------------------------------------------------
# queue, allocator, store, program cache
# ---------------------------------------------------------------------------

def test_program_cache_evicts_closure_keyed_entries():
    pc = ProgramCache(max_closure_entries=2)
    for j in range(4):
        pc.get(("x", (lambda X: X), j), lambda: object())
    for j in range(4):
        pc.get(("static", j), lambda: object())
    snap = pc.snapshot()
    assert snap["traces"] == 8 and snap["programs"] == 6
    pc.get(("static", 0), lambda: object())
    assert pc.snapshot()["hits"] == 1


def test_store_roundtrip_of_stacked_carry_and_allocator(tmp_path):
    eng = tbucketed.BucketedLadderEngine(n=4, max_evals=4000, device="cpu",
                                         **KW)
    from repro_torch.core import ladder
    carry = eng.init_carry(ladder.member_keys(0, 4, "cpu"))
    al = SlotAllocator(2, 2)
    al.alloc(10, 1000)
    al.alloc(11, 2000)
    d = str(tmp_path / "ck")
    store.save(d, 5, {"carry": carry}, meta={"alloc": al.to_meta()})
    al2 = SlotAllocator.from_meta(store.load_meta(d, 5)["alloc"])
    assert al2.occupied() == al.occupied()
    assert [list(b) for b in al2.budgets] == [list(b) for b in al.budgets]
    back = store.restore(d, 5, {"carry": carry})["carry"]
    want, got = store._flatten(carry), store._flatten(back)
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_queue_backpressure_and_priority():
    q = AdmissionQueue(max_pending=2)
    t1 = q.submit(CampaignRequest(dim=4, fid=1, budget=100, priority=0))
    t2 = q.submit(CampaignRequest(dim=4, fid=1, budget=100, priority=5))
    with pytest.raises(QueueFull):
        q.submit(CampaignRequest(dim=4, fid=1, budget=100))
    req, t = q.take()
    assert t is t2 and req.priority == 5
    req, t = q.take()
    assert t is t1 and q.take() is None
    q2 = AdmissionQueue()
    q2.submit(CampaignRequest(dim=8, fid=1, budget=100, priority=9))
    tb_ = q2.submit(CampaignRequest(dim=4, fid=1, budget=100, priority=0))
    req, t = q2.take(lambda r: r.dim == 4)
    assert t is tb_ and len(q2) == 1


def test_request_validation():
    with pytest.raises(ValueError, match="exactly one"):
        CampaignRequest(dim=4, budget=100).validate()
    with pytest.raises(ValueError, match="exactly one"):
        CampaignRequest(dim=4, budget=100, fid=1, fitness="x").validate()
    srv = make_server()
    with pytest.raises(ValueError, match="max_budget"):
        srv.submit(CampaignRequest(dim=4, fid=1, budget=10 ** 9))
    with pytest.raises(ValueError, match="menu"):
        srv.submit(CampaignRequest(dim=4, fid=24, budget=100))
    with pytest.raises(ValueError, match="unknown fitness"):
        srv.submit(CampaignRequest(dim=4, fitness="nope", budget=100))
    g0 = srv.registry.generation
    srv.registry.register("late", shifted_sphere)
    assert srv.registry.generation == g0 + 1
    assert "late" not in srv.registry.names_at(g0)
    with pytest.raises(ValueError, match="already registered"):
        srv.registry.register("late", shifted_sphere)
    with pytest.raises(ValueError, match="negative|>= 0"):
        CampaignRequest(dim=4, fid=1, budget=100, deadline_s=-1).validate()


def test_request_meta_matches_jax():
    """``to_meta`` writes an explicit key as the JAX package writes a
    ``PRNGKey``: the two 32-bit words; ``from_meta`` reads either."""
    for key in (7, 2 ** 40 + 5):
        jm = JRequest(dim=4, fid=1, budget=10,
                      key=jax.random.PRNGKey(key)).to_meta()
        tm = CampaignRequest(dim=4, fid=1, budget=10, key=key).to_meta()
        assert jm == tm
        back = CampaignRequest.from_meta(jm)
        from repro_torch.core import prng
        assert prng.as_key(back.key).tolist() == \
            prng.PRNGKey(key).tolist()


def test_allocator_matches_jax():
    """The same allocations, releases and repack on both allocators give
    the same rows, maps and layouts."""
    out = []
    for cls in (SlotAllocator, JAllocator):
        al = cls(2, 2)
        spots = [al.alloc(j, 100 * (j + 1)) for j in range(4)]
        full = al.alloc(9, 1)
        al.release(*spots[1])
        al.alloc(9, 900)
        new, moves, layout = al.repack(4, 1)
        with pytest.raises(ValueError, match="repack"):
            al.repack(1, 2)
        out.append((spots, full, al.to_meta(), new.to_meta(), moves,
                    layout))
    assert out[0] == out[1]
    assert out[0][1] is None
