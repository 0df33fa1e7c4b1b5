"""The port's mesh campaign engine on the CPU beside
``tests/test_torch_mesh.py`` (whose helpers it uses; n = 4, λ_start = 8,
kmax_exp = 2, 5 000 evaluations a member unless noted):

* one island against JAX's in-process one-device mesh, both strategies:
  ints and trace fields equal, floats within 1e-12 relative (the
  per-generation trace 1e-11, as the bucketed driver's against JAX's),
  and the segments, exchange records, ``compiles``, useful and padded
  evaluations;
* inert padding rows, empty progress, an unknown strategy, the island
  runner cache, S1 split by device against S1 in one call;
* the campaign mesh's island layout, and the member split over the
  islands and back.
"""
import numpy as np
import pytest
import torch
from test_torch_mesh import (  # noqa: F401 (the autouse fixture)
    FIDS, FLOATS, INTS, KW, STRATEGIES, _close, _port, _same_campaign,
    _same_records, _signed_eigen, one_intra_op_thread)

from repro.core import cmaes as jcmaes
from repro.distributed import mesh_engine as jmesh
from repro_torch.core import bucketed as tbucketed
from repro_torch.core import ladder as tladder
from repro_torch.distributed import mesh_engine as tmesh
from repro_torch.distributed import sharding
from repro_torch.fitness import bbob as tb
from repro_torch.fleet import FaultPlan, FleetConfig
from repro_torch.fleet.controller import IslandSupervisor
from repro_torch.launch.mesh import make_campaign_mesh
from torch_threads import one_thread  # noqa: F401


# ---------------------------------------------------------------------------
# (a) one island against JAX's one-device mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_one():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcmaes, "eigen_decompose", _signed_eigen)
        out = {}
        for s in STRATEGIES:
            eng = jmesh.MeshCampaignEngine(strategy=s, **KW)
            assert eng.n_devices == 1
            out[s] = jmesh.run_campaign_mesh(eng, FIDS, runs=2)
        return out


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_one_island_matches_jax_one_device(strategy, jax_one):
    rj = jax_one[strategy]
    rt = _port(strategy, 1, runs=2)
    assert rt.n_devices == 1 and rt.strategy == strategy
    _same_campaign(rt, rj)
    assert rt.compiles == rj.compiles <= KW["kmax_exp"] + 1
    assert (rt.useful_evals, rt.padded_evals) == (rj.useful_evals,
                                                  rj.padded_evals)
    assert [(s["bucket"], s["gens"]) for s in rt.segments] == \
        [(s["bucket"], s["gens"]) for s in rj.segments]
    _same_records(rt.exchange, rj.exchange)
    if strategy == "ordered":
        for g, w in zip(rt.segments, rj.segments):
            assert g["spec_hit"] == w["spec_hit"]
            _close(g["global_best"], w["global_best"])
        assert rt.pulls == len(rt.segments) + 1
    else:
        assert [[(s["bucket"], s["gens"]) for s in ss]
                for ss in rt.shard_segments] == \
            [[(s["bucket"], s["gens"]) for s in ss]
             for ss in rj.shard_segments]
    assert rt.exchange[-1]["global_fevals"] == int(np.sum(rt.total_fevals))



# ---------------------------------------------------------------------------
# (c), (g) padding rows, edge cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_padding_rows_sliced_off(strategy):
    """6 members on 8 islands (1 000 evaluations a member): the inert
    rows never run, and the result holds the 6 members, each the bucketed
    driver's."""
    kw = dict(KW, max_evals=1000)
    eng = tbucketed.BucketedLadderEngine(**kw, device="cpu")
    rb = tbucketed.run_campaign_bucketed(eng, FIDS, runs=3, seed=2)
    rt = _port(strategy, 8, kw=kw, runs=3, seed=2)
    assert len(rt.members) == 6
    assert rt.trace.ran.shape[0] == 6 and rt.best_x.shape == (6, 4)
    np.testing.assert_array_equal(rt.total_fevals, rb.total_fevals)
    _close(rt.best_f, rb.best_f)
    assert rt.exchange[-1]["global_fevals"] == int(rb.total_fevals.sum())
    for b in range(6):
        ran_b, ran_m = rb.trace.ran[b, :, 0], rt.trace.ran[b, :, 0]
        np.testing.assert_array_equal(rt.trace.gen[b, :, 0][ran_m],
                                      rb.trace.gen[b, :, 0][ran_b])
    if strategy == "concurrent":
        # the islands of members 6 and 7 hold only pads: no segment
        assert rt.shard_segments[6] == rt.shard_segments[7] == []
        assert all(rt.shard_segments[:6])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_budget_below_one_generation_is_empty_progress(strategy):
    kw = dict(n=3, lam_start=8, kmax_exp=1, max_evals=4)
    rt = _port(strategy, 2, kw=kw, fids=(1,), runs=2)
    rj = jmesh.run_campaign_mesh(
        jmesh.MeshCampaignEngine(strategy=strategy, **kw), (1,), runs=2)
    assert rt.useful_evals == 0 and rt.segments == rj.segments == []
    for f in rj.trace._fields:
        a, b = np.asarray(getattr(rj.trace, f)), getattr(rt.trace, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
    assert rt.hit_evals(np.array([1e2])).shape == (2, 1)
    np.testing.assert_array_equal(rt.total_fevals, 0)


def test_unknown_strategy_and_supervisor_rejected():
    """An unknown strategy raises; a supervisor is taken (fleet
    supervision is ported): a campaign whose S1 island dies at boundary 1
    replays from its snapshot to the unsupervised campaign, bit for bit."""
    with pytest.raises(ValueError, match="strategy"):
        tmesh.MeshCampaignEngine(n=3, strategy="barrier-free", device="cpu")
    kw = dict(n=3, lam_start=8, kmax_exp=1, max_evals=400, device="cpu")
    plain = tmesh.run_campaign_mesh(tmesh.MeshCampaignEngine(**kw), (1,),
                                    runs=2)
    sup = IslandSupervisor(FleetConfig(snapshot_every=1,
                                       plan=FaultPlan.parse("0:1")))
    got = tmesh.run_campaign_mesh(tmesh.MeshCampaignEngine(**kw), (1,),
                                  runs=2, supervisor=sup)
    assert sup.health.state(0) == "alive" and sup.snapshot_s
    np.testing.assert_array_equal(got.total_fevals, plain.total_fevals)
    np.testing.assert_array_equal(got.best_f, plain.best_f)
    for f in INTS + FLOATS:
        np.testing.assert_array_equal(getattr(got.trace, f),
                                      getattr(plain.trace, f), err_msg=f)


# ---------------------------------------------------------------------------
# (h) the island runner cache
# ---------------------------------------------------------------------------

def test_island_program_cache_reuses_across_engines():
    """A second campaign on a new engine of the same bucket shapes and
    mesh builds no runner; a generic fitness keys by its closure object,
    so two calls with distinct closures never share one."""
    kw = dict(KW, max_evals=800)
    tmesh.clear_island_program_cache()
    mesh = make_campaign_mesh(2, device="cpu")
    eng1 = tmesh.MeshCampaignEngine(**kw, strategy="concurrent", mesh=mesh)
    tmesh.run_campaign_mesh(eng1, FIDS, runs=1)
    s1 = tmesh.island_cache_stats()
    assert s1["traces"] >= 1 and s1["programs"] == s1["traces"]
    eng2 = tmesh.MeshCampaignEngine(**kw, strategy="concurrent", mesh=mesh)
    res2 = tmesh.run_campaign_mesh(eng2, FIDS, runs=1, seed=1)
    s2 = tmesh.island_cache_stats()
    assert s2["traces"] == s1["traces"], (s1, s2)
    assert s2["hits"] > s1["hits"]
    assert 1 <= res2.compiles <= kw["kmax_exp"] + 1
    assert eng1._island_keys == eng2._island_keys
    fn, _ = tb.make_fitness(1, 4, 1, device="cpu")
    before = tmesh.island_cache_stats()["programs"]
    for _ in range(2):
        eng = tmesh.MeshCampaignEngine(**kw, strategy="concurrent",
                                       mesh=mesh)
        tmesh.run_mesh_single(eng, 0, lambda X: fn(X))
        now = tmesh.island_cache_stats()["programs"]
        assert now > before
        before = now


# ---------------------------------------------------------------------------
# (i) S1 split by device
# ---------------------------------------------------------------------------

def test_s1_split_by_device_equals_fused(monkeypatch):
    """With the 8 islands grouped as two devices (0, 2, 4, 6 and 1, 3, 5,
    7), S1 makes two segment calls a segment and gathers two pulls; the
    campaign (8 members, 2 000 evaluations each) equals the one-call
    run."""
    kw = dict(KW, max_evals=2000)
    rf = _port("ordered", 8, kw=kw)
    calls = []
    seg_fn = tmesh.MeshCampaignEngine._seg_fn

    def counting(self, k, seg_gens):
        run = seg_fn(self, k, seg_gens)

        def counted(keys, fit, carry):
            calls.append(int(keys.shape[0]))
            return run(keys, fit, carry)
        return counted
    monkeypatch.setattr(tmesh.MeshCampaignEngine, "_seg_fn", counting)
    monkeypatch.setattr(tmesh, "device_groups",
                        lambda mesh: [[0, 2, 4, 6], [1, 3, 5, 7]])
    rs = _port("ordered", 8, kw=kw)
    assert set(calls) == {4} and len(calls) >= 2 * len(rs.segments)
    np.testing.assert_array_equal(rs.total_fevals, rf.total_fevals)
    _close(rs.best_f, rf.best_f)
    _close(rs.best_x, rf.best_x)
    for f in INTS:
        np.testing.assert_array_equal(getattr(rs.trace, f),
                                      getattr(rf.trace, f), err_msg=f)
    for f in FLOATS:
        _close(getattr(rs.trace, f), getattr(rf.trace, f))
    assert [(s["bucket"], s["gens"]) for s in rs.segments] == \
        [(s["bucket"], s["gens"]) for s in rf.segments]
    _same_records(rs.exchange, rf.exchange)


# ---------------------------------------------------------------------------
# the mesh and the member split
# ---------------------------------------------------------------------------

def test_campaign_mesh_layout():
    """Islands in order on the one device given, or on the devices
    listed; no island raises; without ``device`` the mesh is CUDA's."""
    mesh = make_campaign_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.axis == "camp"
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert make_campaign_mesh(device="cpu").size == 1
    listed = make_campaign_mesh(devices=["cpu", "cpu", "cpu"])
    assert listed.size == 3 and tmesh.device_groups(listed) == [[0, 1, 2]]
    with pytest.raises(ValueError, match="island"):
        make_campaign_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_campaign_mesh(8)


@pytest.mark.parametrize("groups", [None, [[0, 2, 4, 6], [1, 3, 5, 7]]],
                         ids=["per_island", "per_device"])
def test_shard_and_join_round_trip(groups):
    """A carry's member axis split over 8 islands (or two device groups
    of them) and joined back gives the carry; each part holds its
    islands' members in group order; 6 members do not split over 8."""
    eng = tbucketed.BucketedLadderEngine(**KW, device="cpu")
    keys = tladder.member_keys(3, 16, "cpu")
    carry = eng.init_carry(keys)
    mesh = make_campaign_mesh(8, device="cpu")
    parts = sharding.shard_members(carry, mesh, groups)
    assert len(parts) == (8 if groups is None else 2)
    order = [[i] for i in range(8)] if groups is None else groups
    for part, g in zip(parts, order):
        want = torch.cat([carry.states.m[2 * i:2 * i + 2] for i in g])
        assert torch.equal(part.states.m, want)
        assert part.states.m.data_ptr() != carry.states.m.data_ptr()
    back = sharding.join_members(parts, mesh, groups)
    for a, b in zip(sharding.leaves(back), sharding.leaves(carry)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="split"):
        sharding.shard_members(keys[:6], mesh)
