"""The request lifecycle of the port's campaign service: the counterparts
of the JAX package's ``tests/test_lifecycle.py`` (fleet parts excepted:
the fleet is not ported).

* every job ends in one terminal status: cancel while queued and while
  running (a partial result), queue TTL and run deadline, NaN poison
  quarantined with a partial result and no NaN reaching a neighbouring
  row, the no-progress watermark;
* priority shedding, then an idempotent dedup resubmit;
* a lifecycle mix adds no schedule pull and no program;
* a registry rollout builds programs for the new generation only;
* lifecycle states, pending cancels and dedup pins ride a snapshot.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bucketed as tbucketed
from repro_torch.core import ipop as tipop
from repro_torch.fitness import bbob as tb
from repro_torch.obs import registry as reg_mod
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.service import (AdmissionQueue, CampaignRequest,
                                 CampaignServer, CampaignTicket,
                                 FitnessRegistry, QueueFull)
from repro_torch.service.server import (clear_program_cache,
                                        program_cache_stats)

KW = dict(lam_start=8, kmax_exp=2)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def shifted_sphere(X):
    return torch.sum((X - 1.2) ** 2, dim=-1)


def nan_fitness(X):
    """Poison: every value NaN, so the best never leaves +inf."""
    return torch.full(X.shape[:-1], torch.nan, dtype=X.dtype)


def make_registry():
    reg = FitnessRegistry()
    reg.register("shifted_sphere", shifted_sphere)
    reg.register("nan_fn", nan_fitness)
    return reg


def make_server(**extra):
    kw = dict(registry=make_registry(), bbob_fids=(1, 8), max_budget=5000,
              rows_per_island=2, devices=["cpu"], **KW)
    kw.update(extra)
    return CampaignServer(**kw)


@pytest.fixture
def fresh_metrics():
    prev = reg_mod.set_metrics(MetricsRegistry())
    yield reg_mod.metrics()
    reg_mod.set_metrics(prev)


@pytest.fixture
def count_pulls(monkeypatch):
    calls = {"n": 0}
    real = tbucketed.pull_schedule

    def counting(carry, **kw):
        calls["n"] += 1
        return real(carry, **kw)
    monkeypatch.setattr(tbucketed, "pull_schedule", counting)
    return calls


def series(reg, name):
    return {lkey: s for (n, lkey), s in reg._series.items() if n == name}


def counter_sum(reg, name, **labels):
    return sum(s.value for lkey, s in series(reg, name).items()
               if all(dict(lkey).get(k) == v for k, v in labels.items()))


def heap_ok(heap):
    return all(heap[(i - 1) // 2] <= heap[i] for i in range(1, len(heap)))


def test_cancel_queued_and_running():
    srv = make_server(rows_per_island=1)
    t_run = srv.submit(CampaignRequest(dim=4, fid=8, budget=3000, seed=7))
    t_q = srv.submit(CampaignRequest(dim=4, fid=1, budget=2000, seed=3))
    srv.step()
    assert t_run.status == "running" and t_q.status == "queued"
    assert srv.cancel(t_q.job_id) is True
    assert t_q.status == "cancelled" and t_q.reason == "cancelled by client"
    assert srv.cancel(t_q.job_id) is False
    assert len(srv.queue) == 0
    assert srv.cancel(t_run.job_id) is True
    assert t_run.status == "running"            # at the next boundary
    srv.step()
    assert t_run.status == "cancelled"
    assert t_run.result is not None
    assert 0 < t_run.fevals < t_run.request.budget
    assert t_run.result.total_fevals == t_run.fevals
    assert srv.cancel(12345) is False
    srv.drain()
    assert all(t.terminal for t in srv.tickets.values())


def test_deadline_and_ttl_expiry():
    srv = make_server(rows_per_island=1)
    t_run = srv.submit(CampaignRequest(dim=4, fid=8, budget=3000, seed=7,
                                       deadline_s=3600.0))
    t_q = srv.submit(CampaignRequest(dim=4, fid=1, budget=2000, seed=3,
                                     queue_ttl_s=3600.0))
    assert t_run.deadline_at is not None and t_q.ttl_at is not None
    srv.step()
    assert t_run.status == "running" and t_q.status == "queued"
    t_q.ttl_at = 0.0
    srv.step()
    assert t_q.status == "expired" and t_q.reason == "queue TTL exceeded"
    t_run.deadline_at = 0.0
    srv.step()
    assert t_run.status == "expired"
    assert t_run.reason == "deadline exceeded while running"
    assert t_run.result is not None and t_run.fevals > 0
    srv.drain()


def test_nan_poison_is_quarantined_and_stays_in_its_row(fresh_metrics):
    """The poison job is quarantined at its first verdict with a partial
    result; its island neighbour's run is its bucketed run, bit for bit:
    no NaN crossed rows."""
    reg = fresh_metrics
    srv = make_server()
    t_bad = srv.submit(CampaignRequest(dim=4, fitness="nan_fn",
                                       budget=3000, seed=1))
    t_ok = srv.submit(CampaignRequest(dim=4, fid=1, budget=1500, seed=3))
    srv.drain()
    assert t_bad.island == t_ok.island == 0
    assert t_bad.status == "quarantined" and "non-finite" in t_bad.reason
    assert t_bad.result is not None and 0 < t_bad.fevals < 3000
    assert not np.isfinite(t_bad.best_f)
    assert t_ok.done
    fn, _ = tb.make_fitness(1, 4, 1, device="cpu")
    want = tipop.run_ipop(fn, 4, 3, backend="bucketed", max_evals=1500,
                          device="cpu", **KW)
    assert t_ok.result.total_fevals == want.total_fevals
    for a, b in zip(t_ok.result.descents, want.descents):
        np.testing.assert_array_equal(a.best_f, b.best_f)
        np.testing.assert_array_equal(a.fevals, b.fevals)
    assert counter_sum(reg, "service_quarantine_total",
                       reason="nonfinite") == 1
    assert counter_sum(reg, "service_job_lifecycle_total",
                       **{"from": "running", "to": "quarantined"}) == 1


def test_no_progress_watermark_verdict():
    srv = make_server(quarantine_stall_boundaries=2)
    t = CampaignTicket(job_id=99,
                       request=CampaignRequest(dim=4, fid=1, budget=100))
    assert srv._row_verdict(t, 99, 10, 1.0, True, now=0.0) is None
    assert srv._row_verdict(t, 99, 10, 1.0, False, now=0.0) is None
    assert srv._noprog[99][1] == 0              # not dispatched: not charged
    assert srv._row_verdict(t, 99, 10, 1.0, True, now=0.0) is None
    v = srv._row_verdict(t, 99, 10, 1.0, True, now=0.0)
    assert v is not None and v[0] == "quarantined" and "no progress" in v[1]
    assert 99 not in srv._noprog
    assert srv._row_verdict(t, 99, 10, 1.0, True, now=0.0) is None
    assert srv._row_verdict(t, 99, 10, 1.0, True, now=0.0) is None
    assert srv._row_verdict(t, 99, 20, 1.0, True, now=0.0) is None
    assert srv._noprog[99] == (20, 0)
    srv._cancels.add(99)
    t.deadline_at = 0.0
    assert srv._row_verdict(t, 99, 20, float("nan"), True,
                            now=1.0)[0] == "cancelled"
    srv._cancels.discard(99)
    assert srv._row_verdict(t, 99, 20, float("nan"), True,
                            now=1.0)[0] == "expired"
    t.deadline_at = None
    assert srv._row_verdict(t, 99, 20, float("nan"), True,
                            now=1.0)[0] == "quarantined"


def test_queue_sheds_lowest_priority_on_strict_win():
    q = AdmissionQueue(max_pending=2)
    t_mid = q.submit(CampaignRequest(dim=4, fid=1, budget=100, priority=1))
    t_lo = q.submit(CampaignRequest(dim=4, fid=1, budget=100, priority=0))
    with pytest.raises(QueueFull):
        q.submit(CampaignRequest(dim=4, fid=1, budget=100, priority=0))
    t_hi = q.submit(CampaignRequest(dim=4, fid=1, budget=100, priority=5))
    assert t_lo.status == "shed" and "priority-5" in t_lo.reason
    with pytest.raises(QueueFull):
        q.submit(CampaignRequest(dim=4, fid=1, budget=100, priority=1))
    assert q.drain_shed() == [t_lo] and q.drain_shed() == []
    assert len(q) == 2 and heap_ok(q._heap)
    assert {t.job_id for t in q.pending()} == {t_mid.job_id, t_hi.job_id}


def test_take_is_nondestructive_and_never_starves():
    rng = np.random.default_rng(0)
    q = AdmissionQueue(max_pending=64)
    wide = q.submit(CampaignRequest(dim=16, fid=1, budget=100, priority=9))
    narrow = [q.submit(CampaignRequest(dim=4, fid=1, budget=100,
                                       priority=int(rng.integers(0, 4))))
              for _ in range(20)]
    out = []
    while True:
        item = q.take(lambda r: r.dim == 4)
        if item is None:
            break
        assert heap_ok(q._heap)
        out.append(item[1])
    assert len(out) == len(narrow)
    prios = [t.request.priority for t in out]
    assert prios == sorted(prios, reverse=True)
    for p in set(prios):
        ids = [t.job_id for t in out if t.request.priority == p]
        assert ids == sorted(ids)
    assert q.take()[1] is wide
    for _ in range(12):
        q.submit(CampaignRequest(dim=4, fid=1, budget=100,
                                 priority=int(rng.integers(0, 4))))
    victims = [t for i, t in enumerate(q.pending()) if i % 3 == 0]
    for t in victims[:2]:
        assert q.remove(t.job_id) is t and heap_ok(q._heap)
    for t in victims[2:]:
        t.ttl_at = 0.0
    expired = q.expire(now_s=1.0)
    assert heap_ok(q._heap)
    assert sorted(t.job_id for t in expired) == sorted(
        t.job_id for t in victims[2:])


def test_server_shed_then_dedup_resubmit(fresh_metrics):
    reg = fresh_metrics
    srv = make_server(max_pending=2)
    t1 = srv.submit(CampaignRequest(dim=4, fid=1, budget=800, seed=0,
                                    dedup_key="a"))
    t2 = srv.submit(CampaignRequest(dim=4, fid=8, budget=800, seed=1,
                                    dedup_key="b"))
    assert srv.submit(CampaignRequest(dim=4, fid=1, budget=800, seed=0,
                                      dedup_key="a")) is t1
    t3 = srv.submit(CampaignRequest(dim=4, fid=1, budget=600, seed=2,
                                    priority=5))
    assert t2.status == "shed"
    assert counter_sum(reg, "service_shed_total") == 1
    assert counter_sum(reg, "service_jobs_total", event="shed") == 1
    srv.drain()
    assert t1.done and t3.done
    t2b = srv.submit(CampaignRequest(dim=4, fid=8, budget=800, seed=1,
                                     dedup_key="b"))
    assert t2b is not t2 and t2b.job_id != t2.job_id
    assert srv.submit(CampaignRequest(dim=4, fid=1, budget=800, seed=0,
                                      dedup_key="a")) is t1
    srv.drain()
    assert t2b.done
    srv.release_ticket(t1.job_id)
    t1b = srv.submit(CampaignRequest(dim=4, fid=1, budget=800, seed=0,
                                     dedup_key="a"))
    assert t1b.job_id != t1.job_id
    srv.drain()
    assert t1b.done


def test_lifecycle_mix_adds_no_pulls_or_programs(fresh_metrics, count_pulls):
    reg = fresh_metrics
    srv = make_server(rows_per_island=2, max_pending=2)
    t_bad = srv.submit(CampaignRequest(dim=4, fitness="nan_fn",
                                       budget=2500, seed=1))
    t_run = srv.submit(CampaignRequest(dim=4, fid=8, budget=3000, seed=7))
    srv.step()
    srv.cancel(t_run.job_id)
    t_q1 = srv.submit(CampaignRequest(dim=4, fid=1, budget=1000, seed=2,
                                      queue_ttl_s=3600.0))
    t_q2 = srv.submit(CampaignRequest(dim=4, fid=1, budget=1000, seed=3))
    t_hi = srv.submit(CampaignRequest(dim=4, fid=1, budget=800, seed=4,
                                      priority=5))
    assert t_q2.status == "shed"
    t_q1.ttl_at = 0.0
    srv.drain()
    assert t_bad.status == "quarantined" and t_run.status == "cancelled"
    assert t_q1.status == "expired" and t_hi.done
    assert all(t.terminal for t in srv.tickets.values())
    edges = {(dict(lkey)["from"], dict(lkey)["to"]): s.value
             for lkey, s in series(reg, "service_job_lifecycle_total").items()}
    assert edges[("new", "queued")] == 5
    assert edges[("queued", "shed")] == 1
    assert edges[("queued", "expired")] == 1
    assert edges[("running", "cancelled")] == 1
    assert edges[("running", "quarantined")] == 1
    assert edges[("running", "done")] == 1
    pulls = sum(h.count for h in
                series(reg, "service_boundary_pull_s").values())
    assert pulls > 0 and count_pulls["n"] == pulls
    assert srv.segment_compiles() <= (KW["kmax_exp"] + 1) * len(srv.lanes)


def test_registry_rollout_builds_no_program_of_resident_lanes():
    """A registration on a live server opens generation 1: its jobs get
    new programs, the resident generation-0 lane builds none again (the
    cache is cleared first, so earlier tests' programs of the same
    callables do not count as hits)."""
    clear_program_cache()
    srv = make_server()
    t0 = srv.submit(CampaignRequest(dim=4, fitness="shifted_sphere",
                                    budget=1500, seed=5))
    for _ in range(2):
        srv.step()
    lane0 = srv.lanes[srv._lane_key(t0.request)]
    assert lane0.key[4] == 0
    progs0 = set(lane0.used_programs)
    pc0 = program_cache_stats()
    srv.registry.register("late_sphere",
                          lambda X: torch.sum((X - 0.5) ** 2, dim=-1))
    assert srv.registry.generation == 1
    t1 = srv.submit(CampaignRequest(dim=4, fitness="late_sphere",
                                    budget=1000, seed=9))
    srv.drain()
    assert t0.done and t1.done
    lane1 = srv.lanes[srv._lane_key(t1.request)]
    assert lane1.key[4] == 1 and lane1.key[:4] == lane0.key[:4]
    assert len(lane1.custom_fns) == len(lane0.custom_fns) + 1
    pc1 = program_cache_stats()
    new_keys = (lane0.used_programs | lane1.used_programs) - progs0
    assert pc1["traces"] - pc0["traces"] == len(new_keys)
    assert pc1["hits"] > pc0["hits"]
    assert lane1.used_programs.isdisjoint(lane0.used_programs)
    assert srv.segment_compiles() <= (KW["kmax_exp"] + 1) * len(srv.lanes)
    r = tipop.run_ipop(shifted_sphere, 4, 5, backend="bucketed",
                       max_evals=1500, device="cpu", **KW)
    assert r.total_fevals == t0.fevals and r.best_f == t0.best_f


def test_snapshot_roundtrips_lifecycle_states_and_dedup(tmp_path):
    d = str(tmp_path / "ck")
    srv = make_server(snapshot_dir=d)
    t_run = srv.submit(CampaignRequest(dim=4, fid=8, budget=3000, seed=7,
                                       dedup_key="keep"))
    t_bad = srv.submit(CampaignRequest(dim=4, fitness="nan_fn",
                                       budget=2000, seed=1))
    srv.step()
    srv.step()
    assert t_bad.status == "quarantined"
    t_c = srv.submit(CampaignRequest(dim=6, fid=1, budget=1000, seed=2))
    srv.cancel(t_c.job_id)
    t_e = srv.submit(CampaignRequest(dim=6, fid=1, budget=1000, seed=3,
                                     queue_ttl_s=3600.0))
    t_e.ttl_at = 0.0
    srv._expire_queued()
    srv.cancel(t_run.job_id)
    srv.snapshot()
    del srv
    srv2 = CampaignServer.restore(d, registry=make_registry(),
                                  devices=["cpu"])
    r_run = srv2.tickets[t_run.job_id]
    assert r_run.status == "running"
    assert srv2._cancels == {t_run.job_id}
    assert srv2._dedup == {"keep": t_run.job_id}
    for t in (t_bad, t_c, t_e):
        r = srv2.tickets[t.job_id]
        assert r.status == t.status and r.reason == t.reason
    got = srv2.tickets[t_bad.job_id].result
    assert got is not None and got.total_fevals == t_bad.result.total_fevals
    assert srv2.submit(CampaignRequest(dim=4, fid=8, budget=3000, seed=7,
                                       dedup_key="keep")) is r_run
    srv2.drain()
    assert r_run.status == "cancelled" and r_run.result is not None
    t_new = srv2.submit(CampaignRequest(dim=4, fid=8, budget=800, seed=7,
                                        dedup_key="keep"))
    assert t_new.job_id != t_run.job_id
    srv2.drain()
    assert t_new.done
