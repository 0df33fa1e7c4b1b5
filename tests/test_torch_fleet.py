"""Fleet supervision in the port (repro_torch/fleet/) against the JAX
package's (repro/fleet/), on the CPU.

* the counterparts of ``tests/test_fleet.py``, at its sizes (n = 6,
  λ_start = 8, kmax_exp = 2, 3 000 evaluations on ``sphere``): plan
  validation, seeding and parsing; the health detector (deadline →
  suspect → dead, a stall only where progress was expected); occupancy
  skew; recovery against the fault-free run (bucketed and mesh bit for
  bit, the service's evaluations exactly and its bests to 1e-12);
  corrupt and delay faults absorbed; reassignment onto the survivor,
  rebalance on rejoin and on skew alone; snapshots that keep results and
  update tails, ``release_ticket``; no new segment program, no
  ``fleet_*`` series and no extra pull without a supervisor; ``hostloop``
  refused;
* the fleet-composition tests of ``tests/test_lifecycle.py``: a poison
  job is a job verdict, never an island failure, and slot reuse is no
  corrupt read;
* against JAX: ``FaultPlan.seeded``/``parse`` give JAX's events,
  ``FleetHealth`` walks JAX's states on one scripted observation stream,
  and the port's supervised ``run_ipop`` gives JAX's (run in a subprocess
  beside the port's tests, JAX's ``eigen_decompose`` in the port's sign
  convention) on BBOB f1 at n = 4 (``CASES``): ``"bucketed"`` (bests to
  1e-11), ``"mesh"`` S2 and S1 (1e-10) and ``"service"`` (1e-12), the
  integer fields exactly, with equal ``fleet_failures_total``,
  ``fleet_recoveries_total`` and ``fleet_pull_retries_total``;
* two kills after one snapshot replay bit for bit, under ``auto`` and
  ``kernel_rng`` (JAX's ``pallas_rng``, its update routed to the float64
  ref), and S2's killed island replays bit for bit.
"""
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import hermetic_subproc_env

from repro.fleet import faults as jfaults
from repro.fleet import health as jhealth
from repro.obs import registry as jreg_mod
from repro_torch import obs
from repro_torch.core import ipop as tipop
from repro_torch.fleet import (CORRUPT, DELAY, KILL, FaultEvent, FaultPlan,
                               FleetConfig, FleetHealth, HealthConfig)
from repro_torch.fleet import faults as tfaults
from repro_torch.fitness import bbob as tb
from repro_torch.fleet.controller import FleetController, occupancy_skew
from repro_torch.obs import registry as reg_mod
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.service import (CampaignRequest, CampaignServer,
                                 FitnessRegistry, SlotAllocator)

KW = dict(lam_start=8, kmax_exp=2)
RUN_KW = dict(max_evals=3000, **KW)
COUNTERS = ("fleet_failures_total", "fleet_recoveries_total",
            "fleet_pull_retries_total")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The n = 6 ops are too small to split over torch's threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def sphere(X):
    return torch.sum(X * X, dim=-1)


@pytest.fixture
def fresh_metrics():
    prev = reg_mod.set_metrics(MetricsRegistry())
    yield reg_mod.metrics()
    reg_mod.set_metrics(prev)


def series(reg, name):
    return {lkey: s for (n, lkey), s in reg._series.items() if n == name}


def counter_sum(reg, name, **labels):
    return sum(s.value for lkey, s in series(reg, name).items()
               if all(dict(lkey).get(k) == v for k, v in labels.items()))


def fleet_counters(reg) -> dict:
    """The fleet's counters as ``{"name{labels}": value}``, JSON keys."""
    return {f"{n}{sorted(dict(lk).items())}": s.value
            for (n, lk), s in reg._series.items() if n in COUNTERS}


def assert_same_result(ref, got, exact=True):
    """Exact descent structure and evaluation counts always; bests bit
    for bit on the replay paths, to 1e-12 on the relocation paths."""
    assert got.total_fevals == ref.total_fevals
    assert len(got.descents) == len(ref.descents)
    for a, b in zip(ref.descents, got.descents):
        assert a.k_exp == b.k_exp and a.lam == b.lam
        assert a.stop_reason == b.stop_reason
        np.testing.assert_array_equal(a.fevals, b.fevals)
        np.testing.assert_array_equal(a.gens, b.gens)
        if exact:
            np.testing.assert_array_equal(a.best_f, b.best_f)
        else:
            np.testing.assert_allclose(a.best_f, b.best_f,
                                       rtol=1e-12, atol=1e-12)
    if exact:
        assert got.best_f == ref.best_f
    else:
        np.testing.assert_allclose(got.best_f, ref.best_f,
                                   rtol=1e-12, atol=1e-12)


def assert_matches_jax(got, want, tol):
    """A port result against JAX's (the subprocess's JSON record)."""
    assert got.total_fevals == want["total_fevals"]
    assert [[d.k_exp, d.lam, d.stop_reason] for d in got.descents] == \
        [d[:3] for d in want["descents"]]
    for d, w in zip(got.descents, want["descents"]):
        np.testing.assert_array_equal(d.gens, w[3])
        np.testing.assert_array_equal(d.fevals, w[4])
        np.testing.assert_allclose(d.best_f, w[5], rtol=tol, atol=tol)
    np.testing.assert_allclose(got.best_f, want["best_f"], rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# JAX's supervised runs, in a subprocess started with the module
# ---------------------------------------------------------------------------

#: JAX's supervised runs: name -> (backend, mesh strategy, impl,
#: snapshot_every, plan), each on BBOB f1 at n = 4 (``JAX_KW``, key 0):
#: sphere at n = 6 stops its first descent on float noise near 1e-16, so
#: the two packages' runs part at a stop generation (JAX's test_fleet
#: compares JAX with itself); f1 at n = 4 holds their descents equal.
#: Plans: on the bucketed engine kills at boundaries 2 and 3 after one
#: snapshot (at 0), a delay before them and a corrupt read after them; a
#: kill at round 2 on the mesh; a kill of the service's one island for
#: two boundaries
CASES = {
    "bucketed_auto": ("bucketed", "ordered", "auto", 4,
                      "d0:1,k0:2,k0:3,c0:5"),
    "bucketed_kernel_rng": ("bucketed", "ordered", "kernel_rng", 4,
                            "k0:2,k0:3"),
    "mesh_s2": ("mesh", "concurrent", "auto", 2, "k0:2"),
    "mesh_s1": ("mesh", "ordered", "auto", 2, "k0:2"),
    "service": ("service", "ordered", "auto", 2, "k0:2:2"),
}
JAX_KW = dict(n=4, max_evals=3000, **KW)
JAX_IMPL = {"auto": "auto", "kernel_rng": "pallas_rng"}


def make_plan(spec, mod):
    """A plan from ``CASES``' shorthand (``k`` kill island:boundary[:down],
    ``c`` corrupt, ``d`` a 10 ms delay), built with ``mod``'s classes."""
    events = []
    for cell in spec.split(","):
        kind, rest = cell[0], [int(p) for p in cell[1:].split(":")]
        if kind == "k":
            events.append(mod.FaultEvent(mod.KILL, rest[0], rest[1],
                                         down_for=rest[2] if len(rest) > 2
                                         else 0))
        elif kind == "c":
            events.append(mod.FaultEvent(mod.CORRUPT, rest[0], rest[1]))
        else:
            events.append(mod.FaultEvent(mod.DELAY, rest[0], rest[1],
                                         delay_s=0.01))
    return mod.FaultPlan(events)


JAX_FLEET = r"""
import json
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.core import cmaes
from repro.core.ipop import run_ipop
from repro.fitness import bbob
from repro.fleet import faults
from repro.fleet.controller import FleetConfig
from repro.kernels import ops
from repro.obs import registry as reg_mod

def signed(C):
    evals, evecs = jnp.linalg.eigh(C)
    pivot = jnp.argmax(jnp.abs(evecs), axis=-2, keepdims=True)
    sign = jnp.where(jnp.take_along_axis(evecs, pivot, axis=-2) < 0,
                     -1.0, 1.0)
    return evecs * sign, jnp.sqrt(jnp.maximum(evals, 1e-300))

cmaes.eigen_decompose = signed
# off a TPU JAX runs its float32 Pallas update in interpret mode: the
# port's kernel_rng update is the float64 ref
ops._kernel_tier = lambda impl: False

CASES, COUNTERS, JAX_IMPL, kw = json.loads(%r)
%s
n = kw.pop("n")
inst = bbob.make_instance(1, n, 1)
f1 = bbob.fusable_fitness(inst, (1,), lambda X: bbob.evaluate(1, inst, X))
out = {}
for name, (backend, strategy, impl, every, spec) in CASES.items():
    reg_mod.set_metrics(reg_mod.MetricsRegistry())
    res = run_ipop(f1, n, jax.random.PRNGKey(0), backend=backend,
                   mesh_strategy=strategy, impl=JAX_IMPL[impl],
                   fleet=FleetConfig(snapshot_every=every,
                                     plan=make_plan(spec, faults)), **kw)
    reg = reg_mod.metrics()
    out[name] = {
        "total_fevals": int(res.total_fevals), "best_f": float(res.best_f),
        "descents": [[int(d.k_exp), int(d.lam), int(d.stop_reason),
                      np.asarray(d.gens).tolist(),
                      np.asarray(d.fevals).tolist(),
                      np.asarray(d.best_f).tolist()]
                     for d in res.descents],
        "counters": {f"{n}{sorted(dict(lk).items())}": s.value
                     for (n, lk), s in reg._series.items() if n in COUNTERS}}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_fleet():
    """JAX's supervised runs of ``CASES``: started with the module, so
    that they run beside the port's, read when a test needs them
    (150 s)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = JAX_FLEET % (json.dumps([CASES, COUNTERS, JAX_IMPL, JAX_KW]),
                          inspect.getsource(make_plan))
    proc = subprocess.Popen([sys.executable, "-c", script],
                            env=hermetic_subproc_env(), cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    result = {}

    def get():
        if not result:
            out, err = proc.communicate(timeout=150)
            assert proc.returncode == 0, err[-4000:]
            line = next(x for x in out.splitlines() if x.startswith("JSON"))
            result.update(json.loads(line[4:]))
        return result
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def f1_fitness():
    inst = tb.make_instance(1, JAX_KW["n"], 1, device="cpu")
    return tb.fusable_fitness(inst, (1,),
                              lambda X: tb.evaluate(1, inst, X))


@pytest.fixture(scope="module")
def refs():
    """The port's fault-free runs, one a (fitness, backend, strategy,
    impl), made on first use: ``"sphere"`` at ``RUN_KW``'s sizes and
    n = 6, ``"f1"`` at ``JAX_KW``'s."""
    cache = {}

    def get(fit, backend, strategy="ordered", impl="auto"):
        key = (fit, backend, strategy, impl)
        if key not in cache:
            cache[key] = supervised(fit, backend, strategy, impl)[0]
        return cache[key]
    return get


def supervised(fit, backend, strategy="ordered", impl="auto", fleet=None):
    """``run_ipop`` on sphere (n = 6, ``RUN_KW``) or f1 (``JAX_KW``) under
    ``fleet``, on a fresh registry: ``(result, registry)``."""
    prev = reg_mod.set_metrics(MetricsRegistry())
    try:
        if fit == "sphere":
            fn, n, kw = sphere, 6, RUN_KW
        else:
            kw = dict(JAX_KW)
            fn, n = f1_fitness(), kw.pop("n")
        res = tipop.run_ipop(fn, n, 0, backend=backend,
                             mesh_strategy=strategy, impl=impl, fleet=fleet,
                             device="cpu", **kw)
        return res, reg_mod.metrics()
    finally:
        reg_mod.set_metrics(prev)


def run_case(name):
    """The port's supervised f1 run of ``CASES[name]``."""
    backend, strategy, impl, every, spec = CASES[name]
    return supervised("f1", backend, strategy, impl, FleetConfig(
        snapshot_every=every, plan=make_plan(spec, tfaults)))


# ---------------------------------------------------------------------------
# fault plans (pure)
# ---------------------------------------------------------------------------

def test_fault_plan_validation_and_lookup():
    with pytest.raises(ValueError):
        FaultEvent("explode", island=0, boundary=1)
    with pytest.raises(ValueError):
        FaultEvent(KILL, island=0, boundary=0)   # nothing to recover yet
    with pytest.raises(ValueError):
        FaultEvent(DELAY, island=-1, boundary=1)
    p = FaultPlan([FaultEvent(KILL, island=1, boundary=3, down_for=2),
                   FaultEvent(DELAY, island=0, boundary=2, delay_s=0.1),
                   FaultEvent(DELAY, island=0, boundary=2, delay_s=0.2),
                   FaultEvent(CORRUPT, island=0, boundary=4)])
    assert [e.boundary for e in p.kills_at(3)] == [3]
    assert p.kill_at(1, 3) is not None and p.kill_at(0, 3) is None
    assert p.delay(0, 2) == pytest.approx(0.3)      # delays accumulate
    assert p.corrupts(0, 4) and not p.corrupts(0, 3)
    assert p.max_boundary() == 4


def _events(plan):
    return [(e.kind, e.island, e.boundary, e.down_for, e.delay_s)
            for e in plan.events]


def test_fault_plan_seeded_and_parse():
    a = FaultPlan.seeded(11, 4, kills=2, delays=1, corrupts=1)
    b = FaultPlan.seeded(11, 4, kills=2, delays=1, corrupts=1)
    assert _events(a) == _events(b)
    kills = [e for e in a.events if e.kind == KILL]
    assert len(kills) == 2
    assert len({e.island for e in kills}) == 2       # one kill per island
    assert all(e.boundary >= 1 for e in kills)

    p = FaultPlan.parse("0:2,1:5:3", down_for=1)
    ks = [e for e in p.events if e.kind == KILL]
    assert [(e.island, e.boundary, e.down_for) for e in ks] == \
           [(0, 2, 1), (1, 5, 3)]                    # per-cell down_for wins


@pytest.mark.parametrize("seed,kw", [
    (11, dict(kills=2, delays=1, corrupts=1)),
    (0, dict(kills=3, delays=2, corrupts=2, horizon=8, down_for=2,
             delay_s=0.25)),
    (7, dict(kills=1, min_boundary=4, horizon=4))])
def test_fault_plans_match_jax(seed, kw):
    """The same seed and the same spec give JAX's events."""
    assert _events(FaultPlan.seeded(seed, 5, **kw)) == \
        _events(jfaults.FaultPlan.seeded(seed, 5, **kw))
    spec = "0:3, 2:1:4,1:7"
    assert _events(FaultPlan.parse(spec, down_for=2)) == \
        _events(jfaults.FaultPlan.parse(spec, down_for=2))
    with pytest.raises(ValueError):
        FaultPlan.parse("1:2:3:4")


# ---------------------------------------------------------------------------
# health detector (pure)
# ---------------------------------------------------------------------------

def test_health_deadline_suspect_then_dead(fresh_metrics):
    h = FleetHealth(HealthConfig(deadline_s=1.0, retries=1))
    h.observe(0, 0, 100.0, wall_s=0.1)
    assert h.state(0) == "alive"
    h.observe(0, 1, 200.0, wall_s=2.0)               # over deadline
    assert h.state(0) == "suspect"
    h.observe(0, 2, 300.0, wall_s=0.1)               # fast pull clears it
    assert h.state(0) == "alive"
    h.observe(0, 3, 400.0, wall_s=2.0)
    h.observe(0, 4, 500.0, wall_s=2.0)               # retry budget exhausted
    assert h.is_dead(0) and h.island(0).reason == "deadline"
    assert h.dead_islands() == [0]
    h.revive(0, 5)
    assert h.state(0) == "alive" and not h.dead_islands()
    # the state gauge followed the transitions
    g = fresh_metrics.gauge("fleet_island_state", island=0)
    assert g.value == 0.0


def test_health_stall_needs_expected_progress():
    h = FleetHealth(HealthConfig(deadline_s=10.0, stall_boundaries=2))
    h.observe(0, 0, 50.0, wall_s=0.01)
    for b in range(1, 5):                            # idle: no dispatch
        h.observe(0, b, 50.0, wall_s=0.01, expect_progress=False)
    assert h.state(0) == "alive"
    h.observe(0, 5, 50.0, wall_s=0.01)               # dispatched, no progress
    assert not h.is_dead(0)
    h.observe(0, 6, 50.0, wall_s=0.01)
    assert h.is_dead(0) and h.island(0).reason == "stalled"
    # progress watermark rebases after a restore (no false stall verdicts)
    h.revive(0, 7)
    h.reset_progress(0, 20.0)
    h.observe(0, 8, 30.0, wall_s=0.01)
    assert h.state(0) == "alive"


def test_health_walks_jax_states(fresh_metrics):
    """One scripted stream of observations, verdicts and revivals over
    three islands: the port's detector and JAX's pass through the same
    states, reasons and watermarks, and emit the same gauge values."""
    rng = np.random.default_rng(3)
    cfg = dict(deadline_s=1.0, stall_boundaries=2, retries=1)
    tp = FleetHealth(HealthConfig(**cfg))
    jprev = jreg_mod.set_metrics(jreg_mod.MetricsRegistry())
    try:
        jp = jhealth.FleetHealth(jhealth.HealthConfig(**cfg))
        fev = np.zeros(3)
        for b in range(60):
            for i in range(3):
                op = rng.integers(0, 10)
                if op == 0:
                    for h in (tp, jp):
                        h.revive(i, b)
                elif op == 1:
                    for h in (tp, jp):
                        h.mark_dead(i, b, "killed")
                elif op == 2:
                    fev[i] = max(0.0, fev[i] - 30.0)
                    for h in (tp, jp):
                        h.reset_progress(i, fev[i])
                else:
                    fev[i] += rng.choice([0.0, 0.0, 25.0])
                    wall = float(rng.choice([0.1, 0.1, 2.0]))
                    expect = bool(rng.integers(0, 2))
                    got = tp.observe(i, b, fev[i], wall, expect)
                    assert got == jp.observe(i, b, fev[i], wall, expect)
                a, w = tp.island(i), jp.island(i)
                assert (a.state, a.reason, a.last_fev, a.stalled_for,
                        a.slow_pulls, a.down_since) == \
                    (w.state, w.reason, w.last_fev, w.stalled_for,
                     w.slow_pulls, w.down_since), (b, i)
        assert tp.dead_islands() == jp.dead_islands()
        for i in range(3):
            assert fresh_metrics.gauge("fleet_island_state",
                                       island=i).value == \
                jreg_mod.metrics().gauge("fleet_island_state",
                                         island=i).value
    finally:
        jreg_mod.set_metrics(jprev)


def test_occupancy_skew_is_the_rebalance_signal():
    al = SlotAllocator(2, 4)
    for j in range(4):
        al.alloc(j, 100, island=0)                   # all on island 0
    assert occupancy_skew(al) == 1.0
    al.release(0, 3)
    al.alloc(9, 100, island=1)
    assert occupancy_skew(al) == 0.5
    balanced, _moves, _layout = al.repack(2)
    assert occupancy_skew(balanced) == 0.0           # repack balances


# ---------------------------------------------------------------------------
# recovery determinism: every backend against its fault-free run
# ---------------------------------------------------------------------------

def test_bucketed_kill_recovery_bit_identical(refs):
    got, reg = supervised("sphere", "bucketed", fleet=FleetConfig(
        snapshot_every=2,
        plan=FaultPlan([FaultEvent(KILL, island=0, boundary=3)])))
    assert_same_result(refs("sphere", "bucketed"), got, exact=True)
    assert counter_sum(reg, "fleet_failures_total", reason="killed") == 1
    assert counter_sum(reg, "fleet_recoveries_total", mode="replayed") == 1
    assert reg.histogram("fleet_recovery_wall_s").count == 1
    assert reg.histogram("fleet_lost_work_evals").count == 1


def test_bucketed_corrupt_and_delay_faults_are_absorbed(refs):
    got, reg = supervised("sphere", "bucketed", fleet=FleetConfig(
        snapshot_every=2,
        plan=FaultPlan([FaultEvent(CORRUPT, island=0, boundary=2),
                        FaultEvent(DELAY, island=0, boundary=1,
                                   delay_s=0.01)])))
    assert_same_result(refs("sphere", "bucketed"), got, exact=True)
    # the garbled read was re-pulled, not believed (and not a death)
    assert counter_sum(reg, "fleet_pull_retries_total") >= 1
    assert counter_sum(reg, "fleet_failures_total") == 0


def test_mesh_kill_recovery_bit_identical(refs):
    got, reg = supervised("sphere", "mesh", fleet=FleetConfig(
        snapshot_every=2,
        plan=FaultPlan([FaultEvent(KILL, island=0, boundary=2)])))
    assert_same_result(refs("sphere", "mesh"), got, exact=True)
    assert counter_sum(reg, "fleet_recoveries_total", mode="replayed") == 1


def test_service_kill_park_and_rejoin_identical(refs):
    """Single-island service: the kill parks the row (no survivor has
    capacity), the island rejoins after ``down_for`` boundaries and the
    row replays — the fault-free run's result."""
    got, reg = supervised("sphere", "service", fleet=FleetConfig(
        snapshot_every=2,
        plan=FaultPlan([FaultEvent(KILL, island=0, boundary=2,
                                   down_for=2)])))
    assert_same_result(refs("sphere", "service"), got, exact=False)
    assert counter_sum(reg, "fleet_recoveries_total", mode="requeued") == 1
    assert counter_sum(reg, "fleet_recoveries_total", mode="rejoined") == 1
    assert counter_sum(reg, "fleet_recoveries_total", mode="reassigned") == 1


# ---------------------------------------------------------------------------
# service-level controller: reassignment onto survivors + rebalancing
# ---------------------------------------------------------------------------

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


def make_server(n_islands=2, **extra):
    kw = dict(registry=make_registry(), bbob_fids=(1, 8), max_budget=5000,
              rows_per_island=2, devices=["cpu"] * n_islands, **KW)
    kw.update(extra)
    return CampaignServer(**kw)


def _submit_pair(srv):
    return [srv.submit(CampaignRequest(dim=4, fid=8, budget=3000, seed=7)),
            srv.submit(CampaignRequest(dim=4, fitness="shifted_sphere",
                                       budget=2000, seed=3))]


@pytest.fixture(scope="module")
def pair_reference():
    """The fault-free pair on a plain two-island server: its tickets and
    its programs."""
    srv = make_server()
    ts = _submit_pair(srv)
    srv.drain()
    return ts, srv.segment_compiles()


@pytest.fixture(scope="module")
def pair_killed(tmp_path_factory):
    """The pair on a supervised two-island server whose island 1 dies at
    boundary 3 for good: the server, its tickets, its metrics registry
    and its spans."""
    srv = make_server(snapshot_dir=str(tmp_path_factory.mktemp("ckpt")))
    prev_m = reg_mod.set_metrics(MetricsRegistry())
    prev_t = obs.set_tracer(obs.Tracer())
    try:
        ts = _submit_pair(srv)
        ctl = FleetController(srv, FleetConfig(
            snapshot_every=2,
            plan=FaultPlan([FaultEvent(KILL, island=1, boundary=3)])))
        assert srv.snapshot_every == 2      # controller owns the cadence
        ctl.drain()
        return srv, ts, reg_mod.metrics(), obs.tracer().finished()
    finally:
        reg_mod.set_metrics(prev_m)
        obs.set_tracer(prev_t)


def test_service_kill_reassigns_rows_to_survivor(pair_reference,
                                                 pair_killed):
    ref, _compiles = pair_reference
    srv, ts, reg, spans = pair_killed
    assert 1 in srv.down_islands            # never came back (down_for=0)
    assert counter_sum(reg, "fleet_failures_total", reason="killed") == 1
    assert counter_sum(reg, "fleet_recoveries_total", mode="reassigned") == 1
    for tr, tg in zip(ref, ts):
        assert tg.done
        assert tg.island == 0               # relocated onto the survivor
        assert tg.fevals == tr.fevals
        assert_same_result(tr.result, tg.result, exact=False)
    # the moved job's spans stitch across the failure: a recover event and
    # two running phases under its root
    root = next(sp for sp in spans if sp.name == "job"
                and sp.attrs["job"] == ts[1].job_id)
    kids = [sp for sp in spans if sp.parent_id == root.span_id]
    assert [sp.attrs["mode"] for sp in kids if sp.name == "recover"] == \
        ["reassigned"]
    assert sum(sp.name == "running" for sp in kids) == 2


def test_rejoin_triggers_rebalance_back_onto_returned_island(fresh_metrics,
                                                             tmp_path):
    """down_for kill on a 2-island lane with survivor head-room: the dead
    island's rows are REASSIGNED onto the survivor (it has free rows), so
    the island rejoins empty — and the rejoin-triggered repack spreads the
    lane across both islands again."""
    srv = make_server(rows_per_island=4, snapshot_dir=str(tmp_path / "ckpt"))
    ts = [srv.submit(CampaignRequest(dim=4, fid=1, budget=5000, seed=s))
          for s in range(4)]                # 2 rows per island, 2 free each
    ctl = FleetController(srv, FleetConfig(
        snapshot_every=2, skew_threshold=0.4,
        plan=FaultPlan([FaultEvent(KILL, island=1, boundary=3,
                                   down_for=1)])))
    lane = None
    for _ in range(5):                      # kill at b=3, rejoin at b=4
        ctl.step()
        if lane is None:
            lane = next(iter(srv.lanes.values()))
    reg = fresh_metrics
    assert counter_sum(reg, "fleet_recoveries_total", mode="reassigned") == 2
    assert counter_sum(reg, "fleet_recoveries_total", mode="rejoined") == 1
    assert counter_sum(reg, "fleet_rebalances_total", trigger="rejoin") >= 1
    assert occupancy_skew(lane.allocator) <= 0.25   # repacked across both
    ctl.drain()
    assert not srv.down_islands
    for t in ts:
        assert t.done


def test_load_skew_triggers_rebalance_without_any_failure(fresh_metrics):
    """The repack trigger fires on plain load imbalance — short jobs
    retire one island's rows while the other stays full — with no fault
    anywhere in the run."""
    srv = make_server(rows_per_island=4)
    # admission balances islands round-robin: even submissions land on
    # island 0, odd on island 1 — so the short jobs all retire from one side
    ts = [srv.submit(CampaignRequest(dim=4, fid=1, budget=b, seed=s))
          for s, b in enumerate([600, 5000, 600, 5000])]
    ctl = FleetController(srv, FleetConfig(skew_threshold=0.4))
    for _ in range(30):
        ctl.step()
        if counter_sum(fresh_metrics, "fleet_rebalances_total",
                       trigger="skew"):
            break
    assert counter_sum(fresh_metrics, "fleet_rebalances_total",
                       trigger="skew") >= 1
    assert counter_sum(fresh_metrics, "fleet_failures_total") == 0
    ctl.drain()
    for t in ts:
        assert t.done


def test_kill_without_snapshot_replays_rows_from_their_requests(
        fresh_metrics):
    """No snapshot directory: a dead island's rows restart from their
    requests (admission state is a pure function of the request) on the
    survivor, to the fault-free server's results."""
    reqs = [CampaignRequest(dim=4, fid=f, budget=1500, seed=s)
            for s, f in enumerate((1, 8))]
    ref = make_server()
    want = [ref.submit(r) for r in reqs]
    ref.drain()
    srv = make_server()
    got = [srv.submit(r) for r in reqs]
    ctl = FleetController(srv, FleetConfig(
        plan=FaultPlan([FaultEvent(KILL, island=0, boundary=2)])))
    ctl.drain()
    assert counter_sum(fresh_metrics, "fleet_recoveries_total",
                       mode="reassigned") == 1
    # nothing was snapshotted: the dead row's evaluations were all lost
    assert fresh_metrics.histogram("fleet_lost_work_evals").sum > 0
    for w, g in zip(want, got):
        assert g.done and g.island == 1 and g.fevals == w.fevals
        assert_same_result(w.result, g.result, exact=False)


# ---------------------------------------------------------------------------
# job persistence across snapshots
# ---------------------------------------------------------------------------

def test_snapshot_persists_results_and_update_tails(tmp_path):
    d = str(tmp_path / "ckpt")
    srv = make_server(n_islands=1, snapshot_dir=d)
    t_done = srv.submit(CampaignRequest(dim=4, fid=1, budget=1500, seed=5))
    srv.drain()
    t_live = srv.submit(CampaignRequest(dim=4, fid=8, budget=3000, seed=7))
    for _ in range(3):
        srv.step()                          # t_live mid-flight, streaming
    assert t_done.done and t_done.result is not None
    assert t_live.updates
    srv.snapshot()
    del srv

    srv2 = CampaignServer.restore(d, registry=make_registry(),
                                  devices=["cpu"])
    r_done = srv2.tickets[t_done.job_id]
    assert r_done.done
    # the FULL result rode the snapshot: scalars, descents, best_x arrays
    assert_same_result(t_done.result, r_done.result, exact=True)
    np.testing.assert_array_equal(t_done.result.best_x, r_done.result.best_x)
    # streamed ticket tails are identical after resume
    assert srv2.tickets[t_live.job_id].updates == t_live.updates
    assert r_done.updates == t_done.updates
    srv2.drain()
    assert srv2.tickets[t_live.job_id].done


def test_release_ticket_frees_host_memory_only_when_done():
    srv = make_server(n_islands=1)
    t = srv.submit(CampaignRequest(dim=4, fid=1, budget=1200, seed=0))
    assert srv.release_ticket(t.job_id) is None      # still running
    srv.drain()
    released = srv.release_ticket(t.job_id)
    assert released is t and t.job_id not in srv.tickets
    assert srv.release_ticket(t.job_id) is None      # idempotent
    # retired rows stay recognised: a follow-up job still drains cleanly
    t2 = srv.submit(CampaignRequest(dim=4, fid=1, budget=1000, seed=1))
    srv.drain()
    assert t2.done


# ---------------------------------------------------------------------------
# zero overhead when disabled / no new programs when enabled
# ---------------------------------------------------------------------------

def test_supervision_adds_no_segment_programs(pair_reference, pair_killed):
    """The recovery path replays the segment runners already in use: a
    supervised server (with a kill) uses exactly the plain server's."""
    _ref, baseline = pair_reference
    srv = pair_killed[0]
    assert srv.segment_compiles() == baseline


def test_no_supervisor_means_no_fleet_series(fresh_metrics):
    res = tipop.run_ipop(sphere, 4, 0, backend="bucketed", max_evals=1500,
                         fleet=None, device="cpu", **KW)
    assert not any(n.startswith("fleet_")
                   for (n, _l) in fresh_metrics._series)
    # no extra device read: one pull a boundary
    assert res.driver["pulls"] == len(res.driver["segments"]) + 1
    assert fresh_metrics.histogram("bucketed_sync_s").count == \
        res.driver["pulls"]


def test_fleet_rejects_engineless_backends():
    for backend in ("hostloop", "ladder"):
        with pytest.raises(ValueError, match="fleet supervision"):
            tipop.run_ipop(sphere, 4, 0, backend=backend,
                           fleet=FleetConfig(), max_evals=1000,
                           device="cpu", **KW)


# ---------------------------------------------------------------------------
# fleet composition: poison is a job verdict, never an island one
# ---------------------------------------------------------------------------

def test_poison_job_never_kills_island(fresh_metrics, tmp_path):
    reg = fresh_metrics
    # reference: the healthy job alone, unsupervised
    ref = make_server(n_islands=1)
    t_ref = ref.submit(CampaignRequest(dim=4, fid=8, budget=2500, seed=7))
    ref.drain()

    # stall_boundaries=1: a single mis-graded no-progress round would kill
    # the island — the tightest setting the blind spot could trip
    srv = make_server(n_islands=1, snapshot_dir=str(tmp_path / "ck"))
    ctl = FleetController(srv, FleetConfig(snapshot_every=2,
                                           stall_boundaries=1))
    t_bad = srv.submit(CampaignRequest(dim=4, fitness="nan_fn",
                                       budget=2500, seed=1))
    t_ok = srv.submit(CampaignRequest(dim=4, fid=8, budget=2500, seed=7))
    ctl.drain()
    assert t_bad.status == "quarantined"
    assert t_ok.done
    assert ctl.sup.health.state(0) == "alive"
    assert counter_sum(reg, "fleet_failures_total") == 0
    # the healthy co-tenant is its run alone (row-keyed sampling: a
    # quarantined neighbour never perturbs a trajectory)
    assert t_ok.fevals == t_ref.fevals
    assert_same_result(t_ref.result, t_ok.result, exact=False)
    # an island whose residents are all retired dispatches nothing and must
    # never be graded "stalled" — idle supervised rounds keep it ALIVE
    for _ in range(3):
        ctl.step()
    assert ctl.sup.health.state(0) == "alive"


def test_slot_reuse_is_not_a_corrupt_read(fresh_metrics, tmp_path):
    """Readmission into a freed row resets its evaluation counter to 0 — a
    legitimate regress of the island's summed watermark that must trigger
    neither the corrupt-read retry nor a stall/dead verdict."""
    reg = fresh_metrics
    srv = make_server(n_islands=1, rows_per_island=1,
                      snapshot_dir=str(tmp_path / "ck"))
    ctl = FleetController(srv, FleetConfig(snapshot_every=2,
                                           stall_boundaries=2, retries=1))
    t_a = srv.submit(CampaignRequest(dim=4, fid=1, budget=1500, seed=3))
    t_b = srv.submit(CampaignRequest(dim=4, fid=8, budget=1500, seed=5))
    ctl.drain()                         # B re-uses A's row after A finishes
    assert t_a.done and t_b.done
    assert ctl.sup.health.state(0) == "alive"
    assert counter_sum(reg, "fleet_pull_retries_total") == 0


# ---------------------------------------------------------------------------
# against JAX's supervised runs (last: JAX's subprocess runs beside the
# tests above)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,tol", [("mesh_s1", 1e-10),
                                      ("service", 1e-12)])
def test_supervised_run_matches_jax(case, tol, jax_fleet):
    """The port's supervised run against JAX's under the same plan: the
    integer fields exactly, the bests to ``tol`` (ROADMAP.md queue C's
    tolerances), the fleet counters equal."""
    got, reg = run_case(case)
    want = jax_fleet()[case]
    assert_matches_jax(got, want, tol)
    assert fleet_counters(reg) == want["counters"]
    assert counter_sum(reg, "fleet_failures_total") == 1


def test_mesh_s2_kill_recovery_bit_identical(refs, jax_fleet):
    """S2 replays its killed island from the island's snapshot: the
    fault-free run bit for bit, and JAX's supervised S2 run."""
    got, reg = run_case("mesh_s2")
    assert_same_result(refs("f1", "mesh", "concurrent"), got, exact=True)
    want = jax_fleet()["mesh_s2"]
    assert_matches_jax(got, want, 1e-10)
    assert fleet_counters(reg) == want["counters"]
    assert counter_sum(reg, "fleet_recoveries_total", mode="replayed") == 1


@pytest.mark.parametrize("impl", ["auto", "kernel_rng"])
def test_two_kills_after_one_snapshot_replay_bit_for_bit(impl, refs,
                                                         jax_fleet):
    """Kills at boundaries 2 and 3 both restore boundary 0's snapshot:
    the restore clones it, so the second replay starts from the state the
    first did (a snapshot aliasing the live carry would not).  Under
    ``auto`` a delay and a corrupt read ride the same run.  Both against
    the fault-free run bit for bit and JAX's supervised run (bests to
    1e-11, counters equal)."""
    case = f"bucketed_{impl}"
    got, reg = run_case(case)
    assert_same_result(refs("f1", "bucketed", impl=impl), got, exact=True)
    assert counter_sum(reg, "fleet_failures_total", reason="killed") == 2
    assert counter_sum(reg, "fleet_recoveries_total", mode="replayed") == 2
    if impl == "auto":
        assert counter_sum(reg, "fleet_pull_retries_total") >= 1
    want = jax_fleet()[case]
    assert_matches_jax(got, want, 1e-11)
    assert fleet_counters(reg) == want["counters"]
