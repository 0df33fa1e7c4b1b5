"""The port's observability package (``repro_torch/obs``) against the JAX
package's: the same 40 series and the same ``docs/METRICS.md`` table, the
same instrument semantics and schema errors, files each package reads from
the other, no torch or numpy import, and the bucketed driver's and the
mesh engine's series on a real run of the port, from the pulls it already
makes."""
import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from repro.obs import registry as jreg
from repro.obs import schema as jschema
from repro.obs import trace as jtrace
from repro_torch import obs
from repro_torch.core import bucketed as tbucketed
from repro_torch.core import ipop as tipop
from repro_torch.fitness import bbob as tb
from repro_torch.obs import registry as treg
from repro_torch.obs import schema as tschema
from repro_torch.obs import trace as ttrace
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
KW = dict(lam_start=8, kmax_exp=2, device="cpu")


@pytest.fixture
def fresh():
    """Empty process-wide registry and tracer of the port, restored after."""
    prev_m = treg.set_metrics(treg.MetricsRegistry())
    prev_t = ttrace.set_tracer(ttrace.Tracer())
    yield obs.metrics(), obs.tracer()
    treg.set_metrics(prev_m)
    ttrace.set_tracer(prev_t)


def series(reg, name):
    return {lkey: s for (n, lkey), s in reg._series.items() if n == name}


def test_specs_equal_jax():
    """The same 40 series: names, kinds, units, label sets, buckets."""
    import dataclasses
    assert len(tschema.SCHEMA) == len(jschema.SCHEMA) == 40
    for t, j in zip(tschema.SCHEMA, jschema.SCHEMA):
        assert dataclasses.asdict(t) == dataclasses.asdict(j), j.name
    assert list(tschema.SPECS) == list(jschema.SPECS)
    assert tschema.TIME_BUCKETS_S == jschema.TIME_BUCKETS_S
    assert tschema.log_buckets(1e-2, 1e1, 1) == jschema.log_buckets(
        1e-2, 1e1, 1)


def test_render_markdown_is_the_docs_table():
    assert tschema.render_markdown() == jschema.render_markdown()
    assert tschema.check_file(str(ROOT / "docs" / "METRICS.md"))


def _instrument_run(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("service_jobs_total", event="submitted")
    c.inc()
    c.inc(2.5)
    same = reg.counter("service_jobs_total", event="submitted") is c
    g = reg.gauge("service_queue_depth")
    g.set(4)
    g.set(2)
    h = reg.histogram("service_snapshot_s")
    for v in (1e-6, 0.02, 5e4):
        h.observe(v)
    return (c.value, same, g.value, h.count, list(h.counts), h.sum,
            h.quantile(0.5), h.quantile(1.0), reg.collect(),
            reg.render_text())


def test_instrument_semantics_match_jax():
    assert _instrument_run(treg) == _instrument_run(jreg)
    with pytest.raises(ValueError):
        treg.MetricsRegistry().counter("service_jobs_total",
                                       event="x").inc(-1)
    assert treg.MetricsRegistry().histogram("service_snapshot_s") \
        .quantile(0.5) is None


@pytest.mark.parametrize("call,exc", [
    (lambda r: r.counter("no_such_metric_total"), KeyError),
    (lambda r: r.gauge("service_jobs_total", event="submitted"), TypeError),
    (lambda r: r.counter("service_jobs_total"), ValueError),
    (lambda r: r.counter("service_jobs_total", event="x", extra="y"),
     ValueError),
])
def test_schema_validation_errors_match_jax(call, exc):
    for mod in (treg, jreg):
        with pytest.raises(exc):
            call(mod.MetricsRegistry())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_jsonl_is_read_by_both_packages(writer, tmp_path):
    """Each package's JSONL sink is read by the other's ``read_jsonl``; a
    torn last line is skipped."""
    mod = treg if writer == "port" else jreg
    reg = mod.MetricsRegistry()
    reg.counter("service_jobs_total", event="submitted").inc(3)
    reg.histogram("service_admission_wait_s").observe(0.5)
    path = tmp_path / "m.jsonl"
    reg.flush_jsonl(str(path))
    reg.counter("service_jobs_total", event="submitted").inc()
    reg.flush_jsonl(str(path))
    with open(path, "a") as fh:
        fh.write('{"seq": 2, "metr')             # a torn write
    got_t = list(treg.read_jsonl(str(path)))
    got_j = list(jreg.read_jsonl(str(path)))
    assert got_t == got_j
    assert [r["seq"] for r in got_t] == [0, 1]
    assert got_t[-1]["metrics"] == reg.collect()


def test_text_exposition_and_http_endpoints():
    """``/metrics`` serves the text exposition, ``/statusz`` the status
    function's JSON, other paths 404 (on 127.0.0.1)."""
    reg = treg.MetricsRegistry()
    reg.counter("service_jobs_total", event="submitted").inc(2)
    reg.histogram("service_boundary_pull_s", lane="d4.l8.k2.float64") \
        .observe(0.001)
    txt = reg.render_text()
    assert 'service_jobs_total{event="submitted"} 2' in txt
    assert 'le="+Inf"' in txt
    httpd, port = treg.start_metrics_server(reg,
                                            status_fn=lambda: {"boundary": 7})
    try:
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/metrics") as resp:
            assert resp.read().decode() == reg.render_text()
        with urllib.request.urlopen(base + "/statusz") as resp:
            assert json.loads(resp.read().decode()) == {"boundary": 7}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope")
    finally:
        httpd.shutdown()


def _spans(tr):
    root = tr.start("job", job=1, dim=4, priority=0)
    ph = tr.start("queued", parent=root, job=1)
    tr.end(ph)
    with tr.span("pull", island=0, boundary=0):
        pass
    with tr.span("segment", island=0, bucket=1, boundary=0):
        pass
    tr.event("recover", parent=root, job=1)
    tr.end(root, status="done")


def test_chrome_export_passes_jax_validation(tmp_path):
    """The port's Chrome trace passes the JAX package's ``validate_chrome``
    and its own; its JSONL spans load and summarise in both packages."""
    tr = ttrace.Tracer()
    _spans(tr)
    tr.export_chrome(str(tmp_path / "t.json"))
    tr.export_jsonl(str(tmp_path / "t.jsonl"))
    doc = json.loads((tmp_path / "t.json").read_text())
    assert jtrace.validate_chrome(doc) == []
    assert ttrace.validate_chrome(doc) == []
    spans_t = ttrace.load_jsonl(str(tmp_path / "t.jsonl"))
    spans_j = jtrace.load_jsonl(str(tmp_path / "t.jsonl"))
    assert spans_t == spans_j and len(spans_t) == 5
    assert ttrace.summarize(spans_t) == jtrace.summarize(spans_j)


def test_tracer_ring_counts_evictions():
    tr = ttrace.Tracer(capacity=4)
    for j in range(7):
        with tr.span("pull", island=0, boundary=j):
            pass
    assert len(tr.finished()) == 4 and tr.dropped == 3
    assert [s.attrs["boundary"] for s in tr.finished()] == [3, 4, 5, 6]


def test_flight_recorder_ring_and_dump(tmp_path):
    from repro_torch.obs.recorder import FlightRecorder
    rec = FlightRecorder(k=3)
    for b in range(5):
        rec.observe(0, b, lane="d4", wall=0.1, fevals=10 * b, grade="alive",
                    verdicts=[])
    out = rec.dump(0, 4, "quarantine", extra={"job": 2})
    assert [o["boundary"] for o in out["timeline"]] == [2, 3, 4]
    assert out["trigger"] == "quarantine" and out["extra"] == {"job": 2}
    rec.out_dir = str(tmp_path)
    rec.dump(0, 5, "quarantine")
    assert (tmp_path / "postmortem-0-5.json").exists()


def test_obs_imports_neither_torch_nor_numpy():
    code = ("import sys; sys.modules['torch'] = None; "
            "sys.modules['numpy'] = None; "
            "import repro_torch.obs, repro_torch.obs.registry, "
            "repro_torch.obs.schema, repro_torch.obs.trace, "
            "repro_torch.obs.recorder; "
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin"})


def test_bucketed_run_emits_series_from_its_pulls(fresh, monkeypatch):
    """The counterpart of the JAX package's pin: one ``bucketed_sync_s``
    observation per schedule pull, useful evaluations = ``total_fevals``,
    one segment span and record per segment, and the spans' busy and
    blocked seconds bracket the histograms' walls."""
    reg, tracer = fresh
    calls = []
    pull = tbucketed.pull_schedule

    def counting(carry, **kw):
        calls.append(1)
        return pull(carry, **kw)
    monkeypatch.setattr(tbucketed, "pull_schedule", counting)
    fn, _ = tb.make_fitness(1, 4, 1, device="cpu")
    res = tipop.run_ipop(fn, 4, 0, backend="bucketed", max_evals=3000, **KW)
    syncs = reg.histogram("bucketed_sync_s")
    assert syncs.count == len(calls) == res.driver["pulls"] > 1
    assert reg.counter("bucketed_useful_evals_total").value \
        == res.total_fevals
    padded = sum(s.value for s in
                 series(reg, "bucketed_padded_evals_total").values())
    assert padded >= res.total_fevals
    segs = series(reg, "bucketed_segments_total")
    n_segs = sum(s.value for s in segs.values())
    assert n_segs == syncs.count - 1 == len(res.driver["segments"])
    walls = series(reg, "bucketed_segment_wall_s")
    assert set(walls) == set(segs)
    assert all(s.value > 0 for s in
               series(reg, "bucketed_eigh_blocks_total").values())
    spans = tracer.finished()
    assert sum(1 for s in spans if s.name == "segment") == n_segs
    assert sum(1 for s in spans if s.name == "pull") == syncs.count
    digest = ttrace.summarize([s.to_json() for s in spans])
    isl = digest["islands"]["all"]
    seg_wall = sum(h.sum for h in walls.values())
    assert isl["busy_s"] == pytest.approx(seg_wall, rel=0.2, abs=0.05)
    assert isl["blocked_s"] == pytest.approx(syncs.sum, rel=0.2, abs=0.05)
    assert isl["busy_frac"] + isl["blocked_frac"] + isl["idle_frac"] \
        == pytest.approx(1.0, abs=1e-3)
    for (name, lkey), _s in reg._series.items():
        assert tuple(sorted(dict(lkey))) == tuple(
            sorted(tschema.SPECS[name].labels))


@pytest.mark.parametrize("strategy", ["ordered", "concurrent"])
def test_mesh_engine_emits_its_series(fresh, strategy):
    """The mesh engine's spans and series: S1's dispatch histogram and
    exchange rounds (one a segment), S2's block, dispatch and retirement
    series and compile spans."""
    from repro_torch.distributed import mesh_engine
    from repro_torch.launch.mesh import make_campaign_mesh
    reg, tracer = fresh
    eng = mesh_engine.MeshCampaignEngine(
        n=4, lam_start=8, kmax_exp=1, max_evals=600, strategy=strategy,
        overlap=False, mesh=make_campaign_mesh(2, device="cpu"))
    res = mesh_engine.run_campaign_mesh(eng, fids=(1,), runs=2)
    names = {s.name for s in tracer.finished()}
    rounds = reg.counter("mesh_exchange_rounds_total",
                         strategy=strategy).value
    assert rounds == len(res.exchange) > 0
    if strategy == "ordered":
        assert reg.histogram("mesh_island_dispatch_s", strategy="ordered",
                             island="all").count == len(res.segments)
        assert {"dispatch", "segment", "pull"} <= names
    else:
        blocks = sum(h.count for h in
                     series(reg, "mesh_island_block_s").values())
        assert blocks == res.pulls
        disp = sum(h.count for h in
                   series(reg, "mesh_island_dispatch_s").values())
        assert disp == len(res.segments)
        assert sum(s.value for s in series(
            reg, "mesh_retirements_total").values()) == 2
        assert {"block", "dispatch", "compile"} <= names
    assert np.all(res.total_fevals > 0)
