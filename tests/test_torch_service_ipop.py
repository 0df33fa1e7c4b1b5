"""``run_ipop(backend="service")`` and the launcher of the port's campaign
service, and the signatures the port shares with the JAX package.

* ``backend="service"`` gives ``backend="bucketed"``'s run bit for bit
  (f1, f2, f8; both sampling tiers), and JAX's ``service`` backend's on
  f1/f2: the ints exactly, the bests to 1e-10; ``total_gens`` raises;
* ``fleet``: a ``FleetConfig`` on the segment-driven backends gives
  ``fleet=None``'s result, and raises ``ValueError`` on the others, as in
  JAX;
* ``drive_segments``, ``run_bucketed_single``, ``run_campaign_bucketed``
  and ``run_service_single`` take the parameters they share with JAX's in
  JAX's order with JAX's defaults, and return JAX's shapes;
* ``python -m repro_torch.launch.serve_campaigns --device cpu`` serves,
  writes schema-valid metrics and a valid Chrome trace, resumes from its
  snapshots, and serves a stream under ``--fleet --chaos-kills``.
"""
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucketed as jbucketed
from repro.core import cmaes as jcmaes
from repro.core import ipop as jipop
from repro.fitness import bbob as jb
from repro.obs import trace as jtrace
from repro.service import server as jserver
from repro_torch.core import bucketed as tbucketed
from repro_torch.core import ipop as tipop
from repro_torch.fitness import bbob as tb
from repro_torch.fleet import FleetConfig
from repro_torch.fleet.controller import IslandSupervisor
from repro_torch.obs import schema as tschema
from repro_torch.obs import trace as ttrace
from repro_torch.service import server as tserver

ROOT = Path(__file__).resolve().parents[1]
KW = dict(lam_start=8, kmax_exp=2)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same(got, want, rtol=0.0):
    assert got.total_fevals == want.total_fevals
    assert [(d.k_exp, d.lam, d.stop_reason) for d in got.descents] == \
        [(d.k_exp, d.lam, d.stop_reason) for d in want.descents]
    for a, b in zip(got.descents, want.descents):
        np.testing.assert_array_equal(a.gens, b.gens)
        np.testing.assert_array_equal(a.fevals, b.fevals)
        np.testing.assert_allclose(a.best_f, b.best_f, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got.best_f, want.best_f, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("fid,impl", [(1, "auto"), (2, "kernel_rng"),
                                      (8, "auto")])
def test_service_backend_is_the_bucketed_run(fid, impl):
    fn, inst = tb.make_fitness(fid, 4, 1, device="cpu")
    fit = tb.fusable_fitness(inst, (fid,), fn) if fid in (1, 2) else fn
    kw = dict(max_evals=3000, impl=impl, device="cpu", **KW)
    r_b = tipop.run_ipop(fit, 4, 7, backend="bucketed", **kw)
    r_s = tipop.run_ipop(fit, 4, 7, backend="service", **kw)
    _same(r_s, r_b)
    assert len(r_s.descents) >= 2


def _signed_eigen(C):
    evals, evecs = jnp.linalg.eigh(C)
    pivot = jnp.argmax(jnp.abs(evecs), axis=-2, keepdims=True)
    sign = jnp.where(jnp.take_along_axis(evecs, pivot, axis=-2) < 0,
                     -1.0, 1.0)
    return evecs * sign, jnp.sqrt(jnp.maximum(evals, 1e-300))


@pytest.mark.parametrize("fid", [1, 2])
def test_service_backend_matches_jax(fid, monkeypatch):
    """Against JAX's ``run_ipop(backend="service")`` on the same key (JAX's
    ``eigen_decompose`` in the port's sign convention)."""
    monkeypatch.setattr(jcmaes, "eigen_decompose", _signed_eigen)
    jserver.clear_program_cache()
    ji = jb.make_instance(fid, 4, 1)
    kw = dict(max_evals=2000, **KW)
    try:
        want = jipop.run_ipop(lambda X: jb.evaluate(fid, ji, X), 4,
                              jax.random.PRNGKey(11), backend="service", **kw)
    finally:
        jserver.clear_program_cache()
    fn, _ = tb.make_fitness(fid, 4, 1, device="cpu")
    got = tipop.run_ipop(fn, 4, 11, backend="service", device="cpu", **kw)
    _same(got, want, rtol=1e-10)


@pytest.mark.parametrize("backend", ["ladder", "bucketed", "hostloop",
                                     "mesh", "service"])
def test_fleet(backend):
    """``fleet=None`` runs every backend; ``fleet=FleetConfig()`` gives
    the same result on the segment-driven ones and raises ``ValueError``
    on the ladder and the host loop, as in JAX."""
    fn, _ = tb.make_fitness(1, 3, 1, device="cpu")
    kw = dict(lam_start=8, kmax_exp=1, max_evals=200, device="cpu")
    res = tipop.run_ipop(fn, 3, 0, backend=backend, fleet=None, **kw)
    assert res.total_fevals > 0
    if backend in ("bucketed", "mesh", "service"):
        got = tipop.run_ipop(fn, 3, 0, backend=backend, fleet=FleetConfig(),
                             **kw)
        _same(got, res)
    else:
        with pytest.raises(ValueError, match="fleet"):
            tipop.run_ipop(fn, 3, 0, backend=backend, fleet=FleetConfig(),
                           **kw)


def test_service_backend_rejects_total_gens():
    fn, _ = tb.make_fitness(1, 3, 1, device="cpu")
    with pytest.raises(ValueError, match="total_gens"):
        tipop.run_ipop(fn, 3, 0, backend="service", total_gens=10,
                       device="cpu")


@pytest.mark.parametrize("jfn,tfn,extra", [
    (jbucketed.drive_segments, tbucketed.drive_segments, ["log"]),
    (jbucketed.run_bucketed_single, tbucketed.run_bucketed_single, ["log"]),
    (jbucketed.run_campaign_bucketed, tbucketed.run_campaign_bucketed, []),
    (jserver.run_service_single, tserver.run_service_single, ["device"]),
])
def test_signature_matches_jax(jfn, tfn, extra):
    """JAX's parameters in JAX's order and with JAX's defaults; the port
    adds only keyword-only ones."""
    jp = inspect.signature(jfn).parameters
    tp = inspect.signature(tfn).parameters
    assert list(tp)[:len(jp)] == list(jp)
    for p in jp:
        assert tp[p].default == jp[p].default, p
    assert list(tp)[len(jp):] == extra
    assert all(tp[p].kind is inspect.Parameter.KEYWORD_ONLY for p in extra)


def test_return_shapes_match_jax():
    """``drive_segments`` returns (carry, trace, segments, bucket_wall) and
    ``run_bucketed_single`` (carry, trace); ``log`` opts into the pulls."""
    fn, _ = tb.make_fitness(1, 3, 1, device="cpu")
    eng = tbucketed.BucketedLadderEngine(n=3, max_evals=400, device="cpu",
                                         **KW)
    log = {}
    out = tbucketed.run_bucketed_single(eng, 0, fn, log=log)
    assert len(out) == 2 and out[1].ran.shape[1] == 1
    assert log["pulls"] == len(log["segments"]) + 1
    carry = eng.init_carry(eng.full.base_key(0))

    def dispatch(k, g, c):
        return eng.segment_scan(k, eng.full.base_key(0), fn, c, g)
    out = tbucketed.drive_segments(eng, carry, dispatch, 10_000, 0)
    assert len(out) == 4
    _c, trace, segments, walls = out
    assert sum(s["gens"] for s in segments) == trace.ran.shape[0]
    assert set(walls) == {s["bucket"] for s in segments}
    # a supervisor (ported) changes neither the returns nor the run
    sup = IslandSupervisor(FleetConfig(snapshot_every=1))
    out_s = tbucketed.drive_segments(eng, carry, dispatch, 10_000, 0,
                                     supervisor=sup)
    assert len(out_s) == 4
    assert [(s["bucket"], s["gens"]) for s in out_s[2]] == \
        [(s["bucket"], s["gens"]) for s in segments]
    assert all(torch.equal(a, b) for a, b in zip(out_s[1], trace))
    assert len(sup.snapshot_s) == len(segments) + 1


def _cli(*args, cwd):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1", "HOME": str(cwd)}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_campaigns",
         "--device", "cpu", "--dims", "4", "--budget", "800", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_cli_serves_and_writes_valid_files(tmp_path):
    out = _cli("--synthetic", "4", "--out", "res.json", "--metrics-out",
               "m.jsonl", "--trace-out", "tr.json", cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    res = json.loads((tmp_path / "res.json").read_text())
    assert res["jobs"] == res["done"] == 4
    assert res["statuses"] == {"done": 4}
    assert res["useful_evals"] == sum(r["fevals"] for r in res["results"])
    lines = [json.loads(ln) for ln in
             (tmp_path / "m.jsonl").read_text().splitlines()]
    assert len(lines) == res["stats"]["boundaries"]
    for ln in lines:
        for m in ln["metrics"]:
            spec = tschema.SPECS[m["name"]]
            assert m["type"] == spec.kind
            assert sorted(m["labels"]) == sorted(spec.labels)
    doc = json.loads((tmp_path / "tr.json").read_text())
    assert jtrace.validate_chrome(doc) == []
    assert ttrace.validate_chrome(doc) == []
    spans = ttrace.load_jsonl(str(tmp_path / "tr.jsonl"))
    assert sum(1 for s in spans if s["name"] == "job") == 4


def test_cli_resumes_from_its_snapshot(tmp_path):
    out = _cli("--synthetic", "3", "--snapshot-dir", "ck",
               "--snapshot-every", "2", "--out", "a.json", cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    a = json.loads((tmp_path / "a.json").read_text())
    steps = sorted(os.listdir(tmp_path / "ck"))
    assert steps and all(s.startswith("step_") for s in steps)
    out = _cli("--resume", "--snapshot-dir", "ck", "--out", "b.json",
               cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    b = json.loads((tmp_path / "b.json").read_text())
    assert b["jobs"] == a["jobs"] == 3
    assert {r["job_id"]: r["fevals"] for r in b["results"]} == \
        {r["job_id"]: r["fevals"] for r in a["results"]}


def test_cli_refuses_fleet(tmp_path):
    """``--fleet --chaos-kills`` (ported: no longer refused) serves a
    synthetic stream to its end with a snapshot directory: island 1 dies
    at boundary 2 for two boundaries, its rows move to island 0, and every
    job ends done with the fault-free run's evaluations."""
    args = ("--synthetic", "3", "--devices", "2", "--rows-per-island", "2",
            "--snapshot-dir", "ck", "--snapshot-every", "1")
    out = _cli(*args, "--out", "plain.json", cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    out = _cli(*args, "--fleet", "--chaos-kills", "1:2:2", "--out",
               "fleet.json", "--postmortem-dir", "pm", cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "fleet supervision on" in out.stdout
    plain, fleet = (json.loads((tmp_path / f).read_text())
                    for f in ("plain.json", "fleet.json"))
    assert fleet["statuses"] == {"done": 3}
    assert {r["job_id"]: r["fevals"] for r in fleet["results"]} == \
        {r["job_id"]: r["fevals"] for r in plain["results"]}
    assert os.listdir(tmp_path / "pm")          # the island's post-mortem
