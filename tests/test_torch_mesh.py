"""The port's mesh campaign engine (repro_torch/distributed/mesh_engine.py)
on 8 islands against repro's on 8 devices, on the CPU at n = 4,
λ_start = 8, kmax_exp = 2, 5 000 evaluations a member, fids (1, 2) × 4
runs, the JAX side's ``eigen_decompose`` in the port's sign convention.

* JAX's S1 and S2 on eight virtual devices run in one subprocess (under
  ``--xla_force_host_platform_device_count=8``) while the port's run: the
  evaluations, the bests to 1e-12, S2's per-island segments, the exchange
  records, the padded and useful evaluations must agree;
* both strategies give the port's bucketed driver's campaign; S2's
  ``stop_at`` retires every island; S1's speculative dispatch is
  bit-identical to ``overlap=False``.

The helpers here serve ``tests/test_torch_mesh_one.py`` (one island
against JAX's one-device mesh, padding, the runner cache, S1's split by
device, the mesh layout and the member split) and ``tests/test_torch_mesh_ipop.py`` (ECDF and
``run_ipop(backend="mesh")``).
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import hermetic_subproc_env

from repro_torch.core import bucketed as tbucketed
from repro_torch.distributed import mesh_engine as tmesh
from repro_torch.launch.mesh import make_campaign_mesh
from torch_threads import one_thread  # noqa: F401

KW = dict(n=4, lam_start=8, kmax_exp=2, max_evals=5000)
FIDS = (1, 2)
STRATEGIES = ("ordered", "concurrent")
INTS = ("ran", "k_idx", "gen", "fevals", "stop_reason", "stopped",
        "total_fevals")
FLOATS = ("best_f", "global_best")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The n = 4 ops are too small to split: torch's intra-op threads only
    add barriers (three times the wall of one thread here, and far more on
    a loaded host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signed_eigen(C):
    """repro's eigen_decompose with the port's column-sign convention."""
    evals, evecs = jnp.linalg.eigh(C)
    pivot = jnp.argmax(jnp.abs(evecs), axis=-2, keepdims=True)
    sign = jnp.where(jnp.take_along_axis(evecs, pivot, axis=-2) < 0,
                     -1.0, 1.0)
    return evecs * sign, jnp.sqrt(jnp.maximum(evals, 1e-300))


def _port(strategy, islands, kw=KW, fids=FIDS, runs=4, seed=0, **extra):
    eng = tmesh.MeshCampaignEngine(
        **kw, strategy=strategy,
        mesh=make_campaign_mesh(islands, device="cpu"), **extra)
    return tmesh.run_campaign_mesh(eng, fids, runs=runs, seed=seed)


def _close(got, want, rtol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0)


def _same_records(got, want):
    """Exchange records: every key JAX writes, floats to 1e-12."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key, val in w.items():
            if isinstance(val, float):
                _close(g[key], val)
            else:
                assert g[key] == val, key


def _same_campaign(rt, rj, traces=True):
    assert rt.members == [tuple(m) for m in rj.members]
    np.testing.assert_array_equal(rt.total_fevals, rj.total_fevals)
    _close(rt.best_f, rj.best_f)
    if traces:
        for f in INTS:
            np.testing.assert_array_equal(getattr(rt.trace, f),
                                          np.asarray(getattr(rj.trace, f)),
                                          err_msg=f)
        # the per-generation bests drift to 5.8e-12 on f2 (conditioning
        # 1e6): the port's bucketed driver against JAX's gives the same
        for f in FLOATS:
            _close(getattr(rt.trace, f), np.asarray(getattr(rj.trace, f)),
                   rtol=1e-11)


# ---------------------------------------------------------------------------
# JAX's eight virtual devices, in a subprocess
# ---------------------------------------------------------------------------

JAX_EIGHT = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.core import cmaes
from repro.distributed import mesh_engine

def signed(C):
    evals, evecs = jnp.linalg.eigh(C)
    pivot = jnp.argmax(jnp.abs(evecs), axis=-2, keepdims=True)
    sign = jnp.where(jnp.take_along_axis(evecs, pivot, axis=-2) < 0,
                     -1.0, 1.0)
    return evecs * sign, jnp.sqrt(jnp.maximum(evals, 1e-300))

cmaes.eigen_decompose = signed
assert jax.device_count() == 8
out = {}
for strategy in ("ordered", "concurrent"):
    eng = mesh_engine.MeshCampaignEngine(strategy=strategy, n=4, lam_start=8,
                                         kmax_exp=2, max_evals=5000)
    res = mesh_engine.run_campaign_mesh(eng, fids=(1, 2), runs=4, seed=0)
    out[strategy] = {
        "total_fevals": np.asarray(res.total_fevals).tolist(),
        "best_f": np.asarray(res.best_f).tolist(),
        "segments": [(s["bucket"], s["gens"]) for s in res.segments],
        "shard_segments": None if res.shard_segments is None else
        [[(s["bucket"], s["gens"]) for s in ss] for ss in res.shard_segments],
        "exchange": res.exchange, "padded_evals": res.padded_evals,
        "useful_evals": res.useful_evals}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_eight():
    """JAX's S1 and S2 on 8 virtual devices: started at the module's first
    test, read when a test needs it (its own timeout, 150 s)."""
    proc = subprocess.Popen([sys.executable, "-c", JAX_EIGHT],
                            env=hermetic_subproc_env(),
                            cwd=os.path.dirname(os.path.dirname(
                                os.path.abspath(__file__))),
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


@pytest.fixture(scope="module")
def port_eight():
    return {s: _port(s, 8) for s in STRATEGIES}


# ---------------------------------------------------------------------------
# (b) eight islands against JAX's eight virtual devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_eight_islands_match_jax_eight_devices(strategy, jax_eight,
                                               port_eight):
    want = jax_eight()[strategy]
    rt = port_eight[strategy]
    assert rt.n_devices == 8
    np.testing.assert_array_equal(rt.total_fevals, want["total_fevals"])
    _close(rt.best_f, want["best_f"])
    assert [[s["bucket"], s["gens"]] for s in rt.segments] == \
        want["segments"]
    _same_records(rt.exchange, want["exchange"])
    assert (rt.padded_evals, rt.useful_evals) == (want["padded_evals"],
                                                  want["useful_evals"])
    if strategy == "concurrent":
        assert [[[s["bucket"], s["gens"]] for s in ss]
                for ss in rt.shard_segments] == want["shard_segments"]
        assert all(rt.shard_segments)      # every island ran its slice
    else:
        assert rt.shard_segments is None
        assert len(rt.exchange) == len(rt.segments)
    # S2 pads less than S1: a finished island stops paying
    if strategy == "concurrent":
        assert rt.padded_evals < port_eight["ordered"].padded_evals


def test_eight_islands_match_bucketed(port_eight):
    """Both strategies give the bucketed driver's campaign: ints exactly,
    floats to 1e-12 (a member slice of another size may round a product
    otherwise)."""
    eng = tbucketed.BucketedLadderEngine(**KW, device="cpu")
    rb = tbucketed.run_campaign_bucketed(eng, FIDS, runs=4)
    for s in STRATEGIES:
        rt = port_eight[s]
        np.testing.assert_array_equal(rt.total_fevals, rb.total_fevals)
        _close(rt.best_f, rb.best_f)
        assert rt.useful_evals == rb.useful_evals
        for b in range(len(rb.members)):
            ran_b, ran_m = rb.trace.ran[b, :, 0], rt.trace.ran[b, :, 0]
            for f in ("k_idx", "gen", "fevals", "stop_reason"):
                np.testing.assert_array_equal(
                    getattr(rt.trace, f)[b, :, 0][ran_m],
                    getattr(rb.trace, f)[b, :, 0][ran_b], err_msg=f)
            _close(rt.trace.best_f[b, :, 0][ran_m],
                   rb.trace.best_f[b, :, 0][ran_b])
    assert port_eight["ordered"].segments[0]["bucket"] == rb.segments[0][
        "bucket"]



# ---------------------------------------------------------------------------
# (e) stop_at, (f) S1's speculation
# ---------------------------------------------------------------------------

def test_stop_at_retires_every_island(port_eight):
    rt = _port("concurrent", 8, stop_at=1e30)
    assert any(e.get("stopped_early") for e in rt.exchange)
    # one round of segments at most: the exchange stopped all after it
    assert len(rt.exchange) <= 2
    assert int(np.sum(rt.total_fevals)) < int(
        np.sum(port_eight["concurrent"].total_fevals))


def test_s1_overlap_is_bit_identical(port_eight):
    """S1's speculative dispatch (``overlap=True``, the default) drops a
    mispredicted segment unread: the run equals ``overlap=False`` bit for
    bit, with one exchange record per accepted segment in both."""
    ro = port_eight["ordered"]
    rp = _port("ordered", 8, overlap=False)
    np.testing.assert_array_equal(ro.best_f, rp.best_f)
    np.testing.assert_array_equal(ro.best_x, rp.best_x)
    for f in ro.trace._fields:
        np.testing.assert_array_equal(getattr(ro.trace, f),
                                      getattr(rp.trace, f), err_msg=f)
    assert len(ro.exchange) == len(ro.segments)
    assert len(rp.exchange) == len(rp.segments)
    assert [e["global_fevals"] for e in ro.exchange] == \
        [e["global_fevals"] for e in rp.exchange]
    assert any(s["spec_hit"] for s in ro.segments)
    assert not any("spec_hit" in s for s in rp.segments)
