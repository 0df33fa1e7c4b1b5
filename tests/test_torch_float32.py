"""float32 campaigns on the port against the JAX package's.

* ``bbob.make_instance(..., dtype=torch.float32)`` draws the JAX package's
  float32 instance (its normals are ``prng.normal``'s float32 form, 3 ulp
  from ``jax.random.normal``);
* one float32 generation from a loaded JAX state matches JAX's next state
  to float32 precision (``RTOL32``), ints exactly;
* ``run_ipop(dtype="float32")`` runs on both backends under ``auto`` and
  ``kernel_rng`` (JAX's ``pallas_rng``, its update routed to the ref), at
  n = 4 on f1 and f2.  Each run reaches f_opt to float32 precision within
  its budget over the same rungs.  On f1 its first descent follows JAX's
  best-so-far record to ``RTOL32`` until the record comes within ``FLOOR``
  of f_opt; on f2 for the first generation only: the ellipsoid's 10⁶
  conditioning turns the 3-ulp spread of the float32 normals into 3.5e-5 of
  f by generation 2, and a changed ranking then sends the two descents
  apart (the one-generation test above pins f2's state).  The descents'
  lengths and stop reasons are not held: once f sits on float32's floor
  around f_opt, the history-range stop (TolFunHist) fires on ulp-level
  noise, so a few ulp of difference in any op moves it (ROADMAP.md C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cmaes as jcmaes
from repro.core import ipop as jipop
from repro.core import ladder as jladder
from repro.core.params import select_params as jselect
from repro.fitness import bbob as jb
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import ipop as tipop
from repro_torch.core import ladder as tladder
from repro_torch.core.params import select_params as tselect
from repro_torch.fitness import bbob as tb

from test_torch_bucketed import JAX_IMPL, _signed_eigen
from torch_threads import one_thread  # noqa: F401

#: float32 agreement: 64 ulp of the value (accumulated rounding over a
#: generation's sums and the batched eigh)
RTOL32 = 64 * float(np.finfo(np.float32).eps)
#: the best-so-far records are compared while best − f_opt exceeds this
#: share of |f_opt| (about 500 ulp of f_opt in float32)
FLOOR = 1e-4
KW = dict(lam_start=8, kmax_exp=2, max_evals=2600)


@pytest.fixture
def jax_like_port(monkeypatch):
    monkeypatch.setattr(jcmaes, "eigen_decompose", _signed_eigen)
    monkeypatch.setattr(jops, "_kernel_tier", lambda impl: False)


def _fitness(fid, n):
    ji = jb.make_instance(fid, n, 1, dtype=jnp.float32)
    ti = tb.make_instance(fid, n, 1, dtype=torch.float32, device="cpu")
    jf = jb.fusable_fitness(ji, (fid,), lambda X: jb.evaluate(fid, ji, X))
    tf = tb.fusable_fitness(ti, (fid,), lambda X: tb.evaluate(fid, ti, X))
    return jf, tf, ji, ti


@pytest.mark.parametrize("fid", [1, 2, 8])
def test_float32_instance_matches_jax(fid):
    _, _, ji, ti = _fitness(fid, 6)
    for name in ti._fields:
        want, got = np.asarray(getattr(ji, name)), getattr(ti, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=RTOL32, atol=RTOL32,
                                   err_msg=name)
    X = np.random.default_rng(fid).uniform(-4, 4, (9, 6)).astype(np.float32)
    np.testing.assert_allclose(tb.evaluate(fid, ti, torch.tensor(X)).numpy(),
                               np.asarray(jb.evaluate(fid, ji, X)),
                               rtol=RTOL32)


@pytest.mark.parametrize("fid", [1, 2])
def test_one_float32_generation_from_reference_state(fid, jax_like_port):
    jf, tf, _, ti = _fitness(fid, 6)
    kw = dict(n=6, lam_start=6, kmax_exp=2, schedule="concurrent",
              max_evals=10 ** 6, dtype="float32")
    jeng = jladder.LadderEngine(**kw)
    key = jax.random.PRNGKey(5)
    carry = jeng.init_carry(key)
    for _ in range(3):
        carry, _ = jeng.gen_step(carry, key, jf, eigen="always")
    S = jeng.n_slots
    jp = jselect(jeng.sparams, carry.k_idx)
    kds = jax.vmap(lambda s, i: jladder.slot_key(key, s, i))(
        np.arange(S, dtype=np.int32), carry.incarnation)
    kgs = jax.vmap(jladder.gen_key)(kds, carry.states.gen)
    Z = jax.vmap(lambda st, kg: jcmaes.sample_z(st, kg, jeng.lam_max))(
        carry.states, kgs)
    want = jax.tree_util.tree_map(np.asarray, jladder._slots_fused_update(
        jeng.cfg, jp, carry.states, kgs, jf, "xla", "always"))

    teng = tladder.LadderEngine(**kw, device="cpu")
    tcarry = convert.ladder_carry(jax.tree_util.tree_map(np.asarray, carry),
                                  "cpu")
    assert tcarry.states.C.dtype == torch.float32
    tp = tselect(teng.sparams, tcarry.k_idx.long())
    got = convert.to_numpy(tladder.fused_generation(
        teng.cfg, tp, tcarry.states, torch.tensor(np.asarray(Z)), tf,
        "always"))
    for f in ("m", "sigma", "C", "p_sigma", "p_c", "best_f", "D"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype == np.float32, f
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=RTOL32, atol=RTOL32 * scale,
                                   err_msg=f)
    for f in ("fevals", "gen", "last_eigen_gen", "hist_count", "stop",
              "stop_reason"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("backend", ["ladder", "bucketed"])
@pytest.mark.parametrize("impl", ["auto", "kernel_rng"])
@pytest.mark.parametrize("fid", [1, 2])
def test_run_ipop_float32_follows_jax(fid, backend, impl, jax_like_port):
    jf, tf, ji, _ = _fitness(fid, 4)
    rj = jipop.run_ipop(jf, 4, jax.random.PRNGKey(7), backend=backend,
                        impl=JAX_IMPL[impl], dtype="float32", **KW)
    rt = tipop.run_ipop(tf, 4, 7, backend=backend, impl=impl,
                        dtype="float32", device="cpu", **KW)
    f_opt = float(ji.f_opt)
    for r in (rt, rj):
        assert KW["max_evals"] - KW["lam_start"] * 4 < r.total_fevals \
            <= KW["max_evals"]
        assert r.best_f - f_opt <= 8 * np.spacing(np.float32(f_opt))
        assert [d.lam for d in r.descents] == \
            [KW["lam_start"] << k for k in range(len(r.descents))]
    dt, dj = rt.descents[0], rj.descents[0]
    if fid == 1:
        upto = int(np.argmax(dj.best_f - f_opt < FLOOR * abs(f_opt)))
        assert upto >= 10                   # the records are compared
    else:
        upto = 1
    np.testing.assert_array_equal(dt.gens[:upto], dj.gens[:upto])
    np.testing.assert_array_equal(dt.fevals[:upto], dj.fevals[:upto])
    np.testing.assert_allclose(dt.best_f[:upto], dj.best_f[:upto],
                               rtol=RTOL32)
