"""The port's parallel strategies against repro's, piece by piece, on the CPU.

* ``heap_descent_of``, ``local_ranks`` (random, tied and subnormal inputs),
  the virtual-device reductions and ``stack_params``;
* ``sample_population`` on grouped states and the strategies' updates
  (moments soup, fused, from a reduced gram) from a JAX-made state;
* one ``device_step`` of K-Distributed (both ``comm`` values, both eager
  tiers, ``gram_dtype``) and of K-Replicated from a JAX carry converted by
  ``convert.kdist_carry`` / ``convert.krep_carry``, to 1e-11;
* ``scan_eigen_blocks``: the ladder's traces are the step-by-step loop's,
  bit for bit, and the ``xs`` form hands each generation its own slice;
* the device rule and the ladder's refusal of the eager tiers.

Whole runs are in tests/test_torch_strategies_runs.py.  The JAX side's
``eigen_decompose`` carries the port's sign convention
(``test_torch_ladder._signed_eigen``).  float64 throughout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ladder import _signed_eigen

from repro.core import cmaes as jcmaes
from repro.core import eval_dispatch as jed
from repro.core import params as jparams
from repro.core import strategies as jst
from repro.fitness import bbob as jb
from repro_torch import convert
from repro_torch.core import cmaes as tcmaes
from repro_torch.core import eval_dispatch as ted
from repro_torch.core import ladder as tladder
from repro_torch.core import params as tparams
from repro_torch.core import strategies as tst
from repro_torch.fitness import bbob as tb
from torch_threads import one_thread  # noqa: F401

TOL = 1e-11
JAX_IMPL = {"eager": "xla", "eager_unfused": "xla_unfused"}


@pytest.fixture(autouse=True)
def signed_jax_eigen(monkeypatch):
    monkeypatch.setattr(jcmaes, "eigen_decompose", _signed_eigen)


def _fitness(fid, n):
    ji = jb.make_instance(fid, n, 1)
    ti = tb.make_instance(fid, n, 1, device="cpu")
    return (lambda X: jb.evaluate(fid, ji, X),
            lambda X: tb.evaluate(fid, ti, X), ji)


def _close(got, want, name, tol=TOL):
    """A NamedTuple of tensors against one of JAX arrays: ints exactly,
    floats to ``tol`` relative to each leaf's largest entry."""
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).cpu().numpy()
        assert a.shape == b.shape, (name, f)
        if a.dtype.kind == "f":
            scale = max(np.abs(a[np.isfinite(a)]).max(initial=0.0), 1.0)
            np.testing.assert_array_equal(np.isfinite(b), np.isfinite(a),
                                          err_msg=f"{name}.{f}")
            fin = np.isfinite(a)
            np.testing.assert_allclose(b[fin], a[fin], rtol=0,
                                       atol=tol * scale,
                                       err_msg=f"{name}.{f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{name}.{f}")


# ---------------------------------------------------------------------------
# helpers of the virtual-device axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_active", [1, 7, 511, 4095])
def test_heap_descent_of_matches_jax(n_active):
    idx = np.arange(4096)
    want = np.asarray(jst.heap_descent_of(jnp.asarray(idx, jnp.int32),
                                          n_active))
    got = tst.heap_descent_of(torch.tensor(idx), n_active)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("P", [1, 3, 7, 8, 512])
def test_kdist_groups_are_the_heap_ranges(P):
    """Descent k owns devices [2ᵏ−1, 2ᵏ⁺¹−1); the devices past n_active go to
    the last descent, so every descent's devices are one row range."""
    kd = tst.KDistributed(n=3, n_devices=P, lam_start=4, lam_slots=4,
                          device="cpu")
    D = kd.n_descents
    assert kd.groups.starts == tuple(2 ** k - 1 for k in range(D)) + (P,)
    np.testing.assert_array_equal(
        kd.groups.index.numpy(),
        np.asarray(jst.heap_descent_of(jnp.arange(P), kd.n_active)))
    assert (kd.kd_rows[kd.n_active:] == D).all()


def _local_ranks_both(f):
    """JAX's per-device local_ranks and the port's batched one on the
    fitness (P, λ) of one descent."""
    P, lam = f.shape
    flat = f.reshape(-1)
    want = np.stack([np.asarray(jed.local_ranks(
        jnp.asarray(f[p]), jnp.asarray(flat), p * lam)) for p in range(P)])
    got = ted.local_ranks(torch.tensor(f), torch.tensor(flat)[None, :],
                          torch.arange(P) * lam)
    return got.numpy(), want


@pytest.mark.parametrize("kind", ["random", "ties", "masked"])
def test_local_ranks_match_jax(kind):
    rng = np.random.default_rng({"random": 0, "ties": 1, "masked": 2}[kind])
    f = rng.normal(size=(5, 6))
    if kind == "ties":
        f = rng.integers(0, 4, size=(5, 6)).astype(np.float64)
    if kind == "masked":
        f[rng.uniform(size=f.shape) < 0.3] = np.inf
        f[0, 0] = np.nan
    got, want = _local_ranks_both(f)
    np.testing.assert_array_equal(got, want)


def test_local_ranks_subnormal_ties_match_a_stable_argsort():
    """On subnormal inputs JAX's CPU ranks flush them to 0 (ROADMAP C,
    "Subnormal ties"); the port's ranks are a stable argsort's, as numpy
    computes it."""
    f = np.array([[1.1125e-308, 0.0, 5e-324], [0.0, 2.2e-308, 1.1125e-308]])
    got = ted.local_ranks(torch.tensor(f), torch.tensor(f.reshape(-1))[None],
                          torch.arange(2) * 3)
    order = np.argsort(f.reshape(-1), kind="stable")
    want = np.argsort(order, kind="stable").reshape(f.shape)
    np.testing.assert_array_equal(got.numpy(), want)


def test_psum_and_all_gather_on_the_device_axis():
    x = torch.arange(24, dtype=torch.float64).reshape(6, 4)
    regular = ted.Groups((0, 2, 4, 6), torch.tensor([0, 0, 1, 1, 2, 2]))
    ragged = ted.groups(torch.tensor([0, 1, 1, 2, 2, 2]))
    assert ragged.starts == (0, 1, 3, 6)
    for grp in (regular, ragged):
        want = torch.stack([x[a:b].sum(0)
                            for a, b in zip(grp.starts, grp.starts[1:])])
        assert torch.equal(ted.psum(x, grp), want)
    y = x.reshape(2, 3, 4)
    assert torch.equal(ted.all_gather_flat(y, 2), x)
    assert ted.axis_size(y, 2) == 6
    assert torch.equal(ted.flat_index(6), torch.arange(6))
    f = torch.tensor([1.0, 2.0])
    assert torch.equal(ted.masked_fitness(f, torch.tensor([True, False])),
                       torch.tensor([1.0, torch.inf]))
    with pytest.raises(ValueError):
        ted.groups(torch.tensor([0, 1, 0]))


def test_stack_params_matches_jax():
    cfg_j = jparams.CMAConfig(n=5, lam=48, lam_max=48)
    cfg_t = tparams.CMAConfig(n=5, lam=48, lam_max=48)
    want = jparams.stack_params([jparams.make_params(cfg_j, lam=12 * 2 ** k)
                                 for k in range(3)])
    got = tparams.stack_params([tparams.make_params(cfg_t, lam=12 * 2 ** k)
                                for k in range(3)])
    _close(got, want, "stack_params", tol=0.0)
    one = tparams.broadcast_params(tparams.make_params(cfg_t), 4)
    assert one.weights.shape == (4, 48) and one.lam.shape == (4,)


# ---------------------------------------------------------------------------
# sampling and the updates, from a JAX-made descent-stacked state
# ---------------------------------------------------------------------------

N, P, LAM = 4, 7, 12


@pytest.fixture(scope="module")
def jax_kdist_carry():
    """A K-Distributed carry after 12 generations of JAX's run_sim
    (n = 4, 7 devices, 3 descents), made with the port's eigen signs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcmaes, "eigen_decompose", _signed_eigen)
    jf, _, _ = _fitness(8, N)
    kd = jst.KDistributed(n=N, n_devices=P)
    carry, _ = kd.run_sim(jax.random.PRNGKey(1), jf, 12, chunk=12)
    mp.undo()
    return kd, carry


def test_sample_population_groups_match_jax_per_device(jax_kdist_carry):
    """Each device's rows sample with its descent's state, as JAX's
    per-device ``sample_population`` on the selected state."""
    kd, carry = jax_kdist_carry
    keys = jax.random.split(jax.random.PRNGKey(9), P)
    kdix = np.asarray(jst.heap_descent_of(jnp.arange(P), kd.n_active))
    want = [jcmaes.sample_population(
        jax.tree_util.tree_map(lambda a: a[kdix[p]], carry.states), keys[p],
        LAM) for p in range(P)]
    tkd = tst.KDistributed(n=N, n_devices=P, device="cpu")
    states = convert.cma_state(carry.states, "cpu")
    for impl in ("eager", "auto"):
        y, x = tcmaes.sample_population(
            states, torch.tensor(np.asarray(keys, np.int64)), LAM, impl=impl,
            groups=tkd.groups)
        for p in range(P):
            np.testing.assert_allclose(y[p].numpy(), np.asarray(want[p][0]),
                                       rtol=1e-12, atol=1e-13)
            np.testing.assert_allclose(x[p].numpy(), np.asarray(want[p][1]),
                                       rtol=1e-12, atol=1e-13)


def _population(states, lam, seed):
    rng = np.random.default_rng(seed)
    S, n = np.asarray(states.m).shape
    y = rng.normal(size=(S, lam, n))
    x = np.asarray(states.m)[:, None] + np.asarray(states.sigma)[:, None,
                                                                 None] * y
    f = rng.normal(size=(S, lam))
    f[:, -2:] = np.inf                               # masked rows
    return y, x, f


@pytest.mark.parametrize("eigen", ["always", "defer"])
def test_updates_match_jax(jax_kdist_carry, eigen):
    """The moments soup, the fused update and the update from a reduced
    gram, slot-batched, against JAX's per-descent functions vmapped; one
    descent already stopped keeps its state."""
    kd, carry = jax_kdist_carry
    states_j = carry.states._replace(stop=carry.states.stop.at[1].set(True))
    states_t = convert.cma_state(states_j, "cpu")
    sp_j, cfg_j = kd.sparams, kd.cfg
    tkd = tst.KDistributed(n=N, n_devices=P, device="cpu")
    sp_t, cfg_t = tkd.sparams, tkd.cfg
    y, x, f = _population(states_j, kd.lam_max, seed=2)
    jy, jx, jf = (jnp.asarray(a) for a in (y, x, f))
    ty, tx, tf = (torch.tensor(a) for a in (y, x, f))

    mom_j = jax.vmap(lambda p, yy, ff, xx: jcmaes.compute_moments(
        yy, ff, xx, p, kd.lam_max))(sp_j, jy, jf, jx)
    mom_t = tcmaes.compute_moments(ty, tf, tx, sp_t, kd.lam_max)
    _close(mom_t, mom_j, "moments", tol=1e-12)

    want = jax.vmap(lambda p, s, m: jcmaes.masked_update(
        cfg_j, p, s, m, eigen=eigen))(sp_j, states_j, mom_j)
    for impl in ("eager_unfused", "eager"):
        got = tcmaes.masked_update(cfg_t, sp_t, states_t, mom_t, impl=impl,
                                   eigen=eigen)
        _close(got, want, f"masked_update[{impl}]")
    assert torch.equal(got.C[1], states_t.C[1])       # the stopped descent

    want = jax.vmap(lambda p, s, yy, ff, xx: jcmaes.masked_update_fused(
        cfg_j, p, s, yy, ff, xx, impl="xla", eigen=eigen))(
            sp_j, states_j, jy, jf, jx)
    got = tcmaes.masked_update_fused(cfg_t, sp_t, states_t, ty, tf, tx,
                                     eigen=eigen)
    _close(got, want, "masked_update_fused")

    want = jax.vmap(lambda p, s, m: jcmaes.masked_update_from_gram(
        cfg_j, p, s, m.gram, m.y_w, m.f_sorted, m.x_best, m.n_evals,
        eigen=eigen))(sp_j, states_j, mom_j)
    got = tcmaes.masked_update_from_gram(
        cfg_t, sp_t, states_t, mom_t.gram, mom_t.y_w, mom_t.f_sorted,
        mom_t.x_best, mom_t.n_evals, eigen=eigen)
    _close(got, want, "masked_update_from_gram")
    live = got.C[[0, 2]]                  # C′ mirrored from its upper half
    assert torch.equal(live, live.transpose(-1, -2))


# ---------------------------------------------------------------------------
# one device_step from a converted JAX carry
# ---------------------------------------------------------------------------

def _jax_kdist_step(kd, carry, key, fn):
    out = jax.vmap(lambda c, k: kd.device_step(c, k, fn, ("ev",)),
                   in_axes=(None, None), axis_name="ev",
                   axis_size=kd.n_devices)(carry, key)
    return jax.tree_util.tree_map(lambda a: a[0], out)


@pytest.mark.parametrize("comm,impl,gram_dtype", [
    ("stacked", "eager", ""), ("stacked", "eager_unfused", ""),
    ("central", "eager", ""), ("central", "eager_unfused", ""),
    ("stacked", "auto", "float32")])
def test_kdist_device_step_from_jax_carry(jax_kdist_carry, comm, impl,
                                          gram_dtype):
    """A generation from the same state and key: the new carry and the
    trace to 1e-11 (1e-6 with the gram rounded through float32, which JAX
    rounds per device and the port once per descent), with a dropped
    evaluation and a forced stop (so a descent restarts)."""
    kd0, carry = jax_kdist_carry
    carry = carry._replace(states=carry.states._replace(
        gen=carry.states.gen.at[2].set(10 ** 6)))       # MaxIter fires
    jf, tf, _ = _fitness(8, N)
    jimpl = JAX_IMPL.get(impl, "xla")
    kd = jst.KDistributed(n=N, n_devices=P, comm=comm, impl=jimpl,
                          gram_dtype=gram_dtype, drop_prob=0.2)
    tkd = tst.KDistributed(n=N, n_devices=P, comm=comm, impl=impl,
                           gram_dtype=gram_dtype, drop_prob=0.2,
                           device="cpu")
    key = jax.random.PRNGKey(4)
    jc, jt = _jax_kdist_step(kd, carry, key, jf)
    tc, tt = tkd.device_step(convert.kdist_carry(carry, "cpu"),
                             torch.tensor(np.asarray(key, np.int64)), tf)
    tol = 1e-6 if gram_dtype else TOL
    _close(tc.states, jc.states, "states", tol)
    _close(tc._replace(states=tc.states.m), jc._replace(states=jc.states.m),
           "carry", tol)
    _close(tt, jt, "trace", tol)
    assert bool(tt.stopped[2]) and int(tc.restarts[2]) == 1


def _jax_krep_steps(kr, cfg, params, carry, keys, fn):
    """JAX's K-Replicated chunk on a (G, ...) carry, through the nested
    vmap of its run_sim; returns the carry in the same form."""
    G = carry.state.m.shape[0]
    g = kr.n_devices // G
    st = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (g,) + a.shape), carry.state)
    rep = lambda a: jnp.broadcast_to(a[None, None], (g, G) + a.shape)  # noqa: E731
    cb = jst.KRepCarry(state=st, best_f=rep(carry.best_f),
                       best_x=rep(carry.best_x), fevals=rep(carry.fevals))
    inner = jax.vmap(kr.phase_chunk_fn(cfg, params, fn, len(keys)),
                     in_axes=0, out_axes=0, axis_name="grp")
    outer = jax.vmap(inner, in_axes=0, out_axes=0, axis_name="mem")
    cb, tr = outer(cb, jnp.broadcast_to(keys[None, None], (g, G) + keys.shape))
    c = jst.KRepCarry(state=jax.tree_util.tree_map(lambda a: a[0], cb.state),
                      best_f=cb.best_f[0, 0], best_x=cb.best_x[0, 0],
                      fevals=cb.fevals[0, 0])
    return c, jax.tree_util.tree_map(lambda a: a[0, 0], tr)


@pytest.mark.parametrize("impl", ["eager", "eager_unfused"])
def test_krep_device_step_from_jax_carry(impl):
    """Phase 1 of 4 devices (2 groups of 2): 6 JAX generations, then one
    more generation in each package from the converted carry."""
    jf, tf, _ = _fitness(2, N)
    kr = jst.KReplicated(n=N, n_devices=4, impl=JAX_IMPL[impl],
                         drop_prob=0.2)
    tkr = tst.KReplicated(n=N, n_devices=4, impl=impl, drop_prob=0.2,
                          device="cpu")
    cfg, params, G, g = kr.phase_cfg(1)
    tcfg, tparams_, tG, tg = tkr.phase_cfg(1)
    assert (G, g) == (tG, tg) == (2, 2)
    _close(tparams_, params, "phase params", tol=0.0)
    carry = jst.KRepCarry(
        state=kr.init_phase_states(cfg, G, jax.random.PRNGKey(2)),
        best_f=jnp.asarray(jnp.inf), best_x=jnp.zeros(N),
        fevals=jnp.asarray(0, jnp.int64))
    carry, _ = _jax_krep_steps(kr, cfg, params, carry,
                               jax.random.split(jax.random.PRNGKey(3), 6), jf)
    key = jax.random.PRNGKey(8)
    jc, jt = _jax_krep_steps(kr, cfg, params, carry, key[None], jf)
    tc, tt = tkr.device_step(tcfg, tparams_, convert.krep_carry(carry, "cpu"),
                             torch.tensor(np.asarray(key, np.int64)), tf)
    _close(tc.state, jc.state, "state")
    _close(tc._replace(state=tc.state.m), jc._replace(state=jc.state.m),
           "carry")
    _close(tt, jax.tree_util.tree_map(lambda a: a[0], jt), "trace")


# ---------------------------------------------------------------------------
# scan_eigen_blocks, the device rule, refusals
# ---------------------------------------------------------------------------

def test_scan_eigen_blocks_keeps_the_ladder_traces():
    """The ladder at n = 4 through ``scan_eigen_blocks`` is the loop of its
    generations with the defer/always cadence, bit for bit; the ``xs``
    form hands generation t the slice xs[t] and stacks the step's own
    trace type."""
    fn, _ = tb.make_fitness(8, 4, 1, device="cpu")
    eng = tladder.LadderEngine(n=4, lam_start=8, kmax_exp=2,
                               eigen_interval=3, max_evals=10 ** 6,
                               device="cpu")
    key = eng.base_key(5)
    carry, trace = eng.run_scan(key, fn, 9)
    c = eng.init_carry(key)
    steps = []
    for t in range(9):
        c, tr = eng.gen_step(c, key, fn, "always" if t % 3 == 2 else "defer")
        steps.append(tr)
    assert type(trace) is tladder.LadderTrace
    for f in trace._fields:
        assert torch.equal(getattr(trace, f),
                           torch.stack([getattr(s, f) for s in steps])), f
    for a, b in zip(carry.states, c.states):
        assert torch.equal(a, b)

    seen = []

    def step(cc, x, eigen):
        seen.append((int(x), eigen))
        return cc + x, tst.KRepTrace(cc, cc, cc, cc)
    total, tr = tladder.scan_eigen_blocks(step, torch.tensor(0),
                                          2, 3, xs=torch.arange(6))
    assert seen == [(0, "defer"), (1, "always"), (2, "defer"),
                    (3, "always"), (4, "defer"), (5, "always")]
    assert int(total) == 15 and type(tr) is tst.KRepTrace
    assert tr.best_f.tolist() == [0, 0, 1, 3, 6, 10]


def test_strategies_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, _ = tb.make_fitness(1, 3, 1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tst.KDistributed(n=3, n_devices=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        tst.KReplicated(n=3, n_devices=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tladder.run_concurrent(3, 3, 0, fn, 2)


def test_refusals():
    with pytest.raises(ValueError):
        tladder.LadderEngine(n=3, impl="xla", device="cpu")
    with pytest.raises(ValueError):
        tst.KDistributed(n=3, n_devices=3, comm="ring", device="cpu")
    with pytest.raises(ValueError):
        tst.KDistributed(n=3, n_devices=3, impl="xla", device="cpu")
    with pytest.raises(ValueError):
        tst.KDistributed(n=3, n_devices=2, kmax_exp=1, device="cpu")
    with pytest.raises(ValueError):
        tst.KReplicated(n=3, n_devices=6, device="cpu")
