"""Per-generation parity: load repro's ladder state after 3 generations into
the port (repro_torch/convert.py), run one generation on the same draw Z in
both packages, and compare the next state."""
import jax
import numpy as np
import pytest
import torch

from repro.core import cmaes as jcmaes
from repro.core import ladder as jladder
from repro.core.params import select_params as jselect
from repro.fitness import bbob as jb
from repro_torch import convert
from repro_torch.core import cmaes as tcmaes
from repro_torch.core import ladder as tladder
from repro_torch.core.params import select_params as tselect
from repro_torch.fitness import bbob as tb

N = 6


def _fitness(fid):
    ji = jb.make_instance(fid, N, 1)
    ti = convert.bbob_instance(ji, "cpu")
    jf = lambda X: jb.evaluate(fid, ji, X)            # noqa: E731
    tf = lambda X: tb.evaluate(fid, ti, X)            # noqa: E731
    if fid in jb.FUSABLE_FIDS:
        jf = jb.fusable_fitness(ji, (fid,), jf)
        tf = tb.fusable_fitness(ti, (fid,), tf)
    return jf, tf


@pytest.mark.parametrize("fid", [2, 8])
@pytest.mark.parametrize("eigen", ["defer", "always"])
def test_one_generation_from_reference_state(fid, eigen):
    jf, tf = _fitness(fid)
    kw = dict(n=N, lam_start=6, kmax_exp=2, schedule="concurrent",
              max_evals=10 ** 6)
    jeng = jladder.LadderEngine(**kw)
    key = jax.random.PRNGKey(5)
    carry = jeng.init_carry(key)
    for _ in range(3):                       # B and D refreshed each time
        carry, _ = jeng.gen_step(carry, key, jf, eigen="always")

    S = jeng.n_slots
    jp = jselect(jeng.sparams, carry.k_idx)
    kds = jax.vmap(lambda s, i: jladder.slot_key(key, s, i))(
        np.arange(S, dtype=np.int32), carry.incarnation)
    kgs = jax.vmap(jladder.gen_key)(kds, carry.states.gen)
    Z = jax.vmap(lambda st, kg: jcmaes.sample_z(st, kg, jeng.lam_max))(
        carry.states, kgs)
    want = jladder._slots_fused_update(jeng.cfg, jp, carry.states, kgs, jf,
                                       "xla", eigen)
    want = jax.tree_util.tree_map(np.asarray, want)

    teng = tladder.LadderEngine(**kw, device="cpu")
    tcarry = convert.ladder_carry(jax.tree_util.tree_map(np.asarray, carry),
                                  "cpu")
    tp = tselect(teng.sparams, tcarry.k_idx.long())
    got = tladder.fused_generation(teng.cfg, tp, tcarry.states,
                                   torch.tensor(np.asarray(Z)), tf, eigen)
    got = convert.to_numpy(got)

    for f in ("m", "sigma", "C", "p_sigma", "p_c", "best_f", "best_x"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-11, atol=1e-300, err_msg=f)
    np.testing.assert_allclose(got.f_hist, want.f_hist, rtol=1e-11)
    for f in ("fevals", "gen", "last_eigen_gen", "hist_count", "stop",
              "stop_reason"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    if eigen == "always":
        np.testing.assert_allclose(got.D, want.D, rtol=1e-10)

        def recon(st):
            return st.B @ (st.D[..., None] ** 2 * np.swapaxes(st.B, -1, -2))
        np.testing.assert_allclose(recon(got), recon(want), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(recon(got), got.C, rtol=1e-9, atol=1e-12)
    else:
        np.testing.assert_array_equal(got.B, np.asarray(carry.states.B))


def test_eigen_decompose_sign_convention():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(3, 7, 7))
    C = torch.tensor(A @ np.swapaxes(A, -1, -2) + 7 * np.eye(7))
    B, D = tcmaes.eigen_decompose(C)
    assert B.is_contiguous()
    pivot = B.abs().argmax(dim=-2, keepdim=True)
    assert (B.gather(-2, pivot) > 0).all()
    torch.testing.assert_close(B @ torch.diag_embed(D ** 2) @ B.mT, C)


def test_lazy_eigen_mode_not_ported():
    eng = tladder.LadderEngine(n=3, lam_start=4, kmax_exp=1, device="cpu")
    carry = eng.init_carry(eng.base_key(0))
    fn, _ = tb.make_fitness(1, 3, 1, device="cpu")
    with pytest.raises(NotImplementedError):
        eng.gen_step(carry, eng.base_key(0), fn)          # default "lazy"
