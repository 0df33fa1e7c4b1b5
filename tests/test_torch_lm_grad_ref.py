"""The plain versions of the port's LM backward kernels against the JAX
package, on the CPU, on inputs made with numpy.

* ``ref.flash_attention_bwd`` (the two blockwise passes of
  ``repro/models/flash_xla.py::_flash_bwd_impl``, from the forward's row
  log-sum-exp ``ref.flash_attention_lse``) against ``jax.vjp`` of
  ``flash_xla.flash_mha`` and against autograd of ``ref.flash_attention``:
  causal, sliding window, GQA, ragged S, one and several blocks.
  Where S is ragged and spans several q blocks, the JAX package's dk and dv
  are NaN (its pass 2 re-pads the saved l with zeros, so a padded row's
  p = e^{s - m}/0 meets do = 0; ROADMAP.md queue C): there only its dq is
  compared, and the rest against autograd.
* ``ref.wkv_backward`` (autograd through ``ref.wkv_chunked``) against
  ``jax.vjp`` of ``repro.models.rwkv6.wkv_chunked`` with an initial state
  and a final-state cotangent.
* the order of work of the backward kernels, written out here in plain
  torch (``_flash_split_bwd``, ``_wkv_split_bwd``): attention's dk and dv
  as per-query-head partials summed in head order; the WKV's state-free
  pair terms of every chunk ahead, a reverse sweep per 16-key-dim slice
  over rows recomputed by the slice's own forward sweep, and dv's shares
  summed in slice order.  Held to the plain versions at 1e-5 of the
  largest |value| and to JAX at the tolerances below.
* the autograd functions over the CUDA kernels refuse CPU tensors.

Every comparison is in float32, relative to the largest |value| of the
expected gradient: 2e-5 for attention (f32 sums in other orders), 1e-4 for
the WKV (its chunk exponentials reach e^{80}: a last-place change in a
cumulative log-decay moves an element by ~1e-5 of its own size, as
``tests/test_torch_lm_kernels_ref.py`` notes for the forward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash_xla
from repro.models import rwkv6 as jr
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_wkv as t_wkv
from repro_torch.kernels.ref import WKV_CHUNK
from torch_threads import one_thread  # noqa: F401


def _close(got, want, tol):
    """max |got − want| ≤ tol · largest |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"relative error {err:.3e} > {tol:.0e}"


def _flash_inputs(B, S, H, Hk, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D), (B, S, H, D))]


@pytest.mark.parametrize("B,S,H,Hk,D,window,bq", [
    (1, 64, 2, 2, 32, 0, 512),       # MHA, one block
    (2, 129, 4, 2, 16, 0, 512),      # GQA 2:1, ragged S
    (1, 129, 4, 1, 32, 100, 512),    # MQA, sliding window 100
    (1, 192, 4, 2, 16, 48, 64),      # several blocks: window block ranges
    (1, 160, 2, 1, 16, 0, 64),       # several blocks, ragged: JAX's dq only
])
def test_flash_bwd_matches_jax(B, S, H, Hk, D, window, bq):
    q, k, v, do = _flash_inputs(B, S, H, Hk, D, 11)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = tref.flash_attention(tq, tk, tv, causal=True, window=window)
    lse = tref.flash_attention_lse(tq, tk, causal=True, window=window)
    got = tref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=True,
                                   window=window, bq=bq, bkv=bq)
    # the JAX package's custom VJP at its own block sizes
    _, vjp = jax.vjp(lambda a, b, c: flash_xla.flash_mha(
        a, b, c, True, window, bq, bq), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    if S % bq and S > bq:
        want = want[:1]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 2e-5)
    # autograd of the materialised softmax
    ins = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tref.flash_attention(*ins, causal=True, window=window)
    auto = torch.autograd.grad(out, ins, tdo)
    for g, w in zip(got, auto):
        _close(g, w, 2e-5)


def test_flash_lse_and_noncausal():
    """The row statistic is the masked rows' log-sum-exp; a non-causal
    call (S_kv a multiple of the block) differentiates too."""
    q, k, v, do = _flash_inputs(1, 128, 2, 1, 32, 12)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    lse = tref.flash_attention_lse(tq, tk, causal=True, window=5)
    s = np.einsum("bshd,bthd->bhst", q, np.repeat(k, 2, axis=2)) * 32 ** -0.5
    i, j = np.arange(128)[:, None], np.arange(128)[None, :]
    s = np.where((j <= i) & (j > i - 5), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want.transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-5)
    o = tref.flash_attention(tq, tk, tv, causal=False)
    lse = tref.flash_attention_lse(tq, tk, causal=False)
    got = tref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=False)
    _, vjp = jax.vjp(lambda a, b, c: flash_xla.flash_mha(a, b, c, False, 0),
                     *map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        _close(g, w, 2e-5)


def _wkv_inputs(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                   for _ in range(4))
    logw = np.clip(-np.exp(rng.standard_normal((B, S, H, D))), -5.0,
                   -1e-6).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    s0 = (0.5 * rng.standard_normal((B, H, D, D))).astype(np.float32)
    ds = (0.1 * rng.standard_normal((B, H, D, D))).astype(np.float32)
    return r, k, v, logw, u, s0, do, ds


@pytest.mark.parametrize("B,S,H,D,final", [
    (1, WKV_CHUNK * 2, 2, 16, True),
    (2, WKV_CHUNK * 4, 2, 32, True),
    (1, WKV_CHUNK * 3, 1, 64, False),
])
def test_wkv_bwd_matches_jax(B, S, H, D, final):
    r, k, v, logw, u, s0, do, ds = _wkv_inputs(B, S, H, D, 13)
    t = [torch.from_numpy(x) for x in (r, k, v, logw, u, s0)]
    got = tref.wkv_backward(*t, torch.from_numpy(do),
                            torch.from_numpy(ds) if final else None)
    (jo, js), vjp = jax.vjp(jr.wkv_chunked,
                            *map(jnp.asarray, (r, k, v, logw, u, s0)))
    want = vjp((jnp.asarray(do),
                jnp.asarray(ds) if final else jnp.zeros_like(js)))
    names = ("dr", "dk", "dv", "dlogw", "du", "dstate")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32, name
        _close(g, w, 1e-4)


def test_wkv_bwd_zero_state_default():
    """``state=None`` is a zero state, and its gradient is still given."""
    r, k, v, logw, u, _, do, _ = _wkv_inputs(1, WKV_CHUNK * 2, 1, 16, 14)
    t = [torch.from_numpy(x) for x in (r, k, v, logw, u)]
    got = tref.wkv_backward(*t, None, torch.from_numpy(do))
    z = torch.zeros((1, 1, 16, 16))
    want = tref.wkv_backward(*t, z, torch.from_numpy(do))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_autograd_functions_refuse_cpu_tensors():
    """The autograd functions launch the kernels: CPU tensors raise (the
    CPU path differentiates the plain versions through ``kernels.ops``)."""
    q, k, v, _ = map(torch.from_numpy, _flash_inputs(1, 64, 2, 1, 32, 15))
    with pytest.raises(ValueError, match="CUDA"):
        t_flash.FlashAttention.apply(q.requires_grad_(), k, v, True, 0)
    r, kk, vv, logw, u, s0, _, _ = map(torch.from_numpy,
                                       _wkv_inputs(1, 32, 1, 32, 16))
    with pytest.raises(ValueError, match="CUDA"):
        t_wkv.WKV6.apply(r.requires_grad_(), kk, vv, logw, u, s0)
    with pytest.raises(ValueError, match="CUDA"):
        t_flash.flash_attention_bwd(q, k, v, q, q[..., 0], q)
    with pytest.raises(ValueError, match="CUDA"):
        t_wkv.wkv6_backward(r, kk, vv, logw, u, s0, r)


def _flash_split_bwd(q, k, v, o, lse, do, causal, window):
    """``csrc/flash_attention_bwd.cu``'s bf16 order of work: P from the
    row statistic, dS = P (dP − do·o), dq per query row, and dk, dv as one
    f32 partial per query head, summed over each query group in head
    order."""
    B, S, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    rep, scale = H // Hk, D ** -0.5
    kx, vx = (x.repeat_interleave(rep, dim=2) for x in (k, v))
    i = torch.arange(S)[:, None]
    j = torch.arange(Skv)[None, :]
    seen = torch.ones((S, Skv), dtype=torch.bool)
    if causal:
        seen &= j <= i
    if window > 0:
        seen &= j > i - window
    s = torch.einsum("bihd,bjhd->bhij", q, kx) * scale
    p = torch.where(seen, torch.exp(s - lse.permute(0, 2, 1)[..., None]),
                    0.0)
    dp = torch.einsum("bihd,bjhd->bhij", do, vx)
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    dq = torch.einsum("bhij,bjhd->bihd", ds, kx) * scale
    dkp = (torch.einsum("bhij,bihd->bjhd", ds, q) * scale).reshape(
        B, Skv, Hk, rep, D)
    dvp = torch.einsum("bhij,bihd->bjhd", p, do).reshape(B, Skv, Hk, rep, D)
    dk, dv = dkp[..., 0, :], dvp[..., 0, :]
    for r in range(1, rep):
        dk, dv = dk + dkp[..., r, :], dv + dvp[..., r, :]
    return dq, dk, dv


@pytest.mark.parametrize("B,S,H,Hk,D,window,causal", [
    (2, 150, 6, 2, 16, 0, True),     # ragged S, a query group of 3
    (1, 200, 7, 1, 32, 40, True),    # MQA, a group of 7, sliding window
    (1, 128, 4, 2, 16, 0, False),    # non-causal
])
def test_flash_bwd_head_partials(B, S, H, Hk, D, window, causal):
    q, k, v, do = _flash_inputs(B, S, H, Hk, D, 17)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    kw = dict(causal=causal, window=window)
    o = tref.flash_attention(tq, tk, tv, **kw)
    lse = tref.flash_attention_lse(tq, tk, **kw)
    got = _flash_split_bwd(tq, tk, tv, o, lse, tdo, causal, window)
    want = tref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, **kw)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    _, vjp = jax.vjp(lambda a, b, c: flash_xla.flash_mha(
        a, b, c, causal, window), *map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        _close(g, w, 2e-5)


def _wkv_split_bwd(r, k, v, logw, u, s0, do, ds, kd=16):
    """``csrc/rwkv6_wkv_bwd.cu``'s order of work: the state-free terms of
    every chunk at once (A, dA, the bonus and its gradient, and dA's
    shares of dqt and dki); per slice of ``kd`` key dims a forward sweep
    of the slice's rows of the state (the chunks' entry rows) and a
    reverse sweep giving dr, dk, dlogw, du and dS₀ of its key dims and its
    share of dv; dv the state-free terms plus the slices' shares in slice
    order."""
    B, S, H, D = r.shape
    C, n = WKV_CHUNK, S // WKV_CHUNK

    def chunks(x):
        return x.reshape(B, n, C, H, D)
    r, k, v, w, do = map(chunks, (r, k, v, logw, do))
    Lc = torch.cumsum(w, dim=2)
    Lp = Lc - w
    Ll = Lc[:, :, -1]                                    # (B, n, H, D)
    qt, ki = r * torch.exp(Lp), k * torch.exp(-Lc)
    ko = k * torch.exp(Ll[:, :, None] - Lc)
    below = torch.tril(torch.ones((C, C), dtype=torch.bool), diagonal=-1)
    A = torch.where(below, torch.einsum("bnthd,bnjhd->bnhtj", qt, ki), 0.0)
    dA = torch.where(below, torch.einsum("bnthd,bnjhd->bnhtj", do, v), 0.0)
    bonus = torch.einsum("bnthd,hd,bnthd->bnht", r, u, k)
    dbon = torch.einsum("bnthd,bnthd->bnht", do, v)
    dv = (bonus.permute(0, 1, 3, 2)[..., None] * do
          + torch.einsum("bnhtj,bnthc->bnjhc", A, do))
    dqt_free = torch.einsum("bnhtj,bnjhd->bnthd", dA, ki)
    dki_free = torch.einsum("bnhtj,bnthd->bnjhd", dA, qt)
    shares, dr, dk, dlogw, ds0 = [], [], [], [], []
    du = torch.zeros_like(u)
    for q in range(D // kd):
        sl = slice(q * kd, (q + 1) * kd)
        rows, entry = s0[:, :, sl], []
        for i in range(n):
            entry.append(rows)
            rows = (torch.exp(Ll[:, i, :, sl])[..., None] * rows
                    + torch.einsum("bthd,bthc->bhdc", ko[:, i, :, :, sl],
                                   v[:, i]))
        dS = ds[:, :, sl]
        share, g_r, g_k, g_w = ([None] * n for _ in range(4))
        for i in reversed(range(n)):
            S_i, dec = entry[i], torch.exp(Ll[:, i, :, sl])
            q_, k_, o_ = qt[:, i, ..., sl], ki[:, i, ..., sl], ko[:, i, ..., sl]
            dko = torch.einsum("bhdc,bthc->bthd", dS, v[:, i])
            dqs = torch.einsum("bhdc,bthc->bthd", S_i, do[:, i])
            share[i] = torch.einsum("bthd,bhdc->bthc", o_, dS)
            dqt = dqt_free[:, i, ..., sl] + dqs
            dki = dki_free[:, i, ..., sl]
            bu = dbon[:, i].permute(0, 2, 1)[..., None] * u[:, sl]
            g_r[i] = (dqt * torch.exp(Lp[:, i, ..., sl])
                      + bu * k[:, i, ..., sl])
            g_k[i] = (dki * torch.exp(-Lc[:, i, ..., sl])
                      + dko * torch.exp(Ll[:, i, None, :, sl]
                                        - Lc[:, i, ..., sl])
                      + bu * r[:, i, ..., sl])
            dlp = dqt * q_
            dlc = dlp - dki * k_ - dko * o_
            dll = dec * (dS * S_i).sum(-1) + (dko * o_).sum(1)
            g_w[i] = (torch.flip(torch.cumsum(torch.flip(dlc, [1]), 1), [1])
                      - dlp + dll[:, None])
            du[:, sl] += (dbon[:, i].permute(0, 2, 1)[..., None]
                          * r[:, i, ..., sl] * k[:, i, ..., sl]).sum((0, 1))
            dS = (dec[..., None] * dS
                  + torch.einsum("bthd,bthc->bhdc", q_, do[:, i]))
        shares.append(torch.stack(share, 1))
        dr.append(torch.stack(g_r, 1))
        dk.append(torch.stack(g_k, 1))
        dlogw.append(torch.stack(g_w, 1))
        ds0.append(dS)
    for sh in shares:
        dv = dv + sh

    def whole(parts):
        return torch.cat(parts, -1).reshape(B, S, H, D)
    return (whole(dr), whole(dk), dv.reshape(B, S, H, D), whole(dlogw), du,
            torch.cat(ds0, 2))


@pytest.mark.parametrize("B,S,H,D,final", [
    (1, WKV_CHUNK * 3, 2, 32, True),     # D / 16 = 2 slices
    (2, WKV_CHUNK * 4, 1, 64, True),     # 4 slices
    (1, WKV_CHUNK * 2, 1, 128, False),   # 8 slices, no final gradient
])
def test_wkv_bwd_key_dim_split(B, S, H, D, final):
    r, k, v, logw, u, s0, do, ds = _wkv_inputs(B, S, H, D, 19)
    t = [torch.from_numpy(x) for x in (r, k, v, logw, u, s0)]
    tds = torch.from_numpy(ds) if final else torch.zeros(B, H, D, D)
    got = _wkv_split_bwd(*t, torch.from_numpy(do), tds)
    want = tref.wkv_backward(*t, torch.from_numpy(do),
                             tds if final else None)
    names = ("dr", "dk", "dv", "dlogw", "du", "dstate")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        _close(g, w, 1e-5)
    (_, js), vjp = jax.vjp(jr.wkv_chunked,
                          *map(jnp.asarray, (r, k, v, logw, u, s0)))
    jwant = vjp((jnp.asarray(do),
                 jnp.asarray(ds) if final else jnp.zeros_like(js)))
    for name, g, w in zip(names, got, jwant):
        _close(g, w, 1e-4)
