"""The plain versions of the port's LM kernels (repro_torch.kernels.ref,
and ops on CPU tensors) against the JAX package's oracles and its Pallas
kernels in interpret mode, at ``tests/test_kernels_lm.py``'s shapes, on the
same inputs made with numpy.

Tolerances: 2e-5 (float32), 2e-2 (bfloat16).  Attention is compared
element by element, as ``test_kernels_lm.py`` holds the flash kernel to its
oracle.  The WKV recurrence is compared relative to the largest |value| of
the result: its chunk exponentials reach e^{80}, so a last-place change in
a cumulative log-decay moves an element by ~1e-5 of its own size (about
1e-6 of the largest).  Against a float64 token-by-token recurrence the
chunked form is held to 1e-4, as ``test_kernels_lm.py`` holds the Pallas
kernel.  The CUDA wrappers refuse CPU tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.rwkv6_wkv import CHUNK
from repro.kernels.rwkv6_wkv import wkv6_forward as j_wkv6
from repro.models import rwkv6 as jr
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_wkv as t_wkv
from torch_threads import one_thread  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a, dtype):
    return (jnp.asarray(a, jnp.float32).astype(jnp.dtype(dtype)),
            torch.tensor(np.asarray(a, np.float32)).to(
                {"float32": torch.float32,
                 "bfloat16": torch.bfloat16}[dtype]))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _allclose(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close(got, want, tol):
    """max |got − want| ≤ tol · largest |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"relative error {err:.3e} > {tol:.0e}"


def _qkv(B, S, H, Hk, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(shape), dtype) for shape in
            ((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hk,D", [
    (1, 128, 4, 4, 64),       # MHA, one block
    (2, 256, 4, 2, 64),       # GQA 2:1, multi q/kv blocks
    (1, 384, 8, 1, 128),      # MQA, non-pow2 seq (padding path)
    (2, 129, 4, 4, 64),       # ragged seq → q-pad
])
def test_flash_attention_causal(dtype, B, S, H, Hk, D):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, H, Hk, D, dtype, 0)
    got = tref.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype
    _allclose(got, jref.flash_attention(jq, jk, jv, causal=True), TOL[dtype])
    _allclose(ops.flash_attention(tq, tk, tv),
              j_flash(jq, jk, jv, causal=True, interpret=True), TOL[dtype])


@pytest.mark.parametrize("window", [32, 100, 128])
def test_flash_attention_sliding_window(window):
    """Windows that start mid-tile (32, 100 against 64-row tiles)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 256, 4, 2, 64, "float32", 1)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    _allclose(got, jref.flash_attention(jq, jk, jv, causal=True,
                                        window=window), 2e-5)
    _allclose(got, j_flash(jq, jk, jv, causal=True, window=window,
                           interpret=True, bq=64, bkv=64), 2e-5)


def test_flash_attention_non_causal():
    """Non-causal attention: served when S_kv tiles evenly; the ragged case
    raises under a kernel tier, as the JAX kernel does, and the plain tier
    (JAX's "xla") serves it."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 128, 2, 1, 32, "float32", 2)
    _allclose(ops.flash_attention(tq, tk, tv, causal=False),
              j_flash(jq, jk, jv, causal=False, interpret=True), 2e-5)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 129, 2, 1, 32, "float32", 2)
    with pytest.raises(NotImplementedError):
        j_flash(jq, jk, jv, causal=False, interpret=True)
    for impl in ("auto", "kernel_rng"):
        with pytest.raises(NotImplementedError, match="S_kv % bkv"):
            ops.flash_attention(tq, tk, tv, causal=False, impl=impl)
    _allclose(ops.flash_attention(tq, tk, tv, causal=False, impl="eager"),
              jref.flash_attention(jq, jk, jv, causal=False), 2e-5)


def _wkv_inputs(B, S, H, D, dtype, seed, state=True):
    rng = np.random.default_rng(seed)
    r, k, v = (_pair(rng.standard_normal((B, S, H, D)), dtype)
               for _ in range(3))
    logw = np.clip(-np.exp(rng.standard_normal((B, S, H, D))), -5.0, -1e-6)
    u = 0.1 * rng.standard_normal((H, D))
    s0 = (0.5 * rng.standard_normal((B, H, D, D)) if state
          else np.zeros((B, H, D, D)))
    return r, k, v, _pair(logw, "float32"), _pair(u, "float32"), \
        _pair(s0, "float32")


WKV_SHAPES = [(1, CHUNK * 2, 2, 32), (2, CHUNK * 4, 4, 64),
              (1, CHUNK * 8, 1, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,D", WKV_SHAPES)
def test_wkv6(dtype, B, S, H, D):
    """Zero state, output only: JAX's ref and its Pallas kernel."""
    r, k, v, w, u, _ = _wkv_inputs(B, S, H, D, dtype, 3)
    args_t = [a[1] for a in (r, k, v, w, u)]
    args_j = [a[0] for a in (r, k, v, w, u)]
    got = ops.wkv6(*args_t)
    assert got.dtype == args_t[0].dtype
    _close(got, jref.wkv6(*args_j), TOL[dtype])
    _close(got, j_wkv6(*args_j, interpret=True), TOL[dtype])
    _close(tref.wkv6(*args_t), jref.wkv6(*args_j), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,D", WKV_SHAPES)
def test_wkv_chunked_with_state(dtype, B, S, H, D):
    """A non-zero initial state: output and final state against
    ``repro.models.rwkv6.wkv_chunked``."""
    r, k, v, w, u, s0 = _wkv_inputs(B, S, H, D, dtype, 4)
    jo, js = jr.wkv_chunked(*(a[0] for a in (r, k, v, w, u, s0)))
    to, ts = ops.wkv_chunked(*(a[1] for a in (r, k, v, w, u, s0)))
    assert ts.dtype == torch.float32 and to.dtype == r[1].dtype
    _close(to, jo, TOL[dtype])
    _close(ts, js, TOL[dtype])


def test_wkv_state_carry_matches_sequential():
    """The chunked form's state carry equals a token-by-token recurrence
    (the decode path), from a non-zero state."""
    B, S, H, D = 1, CHUNK * 3, 2, 16
    r, k, v, w, u, s0 = (a[1] for a in _wkv_inputs(B, S, H, D, "float32", 5))
    o, s_end = tref.wkv_chunked(r, k, v, w, u, s0)
    st = s0.double()
    outs = torch.zeros((B, S, H, D), dtype=torch.float64)
    for t in range(S):
        kv = torch.einsum("bhd,bhe->bhde", k[:, t].double(), v[:, t].double())
        outs[:, t] = torch.einsum("bhd,bhde->bhe", r[:, t].double(),
                                  st + u.double()[None, :, :, None] * kv)
        st = torch.exp(w[:, t].double())[..., None] * st + kv
    np.testing.assert_allclose(o.numpy(), outs.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_end.numpy(), st.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_wkv_ragged_sequence_refused():
    r, k, v, w, u, s0 = (a[1] for a in _wkv_inputs(1, 20, 1, 32, "float32",
                                                   6))
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.wkv_chunked(r, k, v, w, u, s0)


NEW_HEAD_DIMS = [96, 112, 256]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", NEW_HEAD_DIMS)
@pytest.mark.parametrize("S,window", [(128, 0), (256, 100), (129, 50)])
def test_flash_attention_new_head_dims(dtype, D, S, window):
    """The head dims of phi3-mini (96), zamba2's shared block (112) and
    gemma3-4b (256): causal, windowed (mid-tile), ragged with a window,
    against the JAX package's Pallas kernel in interpret mode and its
    oracle."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, S, 4, 2, D, dtype, D + S)
    kw = dict(causal=True, window=window)
    got = ops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _allclose(got, j_flash(jq, jk, jv, interpret=True, bq=64, bkv=64, **kw),
              TOL[dtype])
    _allclose(got, jref.flash_attention(jq, jk, jv, **kw), TOL[dtype])


def test_flash_backward_refuses_new_head_dims_before_any_launch(monkeypatch):
    """Training at head dims 96, 112 and 256 is queue A item 18: the
    autograd function and the backward wrapper raise before anything is
    launched (and before the forward runs)."""
    from repro_torch.kernels import _build

    def boom(*a, **kw):
        raise AssertionError("a kernel was launched")
    monkeypatch.setattr(_build, "launch", boom)
    monkeypatch.setattr(t_flash, "flash_attention_stats", boom)
    for D in NEW_HEAD_DIMS:
        (_, tq), (_, tk), (_, tv) = _qkv(1, 64, 2, 1, D, "float32", D)
        tq.requires_grad_(True)
        with pytest.raises(NotImplementedError, match="queue A item 18"):
            t_flash.FlashAttention.apply(tq, tk, tv, True, 0)
        lse = torch.zeros(1, 64, 2)
        with pytest.raises(NotImplementedError, match="queue A item 18"):
            t_flash.flash_attention_bwd(tq, tk, tv, tq, lse, tq)
    assert t_flash.HEAD_DIMS == (32, 64, 96, 112, 128, 256)
    assert t_flash.BWD_HEAD_DIMS == (32, 64, 128)


def test_eager_tier_takes_the_plain_version(monkeypatch):
    """``impl="eager"`` never reaches a kernel wrapper, whatever the device;
    a kernel tier on a CPU tensor takes the plain version too."""
    def boom(*a, **kw):
        raise AssertionError("kernel wrapper called")
    monkeypatch.setattr(t_flash, "flash_attention", boom)
    monkeypatch.setattr(t_wkv, "wkv6_forward", boom)
    (_, tq), (_, tk), (_, tv) = _qkv(1, 64, 2, 1, 32, "float32", 7)
    r, k, v, w, u, s0 = (a[1] for a in _wkv_inputs(1, 32, 1, 32, "float32",
                                                   7))
    for impl in ("eager", "auto"):
        torch.testing.assert_close(
            ops.flash_attention(tq, tk, tv, impl=impl),
            tref.flash_attention(tq, tk, tv), rtol=0, atol=0)
        torch.testing.assert_close(ops.wkv6(r, k, v, w, u, impl=impl),
                                   tref.wkv6(r, k, v, w, u), rtol=0, atol=0)
        got = ops.wkv_chunked(r, k, v, w, u, s0, impl=impl)
        want = tref.wkv_chunked(r, k, v, w, u, s0)
        for g, x in zip(got, want):
            torch.testing.assert_close(g, x, rtol=0, atol=0)


def test_cuda_wrappers_refuse_cpu_tensors():
    (_, tq), (_, tk), (_, tv) = _qkv(1, 64, 2, 1, 32, "float32", 8)
    with pytest.raises(ValueError, match="CUDA"):
        t_flash.flash_attention(tq, tk, tv)
    r, k, v, w, u, s0 = (a[1] for a in _wkv_inputs(1, 32, 1, 32, "float32",
                                                   8))
    with pytest.raises(ValueError, match="CUDA"):
        t_wkv.wkv6_forward(r, k, v, w, u, s0)
