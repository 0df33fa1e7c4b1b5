"""Wrapper of the hand-written RWKV-6 WKV kernel (``csrc/rwkv6_wkv.cu``).

``wkv6_forward`` replaces ``repro/kernels/rwkv6_wkv.py::wkv6_forward``:
the chunked WKV recurrence, CHUNK = 16, in f32, over r/k/v (B, S, H, D) in
bfloat16 or float32, logw (B, S, H, D) f32 and u (H, D) f32, S a multiple
of 16 and D ∈ {32, 64, 128}.  Beyond the TPU kernel it takes an optional
initial state (B, H, D, D) f32 (zero when None) and returns the final
state beside o, as ``repro/models/rwkv6.py::wkv_chunked`` does.  One
launch: a block per (b·h, 16 value columns of the state), each chunk of
16 tokens staged by 16-byte asynchronous copies, so r, k, v, logw and
the state must start on 16-byte boundaries.  The plain PyTorch version is
``ref.wkv_chunked``.

The wrapper takes CUDA tensors only — it checks device, dtype, shape and
contiguity and raises, it never falls back — and launches on the current
stream without synchronising.  The launch is counted under
``"wkv6_forward"`` in ``_build.LAUNCHES``.

For training, ``wkv6_backward`` launches ``csrc/rwkv6_wkv_bwd.cu`` (no TPU
counterpart: the JAX package differentiates ``wkv_chunked`` by autodiff),
counted under ``"wkv6_backward"``: the state-free pair terms of every
chunk at once, then a sweep split over key dims (D/16 blocks a head, one
cluster) that recomputes the chunks' entry states into a scratch buffer of
the call (B·H·S/16·D·D f32), so the forward saves only its inputs.
``WKV6`` is the autograd function over the pair; its plain version is
``ref.wkv_backward``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import WKV_CHUNK

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 8 + [_I] * 4 + [_P]
_BWD_ARGS = [_P] * 15 + [_I] * 4 + [_P]
HEAD_DIMS = (32, 64, 128)
#: f32 elements of a chunk's state-free pair terms in the backward's
#: scratch: A (16 × 16), the bonus and its gradient (16 each)
#: (``csrc/rwkv6_wkv_bwd.cu``, PAIR)
BWD_PAIR = WKV_CHUNK * WKV_CHUNK + 2 * WKV_CHUNK


def bwd_scratch_floats(B: int, S: int, H: int, D: int) -> int:
    """f32 elements of ``wkv6_backward``'s scratch: every chunk's entry
    state (B·H·S/16·D·D), every chunk's pair terms, dA's shares of dqt and
    dki (2·16·D a chunk) and du's per-(b, h) sums (B·H·D)."""
    n = B * H * (S // WKV_CHUNK)
    return n * (D * D + BWD_PAIR + 2 * WKV_CHUNK * D) + B * H * D


def _check_shape(r):
    if not r.is_cuda:
        raise ValueError("r: the CUDA kernel takes CUDA tensors, got one on "
                         f"{r.device}")
    if r.dim() != 4 or r.dtype not in _build.LM_DTYPES:
        raise ValueError("r, k, v must be (B, S, H, D), bfloat16 or float32")
    B, S, H, D = r.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    if S % WKV_CHUNK:
        raise ValueError(f"S = {S} must be a multiple of {WKV_CHUNK} (the "
                         "caller pads)")
    return B, S, H, D


def wkv6_forward(r, k, v, logw, u, state=None):
    """(o (B, S, H, D) in r's dtype, final state (B, H, D, D) f32)."""
    B, S, H, D = _check_shape(r)
    dt, dev, f32 = r.dtype, r.device, torch.float32
    shape = (B, S, H, D)
    ptrs = [_build.check("r", r, shape, dt, dev),
            _build.check("k", k, shape, dt, dev),
            _build.check("v", v, shape, dt, dev),
            _build.check("logw", logw, shape, f32, dev),
            _build.check("u", u, (H, D), f32, dev),
            0 if state is None else _build.check("state", state,
                                                 (B, H, D, D), f32, dev)]
    for name, p in zip(("r", "k", "v", "logw", "state"),
                       ptrs[:4] + ptrs[5:]):
        if p % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    o = torch.empty_like(r)
    s_out = torch.empty((B, H, D, D), dtype=f32, device=dev)
    fn = _build.function("rwkv6_wkv", "wkv6_forward", dt, _ARGS)
    _build.launch(fn, "wkv6_forward", dev, *ptrs, o.data_ptr(),
                  s_out.data_ptr(), B, S, H, D)
    return o, s_out


def wkv6_backward(r, k, v, logw, u, state, do, dstate=None,
                  need_dstate: bool = True):
    """Gradients of ``wkv6_forward`` for the output gradient ``do`` (r's
    dtype) and the final state's ``dstate`` (f32, None: zero): (dr, dk,
    dv) in r's dtype, dlogw (B, S, H, D), du (H, D) and d(initial state)
    (B, H, D, D, None unless ``need_dstate``), all f32.  One call, counted
    once: the pair terms, the split sweep and a launch summing du over the
    batch in order."""
    B, S, H, D = _check_shape(r)
    dt, dev, f32 = r.dtype, r.device, torch.float32
    shape = (B, S, H, D)
    sshape = (B, H, D, D)
    ins = [_build.check("r", r, shape, dt, dev),
           _build.check("k", k, shape, dt, dev),
           _build.check("v", v, shape, dt, dev),
           _build.check("logw", logw, shape, f32, dev),
           _build.check("u", u, (H, D), f32, dev),
           0 if state is None else _build.check("state", state, sshape, f32,
                                                dev),
           _build.check("do", do, shape, dt, dev),
           0 if dstate is None else _build.check("dstate", dstate, sshape,
                                                 f32, dev)]
    dr, dk, dv = (torch.empty_like(r), torch.empty_like(k),
                  torch.empty_like(v))
    dlogw = torch.empty(shape, dtype=f32, device=dev)
    du = torch.empty((H, D), dtype=f32, device=dev)
    ds0 = torch.empty(sshape, dtype=f32, device=dev) if need_dstate else None
    scratch = torch.empty(bwd_scratch_floats(B, S, H, D), dtype=f32,
                          device=dev)
    fn = _build.function("rwkv6_wkv_bwd", "wkv6_backward", dt, _BWD_ARGS)
    _build.launch(fn, "wkv6_backward", dev, *ins, dr.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(),
                  du.data_ptr(), 0 if ds0 is None else ds0.data_ptr(),
                  scratch.data_ptr(), B, S, H, D)
    return dr, dk, dv, dlogw, du, ds0


class WKV6(torch.autograd.Function):
    """``wkv6_forward`` with its gradient (``wkv6_backward``).  Saves the
    inputs only; ``state`` may be None (a zero state)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state):
        ctx.set_materialize_grads(False)      # an unused output: None
        o, s_out = wkv6_forward(r, k, v, logw, u, state)
        ctx.save_for_backward(r, k, v, logw, u, state)
        return o, s_out

    @staticmethod
    def backward(ctx, do, dstate):
        r, k, v, logw, u, state = ctx.saved_tensors
        do = torch.zeros_like(r) if do is None else do.contiguous()
        dstate = None if dstate is None else dstate.contiguous()
        dr, dk, dv, dlogw, du, ds0 = wkv6_backward(
            r, k, v, logw, u, state, do, dstate,
            need_dstate=ctx.needs_input_grad[5])
        return dr, dk, dv, dlogw, du, ds0
