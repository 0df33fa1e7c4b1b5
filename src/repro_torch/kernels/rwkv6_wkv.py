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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import WKV_CHUNK

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 8 + [_I] * 4 + [_P]
HEAD_DIMS = (32, 64, 128)


def wkv6_forward(r, k, v, logw, u, state=None):
    """(o (B, S, H, D) in r's dtype, final state (B, H, D, D) f32)."""
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
