"""Wrapper of the hand-written flash attention kernel
(``csrc/flash_attention.cu``).

``flash_attention`` replaces ``repro/kernels/flash_attention.py::
flash_attention``: GQA attention forward with f32 online softmax, causal
and sliding-window masks in index order, q (B, S, H, D) and k/v
(B, S_kv, H_k, D) in bfloat16 or float32, D ∈ {32, 64, 128}; the output
has q's dtype.  One launch: bfloat16 runs on the tensor cores (TMA-fed
wgmma tiles), float32 on scalar FMAs.  The plain PyTorch version is
``ref.flash_attention``.

The wrapper takes CUDA tensors only — it checks device, dtype, shape,
contiguity and alignment and raises, it never falls back — and launches on
the current stream without synchronising.  The launch is counted under
``"flash_attention"`` in ``_build.LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 4 + [_I] * 8 + [ctypes.c_float, _P]
HEAD_DIMS = (32, 64, 128)
#: the TPU kernel's KV block: non-causal attention needs S_kv a multiple
#: of min(BKV, S_kv), as ``repro/kernels/flash_attention.py:128`` requires
BKV = 128


def check_contract(causal: bool, Skv: int) -> None:
    """The JAX kernel's contract: non-causal attention with ragged S_kv is
    not served (it would need masked KV padding)."""
    if not causal and Skv % min(BKV, Skv):
        raise NotImplementedError(
            "non-causal flash kernel requires S_kv % bkv == 0")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """o (B, S, H, D) = softmax(q kᵀ / √D, masked) v with GQA: query head h
    reads KV head ``h // (H // H_k)``."""
    if not q.is_cuda:
        raise ValueError("q: the CUDA kernel takes CUDA tensors, got one on "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or q.dtype not in _build.LM_DTYPES:
        raise ValueError("q must be (B, S, H, D) and k, v (B, S_kv, H_k, D), "
                         "bfloat16 or float32")
    B, S, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    if Hk < 1 or H % Hk:
        raise ValueError(f"{H} query heads do not group over {Hk} KV heads")
    if S < 1 or Skv < 1:
        raise ValueError(f"empty sequence: S={S}, S_kv={Skv}")
    check_contract(causal, Skv)
    dt, dev = q.dtype, q.device
    ptrs = [_build.check("q", q, (B, S, H, D), dt, dev),
            _build.check("k", k, (B, Skv, Hk, D), dt, dev),
            _build.check("v", v, (B, Skv, Hk, D), dt, dev)]
    if any(p % 16 for p in ptrs):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    o = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention", dt, _ARGS)
    _build.launch(fn, "flash_attention", dev, *ptrs, o.data_ptr(), B, S, Skv,
                  H, Hk, D, int(bool(causal)), int(window), D ** -0.5)
    return o
