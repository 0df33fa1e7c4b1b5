"""Wrapper of the hand-written flash attention kernel
(``csrc/flash_attention.cu``).

``flash_attention`` replaces ``repro/kernels/flash_attention.py::
flash_attention``: GQA attention forward with f32 online softmax, causal
and sliding-window masks in index order, q (B, S, H, D) and k/v
(B, S_kv, H_k, D) in bfloat16 or float32, D ∈ ``HEAD_DIMS`` (32, 64, 96,
112, 128, 256: every head dim of the repo's configs); the output has q's
dtype.  One launch: bfloat16 runs on the tensor cores (TMA-fed wgmma
tiles), float32 on scalar FMAs.  The plain PyTorch version is
``ref.flash_attention``.

The wrapper takes CUDA tensors only — it checks device, dtype, shape,
contiguity and alignment and raises, it never falls back — and launches on
the current stream without synchronising.  The launch is counted under
``"flash_attention"`` in ``_build.LAUNCHES``.

For training, ``flash_attention_stats`` is the same launch writing, beside
o, each row's log-sum-exp of the scaled logits (f32 (B, S, H)), and
``flash_attention_bwd`` launches ``csrc/flash_attention_bwd.cu`` (no TPU
counterpart: the JAX package's flash path differentiates with
``repro/models/flash_xla.py::_flash_bwd_impl``), counted under
``"flash_attention_bwd"``: bfloat16 on the tensor cores (a row-statistics
pass, the dq pass, the dk/dv pass over one query head a block and the sum
of each query group's per-head partials in head order), float32 on scalar
FMAs, at D ∈ ``BWD_HEAD_DIMS`` (32, 64, 128) only: the other head dims
raise ``NotImplementedError`` (ROADMAP.md, queue A item 18).
``FlashAttention`` is the autograd function over the pair, and raises at
those head dims before its forward launches; its plain version is
``ref.flash_attention_bwd``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 5 + [_I] * 8 + [ctypes.c_float, _P]
_BWD_ARGS = [_P] * 10 + [_I] * 8 + [ctypes.c_float, _P]
HEAD_DIMS = (32, 64, 96, 112, 128, 256)
#: the head dims of the backward kernel; training at the others is queue A
#: item 18
BWD_HEAD_DIMS = (32, 64, 128)
#: the TPU kernel's KV block: non-causal attention needs S_kv a multiple
#: of min(BKV, S_kv), as ``repro/kernels/flash_attention.py:128`` requires
BKV = 128


#: rows a block of the bf16 backward takes: its row-statistics table
#: holds S rounded up to them (``csrc/flash_attention_bwd.cu``, BROWS)
BWD_ROWS = 128


def bwd_scratch_floats(dtype, B: int, S: int, Skv: int, H: int,
                       D: int) -> int:
    """f32 elements of ``flash_attention_bwd``'s scratch: float32, the row
    sums do·o (B·S·H); bfloat16, the table of (lse·log2 e, do·o) over S
    rounded up to ``BWD_ROWS`` and the per-head f32 partials of dk and dv
    (2·B·S_kv·H·D)."""
    if dtype == torch.float32:
        return B * S * H
    Sp = -(-S // BWD_ROWS) * BWD_ROWS
    return 2 * B * H * Sp + 2 * B * Skv * H * D


def check_contract(causal: bool, Skv: int) -> None:
    """The JAX kernel's contract: non-causal attention with ragged S_kv is
    not served (it would need masked KV padding)."""
    if not causal and Skv % min(BKV, Skv):
        raise NotImplementedError(
            "non-causal flash kernel requires S_kv % bkv == 0")


def check_bwd_head_dim(D: int) -> None:
    """Raise ``NotImplementedError`` for a head dim the backward kernel does
    not take."""
    if D not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash attention's backward at head dim {D} is not ported "
            f"(the kernel takes {BWD_HEAD_DIMS}; ROADMAP.md, queue A item "
            "18)")


def _check(q, k, v, causal: bool):
    """(B, S, H, D, Skv, Hk) of valid operands; raises otherwise."""
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
    return B, S, H, D, Skv, Hk


def _forward(q, k, v, causal: bool, window: int, stats: bool):
    B, S, H, D, Skv, Hk = _check(q, k, v, causal)
    dt, dev = q.dtype, q.device
    ptrs = [_build.check("q", q, (B, S, H, D), dt, dev),
            _build.check("k", k, (B, Skv, Hk, D), dt, dev),
            _build.check("v", v, (B, Skv, Hk, D), dt, dev)]
    if any(p % 16 for p in ptrs):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    o = torch.empty_like(q)
    lse = (torch.empty((B, S, H), dtype=torch.float32, device=dev)
           if stats else None)
    fn = _build.function("flash_attention", "flash_attention", dt, _ARGS)
    _build.launch(fn, "flash_attention", dev, *ptrs, o.data_ptr(),
                  None if lse is None else lse.data_ptr(), B, S, Skv, H, Hk,
                  D, int(bool(causal)), int(window), D ** -0.5)
    return o, lse


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """o (B, S, H, D) = softmax(q kᵀ / √D, masked) v with GQA: query head h
    reads KV head ``h // (H // H_k)``."""
    return _forward(q, k, v, causal, window, False)[0]


def flash_attention_stats(q, k, v, *, causal: bool = True, window: int = 0):
    """(o, lse): ``flash_attention``'s output and, in the same launch, each
    row's log-sum-exp of the scaled, masked logits, f32 (B, S, H)."""
    return _forward(q, k, v, causal, window, True)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) for the output
    gradient ``do``, from the forward's o and lse; the gradients have the
    inputs' dtype.  One call, counted once: float32 two launches (dq with
    the row sums do·o into scratch, then dk and dv), bfloat16 four (the
    row statistics, dq, per-head partials of dk and dv, their sum)."""
    check_bwd_head_dim(q.shape[-1])
    B, S, H, D, Skv, Hk = _check(q, k, v, causal)
    dt, dev = q.dtype, q.device
    qshape, kshape = (B, S, H, D), (B, Skv, Hk, D)
    ptrs = [_build.check("q", q, qshape, dt, dev),
            _build.check("k", k, kshape, dt, dev),
            _build.check("v", v, kshape, dt, dev),
            _build.check("o", o, qshape, dt, dev),
            _build.check("lse", lse, (B, S, H), torch.float32, dev),
            _build.check("do", do, qshape, dt, dev)]
    if any(p % 16 for p in ptrs):
        raise ValueError("q, k, v, o, lse and do must start on a 16-byte "
                         "boundary")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    scratch = torch.empty(bwd_scratch_floats(dt, B, S, Skv, H, D),
                          dtype=torch.float32, device=dev)
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd", dt,
                         _BWD_ARGS)
    _build.launch(fn, "flash_attention_bwd", dev, *ptrs, dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), B, S,
                  Skv, H, Hk, D, int(bool(causal)), int(window), D ** -0.5)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward launches the
    forward kernel with the row statistics, the backward
    ``flash_attention_bwd``.  Saves q, k, v, o and lse.  A head dim the
    backward does not take raises before the forward launches."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        check_bwd_head_dim(q.shape[-1])
        o, lse = flash_attention_stats(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None
