"""RWKV-6 "Finch" (arXiv:2404.05892): data-dependent decay linear attention.
Port of ``repro/models/rwkv6.py``.

Time-mix layer: token shift with LoRA-produced data-dependent interpolation
(µ), data-dependent per-channel decay w_t = exp(−exp(ŵ_t)), bonus u, per-head
GroupNorm, SiLU output gate.  Channel-mix layer: token-shifted squared-ReLU
FFN.  The WKV recurrence runs in chunked-parallel form
(``ops.wkv_chunked``, CHUNK = 16): on the card the kernel of
``kernels/rwkv6_wkv.py``, on the CPU its plain version.  Per-token
log-decay is clamped to [−LOG_CLAMP, −1e−6], bounding every exponential of
a chunk by e^{16·LOG_CLAMP}.  Decode is the O(1)-state recurrence
(``time_mix_decode``), plain torch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import WKV_CHUNK as CHUNK
from repro_torch.models import layers

LOG_CLAMP = 5.0
LORA_MIX = 32
LORA_DECAY = 64


def init_rwkv_params(gen, d_model: int, head_dim: int, param_dtype, device,
                     lead=()) -> dict:
    """Time-mix weights with leading axes ``lead``; the LoRA up-projections
    ``maa_w2`` and ``dec_w2`` start at zero, as in the JAX package."""
    H = d_model // head_dim
    d = d_model
    lead = tuple(lead)
    nl = len(lead)
    dt = layers.dtype_of(param_dtype)

    def dense(shape, in_axis=0):
        return layers.dense_init(gen, lead + shape, param_dtype, device,
                                 in_axis + nl)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=dt, device=device)
    return {
        "mu_base": full((5, d), 0.0),                     # r,k,v,w,g
        "mu_x": full((d,), 0.0),
        "maa_w1": dense((d, 5 * LORA_MIX)),
        "maa_w2": full((5, LORA_MIX, d), 0.0),
        "wr": dense((d, d)), "wk": dense((d, d)), "wv": dense((d, d)),
        "wg": dense((d, d)), "wo": dense((d, d)),
        "w0": full((d,), -1.0),                           # base log-log decay
        "dec_w1": dense((d, LORA_DECAY)),
        "dec_w2": full((LORA_DECAY, d), 0.0),
        "u": full((H, head_dim), 0.0),
        "ln_x_scale": full((H, head_dim), 1.0),
        "ln_x_bias": full((H, head_dim), 0.0),
    }


def init_channel_mix_params(gen, d_model: int, d_ff: int, param_dtype,
                            device, lead=()) -> dict:
    lead = tuple(lead)
    nl = len(lead)
    dt = layers.dtype_of(param_dtype)

    def dense(shape):
        return layers.dense_init(gen, lead + shape, param_dtype, device, nl)
    return {"mu_k": torch.full(lead + (d_model,), 0.5, dtype=dt,
                               device=device),
            "mu_r": torch.full(lead + (d_model,), 0.5, dtype=dt,
                               device=device),
            "wk": dense((d_model, d_ff)), "wv": dense((d_ff, d_model)),
            "wr": dense((d_model, d_model))}


class RWKVState(NamedTuple):
    wkv: torch.Tensor        # (B, H, Dk, Dv) per-layer recurrent state, f32
    shift_tm: torch.Tensor   # (B, d) last token (time mix)
    shift_cm: torch.Tensor   # (B, d) last token (channel mix)


def init_rwkv_state(batch: int, d_model: int, head_dim: int, dtype,
                    device=None) -> RWKVState:
    H = d_model // head_dim
    dt = layers.dtype_of(dtype)
    return RWKVState(
        wkv=torch.zeros((batch, H, head_dim, head_dim), dtype=torch.float32,
                        device=device),
        shift_tm=torch.zeros((batch, d_model), dtype=dt, device=device),
        shift_cm=torch.zeros((batch, d_model), dtype=dt, device=device))


def _data_dependent_mix(p, x, x_prev):
    """RWKV6 token shift: the 5 mixed streams (r,k,v,w,g), (B,S,5,d)."""
    dt = x.dtype
    dx = x_prev - x                                             # (B,S,d)
    xx = x + dx * p["mu_x"].to(dt)
    t = torch.tanh(xx @ p["maa_w1"].to(dt))
    t = t.reshape(*xx.shape[:2], 5, LORA_MIX)
    delta = torch.einsum("bsem,emd->bsed", t, p["maa_w2"].to(dt))
    mu = p["mu_base"].to(dt)[None, None] + delta                # (B,S,5,d)
    return x[:, :, None, :] + dx[:, :, None, :] * mu


def _decay(p, xw):
    """Per-token per-channel log decay, clamped for chunk-safe exponentials
    (B,S,d) f32."""
    dt = xw.dtype
    lo = xw @ p["dec_w1"].to(dt)
    ww = p["w0"].float() + (torch.tanh(lo) @ p["dec_w2"].to(dt)).float()
    return torch.clamp(-torch.exp(ww), -LOG_CLAMP, -1e-6)


def _heads(x, H, head_dim):
    return x.reshape(*x.shape[:2], H, head_dim)


def time_mix(p: dict, x: torch.Tensor, shift: torch.Tensor, wkv_state,
             head_dim: int):
    """Full-sequence RWKV6 attention replacement.  x (B,S,d).  Returns
    (out, last token, new wkv state)."""
    B, S, d = x.shape
    H = d // head_dim
    dt = x.dtype
    x_prev = torch.cat([shift[:, None, :], x[:, :-1]], dim=1)
    mixed = _data_dependent_mix(p, x, x_prev)                   # (B,S,5,d)
    xr, xk, xv, xw, xg = mixed.unbind(2)

    r = _heads(xr @ p["wr"].to(dt), H, head_dim)
    k = _heads(xk @ p["wk"].to(dt), H, head_dim)
    v = _heads(xv @ p["wv"].to(dt), H, head_dim)
    g = xg @ p["wg"].to(dt)
    logw = _heads(_decay(p, xw), H, head_dim)

    pad = (-S) % CHUNK
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        logw = F.pad(logw, (0, 0, 0, 0, 0, pad), value=-1e-6)
    o, new_state = ops.wkv_chunked(r.contiguous(), k.contiguous(),
                                   v.contiguous(), logw.contiguous(), p["u"],
                                   wkv_state)
    o = o[:, :S]

    o = layers.groupnorm_heads(o, p["ln_x_scale"], p["ln_x_bias"])
    o = o.reshape(B, S, d) * F.silu(g)
    out = o @ p["wo"].to(dt)
    return out, x[:, -1, :], new_state


def time_mix_decode(p: dict, x: torch.Tensor, shift: torch.Tensor, wkv_state,
                    head_dim: int):
    """One-token recurrence (decode).  x (B,1,d)."""
    B, _, d = x.shape
    H = d // head_dim
    dt = x.dtype
    mixed = _data_dependent_mix(p, x, shift[:, None, :])
    xr, xk, xv, xw, xg = mixed.unbind(2)
    r = (xr @ p["wr"].to(dt)).reshape(B, H, head_dim)
    k = (xk @ p["wk"].to(dt)).reshape(B, H, head_dim)
    v = (xv @ p["wv"].to(dt)).reshape(B, H, head_dim)
    g = (xg @ p["wg"].to(dt))[:, 0]
    logw = _decay(p, xw).reshape(B, H, head_dim)

    r32, k32, v32 = (a.float() for a in (r, k, v))
    u32 = p["u"].float()
    # o = r·(S + u ⊙ k ⊗ v);  S' = e^{logw} ⊙ S + k ⊗ v
    kv = torch.einsum("bhd,bhv->bhdv", k32, v32)
    o = torch.einsum("bhd,bhdv->bhv", r32,
                     wkv_state + u32[None, :, :, None] * kv)
    new_state = torch.exp(logw)[..., None] * wkv_state + kv
    o = layers.groupnorm_heads(o.to(dt), p["ln_x_scale"], p["ln_x_bias"])
    o = o.reshape(B, d) * F.silu(g)
    out = o @ p["wo"].to(dt)
    return out[:, None, :], x[:, -1, :], new_state


def channel_mix(p: dict, x: torch.Tensor, shift: torch.Tensor):
    dt = x.dtype
    x_prev = torch.cat([shift[:, None, :], x[:, :-1]], dim=1)
    xk = x + (x_prev - x) * p["mu_k"].to(dt)
    xr = x + (x_prev - x) * p["mu_r"].to(dt)
    kk = torch.square(F.relu(xk @ p["wk"].to(dt)))
    vv = kk @ p["wv"].to(dt)
    rr = torch.sigmoid(xr @ p["wr"].to(dt))
    return rr * vv, x[:, -1, :]
