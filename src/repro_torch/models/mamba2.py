"""Mamba-2 (SSD, arXiv:2405.21060) in its chunked state-space duality form.
Port of ``repro/models/mamba2.py``.

The selective-SSM recurrence (per head, A scalar)
    h_t = e^{dt_t·A}·h_{t−1} + dt_t·B_t ⊗ x_t ,   y_t = C_t·h_t + D·x_t
is evaluated a chunk of CHUNK steps at a time: within a chunk the (c × c)
decay kernel L[t,j] = e^{cumA_t − cumA_j} (j ≤ t, never above 1) turns the
recurrence into two products; across chunks a loop carries the (H, N, P)
state.  The JAX package computes this in jnp (no Pallas kernel), in f32
inside whatever the compute dtype; so does the port, in plain PyTorch on
every device.  This is the attention-free mixer of the zamba2-7b hybrid;
decode is one step of the recurrence.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers

CHUNK = 64
CONV_K = 4


def init_mamba_params(gen, d_model: int, d_state: int, head_dim: int = 64,
                      expand: int = 2, param_dtype="float32", device=None,
                      lead=()) -> dict:
    """The mixer's weights with leading axes ``lead`` (a layer stack)."""
    d_inner = expand * d_model
    H = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state                 # one B/C group
    lead = tuple(lead)
    dt = layers.dtype_of(param_dtype)

    def dense(shape):
        return layers.dense_init(gen, lead + shape, param_dtype, device,
                                 len(lead))

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=dt, device=device)
    return {"in_proj": dense((d_model, 2 * d_inner + 2 * d_state + H)),
            "conv_w": dense((CONV_K, conv_dim)),
            "conv_b": full((conv_dim,), 0.0),
            "A_log": full((H,), 0.0),                # A = −exp(A_log) = −1
            "D": full((H,), 1.0),
            "dt_bias": full((H,), 0.0),
            "norm_scale": full((d_inner,), 1.0),
            "out_proj": dense((d_inner, d_model))}


class MambaState(NamedTuple):
    ssm: torch.Tensor        # (B, H, N, P) f32
    conv: torch.Tensor       # (B, CONV_K−1, conv_dim) the last inputs


def init_mamba_state(batch: int, d_model: int, d_state: int,
                     head_dim: int = 64, expand: int = 2,
                     dtype=torch.bfloat16, device=None) -> MambaState:
    d_inner = expand * d_model
    H = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state
    return MambaState(
        ssm=torch.zeros((batch, H, d_state, head_dim), dtype=torch.float32,
                        device=device),
        conv=torch.zeros((batch, CONV_K - 1, conv_dim),
                         dtype=layers.dtype_of(dtype), device=device))


def _split_proj(p, x, d_model, d_state, head_dim, expand):
    d_inner = expand * d_model
    H = d_inner // head_dim
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = torch.split(
        zxbcdt, [d_inner, d_inner + 2 * d_state, H], dim=-1)
    return z, xbc, dt, d_inner, H


def _causal_conv(p, xbc, prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv, k = 4, then SiLU.  ``prev``: the (B, k−1, C)
    inputs before ``xbc`` (decode); zeros when None.  Returns (out, the
    last k−1 inputs)."""
    dt = xbc.dtype
    w = p["conv_w"].to(dt)                              # (K, C)
    if prev is None:
        prev = torch.zeros((xbc.shape[0], CONV_K - 1, xbc.shape[-1]),
                           dtype=dt, device=xbc.device)
    xp = torch.cat([prev, xbc], dim=1)                  # (B, S+K−1, C)
    S = xbc.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(CONV_K))
    return F.silu(out + p["conv_b"].to(dt)), xp[:, -(CONV_K - 1):]


def ssd_chunked(x, dt_h, A, Bm, Cm, state):
    """x (B,S,H,P); dt_h (B,S,H) post-softplus; A (H,) ≤ 0 log-decay rate;
    Bm/Cm (B,S,N); state (B,H,N,P) f32; S a multiple of CHUNK.  Returns
    (y in x's dtype, new state f32)."""
    Bsz, S, H, Pd = x.shape
    assert S % CHUNK == 0
    dt = x.dtype
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                device=x.device))
    h = state
    ys = []
    for c0 in range(0, S, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        xx = x[:, sl].float()                           # (B,c,H,P)
        dd = dt_h[:, sl].float()                        # (B,c,H)
        BB = Bm[:, sl].float()                          # (B,c,N)
        CC = Cm[:, sl].float()
        cumA = torch.cumsum(dd * A[None, None, :], dim=1)   # inclusive, ≤ 0
        # decay kernel L[t,j] = e^{cumA_t − cumA_j}, j ≤ t (≤ 1 always)
        L = torch.exp(cumA[:, :, None, :] - cumA[:, None, :, :])  # (B,c,c,H)
        L = torch.where(tri[None, :, :, None], L, 0.0)
        # scores (C_t · B_j) shared across heads (one group)
        G = torch.einsum("btn,bjn->btj", CC, BB)
        M = G[..., None] * L                            # (B,c,c,H)
        y = torch.einsum("btjh,bjhp->bthp", M * dd[:, None], xx)
        # inter-chunk: y += C_t · e^{cumA_t} · h
        y = y + (torch.einsum("btn,bhnp->bthp", CC, h)
                 * torch.exp(cumA)[..., None])
        # h' = e^{cumA_last}·h + Σ_j e^{cumA_last − cumA_j}·dt_j·B_j ⊗ x_j
        decay_out = torch.exp(cumA[:, -1:, :] - cumA)   # (B,c,H) ≤ 1
        h = (torch.exp(cumA[:, -1])[:, :, None, None] * h
             + torch.einsum("bjn,bjhp->bhnp", BB,
                            xx * (decay_out * dd)[..., None]))
        ys.append(y.to(dt))
    return torch.cat(ys, dim=1), h


def _gated_norm(p, y, z):
    """Mamba2's norm(y)·silu(z): RMSNorm with scale ``norm_scale`` (the
    (1 + w) form with w = norm_scale − 1)."""
    return layers.rmsnorm({"scale": p["norm_scale"] - 1.0}, y) * F.silu(z)


def mamba_layer(p: dict, x: torch.Tensor, d_model: int, d_state: int,
                head_dim: int = 64, expand: int = 2,
                state: Optional[MambaState] = None):
    """Full-sequence Mamba2 mixer.  x (B,S,d) → (y, new state)."""
    B_, S, _ = x.shape
    z, xbc, dtp, d_inner, H = _split_proj(p, x, d_model, d_state, head_dim,
                                          expand)
    xbc, conv_tail = _causal_conv(p, xbc,
                                  None if state is None else state.conv)
    xs, Bm, Cm = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    xs = xs.reshape(B_, S, H, head_dim)
    dt_h = F.softplus(dtp.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    pad = (-S) % CHUNK
    xs_p, dt_p, B_p, C_p = xs, dt_h, Bm, Cm
    if pad:
        xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt_p = F.pad(dt_h, (0, 0, 0, pad))
        B_p = F.pad(Bm, (0, 0, 0, pad))
        C_p = F.pad(Cm, (0, 0, 0, pad))
    ssm0 = (torch.zeros((B_, H, d_state, head_dim), dtype=torch.float32,
                        device=x.device) if state is None else state.ssm)
    y, ssm = ssd_chunked(xs_p, dt_p, A, B_p, C_p, ssm0)
    y = y[:, :S] + p["D"].to(y.dtype)[None, None, :, None] * xs
    y = _gated_norm(p, y.reshape(B_, S, d_inner), z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, MambaState(ssm=ssm, conv=conv_tail)


def mamba_decode(p: dict, x: torch.Tensor, state: MambaState, d_model: int,
                 d_state: int, head_dim: int = 64, expand: int = 2):
    """One step of the recurrence.  x (B,1,d) → (y, new state)."""
    B_ = x.shape[0]
    z, xbc, dtp, d_inner, H = _split_proj(p, x, d_model, d_state, head_dim,
                                          expand)
    xbc, conv_tail = _causal_conv(p, xbc, state.conv)
    xs, Bm, Cm = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    xs32 = xs.reshape(B_, H, head_dim).float()
    dt_h = F.softplus(dtp.float() + p["dt_bias"].float())[:, 0]     # (B,H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt_h * A[None, :])                               # (B,H)
    B32 = Bm[:, 0].float()                                          # (B,N)
    C32 = Cm[:, 0].float()
    dBx = B32[:, None, :, None] * (dt_h[..., None] * xs32)[:, :, None, :]
    h_new = dA[:, :, None, None] * state.ssm + dBx
    y = torch.einsum("bn,bhnp->bhp", C32, h_new)
    y = y + p["D"].float()[None, :, None] * xs32
    y = _gated_norm(p, y.reshape(B_, 1, d_inner).to(x.dtype), z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, MambaState(ssm=h_new, conv=conv_tail)
