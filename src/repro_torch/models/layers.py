"""Shared model building blocks: norms, rotary and sinusoidal positions,
activations and parameter init.  Port of ``repro/models/layers.py``.

Parameters are plain nested dicts of tensors, with the JAX package's keys
and shapes.  Init draws from an explicit ``torch.Generator`` on the target
device (``None`` on the meta device, where nothing is drawn); the draws are
not ``jax.random``'s, so tests carry the JAX package's weights across
(``convert.lm_params``) instead of re-drawing them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def dtype_of(name) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``…) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else DTYPES[name]


def generator(seed: int, device) -> Optional[torch.Generator]:
    """The init draws' generator on ``device``; None on the meta device."""
    device = torch.device(device)
    if device.type == "meta":
        return None
    return torch.Generator(device).manual_seed(int(seed))


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen, shape, param_dtype, device, in_axis=0) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init (LeCun-style)."""
    axes = (in_axis,) if isinstance(in_axis, int) else in_axis
    fan_in = math.prod(shape[a] for a in axes)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (1.0 / math.sqrt(float(fan_in)))).to(dtype_of(param_dtype))


def embed_init(gen, shape, param_dtype, device) -> torch.Tensor:
    """(V, d) embedding, std 1/√d."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(0.0, shape[-1] ** -0.5, generator=gen)
    return t.to(dtype_of(param_dtype))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_params(d, param_dtype, device):
    return {"scale": torch.zeros((d,), dtype=dtype_of(param_dtype),
                                 device=device)}


def rmsnorm(params, x, eps: float = 1e-6, gemma_style: bool = True):
    """RMSNorm with (1 + w) scale (zeros-init), computed in f32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = params["scale"].float()
    y = y * (1.0 + w) if gemma_style else y * w
    return y.to(x.dtype)


def layernorm_params(d, param_dtype, device):
    dt = dtype_of(param_dtype)
    return {"scale": torch.ones((d,), dtype=dt, device=device),
            "bias": torch.zeros((d,), dtype=dt, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def make_norm(kind: str):
    """(init(d, param_dtype, device), apply(params, x))."""
    if kind == "rmsnorm":
        return rmsnorm_params, lambda p, x, eps=1e-6: rmsnorm(p, x, eps)
    if kind == "layernorm":
        return layernorm_params, lambda p, x, eps=1e-5: layernorm(p, x, eps)
    raise ValueError(kind)


def groupnorm_heads(x, scale, bias, eps: float = 64e-5):
    """Per-head GroupNorm over the channel dim (RWKV6 ln_x): x (..., H, D)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """1 / θ^(2i/D), i < D/2, in f32 (θ taken as an f32 scalar)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(torch.tensor(theta, dtype=torch.float32)),
                           exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (D/2,)
    ang = positions[..., None].float() * freqs                   # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """positions (B, S) → (B, S, d) classic transformer sin/cos table, f32."""
    half = d_model // 2
    log_base = float(torch.log(torch.tensor(10000.0, dtype=torch.float32)))
    freqs = torch.exp(-log_base * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# activation
# ---------------------------------------------------------------------------

def activation(name: str):
    """``jax.nn``'s activations; its ``gelu`` is the tanh approximation."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu,
            "sqrelu": lambda x: torch.square(F.relu(x))}[name]
