"""GQA attention: causal / sliding-window, prefill and cached decode.
Port of ``repro/models/attention.py``.

Prefill attention is either query-chunked (``impl="naive"``: scores are
materialised per (q_chunk × kv) tile, and sliding-window layers read only a
(W + q_chunk) KV slice per chunk) or the flash attention kernel
(``impl="flash"``, self-attention with a causal mask): on the card
``kernels/flash_attention.py``, on the CPU its plain version.  The JAX
package's flash path is its jnp twin ``models/flash_xla.flash_mha``; on a
TPU its config names the Pallas kernel this one replaces.

Cross and non-causal attention take the query-chunked path whatever
``impl`` is, as in the JAX package, whose flash path serves causal
self-attention only.

Decode reads a pre-allocated KV cache ring.  ``decode_step`` writes the new
token's K and V into the cache in place (the JAX package returns a new
cache); the returned ``KVCache`` holds the same tensors.  Cross-attention
decodes against a K/V set computed once (``precompute_cross_kv``,
``cross_decode``).  The mesh resharding (``batch_tp``) is not ported
(ROADMAP.md, queue A item 16).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 1e4
    pos: str = "rope"            # rope | none (positions baked into embeds)
    sliding_window: int = 0      # 0 → full causal
    causal: bool = True
    q_chunk: int = 1024
    impl: str = "naive"          # naive | flash
    batch_tp: bool = False       # mesh resharding: not ported (A.16)


def init_attn_params(gen, cfg: AttnConfig, param_dtype, device,
                     kv_input_dim: Optional[int] = None, lead=()) -> dict:
    """Weights with leading axes ``lead`` (a layer stack)."""
    d, H, Hk, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d_kv_in = kv_input_dim if kv_input_dim is not None else d
    lead = tuple(lead)
    nl = len(lead)

    def dense(shape, in_axis=0):
        axes = (in_axis,) if isinstance(in_axis, int) else in_axis
        return layers.dense_init(gen, lead + shape, param_dtype, device,
                                 tuple(a + nl for a in axes))
    p = {"wq": dense((d, H, Dh)), "wk": dense((d_kv_in, Hk, Dh)),
         "wv": dense((d_kv_in, Hk, Dh)), "wo": dense((H, Dh, d), (0, 1))}
    if cfg.qkv_bias:
        dt = layers.dtype_of(param_dtype)
        for name, heads in (("bq", H), ("bk", Hk), ("bv", Hk)):
            p[name] = torch.zeros(lead + (heads, Dh), dtype=dt,
                                  device=device)
    return p


def _proj(x, w):
    """x (B, S, d) · w (d, h, k) → (B, S, h, k)."""
    d, h, kd = w.shape
    return (x @ w.reshape(d, h * kd).to(x.dtype)).reshape(*x.shape[:2], h, kd)


def _out(o, w, dtype):
    """o (B, S, H, Dh) · wo (H, Dh, d) → (B, S, d)."""
    H, Dh, d = w.shape
    return o.reshape(*o.shape[:2], H * Dh) @ w.reshape(H * Dh, d).to(dtype)


def _project_qkv(p, cfg: AttnConfig, x, kv_x, q_pos, kv_pos):
    dt = x.dtype
    q = _proj(x, p["wq"])
    k = _proj(kv_x, p["wk"])
    v = _proj(kv_x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.pos == "rope":
        q = layers.apply_rope(q, q_pos, cfg.rope_theta)
        k = layers.apply_rope(k, kv_pos, cfg.rope_theta)
    return q, k, v


def _sdpa_chunk(q, k, v, mask, scale):
    """q (B,C,H,Dh), k/v (B,Skv,Hk,Dh) with GQA broadcast; mask (B,C,Skv) or
    None.  f32 logits and probabilities, output in q's dtype."""
    B, C, H, Dh = q.shape
    Hk = k.shape[2]
    rep = H // Hk
    qg = q.reshape(B, C, Hk, rep, Dh)
    logits = torch.einsum("bchrk,bshk->bhrcs", qg.float() * scale, k.float())
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrcs,bshk->bchrk", probs, v.float())
    return out.reshape(B, C, H, Dh).to(q.dtype)


def attend_full(p: dict, cfg: AttnConfig, x: torch.Tensor,
                positions: torch.Tensor,
                kv_x: Optional[torch.Tensor] = None,
                kv_positions: Optional[torch.Tensor] = None,
                return_kv: bool = False):
    """Prefill attention over a full sequence.  x (B, S, d); kv_x given ⇒
    cross-attention (no causal mask, no window).  ``return_kv`` ⇒ returns
    (out, (k, v)) for the prefill cache."""
    if cfg.batch_tp:
        raise NotImplementedError("attention batch resharding (batch_tp) "
                                  "needs the mesh slice (ROADMAP.md, queue "
                                  "A item 16)")
    B, S, _ = x.shape
    cross = kv_x is not None
    kv_x = x if kv_x is None else kv_x
    kv_positions = positions if kv_positions is None else kv_positions
    Skv = kv_x.shape[1]
    scale = 1.0 / math.sqrt(cfg.head_dim)

    q, k, v = _project_qkv(p, cfg, x, kv_x, positions, kv_positions)

    if cfg.impl == "flash" and not cross and cfg.causal:
        # index-order masks, as the JAX package's flash path: every
        # self-attention call site uses arange positions
        out = ops.flash_attention(q, k, v, causal=True,
                                  window=cfg.sliding_window)
    else:
        cq = min(cfg.q_chunk, S)
        windowed = (cfg.sliding_window > 0 and cfg.causal and not cross
                    and Skv > cfg.sliding_window + cq)
        kv_len = -(-(cfg.sliding_window + cq) // cq) * cq if windowed else 0
        outs = []
        for c in range(-(-S // cq)):
            if windowed:
                start = min(max(c * cq + cq - kv_len, 0), Skv - kv_len)
                sl = slice(start, start + kv_len)
                kc, vc, kidx = k[:, sl], v[:, sl], kv_positions[:, sl]
            else:
                kc, vc, kidx = k, v, kv_positions
            qc = q[:, c * cq:(c + 1) * cq]
            pc = positions[:, c * cq:(c + 1) * cq]
            if cross or not cfg.causal:
                mask = None
            else:
                mask = kidx[:, None, :] <= pc[:, :, None]          # causal
                if cfg.sliding_window > 0:
                    mask &= kidx[:, None, :] > pc[:, :, None] - cfg.sliding_window
            outs.append(_sdpa_chunk(qc, kc, vc, mask, scale))
        out = torch.cat(outs, dim=1)
    y = _out(out, p["wo"], x.dtype)
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# cached decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor        # (B, S_max, Hk, Dh)
    v: torch.Tensor        # (B, S_max, Hk, Dh)
    length: torch.Tensor   # () int32 — tokens currently in cache


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int, dtype,
                  device=None) -> KVCache:
    eff = (min(max_len, cfg.sliding_window) if cfg.sliding_window > 0
           else max_len)
    shape = (batch, eff, cfg.n_kv_heads, cfg.head_dim)
    dt = layers.dtype_of(dtype)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


def decode_step(p: dict, cfg: AttnConfig, x: torch.Tensor, pos: torch.Tensor,
                cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """One-token decode.  x (B, 1, d), pos (B, 1) absolute positions.  The
    new K and V are written into ``cache``'s tensors in place."""
    B = x.shape[0]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k_new, v_new = _project_qkv(p, cfg, x, x, pos, pos)

    S_max = cache.k.shape[1]
    slot = torch.remainder(cache.length, S_max).reshape(1).long()
    k = cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    v = cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
    new_len = cache.length + 1

    # ring-aware slot→token map: slot i holds the latest token t ≡ i
    # (mod S_max) with t < new_len; negative values mark unwritten slots
    idx = torch.arange(S_max, device=x.device)
    tok_pos = idx + torch.div(new_len - 1 - idx, S_max,
                              rounding_mode="floor") * S_max
    valid = (tok_pos >= 0) & (tok_pos < new_len)
    if cfg.sliding_window > 0:
        valid &= tok_pos > (pos[:, 0].max() - cfg.sliding_window)

    mask = valid[None, None, :].expand(B, 1, S_max)
    out = _sdpa_chunk(q, k, v, mask, scale)
    y = _out(out, p["wo"], x.dtype)
    return y, KVCache(k=k, v=v, length=new_len)


def cross_decode(p: dict, cfg: AttnConfig, x: torch.Tensor,
                 kv_k: torch.Tensor, kv_v: torch.Tensor) -> torch.Tensor:
    """Attention of x (B, S, d) over a fixed (precomputed) cross-attention
    K/V set (B, N, Hk, Dh): no mask, no positions."""
    scale = 1.0 / math.sqrt(cfg.head_dim)
    dt = x.dtype
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    out = _sdpa_chunk(q, kv_k, kv_v, None, scale)
    return _out(out, p["wo"], dt)


def precompute_cross_kv(p: dict, cfg: AttnConfig, kv_x: torch.Tensor):
    """The cross-attention K and V (B, N, Hk, Dh) of kv_x (B, N, d)."""
    dt = kv_x.dtype
    k = _proj(kv_x, p["wk"])
    v = _proj(kv_x, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return k, v
