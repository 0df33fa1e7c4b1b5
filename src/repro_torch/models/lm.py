"""LM assembly for the ten archs.  Port of ``repro/models/lm.py``.

Every family of the JAX package, with its pattern units:

  dense / moe / audio : uniform units of 1 layer
  gemma3 (local:global): units of (5 sliding-local + 1 global) + local tail
  vlm                 : units of (4 self-attn + 1 gated cross-attn)
  ssm (rwkv6)         : uniform RWKV6 time-mix/channel-mix units
  hybrid (zamba2)     : units of (6 mamba2 + shared transformer block) + tail

The parameter tree is the JAX package's: the same keys, every layer stack
under ``segments/`` with leading stack axes (``unit/local`` is (units,
5, ...)).  The JAX package scans over those axes; the port unbinds them
once and loops over the layers in Python, so a stack's gradient is
gathered by one stack, not by a scatter a layer.  ``cfg.remat`` means what
it means in the JAX package: while autograd records, each scanned body
(a layer, or a whole pattern unit) and each cross-entropy chunk runs under
``torch.utils.checkpoint`` and is recomputed in the backward (on the card
the flash and WKV forward kernels then launch twice).  Attention's mesh
resharding (``attn_batch_tp``) raises ``NotImplementedError`` (ROADMAP.md,
queue A item 16).

  init_params(cfg, key, device)          → params
  forward(cfg, params, batch)            → (hidden, aux_loss)
  loss(cfg, params, batch)               → (scalar, metrics)   # chunked CE
  init_cache(cfg, B, max_len, dtype, device) → cache dict
  prefill(cfg, params, batch, max_len)   → (last_logits, cache)
  decode_step(cfg, params, cache, batch) → (logits, cache)     # 1 token

``batch`` dict keys: tokens (B,S) int | frames (B,S,d) [audio stub] |
img_embeds (B,N,d) [vlm stub] | labels (B,S) int (loss only).
``decode_step`` updates the cache's tensors in place and returns a new dict
holding them (the JAX package returns a new cache).  Logits are f32; under a
bfloat16 compute dtype the head's product is rounded to bfloat16 before the
upcast (the JAX package accumulates into f32 directly), at most 2⁻⁸ of each
logit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention, layers, mamba2
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6

MOE_AUX_COEF = 0.01


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------

def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run: attention's mesh resharding."""
    if cfg.attn_batch_tp:
        raise NotImplementedError(
            f"{cfg.name}: attention batch resharding (attn_batch_tp) needs "
            "the mesh slice (ROADMAP.md, queue A item 16)")


def _attn_cfg(cfg: ModelConfig, *, window: int = 0, theta: float = 0.0,
              d_model: int = 0, causal: bool = True) -> attention.AttnConfig:
    return attention.AttnConfig(
        d_model=d_model or cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=theta or cfg.rope_theta,
        pos="rope" if cfg.pos == "rope" else "none",
        sliding_window=window, causal=causal, q_chunk=cfg.q_chunk,
        impl=cfg.attn_impl, batch_tp=cfg.attn_batch_tp)


def _cross_attn_cfg(cfg: ModelConfig) -> attention.AttnConfig:
    """Cross-attn: no causal mask, no RoPE (llama-3.2-vision style)."""
    return attention.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias, pos="none",
        causal=False, q_chunk=cfg.q_chunk)


def _norm_fns(cfg: ModelConfig):
    return layers.make_norm(cfg.norm)


def _uniform(cfg: ModelConfig) -> bool:
    """Units of one attention layer (dense without gemma's pattern, moe,
    audio)."""
    return cfg.family in ("dense", "moe", "audio") and not cfg.local_per_global


def _thetas(cfg: ModelConfig):
    """gemma's (local, global) RoPE theta."""
    return cfg.rope_theta, cfg.rope_theta_global or cfg.rope_theta


def gemma_units(cfg: ModelConfig):
    """(n_units, n_tail) for the (local×k + global) pattern."""
    unit = cfg.local_per_global + 1
    return cfg.n_layers // unit, cfg.n_layers % unit


def zamba_units(cfg: ModelConfig):
    unit = cfg.shared_attn_every
    return cfg.n_layers // unit, cfg.n_layers % unit


def vlm_units(cfg: ModelConfig):
    unit = cfg.cross_every
    assert cfg.n_layers % unit == 0
    return cfg.n_layers // unit, unit - 1   # (n_units, self-layers per unit)


def tree_to(tree, device):
    """A nested dict of tensors or numpy arrays as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    return tree.to(device)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked subtree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind_layers(tree, n: int) -> list:
    """The ``n`` layers of a stacked subtree, each leaf unbound once along
    its leading axis (views; the backward stacks the layers' gradients in
    one pass)."""
    def walk(t):
        if isinstance(t, dict):
            parts = {k: walk(v) for k, v in t.items()}
            return [{k: parts[k][i] for k in parts} for i in range(n)]
        return t.unbind(0)
    return walk(tree)


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``
    and autograd records (JAX's ``jax.checkpoint``)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, key: int = 0, device=None) -> dict:
    """Random weights from seed ``key``, drawn on ``device`` (``None``: the
    CUDA device, raising without one; ``"meta"``: shapes only).  The draws
    are not ``jax.random``'s; the tree's keys and shapes are the JAX
    package's."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = layers.generator(key, device)
    pdt = cfg.param_dtype
    norm_init, _ = _norm_fns(cfg)
    d = cfg.d_model

    def norm(lead=(), width=d):
        return {k: v.expand(tuple(lead) + v.shape).clone()
                for k, v in norm_init(width, pdt, device).items()}

    def attn_layer(lead, width=d):
        """ln1, attn, ln2 and the FFN (moe or mlp) at model width
        ``width``, stacked over ``lead``."""
        p = {"ln1": norm(lead, width),
             "attn": attention.init_attn_params(
                 gen, _attn_cfg(cfg, d_model=width), pdt, device, lead=lead),
             "ln2": norm(lead, width)}
        if cfg.family == "moe":
            p["moe"] = moe_mod.init_moe_params(gen, d, cfg.d_ff,
                                               cfg.n_experts, cfg.glu, pdt,
                                               device, lead=lead)
        else:
            p["mlp"] = mlp_mod.init_mlp_params(gen, width, cfg.d_ff, cfg.glu,
                                               pdt, device, lead=lead)
        return p

    def cross_layer(lead):
        p = {"ln1": norm(lead),
             "attn": attention.init_attn_params(
                 gen, _attn_cfg(cfg, causal=False), pdt, device, lead=lead),
             "ln2": norm(lead),
             "mlp": mlp_mod.init_mlp_params(gen, d, cfg.d_ff, cfg.glu, pdt,
                                            device, lead=lead)}
        for g in ("gate_attn", "gate_ffn"):
            p[g] = torch.zeros(lead, dtype=layers.dtype_of(pdt),
                               device=device)
        return p

    def mamba_layer(lead):
        return {"ln": norm(lead),
                "mamba": mamba2.init_mamba_params(
                    gen, d, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_expand,
                    pdt, device, lead=lead)}

    p: dict = {}
    if cfg.embed_inputs:
        p["tok_embed"] = layers.embed_init(gen, (cfg.vocab, d), pdt, device)
    seg: dict = {}
    if _uniform(cfg):
        seg["unit"] = attn_layer((cfg.n_layers,))
    elif cfg.local_per_global:                               # gemma3
        n_units, n_tail = gemma_units(cfg)
        seg["unit"] = {"local": attn_layer((n_units, cfg.local_per_global)),
                       "global": attn_layer((n_units,))}
        if n_tail:
            seg["tail"] = attn_layer((n_tail,))
    elif cfg.family == "vlm":
        n_units, n_self = vlm_units(cfg)
        seg["unit"] = {"self": attn_layer((n_units, n_self)),
                       "cross": cross_layer((n_units,))}
    elif cfg.family == "ssm":
        L = (cfg.n_layers,)
        seg["unit"] = {"ln1": norm(L),
                       "tmix": rwkv6.init_rwkv_params(
                           gen, d, cfg.rwkv_head_dim, pdt, device, lead=L),
                       "ln2": norm(L),
                       "cmix": rwkv6.init_channel_mix_params(
                           gen, d, cfg.d_ff, pdt, device, lead=L)}
        p["ln0"] = norm()                                    # post-embed LN
    elif cfg.family == "hybrid":
        n_units, n_tail = zamba_units(cfg)
        seg["unit"] = {"mamba": mamba_layer((n_units,
                                             cfg.shared_attn_every))}
        if n_tail:
            seg["tail"] = mamba_layer((n_tail,))
        d2 = 2 * d                  # shared block over concat(x, x_embed)
        shared = attn_layer((), width=d2)
        shared["shared_proj"] = layers.dense_init(gen, (d2, d), pdt, device)
        p["shared"] = shared
    else:
        raise ValueError(cfg.family)
    p["segments"] = seg
    p["final_norm"] = norm()
    if not cfg.tied_embeddings and cfg.vocab:
        p["lm_head"] = layers.dense_init(gen, (d, cfg.vocab), pdt, device)
    return p


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Token embeddings (scaled by √d for tied and gemma archs) or the stub
    frontend's frames, plus sinusoidal positions where the arch has them."""
    check_supported(cfg)
    dt = layers.dtype_of(cfg.dtype)
    if cfg.embed_inputs:
        x = params["tok_embed"][batch["tokens"].long()].to(dt)
        if cfg.tied_embeddings or cfg.name.startswith("gemma"):
            # the factor rounded to the compute dtype first, as the JAX
            # package does; a Python scalar needs no host-to-device copy
            x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=dt))
    else:
        x = batch["frames"].to(dt)
    if cfg.pos == "sinusoidal":
        B, S = x.shape[:2]
        pos = batch.get("positions")
        if pos is None:
            pos = _positions(B, S, x.device)
        x = x + layers.sinusoidal_positions(pos, cfg.d_model).to(dt)
    return x


def head_matrix(cfg: ModelConfig, params: dict) -> torch.Tensor:
    """(d, V) projection — tied archs reuse the embedding."""
    if cfg.tied_embeddings:
        return params["tok_embed"].T
    return params["lm_head"]


def _logits(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    return (h @ head.to(h.dtype)).float()


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


# ---------------------------------------------------------------------------
# layer bodies (full sequence)
# ---------------------------------------------------------------------------

def _ffn(cfg: ModelConfig, p: dict, h):
    """The layer's FFN on h: (out, MoE aux loss or 0)."""
    if "moe" in p:
        return moe_mod.moe(p["moe"], h, cfg.experts_per_tok,
                           cfg.capacity_factor, cfg.act,
                           dispatch=cfg.moe_dispatch)
    return (mlp_mod.mlp(p["mlp"], h, cfg.act),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _attn_block(cfg: ModelConfig, p: dict, x, positions, *, window=0,
                theta=0.0, d_model=0, collect_kv=False):
    """(x, MoE aux loss, (k, v) when ``collect_kv``)."""
    _, norm = _norm_fns(cfg)
    acfg = _attn_cfg(cfg, window=window, theta=theta, d_model=d_model)
    a = attention.attend_full(p["attn"], acfg, norm(p["ln1"], x), positions,
                              return_kv=collect_kv)
    kv = None
    if collect_kv:
        a, kv = a
    x = x + a
    f, aux = _ffn(cfg, p, norm(p["ln2"], x))
    return x + f, aux, kv


def _gated(cfg: ModelConfig, p: dict, x, a):
    """The gated cross layer's two residual adds around its MLP."""
    _, norm = _norm_fns(cfg)
    dt = x.dtype
    x = x + torch.tanh(p["gate_attn"].to(dt)) * a
    f = mlp_mod.mlp(p["mlp"], norm(p["ln2"], x), cfg.act)
    return x + torch.tanh(p["gate_ffn"].to(dt)) * f


def _cross_block(cfg: ModelConfig, p: dict, x, img):
    """Gated cross-attention layer (training path, query-chunked)."""
    _, norm = _norm_fns(cfg)
    B, S = x.shape[:2]
    zpos = torch.zeros((B, img.shape[1]), dtype=torch.int32, device=x.device)
    a = attention.attend_full(p["attn"], _cross_attn_cfg(cfg),
                              norm(p["ln1"], x),
                              torch.zeros((B, S), dtype=torch.int32,
                                          device=x.device),
                              kv_x=img, kv_positions=zpos)
    return _gated(cfg, p, x, a)


def _cross_block_cached(cfg: ModelConfig, p: dict, x, img_kv):
    """Decode (and prefill) path against the precomputed cross K/V."""
    _, norm = _norm_fns(cfg)
    a = attention.cross_decode(p["attn"], _cross_attn_cfg(cfg),
                               norm(p["ln1"], x), img_kv[0], img_kv[1])
    return _gated(cfg, p, x, a)


def _img_kv(cfg: ModelConfig, p_cross: dict, img_embeds):
    """Cross-attn K/V from the (stub) image patch embeddings."""
    return attention.precompute_cross_kv(p_cross["attn"],
                                         _cross_attn_cfg(cfg), img_embeds)


def _rwkv_block(cfg: ModelConfig, p: dict, x,
                state: Optional[rwkv6.RWKVState]):
    _, norm = _norm_fns(cfg)
    B, _, d = x.shape
    if state is None:
        state = rwkv6.init_rwkv_state(B, d, cfg.rwkv_head_dim, x.dtype,
                                      x.device)
    o, sh_tm, wkv = rwkv6.time_mix(p["tmix"], norm(p["ln1"], x),
                                   state.shift_tm, state.wkv,
                                   cfg.rwkv_head_dim)
    x = x + o
    o, sh_cm = rwkv6.channel_mix(p["cmix"], norm(p["ln2"], x), state.shift_cm)
    x = x + o
    return x, rwkv6.RWKVState(wkv=wkv, shift_tm=sh_tm, shift_cm=sh_cm)


def _mamba_block(cfg: ModelConfig, p: dict, x,
                 state: Optional[mamba2.MambaState]):
    _, norm = _norm_fns(cfg)
    o, new_state = mamba2.mamba_layer(
        p["mamba"], norm(p["ln"], x), cfg.d_model, cfg.ssm_state,
        cfg.ssm_head_dim, cfg.ssm_expand, state)
    return x + o, new_state


def _shared_tail(cfg: ModelConfig, sp: dict, x, h2, a):
    """The zamba2 shared block after its attention: MLP at width 2d, then
    projected back onto the residual stream x."""
    _, norm = _norm_fns(cfg)
    h2 = h2 + a
    h2 = h2 + mlp_mod.mlp(sp["mlp"], norm(sp["ln2"], h2), cfg.act)
    return x + h2 @ sp["shared_proj"].to(x.dtype)


def _shared_block(cfg: ModelConfig, sp: dict, x, x0, positions,
                  collect_kv=False):
    """Zamba2 shared block: full transformer at width 2d over
    concat(x, x0), projected back.  (x, (k, v) when ``collect_kv``)."""
    _, norm = _norm_fns(cfg)
    acfg = _attn_cfg(cfg, d_model=2 * cfg.d_model)
    h2 = torch.cat([x, x0], dim=-1)
    a = attention.attend_full(sp["attn"], acfg, norm(sp["ln1"], h2),
                              positions, return_kv=collect_kv)
    kv = None
    if collect_kv:
        a, kv = a
    return _shared_tail(cfg, sp, x, h2, a), kv


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: dict, batch: dict):
    """Full-sequence forward.  Returns (hidden (B,S,d), MoE aux loss)."""
    x = embed(cfg, params, batch)
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(B, S, x.device)
    seg = params["segments"]
    _, norm = _norm_fns(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if _uniform(cfg):
        def body(lp, x):
            x, a, _ = _attn_block(cfg, lp, x, positions)
            return x, a
        for lp in _unbind_layers(seg["unit"], cfg.n_layers):
            x, a = _remat(cfg, body, lp, x)
            aux = aux + a

    elif cfg.local_per_global:                                # gemma3
        n_units, n_tail = gemma_units(cfg)
        th_local, th_global = _thetas(cfg)

        def local(lp, x):
            return _attn_block(cfg, lp, x, positions,
                               window=cfg.sliding_window, theta=th_local)[0]

        def unit_body(up, x):
            for lp in _unbind_layers(up["local"], cfg.local_per_global):
                x = local(lp, x)
            return _attn_block(cfg, up["global"], x, positions,
                               theta=th_global)[0]
        for up in _unbind_layers(seg["unit"], n_units):
            x = _remat(cfg, unit_body, up, x)
        if n_tail:
            for lp in _unbind_layers(seg["tail"], n_tail):
                x = _remat(cfg, local, lp, x)

    elif cfg.family == "vlm":
        n_units, n_self = vlm_units(cfg)
        img = batch["img_embeds"].to(x.dtype)

        def unit_body(up, x):
            for lp in _unbind_layers(up["self"], n_self):
                x = _attn_block(cfg, lp, x, positions)[0]
            return _cross_block(cfg, up["cross"], x, img)
        for up in _unbind_layers(seg["unit"], n_units):
            x = _remat(cfg, unit_body, up, x)

    elif cfg.family == "ssm":
        x = norm(params["ln0"], x)

        def body(lp, x):
            return _rwkv_block(cfg, lp, x, None)[0]
        for lp in _unbind_layers(seg["unit"], cfg.n_layers):
            x = _remat(cfg, body, lp, x)

    elif cfg.family == "hybrid":
        n_units, n_tail = zamba_units(cfg)
        x0 = x

        def mamba(lp, x):
            return _mamba_block(cfg, lp, x, None)[0]

        def unit_body(up, x):
            for lp in _unbind_layers(up["mamba"], cfg.shared_attn_every):
                x = mamba(lp, x)
            return _shared_block(cfg, params["shared"], x, x0, positions)[0]
        for up in _unbind_layers(seg["unit"], n_units):
            x = _remat(cfg, unit_body, up, x)
        if n_tail:
            for lp in _unbind_layers(seg["tail"], n_tail):
                x = _remat(cfg, mamba, lp, x)
    else:
        raise ValueError(cfg.family)

    return norm(params["final_norm"], x), aux


# ---------------------------------------------------------------------------
# chunked cross-entropy (never materialises (B, S, V))
# ---------------------------------------------------------------------------

def chunked_ce(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
               labels: torch.Tensor):
    """Mean token NLL over ``logits_chunk`` slices of the sequence, f32
    log-sum-exp; labels < 0 are ignored.  Under ``cfg.remat`` each chunk's
    logits are recomputed in the backward."""
    head = head_matrix(cfg, params)                    # (d, V)
    S = hidden.shape[1]
    C = min(cfg.logits_chunk, S)
    labels = labels.long()

    def chunk_loss(h, y, head):
        logits = _logits(h, head)
        valid = y >= 0
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y.clamp(min=0)[..., None])[..., 0]
        return torch.where(valid, lse - gold, 0.0).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, C):
        total = total + _remat(cfg, chunk_loss, hidden[:, c0:c0 + C],
                               labels[:, c0:c0 + C], head)
    count = (labels >= 0).sum().float()
    return total / torch.clamp(count, min=1.0)


def loss(cfg: ModelConfig, params: dict, batch: dict):
    hidden, aux = forward(cfg, params, batch)
    ce = chunked_ce(cfg, params, hidden, batch["labels"])
    return ce + MOE_AUX_COEF * aux, {"ce": ce, "moe_aux": aux}


def logits_last(cfg: ModelConfig, params: dict, hidden: torch.Tensor):
    """(B, V) f32 logits of the final position."""
    return _logits(hidden[:, -1, :], head_matrix(cfg, params))


# ---------------------------------------------------------------------------
# KV / state caches
# ---------------------------------------------------------------------------

def _win(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_cache(cfg: ModelConfig, B: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Zeros of the JAX package's cache keys and shapes; the SSM and WKV
    states in f32, the rest in ``dtype`` (default the compute dtype)."""
    check_supported(cfg)
    dt = layers.dtype_of(dtype or cfg.dtype)
    device = resolve_device(device)
    f32 = torch.float32

    def z(shape, d=dt):
        return torch.zeros(shape, dtype=d, device=device)

    def kv(L):
        return (B, L, cfg.n_kv_heads, cfg.head_dim)
    cache: dict = {"length": z((), torch.int32)}
    if _uniform(cfg):
        cache["k"] = z((cfg.n_layers,) + kv(max_len))
        cache["v"] = z((cfg.n_layers,) + kv(max_len))
    elif cfg.local_per_global:
        n_units, n_tail = gemma_units(cfg)
        k, w = cfg.local_per_global, _win(cfg, max_len)
        cache["local_k"] = z((n_units, k) + kv(w))
        cache["local_v"] = z((n_units, k) + kv(w))
        cache["global_k"] = z((n_units,) + kv(max_len))
        cache["global_v"] = z((n_units,) + kv(max_len))
        if n_tail:
            cache["tail_k"] = z((n_tail,) + kv(w))
            cache["tail_v"] = z((n_tail,) + kv(w))
    elif cfg.family == "vlm":
        n_units, n_self = vlm_units(cfg)
        img = (B, cfg.n_img_tokens, cfg.n_kv_heads, cfg.head_dim)
        cache["self_k"] = z((n_units, n_self) + kv(max_len))
        cache["self_v"] = z((n_units, n_self) + kv(max_len))
        cache["cross_k"] = z((n_units,) + img)
        cache["cross_v"] = z((n_units,) + img)
    elif cfg.family == "ssm":
        L, d, Dh = cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim
        cache["wkv"] = z((L, B, d // Dh, Dh, Dh), f32)
        cache["shift_tm"] = z((L, B, d))
        cache["shift_cm"] = z((L, B, d))
    elif cfg.family == "hybrid":
        n_units, n_tail = zamba_units(cfg)
        u = cfg.shared_attn_every
        d_in = cfg.ssm_expand * cfg.d_model
        ssm = (B, d_in // cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_head_dim)
        conv = (B, mamba2.CONV_K - 1, d_in + 2 * cfg.ssm_state)
        cache["ssm"] = z((n_units, u) + ssm, f32)
        cache["conv"] = z((n_units, u) + conv)
        cache["shared_k"] = z((n_units,) + kv(max_len))
        cache["shared_v"] = z((n_units,) + kv(max_len))
        cache["x0"] = z((B, cfg.d_model))           # embedding residual
        if n_tail:
            cache["tail_ssm"] = z((n_tail,) + ssm, f32)
            cache["tail_conv"] = z((n_tail,) + conv)
    else:
        raise ValueError(cfg.family)
    return cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _pad_to(x, L: int, axis: int):
    """``x`` cut or zero-padded to length L along ``axis``."""
    n = x.shape[axis]
    if n >= L:
        return x.narrow(axis, 0, L)
    pad = [0, 0] * (x.dim() - 1 - axis) + [0, L - n]
    return torch.nn.functional.pad(x, pad)


def _window_tail(kv, w: int):
    """Keep the last min(S, w) positions, padded or rolled into a w-ring:
    slot i holds token t ≡ i (mod w), as ``attention.decode_step`` reads
    it."""
    k, v = kv
    S = k.shape[1]
    if S <= w:
        return _pad_to(k, w, 1), _pad_to(v, w, 1)
    shift = (S - w) % w                 # the slot of the first kept token
    return (torch.roll(k[:, S - w:], shift, dims=1),
            torch.roll(v[:, S - w:], shift, dims=1))


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int):
    """Run the full prompt, returning (last-position logits, primed cache)."""
    x = embed(cfg, params, batch)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    seg = params["segments"]
    cache = init_cache(cfg, B, max_len, device=x.device)
    cache["length"].fill_(S)
    _, norm = _norm_fns(cfg)

    def put(name, idx, kv, ring=False):
        k, v = (_window_tail(kv, _win(cfg, max_len)) if ring
                else (_pad_to(kv[0], max_len, 1), _pad_to(kv[1], max_len, 1)))
        cache[f"{name}k"][idx] = k
        cache[f"{name}v"][idx] = v

    if _uniform(cfg):
        for i in range(cfg.n_layers):
            x, _, kv = _attn_block(cfg, _layer(seg["unit"], i), x, positions,
                                   collect_kv=True)
            put("", i, kv)

    elif cfg.local_per_global:
        n_units, n_tail = gemma_units(cfg)
        th_local, th_global = _thetas(cfg)
        for u in range(n_units):
            up = _layer(seg["unit"], u)
            for i in range(cfg.local_per_global):
                x, _, kv = _attn_block(cfg, _layer(up["local"], i), x,
                                       positions, window=cfg.sliding_window,
                                       theta=th_local, collect_kv=True)
                put("local_", (u, i), kv, ring=True)
            x, _, kv = _attn_block(cfg, up["global"], x, positions,
                                   theta=th_global, collect_kv=True)
            put("global_", u, kv)
        for i in range(n_tail):
            x, _, kv = _attn_block(cfg, _layer(seg["tail"], i), x, positions,
                                   window=cfg.sliding_window, theta=th_local,
                                   collect_kv=True)
            put("tail_", i, kv, ring=True)

    elif cfg.family == "vlm":
        n_units, n_self = vlm_units(cfg)
        img = batch["img_embeds"].to(x.dtype)
        for u in range(n_units):
            up = _layer(seg["unit"], u)
            for i in range(n_self):
                x, _, kv = _attn_block(cfg, _layer(up["self"], i), x,
                                       positions, collect_kv=True)
                put("self_", (u, i), kv)
            ckv = _img_kv(cfg, up["cross"], img)
            x = _cross_block_cached(cfg, up["cross"], x, ckv)
            cache["cross_k"][u], cache["cross_v"][u] = ckv

    elif cfg.family == "ssm":
        x = norm(params["ln0"], x)
        for i in range(cfg.n_layers):
            x, st = _rwkv_block(cfg, _layer(seg["unit"], i), x, None)
            cache["wkv"][i] = st.wkv
            cache["shift_tm"][i] = st.shift_tm
            cache["shift_cm"][i] = st.shift_cm

    elif cfg.family == "hybrid":
        n_units, n_tail = zamba_units(cfg)
        x0 = x
        cache["x0"].copy_(x0[:, -1, :])
        for u in range(n_units):
            up = _layer(seg["unit"], u)
            for i in range(cfg.shared_attn_every):
                x, st = _mamba_block(cfg, _layer(up["mamba"], i), x, None)
                cache["ssm"][u, i] = st.ssm
                cache["conv"][u, i] = st.conv
            x, kv = _shared_block(cfg, params["shared"], x, x0, positions,
                                  collect_kv=True)
            put("shared_", u, kv)
        for i in range(n_tail):
            x, st = _mamba_block(cfg, _layer(seg["tail"], i), x, None)
            cache["tail_ssm"][i] = st.ssm
            cache["tail_conv"][i] = st.conv
    else:
        raise ValueError(cfg.family)

    hidden = norm(params["final_norm"], x)
    return logits_last(cfg, params, hidden), cache


# ---------------------------------------------------------------------------
# decode (one token)
# ---------------------------------------------------------------------------

def _dec_attn(cfg: ModelConfig, p, x, pos, k, v, length, *, window=0,
              theta=0.0, d_model=0):
    """One layer's decode step; the layer's cache ``k``, ``v`` is written
    in place."""
    _, norm = _norm_fns(cfg)
    acfg = _attn_cfg(cfg, window=window, theta=theta, d_model=d_model)
    kvc = attention.KVCache(k=k, v=v, length=length)
    a, _ = attention.decode_step(p["attn"], acfg, norm(p["ln1"], x), pos,
                                 kvc)
    x = x + a
    return x + _ffn(cfg, p, norm(p["ln2"], x))[0]


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """One-token step.  batch: {"tokens": (B,1)} or {"frames": (B,1,d)}.
    Returns ((B, V) logits, cache); the cache's tensors are updated in
    place."""
    length = cache["length"]
    x = embed(cfg, params, dict(batch, positions=None))
    B = x.shape[0]
    pos = length.reshape(1, 1).expand(B, 1).to(torch.int32)
    if cfg.pos == "sinusoidal":                     # embed() used position 0
        zero = torch.zeros((B, 1), dtype=torch.int32, device=x.device)
        x = x - layers.sinusoidal_positions(zero, cfg.d_model).to(x.dtype)
        x = x + layers.sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    seg = params["segments"]
    new = dict(cache)
    _, norm = _norm_fns(cfg)

    if _uniform(cfg):
        for i in range(cfg.n_layers):
            x = _dec_attn(cfg, _layer(seg["unit"], i), x, pos,
                          cache["k"][i], cache["v"][i], length)

    elif cfg.local_per_global:
        n_units, n_tail = gemma_units(cfg)
        th_local, th_global = _thetas(cfg)
        for u in range(n_units):
            up = _layer(seg["unit"], u)
            for i in range(cfg.local_per_global):
                x = _dec_attn(cfg, _layer(up["local"], i), x, pos,
                              cache["local_k"][u, i], cache["local_v"][u, i],
                              length, window=cfg.sliding_window,
                              theta=th_local)
            x = _dec_attn(cfg, up["global"], x, pos, cache["global_k"][u],
                          cache["global_v"][u], length, theta=th_global)
        for i in range(n_tail):
            x = _dec_attn(cfg, _layer(seg["tail"], i), x, pos,
                          cache["tail_k"][i], cache["tail_v"][i], length,
                          window=cfg.sliding_window, theta=th_local)

    elif cfg.family == "vlm":
        n_units, n_self = vlm_units(cfg)
        for u in range(n_units):
            up = _layer(seg["unit"], u)
            for i in range(n_self):
                x = _dec_attn(cfg, _layer(up["self"], i), x, pos,
                              cache["self_k"][u, i], cache["self_v"][u, i],
                              length)
            x = _cross_block_cached(cfg, up["cross"], x,
                                    (cache["cross_k"][u],
                                     cache["cross_v"][u]))

    elif cfg.family == "ssm":
        x = norm(params["ln0"], x)
        for i in range(cfg.n_layers):
            lp = _layer(seg["unit"], i)
            o, sh_tm, wkv = rwkv6.time_mix_decode(
                lp["tmix"], norm(lp["ln1"], x), cache["shift_tm"][i],
                cache["wkv"][i], cfg.rwkv_head_dim)
            x = x + o
            o, sh_cm = rwkv6.channel_mix(lp["cmix"], norm(lp["ln2"], x),
                                         cache["shift_cm"][i])
            x = x + o
            cache["wkv"][i] = wkv
            cache["shift_tm"][i] = sh_tm
            cache["shift_cm"][i] = sh_cm

    elif cfg.family == "hybrid":
        n_units, n_tail = zamba_units(cfg)
        x0 = x[:, 0, :]                      # the current token's embedding
        cache["x0"].copy_(x0)
        sp = params["shared"]
        acfg = _attn_cfg(cfg, d_model=2 * cfg.d_model)

        def mamba_dec(lp, x, ssm, conv):
            o, st = mamba2.mamba_decode(
                lp["mamba"], norm(lp["ln"], x),
                mamba2.MambaState(ssm=ssm, conv=conv), cfg.d_model,
                cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_expand)
            ssm.copy_(st.ssm)
            conv.copy_(st.conv)
            return x + o
        for u in range(n_units):
            up = _layer(seg["unit"], u)
            for i in range(cfg.shared_attn_every):
                x = mamba_dec(_layer(up["mamba"], i), x, cache["ssm"][u, i],
                              cache["conv"][u, i])
            # the shared block (width 2d) against its KV cache
            h2 = torch.cat([x, x0[:, None, :]], dim=-1)
            kvc = attention.KVCache(k=cache["shared_k"][u],
                                    v=cache["shared_v"][u], length=length)
            a, _ = attention.decode_step(sp["attn"], acfg,
                                         norm(sp["ln1"], h2), pos, kvc)
            x = _shared_tail(cfg, sp, x, h2, a)
        for i in range(n_tail):
            x = mamba_dec(_layer(seg["tail"], i), x, cache["tail_ssm"][i],
                          cache["tail_conv"][i])
    else:
        raise ValueError(cfg.family)

    hidden = norm(params["final_norm"], x)
    new["length"] = length + 1
    return logits_last(cfg, params, hidden), new
