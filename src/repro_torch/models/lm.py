"""LM assembly for the ported families.  Port of ``repro/models/lm.py``.

Two families are ported: ``dense`` without the gemma local/global pattern
(qwen2) and ``ssm`` (rwkv6).  The parameter tree is the JAX package's: the
same keys, every layer stack under ``segments/unit`` with a leading layer
axis.  The JAX package scans over that axis; the port unbinds it once and
loops over the layers in Python, so a stack's gradient is gathered by one
stack, not by a scatter a layer.  ``cfg.remat`` means what it means in the
JAX package: while autograd records, each layer and each cross-entropy
chunk runs under ``torch.utils.checkpoint`` and is recomputed in the
backward (on the card the flash and WKV forward kernels then launch twice
a layer).  The other families (``moe``, ``hybrid``, ``vlm``, ``audio``),
gemma's local/global pattern, sinusoidal positions and non-token inputs
raise ``NotImplementedError`` (ROADMAP.md, queue A item 14).

  init_params(cfg, key, device)          → params
  forward(cfg, params, batch)            → (hidden, aux_loss)
  loss(cfg, params, batch)               → (scalar, metrics)   # chunked CE
  init_cache(cfg, B, max_len, dtype, device) → cache dict
  prefill(cfg, params, batch, max_len)   → (last_logits, cache)
  decode_step(cfg, params, cache, batch) → (logits, cache)     # 1 token

``batch`` dict keys: tokens (B,S) int | labels (B,S) int (loss only).
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
from repro_torch.models import attention, layers, mlp as mlp_mod, rwkv6

MOE_AUX_COEF = 0.01


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------

def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run."""
    what = None
    if cfg.family not in ("dense", "ssm"):
        what = f"the {cfg.family!r} family"
    elif cfg.local_per_global:
        what = "gemma's local/global layer pattern"
    elif cfg.pos == "sinusoidal":
        what = "sinusoidal positions"
    elif not cfg.embed_inputs:
        what = "non-token inputs"
    if what is not None:
        raise NotImplementedError(f"{cfg.name}: {what} is not ported "
                                  "(ROADMAP.md, queue A item 14)")


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


def _norm_fns(cfg: ModelConfig):
    return layers.make_norm(cfg.norm)


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
    its layer axis (views; the backward stacks the layers' gradients in
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
    L, d = cfg.n_layers, cfg.d_model

    def norm(lead=()):
        return {k: v.expand(lead + v.shape).clone()
                for k, v in norm_init(d, pdt, device).items()}

    p: dict = {"tok_embed": layers.embed_init(gen, (cfg.vocab, d), pdt,
                                              device)}
    if cfg.family == "dense":
        unit = {"ln1": norm((L,)),
                "attn": attention.init_attn_params(gen, _attn_cfg(cfg), pdt,
                                                   device, lead=(L,)),
                "ln2": norm((L,)),
                "mlp": mlp_mod.init_mlp_params(gen, d, cfg.d_ff, cfg.glu, pdt,
                                               device, lead=(L,))}
    else:                                                    # ssm
        unit = {"ln1": norm((L,)),
                "tmix": rwkv6.init_rwkv_params(gen, d, cfg.rwkv_head_dim,
                                               pdt, device, lead=(L,)),
                "ln2": norm((L,)),
                "cmix": rwkv6.init_channel_mix_params(gen, d, cfg.d_ff, pdt,
                                                      device, lead=(L,))}
        p["ln0"] = norm()                                    # post-embed LN
    p["segments"] = {"unit": unit}
    p["final_norm"] = norm()
    if not cfg.tied_embeddings and cfg.vocab:
        p["lm_head"] = layers.dense_init(gen, (d, cfg.vocab), pdt, device)
    return p


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    check_supported(cfg)
    dt = layers.dtype_of(cfg.dtype)
    x = params["tok_embed"][batch["tokens"].long()].to(dt)
    if cfg.tied_embeddings or cfg.name.startswith("gemma"):
        # the factor rounded to the compute dtype first, as the JAX package
        # does; a Python scalar needs no host-to-device copy
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=dt))
    return x


def head_matrix(cfg: ModelConfig, params: dict) -> torch.Tensor:
    """(d, V) projection — tied archs reuse the embedding."""
    if cfg.tied_embeddings:
        return params["tok_embed"].T
    return params["lm_head"]


def _logits(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    return (h @ head.to(h.dtype)).float()


# ---------------------------------------------------------------------------
# layer bodies (full sequence)
# ---------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, p: dict, x, positions, *, collect_kv=False):
    _, norm = _norm_fns(cfg)
    a = attention.attend_full(p["attn"], _attn_cfg(cfg), norm(p["ln1"], x),
                              positions, return_kv=collect_kv)
    kv = None
    if collect_kv:
        a, kv = a
    x = x + a
    x = x + mlp_mod.mlp(p["mlp"], norm(p["ln2"], x), cfg.act)
    return x, kv


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


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: dict, batch: dict):
    """Full-sequence forward.  Returns (hidden (B,S,d), aux loss (0 here))."""
    x = embed(cfg, params, batch)
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(B, S, x.device)
    _, norm = _norm_fns(cfg)
    if cfg.family == "ssm":
        x = norm(params["ln0"], x)

    def dense_body(lp, x):
        return _attn_block(cfg, lp, x, positions)[0]

    def ssm_body(lp, x):
        return _rwkv_block(cfg, lp, x, None)[0]
    body = dense_body if cfg.family == "dense" else ssm_body
    for lp in _unbind_layers(params["segments"]["unit"], cfg.n_layers):
        x = _remat(cfg, body, lp, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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

def init_cache(cfg: ModelConfig, B: int, max_len: int, dtype=None,
               device=None) -> dict:
    check_supported(cfg)
    dt = layers.dtype_of(dtype or cfg.dtype)
    device = resolve_device(device)
    L = cfg.n_layers

    def z(shape, d=dt):
        return torch.zeros(shape, dtype=d, device=device)
    cache: dict = {"length": z((), torch.int32)}
    if cfg.family == "dense":
        kv = (L, B, max_len, cfg.n_kv_heads, cfg.head_dim)
        cache["k"], cache["v"] = z(kv), z(kv)
    else:
        d, Dh = cfg.d_model, cfg.rwkv_head_dim
        cache["wkv"] = z((L, B, d // Dh, Dh, Dh), torch.float32)
        cache["shift_tm"] = z((L, B, d))
        cache["shift_cm"] = z((L, B, d))
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


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int):
    """Run the full prompt, returning (last-position logits, primed cache)."""
    x = embed(cfg, params, batch)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    unit = params["segments"]["unit"]
    cache = init_cache(cfg, B, max_len, device=x.device)
    cache["length"].fill_(S)
    _, norm = _norm_fns(cfg)
    if cfg.family == "ssm":
        x = norm(params["ln0"], x)
    for i in range(cfg.n_layers):
        lp = _layer(unit, i)
        if cfg.family == "dense":
            x, (k, v) = _attn_block(cfg, lp, x, positions, collect_kv=True)
            cache["k"][i] = _pad_to(k, max_len, 1)
            cache["v"][i] = _pad_to(v, max_len, 1)
        else:
            x, st = _rwkv_block(cfg, lp, x, None)
            cache["wkv"][i] = st.wkv
            cache["shift_tm"][i] = st.shift_tm
            cache["shift_cm"][i] = st.shift_cm
    hidden = norm(params["final_norm"], x)
    return logits_last(cfg, params, hidden), cache


# ---------------------------------------------------------------------------
# decode (one token)
# ---------------------------------------------------------------------------

def _dec_attn(cfg: ModelConfig, p, x, pos, k, v, length):
    _, norm = _norm_fns(cfg)
    kvc = attention.KVCache(k=k, v=v, length=length)
    a, kvc = attention.decode_step(p["attn"], _attn_cfg(cfg),
                                   norm(p["ln1"], x), pos, kvc)
    x = x + a
    x = x + mlp_mod.mlp(p["mlp"], norm(p["ln2"], x), cfg.act)
    return x, kvc.k, kvc.v


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """One-token step.  batch: {"tokens": (B,1)}.  Returns ((B, V) logits,
    cache); the cache's tensors are updated in place."""
    length = cache["length"]
    x = embed(cfg, params, batch)
    B = x.shape[0]
    pos = length.reshape(1, 1).expand(B, 1).to(torch.int32)
    unit = params["segments"]["unit"]
    new = dict(cache)
    _, norm = _norm_fns(cfg)
    if cfg.family == "ssm":
        x = norm(params["ln0"], x)
    for i in range(cfg.n_layers):
        lp = _layer(unit, i)
        if cfg.family == "dense":
            x, _, _ = _dec_attn(cfg, lp, x, pos, cache["k"][i],
                                cache["v"][i], length)
        else:
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
    hidden = norm(params["final_norm"], x)
    new["length"] = length + 1
    return logits_last(cfg, params, hidden), new

