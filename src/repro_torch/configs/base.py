"""Model configuration: the port's copy of ``repro/configs/base.py``'s
``ModelConfig`` (the same fields, defaults, ``layer_pattern``,
``n_params`` and ``n_active_params``).  The JAX package's shape cells
(``ShapeSpec``, ``SHAPES``, ``cells_for``) belong to its dry-run and are
not copied."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int = 0                # 0 for attention-free archs
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    tied_embeddings: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "silu"
    glu: bool = True                # gated FFN (SwiGLU/GeGLU)
    pos: str = "rope"               # rope | sinusoidal | none
    rope_theta: float = 1e4
    rope_theta_global: float = 0.0  # gemma3 dual-theta (0 → same as local)
    # --- sliding/global interleave (gemma3) ----------------------------------
    sliding_window: int = 0         # 0 → all layers full attention
    local_per_global: int = 0       # e.g. 5 → pattern [5×local, 1×global]
    # --- MoE ------------------------------------------------------------------
    n_experts: int = 0
    experts_per_tok: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "global"    # global | rowwise
    # --- SSM / RWKV -------------------------------------------------------------
    ssm_state: int = 0              # mamba2 d_state
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    rwkv_head_dim: int = 64
    # --- hybrid (zamba2) ---------------------------------------------------------
    shared_attn_every: int = 0      # mamba layers per shared-attn invocation
    # --- VLM / audio frontends (stubs) --------------------------------------------
    cross_every: int = 0            # 1 cross-attn layer per this many layers
    n_img_tokens: int = 0
    embed_inputs: bool = True       # False → inputs are precomputed embeddings
    # --- numerics ----------------------------------------------------------------
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"
    logits_chunk: int = 2048        # CE loss sequence-chunk (never full logits)
    q_chunk: int = 1024             # attention query chunk
    remat: bool = True              # checkpoint each layer and CE chunk
    # attention implementation: "naive" (query-chunked, materialised probs)
    # or "flash" (the flash attention kernel, kernels/flash_attention.py)
    attn_impl: str = "naive"
    attn_batch_tp: bool = False     # mesh resharding: not ported (A.16)

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def layer_pattern(self) -> Tuple[int, int]:
        """(unit_len, n_units) decomposition of the layer stack."""
        if self.family == "vlm" and self.cross_every:
            unit = self.cross_every
            assert self.n_layers % unit == 0
            return unit, self.n_layers // unit
        if self.local_per_global:
            unit = self.local_per_global + 1
            return unit, self.n_layers // unit
        if self.family == "hybrid" and self.shared_attn_every:
            unit = self.shared_attn_every
            return unit, self.n_layers // unit
        return 1, self.n_layers

    def n_params(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        n = 0
        if self.embed_inputs:
            n += V * d
        if not self.tied_embeddings:
            n += V * d
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            H, Hk, Dh = self.n_heads, self.n_kv_heads, self.head_dim
            attn = d * H * Dh + 2 * d * Hk * Dh + H * Dh * d
            if self.family == "moe":
                ffp = (self.n_experts * (d * ff * (3 if self.glu else 2))
                       + d * self.n_experts)
            else:
                ffp = d * ff * (3 if self.glu else 2)
            per_layer = attn + ffp + 2 * d
        if self.family == "ssm":                      # rwkv6
            per_layer = 6 * d * d + d * ff * 2 + d * d  # tmix + cmix approx
        if self.family == "hybrid":                   # zamba2: mamba layers
            d_in = self.ssm_expand * d
            per_layer = d * (2 * d_in + 2 * self.ssm_state +
                             d_in // self.ssm_head_dim) + d_in * d
            H, Dh = self.n_heads, self.head_dim
            n += (2 * d * H * Dh + 2 * d * H * Dh
                  + d * ff * (3 if self.glu else 2))
        n += per_layer * self.n_layers
        return n

    def n_active_params(self) -> int:
        """MoE: params touched per token; other families: ``n_params``."""
        if self.family != "moe":
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        dense = self.n_params() - self.n_layers * self.n_experts * (
            d * ff * (3 if self.glu else 2))
        active_ff = self.n_layers * self.experts_per_tok * (
            d * ff * (3 if self.glu else 2))
        return dense + active_ff
