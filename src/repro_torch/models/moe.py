"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch.
Port of ``repro/models/moe.py`` on one device.

The (token × k) expert assignments are sorted by expert id (a stable sort)
and written into a per-expert capacity buffer (E, C, d), so the expert
products are batched matmuls over contiguous buffers, as in the JAX
package, which leaves them to XLA outside any Pallas kernel.  Assignments
beyond an expert's capacity C = max(1, ⌈T·k/E · capacity_factor⌉) are
dropped (the token keeps its residual), by the JAX package's rule.

The k expert outputs of a token are summed in a fixed order: each
assignment's weighted output goes back to its (token, slot) place, and a
token's k are added in order of expert id, the order of the JAX package's
scatter-add over the sorted assignments.  No atomics: the sum is the same
on every run and device.  ``moe_rowwise`` is JAX's row-local dispatch
without its mesh constraints (the mesh is queue A item 16).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import layers


def init_moe_params(gen, d_model: int, d_ff: int, n_experts: int, glu: bool,
                    param_dtype, device, lead=()) -> dict:
    """Router and expert weights with leading axes ``lead`` (a layer
    stack); the experts' fan-in is d_model (wi, wg) or d_ff (wo)."""
    lead = tuple(lead)
    nl = len(lead)

    def dense(shape, in_axis):
        return layers.dense_init(gen, lead + shape, param_dtype, device,
                                 in_axis + nl)
    p = {"router": dense((d_model, n_experts), 0),
         "wi": dense((n_experts, d_model, d_ff), 1),
         "wo": dense((n_experts, d_ff, d_model), 1)}
    if glu:
        p["wg"] = dense((n_experts, d_model, d_ff), 1)
    return p


def _route(p, x, k):
    """f32 router over x (..., d): (probs (..., E), the k gates renormalised
    to sum 1, their expert ids), top-k in descending probability."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_idx


def _aux_loss(probs, expert_idx, E):
    """Switch-style load balance: E · Σ_e (share routed first to e) · (mean
    probability of e), f32."""
    lead = tuple(range(probs.dim() - 1))
    density = torch.nn.functional.one_hot(expert_idx[..., 0], E).float()
    return E * torch.sum(density.mean(dim=lead) * probs.mean(dim=lead))


def _experts(p, hidden, act):
    """hidden (..., E, C, d) through each expert's FFN: (..., E, C, d)."""
    dt = hidden.dtype
    fn = layers.activation(act)
    h = hidden @ p["wi"].to(dt)
    if "wg" in p:
        h = fn(hidden @ p["wg"].to(dt)) * h
    else:
        h = fn(h)
    return h @ p["wo"].to(dt)


def _dispatch(e_flat, E, C):
    """Sorted dispatch of expert ids (R, N) (R rows, each sorted alone):
    (order, kept, buffer slot: e·C + position in e's segment, or E·C for a
    dropped assignment), each in sorted order."""
    R, N = e_flat.shape
    order = torch.argsort(e_flat, dim=1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    experts = torch.arange(E, device=e_flat.device).expand(R, E).contiguous()
    seg_start = torch.searchsorted(e_sorted.contiguous(), experts,
                                   side="left")
    pos_in_e = (torch.arange(N, device=e_flat.device)[None]
                - torch.gather(seg_start, 1, e_sorted))
    keep = pos_in_e < C
    slot = torch.where(keep, e_sorted * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    return order, keep, slot


def _combine(weighted, order, expert_idx):
    """The weighted outputs of the sorted assignments (R, T·k, d) summed
    per token: each back to its (token, slot) place, then a token's k
    added in order of expert id.  (R, T, d)."""
    R, N, d = weighted.shape
    k = expert_idx.shape[-1]
    back = torch.empty_like(weighted)
    back.scatter_(1, order[..., None].expand(R, N, d), weighted)
    back = back.reshape(R, N // k, k, d)
    by_expert = torch.argsort(expert_idx.reshape(R, N // k, k), dim=-1,
                              stable=True)
    back = torch.gather(back, 2, by_expert[..., None].expand(-1, -1, -1, d))
    out = back[:, :, 0]
    for j in range(1, k):
        out = out + back[:, :, j]
    return out


def _moe_rows(p, x, k, C, act):
    """The dispatch over rows x (R, T, d), each row its own sort and
    capacity C: (out (R, T, d), probs, expert ids)."""
    R, T, d = x.shape
    dt = x.dtype
    E = p["router"].shape[1]
    probs, gate_vals, expert_idx = _route(p, x, k)        # (R, T, ·)
    flat_e = expert_idx.reshape(R, T * k)
    flat_gate = gate_vals.reshape(R, T * k)
    order, keep, slot = _dispatch(flat_e, E, C)
    tok_sorted = torch.div(order, k, rounding_mode="floor")
    gate_sorted = torch.gather(flat_gate, 1, order)

    rows = torch.arange(R, device=x.device)[:, None]
    buf = torch.zeros((R, E * C + 1, d), dtype=dt, device=x.device)
    buf[rows, slot] = x[rows, tok_sorted]                # E·C: the drop slot
    out_e = _experts(p, buf[:, :E * C].reshape(R, E, C, d), act)

    out_flat = out_e.reshape(R, E * C, d)
    got = out_flat[rows, torch.clamp(slot, max=E * C - 1)]
    got = torch.where(keep[..., None], got, torch.zeros((), dtype=dt,
                                                        device=x.device))
    weighted = got * gate_sorted[..., None].to(dt)
    return _combine(weighted, order, expert_idx), probs, expert_idx


def moe(p: dict, x: torch.Tensor, n_experts_per_tok: int,
        capacity_factor: float = 1.25, act: str = "silu",
        dispatch: str = "global") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (out, aux_loss).  ``dispatch="global"``: one sort over
    all B·S·k assignments, capacity C = max(1, ⌈B·S·k/E · cf⌉);
    ``"rowwise"``: ``moe_rowwise``."""
    if dispatch == "rowwise":
        return moe_rowwise(p, x, n_experts_per_tok, capacity_factor, act)
    B, S, d = x.shape
    E = p["router"].shape[1]
    k = n_experts_per_tok
    T = B * S
    C = max(1, int((T * k) / E * capacity_factor + 0.999))
    out, probs, expert_idx = _moe_rows(p, x.reshape(1, T, d), k, C, act)
    return (out.reshape(B, S, d),
            _aux_loss(probs[0], expert_idx[0], E))


def moe_rowwise(p: dict, x: torch.Tensor, n_experts_per_tok: int,
                capacity_factor: float = 1.25, act: str = "silu"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-local dispatch: a sort and a capacity C_b = max(1, ⌈S·k/E · cf⌉)
    per sequence row."""
    B, S, d = x.shape
    E = p["router"].shape[1]
    k = n_experts_per_tok
    C = max(1, int(S * k / E * capacity_factor + 0.999))
    out, probs, expert_idx = _moe_rows(p, x, k, C, act)
    return out, _aux_loss(probs, expert_idx, E)
