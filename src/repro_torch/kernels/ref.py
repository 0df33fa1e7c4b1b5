"""Plain PyTorch versions of the CUDA kernels.

Port of ``repro/kernels/ref.py``.  These are the oracles the CUDA
kernels of ``kernels/cma_gen.py``, ``cma_sample.py``, ``cma_update.py``,
``flash_attention.py`` and ``rwkv6_wkv.py`` are held against (tests, ``chip_smoke.py``) and the path ``kernels/ops.py``
takes for tensors on the CPU and under the ``eager`` tiers.  The fused
generation ops are slot-batched: every argument carries a leading slot axis
S, per-slot scalars are (S,) tensors.  The ops of the strategies path
(``sample_transform`` … ``rank_mu_update``) take the JAX package's
unbatched arguments or any leading batch axes; ``sample_groups`` is the
grouped form of the sample kernel.

Convention shared with the update kernel: C′ is made exactly symmetric by
mirroring its upper triangle (i ≤ j), so no ``0.5·(C + Cᵀ)`` pass is needed
and ``eigh`` reads the same matrix whichever triangle it uses.

The ``*_rng`` functions are the counter stream of the in-kernel RNG tier
(``impl="kernel_rng"``): Z[s, r, c] is a function of the slot's seed words
and the counter ``(r << 16) | c`` alone (``kernels/csrc/threefry.cuh`` is
the kernels' copy).  Words and uniforms are bit-exact on every side; the
normal carries the few-ulp spread of ``log1p`` and ``cos`` between math
libraries (float64 ``log1p`` here is XLA's, ``prng.log1p_xla``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import prng

#: λ and n must stay below 2¹⁶: the counter packs (row, col) into 32 bits
RNG_MAX_DIM = 1 << 16


def sample_transform(B, D, Z):
    """Y = Z·diag(D)·Bᵀ: y_k = B·(D ∘ z_k) (paper eq. 1, batched).  B (n, n),
    D (n,), Z (λ, n) → (λ, n); leading batch axes broadcast."""
    return (Z * D[..., None, :]) @ B.transpose(-1, -2)


def sample_points(m, sigma, B, D, Z):
    """X = m + σ·(Z·diag(D))·Bᵀ (λ, n)."""
    return m[..., None, :] + sigma * sample_transform(B, D, Z)


def sample_groups(B, D, Z, starts, m=None, sigma=None):
    """The grouped sample kernel's function: rows ``starts[g]:starts[g+1]``
    of Z (R, n) sampled with group g's B (G, n, n) and D (G, n) by
    ``sample_transform``, or by ``sample_points`` with m (G, n) and
    sigma (G,) when they are given.  Each row depends only on its own Z
    row and its group, so a group's rows equal the unbatched op's."""
    parts = []
    for g, (a, b) in enumerate(zip(starts, starts[1:])):
        if m is None:
            parts.append(sample_transform(B[g], D[g], Z[a:b]))
        else:
            parts.append(sample_points(m[g], sigma[g], B[g], D[g], Z[a:b]))
    return torch.cat(parts) if parts else torch.empty_like(Z)


def rank_mu_gram(Y, w):
    """Σᵢ wᵢ yᵢyᵢᵀ as one GEMM, Yᵀ·(diag(w)·Y) (paper eq. 3).  Y (λ, n),
    w (λ,) → (n, n); leading batch axes broadcast."""
    return Y.transpose(-1, -2) @ (w[..., :, None] * Y)


def _per_matrix(a, C):
    """A scalar or a per-slot (S,) coefficient, shaped to scale (S, n, n)."""
    return torch.as_tensor(a, dtype=C.dtype, device=C.device)[..., None, None]


def covariance_combine(C, gram, p_c, decay, c_mu, c_1):
    """C′ = decay·C + c_μ·gram + c₁·p_c p_cᵀ (paper eq. 3 epilogue).  The
    coefficients are scalars or (S,) tensors of a slot-batched C."""
    outer = p_c[..., :, None] * p_c[..., None, :]
    return (_per_matrix(decay, C) * C + _per_matrix(c_mu, C) * gram
            + _per_matrix(c_1, C) * outer)


def rank_mu_update(C, Y, w, p_c, decay, c_mu, c_1):
    """The rank-μ update kernel's function: ``covariance_combine`` of
    ``rank_mu_gram(Y, w)``."""
    return covariance_combine(C, rank_mu_gram(Y, w), p_c, decay, c_mu, c_1)


def whiten_floor(dtype: torch.dtype) -> float:
    """Lower bound on D in the whitened step: 1e-300 in float64 (the JAX
    reference's value), 1e-30 in float32 (where 1e-300 underflows to 0)."""
    return 1e-300 if dtype == torch.float64 else 1e-30


def gen_sample(m, sigma, B, D, Z):
    """(Y, X) = (Z·diag(D)·Bᵀ, m + σ·Y).  m (S,n), sigma (S,), B (S,n,n),
    D (S,n), Z (S,λ,n) → Y, X (S,λ,n)."""
    Y = (Z * D[:, None, :]) @ B.transpose(-1, -2)
    X = m[:, None, :] + sigma[:, None, None] * Y
    return Y, X


def gen_sample_eval(m, sigma, B, D, Z, sep):
    """(Y, F) for a separable fid: F = ``bbob.separable_eval`` of the X that
    ``gen_sample`` would return.  ``sep`` leaves are per-slot (S, ...) or
    shared."""
    from repro_torch.fitness import bbob
    Y, X = gen_sample(m, sigma, B, D, Z)
    return Y, bbob.separable_eval(X, sep)


def bits_to_unit(bits: torch.Tensor, dtype) -> torch.Tensor:
    """uint32 words (int64-held) → [0, 1): the top 23 bits as a float32
    mantissa in [1, 2), minus 1, then cast to ``dtype``."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (one - 1.0).to(dtype)


def threefry_normal(seed0, seed1, rows, cols, dtype) -> torch.Tensor:
    """N(0, 1) grid keyed by (seed, row, col): threefry2x32-20 of the
    counter ``((row << 16) | col, 0)``, then the Box–Muller cosine branch
    ``sqrt(−2·log1p(−u1))·cos(2π·u2)`` in ``dtype``.  ``seed0``/``seed1``
    and the int64 ``rows``/``cols`` broadcast against each other."""
    c0 = ((rows << 16) | cols) & prng.MASK32
    b0, b1 = prng.threefry2x32(seed0, seed1, c0, torch.zeros_like(c0))
    u1, u2 = bits_to_unit(b0, dtype), bits_to_unit(b1, dtype)
    log1p = prng.log1p_xla if dtype == torch.float64 else torch.log1p
    two_pi = torch.tensor(2.0 * math.pi, dtype=dtype, device=u2.device)
    return torch.sqrt(-2.0 * log1p(-u1)) * torch.cos(two_pi * u2)


def sample_z_rng(seeds: torch.Tensor, lam: int, n: int,
                 dtype=torch.float64) -> torch.Tensor:
    """The counter stream Z (S, λ, n) from per-slot seeds (S, 2) (uint32
    words held in int64).  Prefix-stable: rows and columns of a smaller
    call are the leading ones of a larger call."""
    dev = seeds.device
    rows = torch.arange(lam, dtype=torch.int64, device=dev)[:, None]
    cols = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    s = seeds.to(torch.int64) & prng.MASK32
    return threefry_normal(s[:, 0, None, None], s[:, 1, None, None],
                           rows[None], cols[None], dtype)


def gen_sample_rng(m, sigma, B, D, seeds, lam: int):
    """``gen_sample`` on the counter stream drawn from ``seeds`` (S, 2):
    (Y, X), each (S, λ, n)."""
    Z = sample_z_rng(seeds, lam, B.shape[-1], m.dtype)
    return gen_sample(m, sigma, B, D, Z)


def gen_sample_rng_eval(m, sigma, B, D, seeds, lam: int, sep):
    """``gen_sample_eval`` on the counter stream: (Y, F), X never kept."""
    Z = sample_z_rng(seeds, lam, B.shape[-1], m.dtype)
    return gen_sample_eval(m, sigma, B, D, Z, sep)


def mirror_upper(A: torch.Tensor) -> torch.Tensor:
    """A with its strict lower triangle replaced by the upper's transpose."""
    return torch.triu(A) + torch.triu(A, 1).transpose(-1, -2)


def fused_update_from_gram(C, B, D, p_sigma, p_c, gram, y_w, c_sigma, mu_eff,
                           c_c, c_1, c_mu, chi_n, gen1):
    """Everything downstream of the gram-family contraction: whitened step,
    evolution paths, h_σ and the covariance epilogue.  Per-slot scalars are
    (S,) tensors.  Returns ``(C_new, p_sigma_new, p_c_new, y_w)``."""
    n = C.shape[-1]
    dt = C.dtype
    v = lambda a: a[:, None]                                 # noqa: E731
    t = (B.transpose(-1, -2) @ y_w[..., None])[..., 0]
    whiten = (B @ (t / torch.clamp(D, min=whiten_floor(dt)))[..., None])[..., 0]
    p_sigma_new = v(1.0 - c_sigma) * p_sigma + v(torch.sqrt(
        c_sigma * (2.0 - c_sigma) * mu_eff)) * whiten
    ps_norm = torch.sqrt(torch.sum(p_sigma_new * p_sigma_new, -1))
    h_sig_denom = torch.sqrt(1.0 - (1.0 - c_sigma) ** (2.0 * gen1))
    h_sigma = (ps_norm / h_sig_denom / chi_n
               < 1.4 + 2.0 / (n + 1.0)).to(dt)
    p_c_new = v(1.0 - c_c) * p_c + v(h_sigma * torch.sqrt(
        c_c * (2.0 - c_c) * mu_eff)) * y_w
    decay = 1.0 - c_1 - c_mu + (1.0 - h_sigma) * c_1 * c_c * (2.0 - c_c)
    outer = (c_1[:, None, None] * p_c_new[:, :, None]) * p_c_new[:, None, :]
    C_new = decay[:, None, None] * C + c_mu[:, None, None] * gram + outer
    return mirror_upper(C_new), p_sigma_new, p_c_new, y_w


def fused_gen_update(C, B, D, p_sigma, p_c, Y, w, c_sigma, mu_eff, c_c, c_1,
                     c_mu, chi_n, gen1):
    """One generation's O(n²) state update: the √w-factored gram
    ``Y_sᵀY_s`` and ``y_w = Y_sᵀ√w`` (Y_s = √w ⊙ Y), then
    ``fused_update_from_gram``.  Y (S,λ,n), w (S,λ); zero-weight rows
    contribute nothing."""
    rw = torch.sqrt(w)
    Ys = rw[..., None] * Y
    YsT = Ys.transpose(-1, -2)
    gram = YsT @ Ys
    y_w = (YsT @ rw[..., None])[..., 0]
    return fused_update_from_gram(C, B, D, p_sigma, p_c, gram, y_w, c_sigma,
                                  mu_eff, c_c, c_1, c_mu, chi_n, gen1)


# ---------------------------------------------------------------------------
# LM kernels
# ---------------------------------------------------------------------------

#: RWKV-6 WKV chunk length: every exponential of a chunk stays below
#: e^{16·5} < float32's max (``models/rwkv6.py``)
WKV_CHUNK = 16


def _index_mask(S: int, Skv: int, causal: bool, window: int, device,
                q0: int = 0, k0: int = 0):
    """(S, Skv) bool: which keys rows ``q0..`` may see among ``k0..``, in
    index order (causal: key ≤ query; window: key > query − window)."""
    q_ids = torch.arange(q0, q0 + S, device=device)[:, None]
    k_ids = torch.arange(k0, k0 + Skv, device=device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_ids <= q_ids
    if window > 0:
        mask &= k_ids > q_ids - window
    return mask


def _flash_logits(q, k, causal: bool, window: int):
    """Masked f32 logits (B, H_k, rep, S, S_kv) of the GQA heads."""
    B, S, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Hk, H // Hk, D).float() * (D ** -0.5)
    logits = torch.einsum("bshrd,bthd->bhrst", qg, k.float())
    mask = _index_mask(S, Skv, causal, window, q.device)
    return torch.where(mask, logits, -1e30)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Materialised-softmax GQA attention (``repro/kernels/ref.py:269``):
    q (B, S, H, D), k/v (B, S_kv, H_k, D) → (B, S, H, D) in q's dtype.
    Masks are in index order: causal keeps keys ≤ the query's index, a
    window keeps keys > index − window.  f32 logits and probabilities."""
    B, S, H, D = q.shape
    p = torch.softmax(_flash_logits(q, k, causal, window), dim=-1)
    o = torch.einsum("bhrst,bthd->bshrd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype).contiguous()


def flash_attention_lse(q, k, *, causal: bool = True, window: int = 0):
    """The flash kernel's row statistic: log-sum-exp of each row's scaled,
    masked logits, f32 (B, S, H)."""
    B, S, H, _ = q.shape
    lse = torch.logsumexp(_flash_logits(q, k, causal, window), dim=-1)
    return lse.permute(0, 3, 1, 2).reshape(B, S, H).contiguous()


def _kv_block_ids(qi: int, bq: int, bkv: int, nkv: int, window: int):
    """KV blocks a q block visits (``flash_xla._kv_block_ids``): all of
    them, or with a window the static-length range ending at the q
    block's diagonal, out-of-range ids dropped."""
    if window <= 0:
        return list(range(nkv))
    n_need = min(nkv, -(-(window + bq) // bkv) + 1)
    last = (qi * bq + bq - 1) // bkv
    return [i for i in range(last - (n_need - 1), last + 1) if 0 <= i < nkv]


def _q_block_ids(ki: int, bq: int, bkv: int, nq: int, window: int):
    """q blocks that may see KV block ``ki`` (``flash_xla``'s pass 2)."""
    if window <= 0:
        return list(range(nq))
    n_need = min(nq, -(-(window + bkv) // bq) + 1)
    first = (ki * bkv) // bq
    return [i for i in range(first, first + n_need) if 0 <= i < nq]


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, bq: int = 512, bkv: int = 512):
    """(dq, dk, dv) of ``flash_attention`` from the forward's o and row
    log-sum-exp ``lse`` (B, S, H): the two blockwise passes of
    ``repro/models/flash_xla.py::_flash_bwd_impl`` (pass 1: dq over q
    blocks × KV blocks; pass 2: dk, dv over KV blocks × q blocks), the
    probabilities recomputed as exp(scale q·k − lse) in f32.  The JAX
    package keeps (m, l) and recomputes exp(s − m)/l; padded q rows get
    lse = +inf here, so they add nothing to dk and dv.  The gradients have
    the inputs' dtype."""
    B, S, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    rep = H // Hk
    scale = D ** -0.5
    bq, bkv = min(bq, S), min(bkv, Skv)
    nq, nkv = -(-S // bq), -(-Skv // bkv)
    pq, pkv = nq * bq - S, nkv * bkv - Skv

    def pad(x, n, value=0.0):
        return torch.nn.functional.pad(
            x.float(), (0, 0) * (x.dim() - 2) + (0, n), value=value)
    qp, op, dop = (pad(x, pq) for x in (q, o, do))
    lp = pad(lse, pq, float("inf"))
    kp, vp = pad(k, pkv), pad(v, pkv)
    delta = torch.sum(dop * op, dim=-1)                      # (B, Sp, H)

    def blk(x, i, size):
        return x[:, i * size:(i + 1) * size]

    def p_tile(q_b, k_b, l_b, qi, ki):
        s = torch.einsum("bqhrd,bkhd->bqhrk",
                         q_b.reshape(B, bq, Hk, rep, D) * scale, k_b)
        msk = _index_mask(bq, bkv, causal, window, q.device, qi * bq,
                          ki * bkv) & (torch.arange(ki * bkv, (ki + 1) * bkv,
                                                    device=q.device) < Skv)
        s = torch.where(msk[None, :, None, None, :], s, -1e30)
        return torch.exp(s.reshape(B, bq, H, bkv) - l_b[..., None])

    def ds_tile(p, do_b, v_b, d_b):
        dp = torch.einsum("bqhrd,bkhd->bqhrk",
                          do_b.reshape(B, bq, Hk, rep, D),
                          v_b).reshape(B, bq, H, bkv)
        return p * (dp - d_b[..., None])

    dq = torch.zeros_like(qp)                                # pass 1
    for qi in range(nq):
        q_b, do_b = blk(qp, qi, bq), blk(dop, qi, bq)
        l_b, d_b = blk(lp, qi, bq), blk(delta, qi, bq)
        acc = torch.zeros((B, bq, H, D), dtype=torch.float32,
                          device=q.device)
        for ki in _kv_block_ids(qi, bq, bkv, nkv, window):
            k_b, v_b = blk(kp, ki, bkv), blk(vp, ki, bkv)
            ds = ds_tile(p_tile(q_b, k_b, l_b, qi, ki), do_b, v_b, d_b)
            acc = acc + torch.einsum(
                "bqhrk,bkhd->bqhrd", ds.reshape(B, bq, Hk, rep, bkv),
                k_b).reshape(B, bq, H, D) * scale
        dq[:, qi * bq:(qi + 1) * bq] = acc

    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)      # pass 2
    for ki in range(nkv):
        k_b, v_b = blk(kp, ki, bkv), blk(vp, ki, bkv)
        dk_acc, dv_acc = torch.zeros_like(k_b), torch.zeros_like(v_b)
        for qi in _q_block_ids(ki, bq, bkv, nq, window):
            q_b, do_b = blk(qp, qi, bq), blk(dop, qi, bq)
            l_b, d_b = blk(lp, qi, bq), blk(delta, qi, bq)
            p = p_tile(q_b, k_b, l_b, qi, ki)
            dv_acc = dv_acc + torch.einsum(
                "bqhrk,bqhrd->bkhd", p.reshape(B, bq, Hk, rep, bkv),
                do_b.reshape(B, bq, Hk, rep, D))
            ds = ds_tile(p, do_b, v_b, d_b)
            dk_acc = dk_acc + torch.einsum(
                "bqhrk,bqhrd->bkhd", ds.reshape(B, bq, Hk, rep, bkv),
                q_b.reshape(B, bq, Hk, rep, D)) * scale
        dk[:, ki * bkv:(ki + 1) * bkv] = dk_acc
        dv[:, ki * bkv:(ki + 1) * bkv] = dv_acc
    return (dq[:, :S].to(q.dtype), dk[:, :Skv].to(k.dtype),
            dv[:, :Skv].to(v.dtype))


def wkv_chunked(r, k, v, logw, u, state):
    """Chunked-parallel RWKV-6 WKV (``repro/models/rwkv6.py:121``):
    r, k, v (B, S, H, D), logw (B, S, H, D) f32 (≤ −1e−6), u (H, D),
    state (B, H, D, D) f32; S a multiple of ``WKV_CHUNK``.  Returns
    (o (B, S, H, D) in r's dtype, final state)."""
    B, S, H, D = r.shape
    if S % WKV_CHUNK:
        raise ValueError(f"S = {S} must be a multiple of {WKV_CHUNK} "
                         "(the caller pads)")
    c = WKV_CHUNK
    u32 = u.float()
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    outs = []
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        rr, kk, vv = (a[:, sl].float() for a in (r, k, v))
        ww = logw[:, sl].float()
        Lc = torch.cumsum(ww, dim=1)                       # Σ_{s≤t}
        Lc_prev = Lc - ww                                  # Σ_{s<t}
        Lc_last = Lc[:, -1:]
        q_t = rr * torch.exp(Lc_prev)
        k_in = kk * torch.exp(-Lc)
        A = torch.einsum("bthd,bjhd->bhtj", q_t, k_in)
        A = torch.where(tri, A, 0.0)
        o = torch.einsum("bhtj,bjhd->bthd", A, vv)
        diag = torch.einsum("bthd,hd,bthd->bth", rr, u32, kk)
        o = o + diag[..., None] * vv
        o = o + torch.einsum("bthd,bhdv->bthv", q_t, state)
        k_out = kk * torch.exp(Lc_last - Lc)
        state = (torch.exp(Lc_last)[:, 0, :, :, None] * state
                 + torch.einsum("bjhd,bjhv->bhdv", k_out, vv))
        outs.append(o.to(r.dtype))
    return torch.cat(outs, dim=1), state


def wkv6(r, k, v, logw, u):
    """``wkv_chunked`` from a zero state, output only (``ops.wkv6``)."""
    B, _, H, D = r.shape
    state0 = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    return wkv_chunked(r, k, v, logw, u, state0)[0]


def wkv_backward(r, k, v, logw, u, state, do, dstate=None):
    """Gradients of ``wkv_chunked`` for the output gradient ``do`` and the
    final state's ``dstate`` (None: zero), by ``torch.autograd.grad``
    through it: (dr, dk, dv, dlogw, du, d(initial state)), each in its
    input's dtype (``state`` None: a zero state, whose gradient is still
    returned)."""
    B, _, H, D = r.shape
    if state is None:
        state = torch.zeros((B, H, D, D), dtype=torch.float32,
                            device=r.device)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_()
               for t in (r, k, v, logw, u, state)]
        o, s_new = wkv_chunked(*ins)
        outs, grads = [o], [do]
        if dstate is not None:
            outs.append(s_new)
            grads.append(dstate)
        return torch.autograd.grad(outs, ins, grads)
