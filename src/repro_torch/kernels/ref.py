"""Plain PyTorch versions of the CUDA kernels.

Port of ``repro/kernels/ref.py:15-262``.  These are the oracles the CUDA
kernels of ``kernels/cma_gen.py``, ``cma_sample.py`` and ``cma_update.py``
are held against (tests, ``chip_smoke.py``) and the path ``kernels/ops.py``
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
