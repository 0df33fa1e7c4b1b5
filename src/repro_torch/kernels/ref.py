"""Plain PyTorch versions of the fused generation kernels.

Port of ``repro/kernels/ref.py:53-262``.  These are the oracles the CUDA
kernels of ``kernels/cma_gen.py`` are held against (tests, ``chip_smoke.py``)
and the path ``kernels/ops.py`` takes for tensors on the CPU.  They are
slot-batched: every argument carries a leading slot axis S, per-slot
scalars are (S,) tensors.

Convention shared with the update kernel: C′ is made exactly symmetric by
mirroring its upper triangle (i ≤ j), so no ``0.5·(C + Cᵀ)`` pass is needed
and ``eigh`` reads the same matrix whichever triangle it uses.
"""
from __future__ import annotations

import torch


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
