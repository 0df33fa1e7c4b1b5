"""Dispatch of the kernel ops on the tier and on the tensor's device.

Under a kernel tier (``"auto"``, ``"kernel_rng"``) a CPU tensor takes the
plain version (``kernels/ref.py``) and a CUDA tensor the hand-written
kernel (``kernels/cma_gen.py``, ``cma_sample.py``, ``cma_update.py``,
``flash_attention.py``, ``rwkv6_wkv.py``), which raises on anything it
does not take — there is no fallback from a CUDA tensor to the plain
version.  The CUDA kernels tile, so no size limit
routes a problem elsewhere (the JAX package's VMEM-fit fallback has no
counterpart).

``impl`` picks the tier (the JAX package's names in brackets):

* ``"auto"`` [``"pallas"`` on a TPU, ``"xla"`` elsewhere] — kernels on the
  card.  Z is the row-keyed ``jax.random`` draw, made before the sample
  kernel and handed to it.
* ``"kernel_rng"`` [``"pallas_rng"``] — as ``"auto"``, except that the
  ladder's fused sample (``gen_sample_rng``/``gen_sample_rng_eval``) draws
  Z inside the kernel from the threefry counter stream of per-slot seeds.
  A different stream from the row-keyed one, so ``"auto"`` never resolves
  to it.  The strategies path draws the row-keyed Z under both.
* ``"eager"`` [``"xla"``] — the plain versions on any device, with the
  generation step fused (one gram-family contraction).
* ``"eager_unfused"`` [``"xla_unfused"``] — the plain versions on any
  device, with the moments op soup (separate gram, combine and whiten;
  ``use_fused`` is False).  Every op, ``rank_mu_update`` included, takes
  the plain version: the JAX package's ``rank_mu_update`` tests for
  ``"xla"`` alone and so sends ``"xla_unfused"`` to its kernel.

``covariance_combine`` is plain under every tier, as in the JAX package.

The LM kernels have gradients: on a CUDA tensor under a kernel tier, while
autograd records and an operand requires a gradient, ``flash_attention``
and ``wkv_chunked`` go through the autograd functions
(``flash_attention.FlashAttention``, ``rwkv6_wkv.WKV6``), whose backward is
a kernel too; otherwise they make the forward launch alone.  On the CPU
the plain versions' own autograd serves.

Not ported: the JAX package's Mosaic probe and quiet fallback
(``_rng_kernel_supported``), its ``REPRO_KERNEL_IMPL`` override, and
``rng_bits="hw"`` (the TPU's hardware PRNG has no counterpart).
"""
from __future__ import annotations

import torch

from repro_torch.core.eval_dispatch import FusableEval
from repro_torch.kernels import (cma_gen, cma_sample, cma_update,
                                  flash_attention as flash_mod, ref,
                                  rwkv6_wkv)

IMPL_CHOICES = ("auto", "kernel_rng", "eager", "eager_unfused")
#: the tiers that launch the kernels on a CUDA tensor
KERNEL_TIERS = ("auto", "kernel_rng")


def validate_impl(impl: str) -> str:
    """The tier ``impl`` runs: itself, once validated.  ``"auto"`` stays
    the row-keyed kernel tier whatever the device (the device picks kernel
    or plain version, not the stream or the tier)."""
    if impl not in IMPL_CHOICES:
        raise ValueError(f"unknown impl {impl!r}; the port offers "
                         f"{IMPL_CHOICES}")
    return impl


def use_fused(impl: str) -> bool:
    """The generation step's structure: fused unless the caller pinned the
    moments op soup (``"eager_unfused"``)."""
    return validate_impl(impl) != "eager_unfused"


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _kernel(impl: str, t: torch.Tensor) -> bool:
    """Whether ``t`` goes to a kernel: a kernel tier and a CUDA tensor."""
    return validate_impl(impl) in KERNEL_TIERS and _on_cuda(t)


def gen_sample(m, sigma, B, D, Z, impl: str = "auto"):
    """Fused sampling (Y, X), slot-batched (see ``ref.gen_sample``)."""
    if _kernel(impl, Z):
        return cma_gen.gen_sample(m, sigma, B, D, Z)
    return ref.gen_sample(m, sigma, B, D, Z)


def slot_sep(sep, S: int, dtype):
    """``bbob.SepCoeffs`` in the sample kernel's per-slot layout: scale and
    shift (S, n) and f_opt (S,) in ``dtype``, mode and valid (S,) int32,
    all contiguous.  Stacked leaves (a campaign's B members, shift (B, n))
    become (B·S, ...), each member's row repeated over its S slots."""
    if sep.shift.dim() == 2:
        def lay(t, dt):
            return t.to(dt).repeat_interleave(S, dim=0).contiguous()
    else:
        def lay(t, dt):
            return t.to(dt).expand((S,) + tuple(t.shape)).contiguous()
    return sep._replace(scale=lay(sep.scale.expand(sep.shift.shape), dtype),
                        shift=lay(sep.shift, dtype),
                        f_opt=lay(sep.f_opt, dtype),
                        mode=lay(sep.mode, torch.int32),
                        valid=lay(sep.valid, torch.int32))


def slot_fitness(fitness_fn, S: int, dtype):
    """``fitness_fn`` with its separable coefficients, if it carries any,
    laid out once per run by ``slot_sep``; otherwise ``fitness_fn``."""
    sep = getattr(fitness_fn, "sep", None)
    if sep is None:
        return fitness_fn
    return FusableEval(fitness_fn.fn, slot_sep(sep, S, dtype))


def gen_sample_eval(m, sigma, B, D, Z, sep, impl: str = "auto"):
    """Eval-fused sampling (Y, F) for a separable fid: X is never written.
    On the card ``sep`` must be laid out per slot (``slot_sep``); the plain
    version also takes shared leaves."""
    if _kernel(impl, Z):
        return cma_gen.gen_sample_eval(m, sigma, B, D, Z, *sep)
    return ref.gen_sample_eval(m, sigma, B, D, Z, sep)


def gen_sample_rng(m, sigma, B, D, seeds, lam: int, impl: str = "auto"):
    """Fused sampling (Y, X) on the counter stream of ``seeds`` (S, 2)."""
    if _kernel(impl, B):
        return cma_gen.gen_sample_rng(m, sigma, B, D, seeds, lam)
    return ref.gen_sample_rng(m, sigma, B, D, seeds, lam)


def gen_sample_rng_eval(m, sigma, B, D, seeds, lam: int, sep,
                        impl: str = "auto"):
    """Eval-fused sampling (Y, F) on the counter stream; ``sep`` as in
    ``gen_sample_eval``."""
    if _kernel(impl, B):
        return cma_gen.gen_sample_rng_eval(m, sigma, B, D, seeds, lam, *sep)
    return ref.gen_sample_rng_eval(m, sigma, B, D, seeds, lam, sep)


def gen_update(C, B, D, p_sigma, p_c, Y, w, coef, impl: str = "auto"):
    """Fused O(n²) update (C′, p_σ′, p_c′, y_w).  ``coef`` maps the names of
    ``cma_gen.COEF_FIELDS`` to (S,) tensors."""
    if _kernel(impl, C):
        cs = torch.stack([coef[f].to(C.dtype) for f in cma_gen.COEF_FIELDS],
                         dim=1).contiguous()
        return cma_gen.gen_update(C, B, D, p_sigma, p_c, Y, w, cs)
    return ref.fused_gen_update(C, B, D, p_sigma, p_c, Y, w,
                                *(coef[f] for f in cma_gen.COEF_FIELDS))


# ---------------------------------------------------------------------------
# the strategies path's ops (kernels/cma_sample.py, kernels/cma_update.py)
# ---------------------------------------------------------------------------

def _sample(m, sigma, B, D, Z, starts, impl: str):
    if B.dim() == 2:                  # the JAX package's unbatched form
        if m is not None:
            m = m[None]
            sigma = torch.as_tensor(sigma, dtype=Z.dtype,
                                    device=Z.device).reshape(1)
        B, D = B[None], D[None]
    if starts is None:
        if B.shape[0] != 1:
            raise ValueError("starts is needed for more than one group")
        starts = (0, Z.shape[0])
    if _kernel(impl, Z):
        return cma_sample.sample_groups(B, D, Z, starts, m, sigma)
    return ref.sample_groups(B, D, Z, starts, m, sigma)


def sample_transform(B, D, Z, starts=None, impl: str = "auto"):
    """Y = Z·diag(D)·Bᵀ.  Unbatched (B (n, n), D (n,), Z (λ, n)) as in the
    JAX package, or grouped: B (G, n, n), D (G, n), and the rows
    ``starts[g]:starts[g+1]`` of Z (R, n) sampled with group g's state."""
    return _sample(None, None, B, D, Z, starts, impl)


def sample_points(m, sigma, B, D, Z, starts=None, impl: str = "auto"):
    """X = m + σ·(Z·diag(D))·Bᵀ, unbatched or grouped as
    ``sample_transform`` (m (G, n), sigma (G,) when grouped)."""
    return _sample(m, sigma, B, D, Z, starts, impl)


def _slot_coef(C, *values):
    """Scalars or (S,) tensors as the update kernel's (S, k) coefficients."""
    S = C.shape[0]
    return torch.stack([torch.as_tensor(v, dtype=C.dtype,
                                        device=C.device).expand(S)
                        for v in values], dim=1).contiguous()


def rank_mu_update(C, Y, w, p_c, decay, c_mu, c_1, impl: str = "auto"):
    """C′ = decay·C + c_μ·Yᵀdiag(w)Y + c₁·p_c p_cᵀ in one pass: C (n, n),
    Y (λ, n), w (λ,), p_c (n,), or with a leading slot axis; the
    coefficients are scalars or (S,) tensors."""
    if not _kernel(impl, C):
        return ref.rank_mu_update(C, Y, w, p_c, decay, c_mu, c_1)
    if C.dim() == 2:
        return rank_mu_update(C[None], Y[None], w[None], p_c[None], decay,
                              c_mu, c_1, impl)[0]
    return cma_update.rank_mu_update(C, Y, w, p_c,
                                     _slot_coef(C, decay, c_mu, c_1))


def rank_mu_gram(Y, w, impl: str = "auto"):
    """Σ wᵢ yᵢyᵢᵀ (the paper's rank-λ GEMM, eq. 3): on the card the update
    kernel with C = 0, p_c = 0, decay = 0, c_μ = 1, c₁ = 0."""
    if not _kernel(impl, Y):
        return ref.rank_mu_gram(Y, w)
    n = Y.shape[-1]
    zeros = Y.new_zeros(Y.shape[:-2] + (n, n))
    return rank_mu_update(zeros, Y, w, Y.new_zeros(Y.shape[:-2] + (n,)),
                          0.0, 1.0, 0.0, impl)


def covariance_combine(C, gram, p_c, decay, c_mu, c_1, impl: str = "auto"):
    """decay·C + c_μ·gram + c₁·p_c p_cᵀ: a cheap epilogue, plain under every
    tier (``rank_mu_update`` is the fused form)."""
    validate_impl(impl)
    return ref.covariance_combine(C, gram, p_c, decay, c_mu, c_1)


# ---------------------------------------------------------------------------
# the LM substrate's ops (kernels/flash_attention.py, kernels/rwkv6_wkv.py)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    impl: str = "auto"):
    """GQA flash attention: q (B, S, H, D), k/v (B, S_kv, H_k, D).  Under a
    kernel tier the JAX kernel's contract holds on every device:
    non-causal attention with S_kv not a multiple of min(128, S_kv) raises
    ``NotImplementedError``.  ``"eager"`` takes the plain version (the JAX
    package's ``"xla"``), which serves that case."""
    if validate_impl(impl) in KERNEL_TIERS:
        flash_mod.check_contract(causal, k.shape[1])
    if _kernel(impl, q):
        if _records(q, k, v):
            return flash_mod.FlashAttention.apply(q, k, v, causal, window)
        return flash_mod.flash_attention(q, k, v, causal=causal,
                                         window=window)
    return ref.flash_attention(q, k, v, causal=causal, window=window)


def _records(*ts) -> bool:
    """Whether autograd records an op on ``ts``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def wkv_chunked(r, k, v, logw, u, state, impl: str = "auto"):
    """Chunked RWKV-6 WKV from ``state`` (B, H, D, D) f32: (o, new state);
    ``repro/models/rwkv6.py::wkv_chunked``'s contract."""
    if _kernel(impl, r):
        if _records(r, k, v, logw, u, state):
            return rwkv6_wkv.WKV6.apply(r, k, v, logw, u, state)
        return rwkv6_wkv.wkv6_forward(r, k, v, logw, u, state)
    return ref.wkv_chunked(r, k, v, logw, u, state)


def wkv6(r, k, v, logw, u, impl: str = "auto"):
    """Chunked RWKV-6 WKV from a zero state, output only (the JAX package's
    ``ops.wkv6``)."""
    if _kernel(impl, r):
        return rwkv6_wkv.wkv6_forward(r, k, v, logw, u)[0]
    return ref.wkv6(r, k, v, logw, u)
