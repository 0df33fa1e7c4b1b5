"""Dispatch of the fused generation ops on the tensor's device.

A CPU tensor takes the plain version (``kernels/ref.py``); a CUDA tensor
takes the hand-written kernel (``kernels/cma_gen.py``), which raises on
anything it does not take — there is no fallback from a CUDA tensor to the
plain version.  The CUDA kernels tile, so no size limit routes a problem
elsewhere (the JAX package's VMEM-fit fallback has no counterpart).

``impl`` picks the sampling tier (the JAX package's names in brackets):

* ``"auto"`` — Z is the row-keyed ``jax.random`` draw, made before the
  sample kernel and handed to it (``gen_sample``/``gen_sample_eval``);
* ``"kernel_rng"`` [``"pallas_rng"``] — Z is the threefry counter stream,
  drawn inside the sample kernel from per-slot seeds
  (``gen_sample_rng``/``gen_sample_rng_eval``).  A different stream from
  the row-keyed one, so ``"auto"`` never resolves to it.

The update is the same kernel under both.  Not ported: the JAX package's
Mosaic probe and quiet fallback (``_rng_kernel_supported``), its
``REPRO_KERNEL_IMPL`` override, and ``rng_bits="hw"`` (the TPU's hardware
PRNG has no counterpart).  ``eager``, ``eager_unfused`` and ``kernel`` come
with the slices that need them (ROADMAP.md, queue A item 1).
"""
from __future__ import annotations

import torch

from repro_torch.core.eval_dispatch import FusableEval
from repro_torch.kernels import cma_gen, ref

IMPL_CHOICES = ("auto", "kernel_rng")


def validate_impl(impl: str) -> str:
    """The sampling tier ``impl`` runs: itself, once validated.  ``"auto"``
    stays the row-keyed tier whatever the device (the device picks kernel
    or plain version, not the stream)."""
    if impl not in IMPL_CHOICES:
        raise ValueError(f"unknown impl {impl!r}; this slice of the port "
                         f"offers {IMPL_CHOICES}")
    return impl


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def gen_sample(m, sigma, B, D, Z):
    """Fused sampling (Y, X), slot-batched (see ``ref.gen_sample``)."""
    if _on_cuda(Z):
        return cma_gen.gen_sample(m, sigma, B, D, Z)
    return ref.gen_sample(m, sigma, B, D, Z)


def slot_sep(sep, S: int, dtype):
    """``bbob.SepCoeffs`` in the sample kernel's per-slot layout: scale and
    shift (S, n) and f_opt (S,) in ``dtype``, mode and valid (S,) int32,
    all contiguous."""
    n = sep.shift.shape[-1]
    return sep._replace(scale=sep.scale.to(dtype).expand(S, n).contiguous(),
                        shift=sep.shift.to(dtype).expand(S, n).contiguous(),
                        f_opt=sep.f_opt.to(dtype).expand(S).contiguous(),
                        mode=sep.mode.to(torch.int32).expand(S).contiguous(),
                        valid=sep.valid.to(torch.int32).expand(S).contiguous())


def slot_fitness(fitness_fn, S: int, dtype):
    """``fitness_fn`` with its separable coefficients, if it carries any,
    laid out once per run by ``slot_sep``; otherwise ``fitness_fn``."""
    sep = getattr(fitness_fn, "sep", None)
    if sep is None:
        return fitness_fn
    return FusableEval(fitness_fn.fn, slot_sep(sep, S, dtype))


def gen_sample_eval(m, sigma, B, D, Z, sep):
    """Eval-fused sampling (Y, F) for a separable fid: X is never written.
    On the card ``sep`` must be laid out per slot (``slot_sep``); the plain
    version also takes shared leaves."""
    if _on_cuda(Z):
        return cma_gen.gen_sample_eval(m, sigma, B, D, Z, *sep)
    return ref.gen_sample_eval(m, sigma, B, D, Z, sep)


def gen_sample_rng(m, sigma, B, D, seeds, lam: int):
    """Fused sampling (Y, X) on the counter stream of ``seeds`` (S, 2)."""
    if _on_cuda(B):
        return cma_gen.gen_sample_rng(m, sigma, B, D, seeds, lam)
    return ref.gen_sample_rng(m, sigma, B, D, seeds, lam)


def gen_sample_rng_eval(m, sigma, B, D, seeds, lam: int, sep):
    """Eval-fused sampling (Y, F) on the counter stream; ``sep`` as in
    ``gen_sample_eval``."""
    if _on_cuda(B):
        return cma_gen.gen_sample_rng_eval(m, sigma, B, D, seeds, lam, *sep)
    return ref.gen_sample_rng_eval(m, sigma, B, D, seeds, lam, sep)


def gen_update(C, B, D, p_sigma, p_c, Y, w, coef):
    """Fused O(n²) update (C′, p_σ′, p_c′, y_w).  ``coef`` maps the names of
    ``cma_gen.COEF_FIELDS`` to (S,) tensors."""
    if _on_cuda(C):
        cs = torch.stack([coef[f].to(C.dtype) for f in cma_gen.COEF_FIELDS],
                         dim=1).contiguous()
        return cma_gen.gen_update(C, B, D, p_sigma, p_c, Y, w, cs)
    return ref.fused_gen_update(C, B, D, p_sigma, p_c, Y, w,
                                *(coef[f] for f in cma_gen.COEF_FIELDS))
