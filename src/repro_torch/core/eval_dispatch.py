"""Evaluation dispatch pieces of the campaign path (port of the
``FusableEval`` part of ``repro/core/eval_dispatch.py``)."""
from __future__ import annotations


class FusableEval:
    """A fitness closure that also carries the separable coefficients of its
    evaluation.  Calling it behaves like the wrapped closure; the ladder
    detects the ``.sep`` payload and samples through the eval-fused kernel,
    so X is never written.  Built by ``bbob.fusable_fitness``."""

    __slots__ = ("fn", "sep")

    def __init__(self, fn, sep):
        self.fn = fn
        self.sep = sep

    def __call__(self, X):
        return self.fn(X)
