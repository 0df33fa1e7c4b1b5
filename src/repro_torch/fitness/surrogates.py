"""Evaluation-cost shaping (paper §4.1: artificial additional costs) — port
of ``repro/fitness/surrogates.py``.

The paper adds 1/10/100 ms to every BBOB evaluation to emulate expensive
black boxes and shows that the parallel strategies' speedups grow with the
evaluation's granularity (Table 2, Fig. 6).  Two forms:

* ``with_flops_cost`` burns device FLOPs inside each evaluation: a chain of
  (width × width) products seeded from the input, folded back at zero
  weight.  The JAX package computes it outside any Pallas kernel, so here
  it is a batched ``torch.matmul`` loop;
* ``CostModel`` is the analytic per-generation cost of the parallel-time
  model, with the JAX package's fields, defaults and formulas.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def with_flops_cost(fitness_fn: Callable, extra_flops: float,
                    width: int = 64) -> Callable:
    """``fitness_fn`` burning about ``extra_flops`` FLOPs an evaluation in
    ``max(1, extra_flops // (2·width³))`` chained products; the chain's
    result is added at weight 0, so the values are ``fitness_fn``'s."""
    if extra_flops <= 0:
        return fitness_fn
    iters = max(1, int(extra_flops / (2 * width ** 3)))

    def wrapped(X):
        f = fitness_fn(X)
        x0 = X.reshape(-1, X.shape[-1])[:, 0]
        a = (torch.ones((width, width), dtype=X.dtype, device=X.device)
             * (1.0 + 1e-12 * x0)[:, None, None])
        m = a
        for _ in range(iters):
            scale = 1.0 / torch.clamp(m.abs().amax(dim=(-2, -1)), min=1e-30)
            m = (m @ a) * scale[:, None, None]
        return f + 0.0 * m[:, 0, 0].reshape(f.shape)

    return wrapped


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Analytic per-generation timing for the parallel-time model.

    An iteration of a descent with population λ on ``devices`` devices
    costs ``ceil(λ / (devices·slots))·t_eval + t_linalg(λ, n) + t_comm``.
    The defaults are inputs of the paper's analytic model, not
    measurements of any chip."""

    eval_cost_s: float = 0.0        # the paper's "additional cost" knob
    base_eval_s: float = 1e-5       # intrinsic BBOB evaluation cost
    linalg_flops_per_s: float = 5e10  # per-device effective linalg throughput
    comm_s: float = 2e-5            # per-generation collective latency

    def t_eval(self) -> float:
        return self.base_eval_s + self.eval_cost_s

    def t_linalg(self, lam: int, n: int, distributed_over: int = 1) -> float:
        # sampling GEMM (λn²) + rank-μ GEMM + amortized eigh (n³ / interval)
        gemm = 2.0 * 2.0 * lam * n * n / distributed_over
        eigh = 10.0 * n ** 3 * min(1.0, lam / max(n, 1) / 10.0)
        return (gemm + eigh) / self.linalg_flops_per_s

    def t_iter(self, lam: int, n: int, devices: int, slots_per_device: int = 1,
               distributed_linalg: bool = True) -> float:
        waves = -(-lam // max(1, devices * slots_per_device))
        linalg = self.t_linalg(lam, n, devices if distributed_linalg else 1)
        return waves * self.t_eval() + linalg + self.comm_s
