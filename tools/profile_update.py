#!/usr/bin/env python3
"""Per-launch device times of the generation kernels: the update (row 6),
the sample kernels (rows 1-4, and row 5 where an RNG call launches it) and
the grouped sample kernel (row 7).

    python3 tools/profile_update.py [--src DIR] [--calls N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so the same script profiles another tree of the port, e.g. a parent commit
unpacked with ``git archive``.  float64, one slot.  The update at
(λ, n) = (3072, 40) and (3072, 1000) with half the rows weighted (CMA-ES
weights in a random order, as a generation hands them over); the sample
kernels at their paths' shapes: row 1 at (3072, 1000) (``main_path_f8``),
row 2 at (3072, 40) (``ipop_f1_restarts``) and (3072, 1000), row 3 at
(12, 1000) (``bucketed_rng_f8``) and (3072, 1000), row 4 at (96, 40)
(``bucketed_rng_f1_restarts``) and (3072, 1000), with the f1 coefficients
for the eval forms; row 7 at the K-Distributed heap of 512 devices × 12
rows (nine descents) and K-Replicated's phases of 8 devices × 12 rows
(G = 8, 4, 2, 1 groups), n = 1000.  Each call runs ``N`` times under
``torch.profiler`` after a warm-up; one JSON line gives, per call and
shape, each kernel's device µs per call (its name as the profiler gives
it), their sum, the CUDA-event ms of one call (``N`` calls in a row) and
the host µs a call takes to return (``N`` calls in a row, no
synchronisation inside): where the host µs exceed the device µs, the call
is host-bound.  Needs a CUDA device; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

UPDATE_SHAPES = [(1, 3072, 40), (1, 3072, 1000)]
#: (kernel, (S, λ, n)) of rows 1-4
SAMPLE_SHAPES = [("cma_gen_sample", (1, 3072, 1000)),
                 ("cma_gen_sample_eval", (1, 3072, 40)),
                 ("cma_gen_sample_eval", (1, 3072, 1000)),
                 ("cma_gen_sample_rng", (1, 12, 1000)),
                 ("cma_gen_sample_rng", (1, 3072, 1000)),
                 ("cma_gen_sample_rng_eval", (1, 96, 40)),
                 ("cma_gen_sample_rng_eval", (1, 3072, 1000))]
LAM, N7 = 12, 1000


def update_inputs(S, lam, n, dev, seed=0):
    from repro_torch.core.params import CMAConfig, make_params
    from repro_torch.kernels import cma_gen
    rng = np.random.default_rng(seed)
    B = np.linalg.qr(rng.normal(size=(S, n, n)))[0]
    D = rng.uniform(0.5, 2.0, size=(S, n))
    C = B @ (D[..., None] ** 2 * np.swapaxes(B, -1, -2))
    C = np.triu(C) + np.swapaxes(np.triu(C, 1), -1, -2)
    p = make_params(CMAConfig(n=n, lam=lam), lam=lam, device="cpu")
    w = np.stack([rng.permutation(p.weights.numpy()) for _ in range(S)])
    coef = [[float(getattr(p, f)) for f in cma_gen.COEF_FIELDS[:-1]] + [3.0]
            for _ in range(S)]

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64, device=dev)
    return dict(C=t(C), B=t(B), D=t(D), p_sigma=t(0.3 * rng.normal(size=(S, n))),
                p_c=t(0.3 * rng.normal(size=(S, n))),
                Y=t(rng.normal(size=(S, lam, n))), w=t(w), coef=t(coef))


def state(G, n, dev, seed=0):
    """m, sigma, B (an orthonormal basis per group), D: float64 on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, dtype=torch.float64, device=dev)
    B = torch.linalg.qr(rand(G, n, n) - 0.5)[0].contiguous()
    return rand(G, n) - 0.5, 0.1 + 0.4 * rand(G), B, 0.5 + 1.5 * rand(G, n)


def sample_calls(dev):
    """(label, call) of every sample shape: rows 1-4 and 7."""
    from repro_torch.core import strategies
    from repro_torch.kernels import cma_gen, cma_sample
    calls = []
    for name, (S, lam, n) in SAMPLE_SHAPES:
        m, sigma, B, D = state(S, n, dev)
        Z = torch.randn((S, lam, n), dtype=torch.float64, device=dev)
        seeds = torch.tensor([[2 ** 31 + 7, 12345]] * S, device=dev)
        x_opt = torch.linspace(-4.0, 4.0, n, dtype=torch.float64, device=dev)
        sep = (torch.ones((S, n), dtype=torch.float64, device=dev),
               x_opt.expand(S, n).contiguous(),
               torch.full((S,), 79.48, dtype=torch.float64, device=dev),
               torch.zeros((S,), dtype=torch.int32, device=dev),
               torch.ones((S,), dtype=torch.int32, device=dev))
        args = {"cma_gen_sample": (m, sigma, B, D, Z),
                "cma_gen_sample_eval": (m, sigma, B, D, Z, *sep),
                "cma_gen_sample_rng": (m, sigma, B, D, seeds, lam),
                "cma_gen_sample_rng_eval": (m, sigma, B, D, seeds, lam,
                                            *sep)}[name]
        fn = getattr(cma_gen, name.replace("cma_", "", 1))
        calls.append((f"{name} {S},{lam},{n}",
                      lambda fn=fn, args=args: fn(*args)))
    kd = strategies.KDistributed(n=8, n_devices=512, lam_start=LAM,
                                 lam_slots=LAM, device="cpu")
    layouts = [("kdist_f8", tuple(LAM * s for s in kd.groups.starts))]
    layouts += [(f"krep_n1000_G{8 >> k}",
                 tuple(range(0, 8 * LAM + 1, LAM << k))) for k in range(4)]
    for label, starts in layouts:
        G, R = len(starts) - 1, starts[-1]
        m, sigma, B, D = state(G, N7, dev)
        Z = torch.randn((R, N7), dtype=torch.float64, device=dev)
        calls.append((f"cma_sample {label}",
                      lambda B=B, D=D, Z=Z, starts=starts:
                      cma_sample.sample_groups(B, D, Z, starts)))
    return calls


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("no device time on profiler events")


def profile_call(fn, calls: int) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key: device_us(e) / calls for e in prof.key_averages()
               if device_us(e) > 0}
    return {"kernels_us": kernels, "sum_us": sum(kernels.values()),
            "event_ms": start.elapsed_time(end) / calls, "host_us": host_us}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_update.py needs a CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import cma_gen
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"src": args.src, "gpu": gpu, "update": {}, "sample": {}}
    for S, lam, n in UPDATE_SHAPES:
        a = update_inputs(S, lam, n, dev)
        out["update"][f"{S},{lam},{n}"] = profile_call(
            lambda: cma_gen.gen_update(**a), args.calls)
    for label, fn in sample_calls(dev):
        out["sample"][label] = profile_call(fn, args.calls)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
