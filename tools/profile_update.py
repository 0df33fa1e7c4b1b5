#!/usr/bin/env python3
"""Per-launch device times of the generation update kernel (row 6).

    python3 tools/profile_update.py [--src DIR] [--calls N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so the same script profiles another tree of the port, e.g. a parent commit
unpacked with ``git archive``.  For one slot at (λ, n) = (3072, 40) and
(3072, 1000), float64, with half the rows weighted (CMA-ES weights in a
random order, as a generation hands them over), it runs ``gen_update``
``N`` times under ``torch.profiler`` after a warm-up and prints one JSON
line: per shape, each kernel's device µs per call (its name as the
profiler gives it), their sum, and the CUDA-event ms of one call.  Needs a
CUDA device; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SHAPES = [(1, 3072, 40), (1, 3072, 1000)]


def inputs(S, lam, n, dev, seed=0):
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


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("no device time on profiler events")


def profile(calls: int) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.kernels import cma_gen
    dev = torch.device("cuda")
    out = {}
    for S, lam, n in SHAPES:
        a = inputs(S, lam, n, dev)
        for _ in range(3):
            cma_gen.gen_update(**a)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            cma_gen.gen_update(**a)
        end.record()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                cma_gen.gen_update(**a)
            torch.cuda.synchronize()
        kernels = {e.key: device_us(e) / calls for e in prof.key_averages()
                   if device_us(e) > 0}
        out[f"{S},{lam},{n}"] = {
            "kernels_us": kernels, "sum_us": sum(kernels.values()),
            "event_ms": start.elapsed_time(end) / calls}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_update.py needs a CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"src": args.src, "gpu": gpu,
                      "update": profile(args.calls)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
