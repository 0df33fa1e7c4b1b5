#!/usr/bin/env python3
"""Per-launch device times of the generation kernels: the update (row 6),
the sample kernels (rows 1-4) and the counter stream alone (row 5), the
grouped sample kernel (row 7), the rank-μ update (row 8), the RWKV-6
WKV kernel (row 10) and the backward kernels (rows 11-12).

    python3 tools/profile_update.py [--src DIR] [--calls N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so the same script profiles another tree of the port, e.g. a parent commit
unpacked with ``git archive``.  float64, one slot.  The update at
(λ, n) = (3072, 40) and (3072, 1000) with half the rows weighted (CMA-ES
weights in a random order, as a generation hands them over); the sample
kernels at their paths' shapes, each RNG form (rows 3, 4) beside its
Z-operand form (rows 1, 2) and row 5: rows 1, 3 and 5 at (12, 1000)
(``bucketed_rng_f8``) and (3072, 1000) (``main_path_f8``), rows 2, 4 and 5
at (96, 40) (``bucketed_rng_f1_restarts``), at every bucket 12·2ᵏ,
k = 0…7, of n = 40 that ``chip_smoke.py`` phase 2 checks, and at
(3072, 40) (``ipop_f1_restarts``) and (3072, 1000), with the f1
coefficients for the eval forms (an RNG call at n = 1000 launches row 5,
then the Z-operand kernel; at n = 40 one kernel that draws Z); row 7 at
the K-Distributed heap of 512 devices × 12 rows (nine descents) and
K-Replicated's phases of 8 devices × 12 rows (G = 8, 4, 2, 1 groups),
n = 1000; row 8 at chip_smoke.py phase 2's
(λ, n) = (12, 1000), (3072, 1000) and (192, 40), half the rows weighted,
each beside its library call (``torch.matmul``, as ``chip_smoke.py`` times
it); row 10 at rwkv6-3b's prefill (4, 1024, 40 heads, D = 64) in bfloat16
and at the 2-layer card-vs-CPU check (2, 64, 40, 64) in float32, with an
initial state; rows 11 and 12 at the training paths' shapes in bfloat16
(``chip_smoke.py`` 13b, 13c): flash attention's backward at (4, 1024, 14
heads, 2 KV heads, D = 64) from the forward's o and row statistic, the
WKV's at (4, 1024, 40, 64) from a zero state.  Each call runs ``N`` times
under
``torch.profiler`` after a warm-up; one JSON line gives, per call and
shape, each kernel's device µs per launch (its name as the profiler gives
it; its own device time over the launches the profiler recorded, which
may be fewer than ``N``), the launches recorded, the sum of the kernels'
µs (each kernel runs once a call in every call profiled here), the
CUDA-event ms of one call (``N`` calls in a row) and the host µs a call
takes to return (``N`` calls in a row, no synchronisation inside): where
the host µs exceed the device µs, the call is host-bound.  ``kernels``
gives the distinct CUDA kernels a call launches.  Needs a CUDA device; it
never falls back to the CPU.  ``chip_smoke.py`` phase 5 times
rows 8 and 10 with ``profile_call``.
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
#: (kernel, (S, λ, n)) of rows 1-5: each RNG form beside its Z-operand
#: form and the stream alone
_YX = ("cma_gen_sample", "cma_gen_sample_rng", "cma_sample_z_rng")
_EVAL = ("cma_gen_sample_eval", "cma_gen_sample_rng_eval", "cma_sample_z_rng")
SAMPLE_SHAPES = ([(k, (1, lam, 1000)) for lam in (12, 3072) for k in _YX]
                 + [(k, (1, 12 << j, 40)) for j in range(8) for k in _EVAL]
                 + [(k, (1, 3072, n)) for n in (40, 1000) for k in _EVAL])
LAM, N7 = 12, 1000
#: (S, λ, n) of row 8, and (B, S, H, D, dtype) of row 10
RANK_MU_SHAPES = [(1, 12, 1000), (1, 3072, 1000), (1, 192, 40)]
WKV_SHAPES = [(4, 1024, 40, 64, "bfloat16"), (2, 64, 40, 64, "float32")]


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
    """(label, call) of every sample shape: rows 1-5 and 7."""
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
                                            *sep),
                "cma_sample_z_rng": (seeds, lam, n)}[name]
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


def rank_mu_calls(dev):
    """(label, call) of row 8 at each of ``RANK_MU_SHAPES``, each followed
    by its library call, ``torch.matmul(Yᵀ, w·Y)`` as ``chip_smoke.py``
    times it."""
    from repro_torch.kernels import cma_update
    calls = []
    for S, lam, n in RANK_MU_SHAPES:
        a = update_inputs(S, lam, n, dev)
        coef = torch.tensor([[0.7, 0.2, 0.05]] * S, dtype=torch.float64,
                            device=dev)
        yt = a["Y"][0].transpose(0, 1)
        wy = (a["w"][0, :, None] * a["Y"][0]).contiguous()
        calls.append((f"cma_rank_mu_update {S},{lam},{n}",
                      lambda a=a, coef=coef: cma_update.rank_mu_update(
                          a["C"], a["Y"], a["w"], a["p_c"], coef)))
        calls.append((f"torch.matmul {S},{lam},{n}",
                      lambda yt=yt, wy=wy: torch.matmul(yt, wy)))
    return calls


def wkv_calls(dev):
    """(label, call) of row 10 at each of ``WKV_SHAPES``: r, k, v standard
    normal, logw = −exp(normal) clamped to [−5, −1e−6], u and the initial
    state small normals."""
    from repro_torch.kernels import rwkv6_wkv
    calls = []
    for B, S, H, D, dt in WKV_SHAPES:
        g = torch.Generator(device=dev).manual_seed(B * S + D)

        def rn(*shape, dtype=torch.float32):
            return torch.randn(shape, generator=g, device=dev).to(dtype)
        dtype = getattr(torch, dt)
        r, k, v = (rn(B, S, H, D, dtype=dtype) for _ in range(3))
        logw = (-rn(B, S, H, D).exp()).clamp(-5.0, -1e-6)
        u, s0 = 0.1 * rn(H, D), 0.5 * rn(B, H, D, D)
        calls.append((f"wkv6_forward {B},{S},{H},{D} {dt}",
                      lambda args=(r, k, v, logw, u, s0):
                      rwkv6_wkv.wkv6_forward(*args)))
    return calls


def lm_bwd_calls(dev):
    """(label, call) of rows 11 and 12 at the training shapes: inputs
    standard normal, logw and u as ``wkv_calls`` makes them."""
    from repro_torch.kernels import flash_attention, rwkv6_wkv
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    q, k, v = rn(4, 1024, 14, 64), rn(4, 1024, 2, 64), rn(4, 1024, 2, 64)
    do = rn(4, 1024, 14, 64)
    o, lse = flash_attention.flash_attention_stats(q, k, v)
    r, kw, vw, dw = (rn(4, 1024, 40, 64) for _ in range(4))
    logw = (-rn(4, 1024, 40, 64, dtype=torch.float32).exp()).clamp(-5.0,
                                                                  -1e-6)
    u = 0.1 * rn(40, 64, dtype=torch.float32)
    return [("flash_attention_bwd 4,1024,14,2,64 bfloat16",
             lambda: flash_attention.flash_attention_bwd(q, k, v, o, lse,
                                                         do)),
            ("wkv6_backward 4,1024,40,64 bfloat16",
             lambda: rwkv6_wkv.wkv6_backward(r, kw, vw, logw, u, None, dw,
                                             need_dstate=False))]


def device_us(evt) -> float:
    """A profiler event's own device time in µs, over all its launches
    (the attribute's name varies across torch versions)."""
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
    evts = [e for e in prof.key_averages() if device_us(e) > 0]
    kernels = {e.key[:80]: device_us(e) / e.count for e in evts}
    return {"kernels_us": kernels, "kernels": len(kernels),
            "recorded": {e.key[:80]: e.count for e in evts}, "calls": calls,
            "sum_us": sum(kernels.values()),
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
    out = {"src": args.src, "gpu": gpu, "update": {}, "sample": {},
           "rank_mu": {}, "wkv": {}, "lm_bwd": {}}
    for S, lam, n in UPDATE_SHAPES:
        a = update_inputs(S, lam, n, dev)
        out["update"][f"{S},{lam},{n}"] = profile_call(
            lambda: cma_gen.gen_update(**a), args.calls)
    for label, fn in sample_calls(dev):
        out["sample"][label] = profile_call(fn, args.calls)
    for label, fn in rank_mu_calls(dev):
        out["rank_mu"][label] = profile_call(fn, args.calls)
    for label, fn in wkv_calls(dev):
        out["wkv"][label] = profile_call(fn, args.calls)
    for label, fn in lm_bwd_calls(dev):
        out["lm_bwd"][label] = profile_call(fn, args.calls)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
