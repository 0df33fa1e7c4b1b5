#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one GPU and hold its kernels against their
plain PyTorch versions.

    python3 chip_smoke.py

Phases, one JSON line each; any failed check raises (non-zero exit):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   and the build of every kernel from ``src/repro_torch/kernels/csrc``;
2. each kernel against its plain version on the card, at the shapes of
   phase 3 (S=1, λ=3072, n=1000) and phase 4 (S=1, λ=3072, n=40, with the
   f1 instance's coefficients) and a ragged one (S=3, λ=37, n=45, one
   all-zero-weight slot), float64 (max relative error ≤ 1e-12) and float32
   (≤ 1e-4); C′ must be exactly symmetric;
3. the main path at full size: ``run_ipop`` on BBOB f8 (n=1000, λ_max=3072,
   float64, 64 generations) through the sample and update kernels, with
   their launch counts and the time of one batched ``eigh`` at that width;
   plus the ladder at n=8 on the card and on the CPU's plain path (f8, and
   f1/f2 through the eval-fused kernel; both schedules), whose traces must
   agree;
4. a whole IPOP run with restarts: ``run_ipop`` on f1 through the
   eval-fused sample kernel (n=40, λ_max=3072, 100 000 evaluations);
5. the ``{"kernels": [...]}`` line: per kernel and per path (phases 3 and
   4) its launches, its time, the plain version's time, one PyTorch call's
   time and the least time the card could take (bound) at that path's
   shape; the top-level numbers are the phase-3 shape's.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/`` beside this file, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import cmaes, ipop, ladder  # noqa: E402
from repro_torch.core.params import CMAConfig, make_params  # noqa: E402
from repro_torch.fitness import bbob  # noqa: E402
from repro_torch.kernels import _build, cma_gen, ops, ref  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): FP64 on the tensor cores and
# FP32 outside them; HBM3 bandwidth.
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
MAIN = dict(S=1, lam=3072, n=1000)        # phase 3, f8
RESTARTS = dict(S=1, lam=3072, n=40)      # phase 4, f1 through the eval kernel
RAGGED = dict(S=3, lam=37, n=45)
#: the paths whose launches are counted: shape and the fid of the fitness
PATHS = {"main_path_f8": (MAIN, None), "ipop_f1_restarts": (RESTARTS, 1)}
SOURCES = {
    "cma_gen_sample": ("src/repro_torch/kernels/csrc/cma_gen_sample.cu",
                       "src/repro/kernels/cma_gen.py:91"),
    "cma_gen_sample_eval": ("src/repro_torch/kernels/csrc/cma_gen_sample.cu",
                            "src/repro/kernels/cma_gen.py:322"),
    "cma_gen_update": ("src/repro_torch/kernels/csrc/cma_gen_update.cu",
                       "src/repro/kernels/cma_gen.py:447"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs, made from a seed with numpy
# ---------------------------------------------------------------------------

def sample_inputs(S, lam, n, dtype, dev, seed=0, fid=None):
    """Sample-kernel operands and separable coefficients in the kernel's
    per-slot layout: those of BBOB ``fid`` (instance 1, as phase 4 runs
    it), or else random ones mixing both modes and an invalid slot."""
    rng = np.random.default_rng(seed)
    B = torch.linalg.qr(torch.tensor(rng.normal(size=(S, n, n)),
                                     device=dev))[0].contiguous()

    def t(a):
        return torch.tensor(a, device=dev)
    args = dict(m=t(rng.normal(size=(S, n))),
                sigma=t(rng.uniform(0.1, 0.5, size=S)), B=B,
                D=t(rng.uniform(0.5, 2.0, size=(S, n))),
                Z=t(rng.normal(size=(S, lam, n))))
    if fid is not None:
        sep = bbob.separable_coeffs(bbob.make_instance(fid, n, 1, device=dev),
                                    (fid,))
    else:
        sep = bbob.SepCoeffs(
            scale=t(np.power(10.0, 6.0 * np.arange(n) / max(n - 1.0, 1.0))
                    ).expand(S, n),
            shift=t(rng.uniform(-4.0, 4.0, size=(S, n))),
            f_opt=t(np.round(rng.uniform(-100, 100, size=S), 2)),
            mode=torch.tensor([1, 0, 1][:S] if S > 1 else [1],
                              dtype=torch.int32, device=dev),
            valid=torch.tensor([True, True, False][:S] if S > 1 else [True],
                               device=dev))
    return ({k: v.to(dtype).contiguous() for k, v in args.items()},
            ops.slot_sep(sep, S, dtype))


def kernel_eval(a, sep):
    return cma_gen.gen_sample_eval(*a.values(), *sep)


def update_inputs(S, lam, n, dtype, dev, seed=1, zero_slot=True):
    """State, population and rank weights as the ladder hands them over:
    slot 0 at full rung, slot 1 at a smaller rung, the last slot (ragged
    case) with all-zero weights."""
    rng = np.random.default_rng(seed)
    s_in, _ = sample_inputs(S, lam, n, torch.float64, dev, seed)
    B, D = s_in["B"], s_in["D"]
    C = ref.mirror_upper(B @ (D[..., None] ** 2 * B.transpose(-1, -2)))
    cfg = CMAConfig(n=n, lam=lam)
    w = np.zeros((S, lam))
    coef = np.zeros((S, len(cma_gen.COEF_FIELDS)))
    for s in range(S):
        p = make_params(cfg, lam=max(2, lam >> s))
        if not (zero_slot and s == S - 1 and S > 1):
            w[s] = rng.permutation(p.weights.numpy())
        coef[s] = [float(getattr(p, f)) for f in cma_gen.COEF_FIELDS[:-1]] \
            + [float(3 + s)]

    def t(a):
        return torch.tensor(a, device=dev).to(dtype).contiguous()
    return dict(C=t(C.cpu().numpy()), B=t(B.cpu().numpy()),
                D=t(D.cpu().numpy()),
                p_sigma=t(0.3 * rng.normal(size=(S, n))),
                p_c=t(0.3 * rng.normal(size=(S, n))),
                Y=t(rng.normal(size=(S, lam, n))), w=t(w), coef=t(coef))


def ref_update(a):
    return ref.fused_gen_update(a["C"], a["B"], a["D"], a["p_sigma"],
                                a["p_c"], a["Y"], a["w"],
                                *a["coef"].unbind(1))


# ---------------------------------------------------------------------------
# comparisons and timing
# ---------------------------------------------------------------------------

def compare(name, got, want, dtype):
    """Max abs and max relative (to the largest |want|) error; NaNs must
    sit in the same places."""
    worst_abs, worst_rel = 0.0, 0.0
    for g, w in zip(got, want):
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{name}: NaN pattern differs")
        ok = ~torch.isnan(w)
        diff = float((g[ok] - w[ok]).abs().max()) if ok.any() else 0.0
        scale = float(w[ok].abs().max()) if ok.any() else 1.0
        worst_abs = max(worst_abs, diff)
        worst_rel = max(worst_rel, diff / max(scale, 1e-300))
    if worst_rel > TOL[dtype]:
        raise AssertionError(f"{name} ({dtype}): max relative error "
                             f"{worst_rel:.3e} > {TOL[dtype]:.0e}")
    return worst_abs, worst_rel


def time_ms(fn, reps=10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = _build.build_all()
    ptxas = []
    for name in _build.SOURCES:
        log = libs[name].parent / f"{name}.ptxas.log"
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "gpu": gpu_line(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": _build.build_seconds, "ptxas": ptxas})


def phase_kernels(dev):
    """Every kernel against its plain version; returns the max errors."""
    errs = {k: 0.0 for k in SOURCES}
    rows = []
    for shape, fid in ((MAIN, None), (RESTARTS, 1), (RAGGED, None)):
        for dtype in (torch.float64, torch.float32):
            S, lam, n = shape["S"], shape["lam"], shape["n"]
            a, sep = sample_inputs(S, lam, n, dtype, dev, fid=fid)
            got = cma_gen.gen_sample(**a)
            want = ref.gen_sample(**a)
            e1 = compare("cma_gen_sample", got, want, dtype)
            got = kernel_eval(a, sep)
            want = ref.gen_sample_eval(**a, sep=sep)
            e2 = compare("cma_gen_sample_eval", got, want, dtype)
            u = update_inputs(S, lam, n, dtype, dev)
            got = cma_gen.gen_update(**u)
            want = ref_update(u)
            e3 = compare("cma_gen_update", got, want, dtype)
            if not torch.equal(got[0], got[0].transpose(-1, -2)):
                raise AssertionError("cma_gen_update: C' is not symmetric")
            torch.cuda.synchronize()
            for k, e in zip(SOURCES, (e1, e2, e3)):
                errs[k] = max(errs[k], e[0]) if dtype == torch.float64 \
                    else errs[k]
                rows.append({"kernel": k, "shape": [S, lam, n],
                             "dtype": str(dtype), "max_abs_err": e[0],
                             "max_rel_err": e[1]})
    emit({"phase": "kernels_vs_plain", "checks": rows})
    return errs


def phase_main_path(dev):
    """run_ipop on f8 at full width through the sample and update kernels,
    then the same ladder at n=8 on the card and on the CPU."""
    n, gens = 1000, 64
    fn, inst = bbob.make_fitness(8, n, 1, device=dev)
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res = ipop.run_ipop(fn, n, 11, lam_start=12, kmax_exp=8,
                        max_evals=10**9, total_gens=gens, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cma_gen.LAUNCHES)
    if launches["cma_gen_sample"] != gens or launches["cma_gen_update"] != gens:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{gens} of the sample and update kernels")
    if not np.isfinite(res.best_f) or res.total_fevals != 12 * gens:
        raise AssertionError(f"f8 run: best_f {res.best_f}, fevals "
                             f"{res.total_fevals}")
    d0 = res.descents[0]
    if not (np.isfinite(d0.best_f).all() and (np.diff(d0.best_f) <= 0).all()
            and np.array_equal(d0.gens, np.arange(1, gens + 1))):
        raise AssertionError("f8 run: trace is not a finite best-so-far "
                             "record of every generation")

    # one batched eigh at this width (eigen_interval is 1 at λ_max = 3072,
    # so the ladder runs one every generation; it syncs with the host)
    C = update_inputs(1, 12, n, torch.float64, dev)["C"]
    eigh_ms = time_ms(lambda: cmaes.eigen_decompose(C), reps=3)
    emit({"phase": "main_path_f8", "n": n, "lam_max": 3072, "gens": gens,
          "ms_per_gen": wall / gens * 1e3, "eigh_ms": eigh_ms,
          "launches": launches,
          "best_f_minus_fopt": res.best_f - float(inst.f_opt),
          "small_ladder_card_vs_cpu_rel_err": small_ladders(dev)})
    return launches


def small_ladders(dev):
    """The ladder at n=8 on the card and on the CPU's plain path, f8 (sample
    kernel) and f1/f2 through ``fusable_fitness`` (eval-fused kernel), both
    schedules: every trace leaf must agree (ints exactly, floats to 1e-9).
    Returns the largest relative error per run."""
    small = dict(n=8, lam_start=8, kmax_exp=2, eigen_interval=24,
                 max_evals=10**6)
    worst = {}
    for fid in (8, 1, 2):
        for schedule in ("sequential", "concurrent"):
            traces = []
            for d in (dev, "cpu"):
                fn, inst = bbob.make_fitness(fid, 8, 1, device=d)
                fn = bbob.fusable_fitness(inst, (fid,), fn) \
                    if fid in bbob.FUSABLE_FIDS else fn
                eng = ladder.LadderEngine(**small, schedule=schedule, device=d)
                traces.append(eng.run(3, fn, 24)[1])
            err = 0.0
            for a, b in zip(*traces):
                a, b = a.cpu(), b.cpu()
                if a.dtype.is_floating_point:
                    err = max(err, float(((a - b).abs()
                                          / b.abs().clamp_min(1e-300)).max()))
                elif not torch.equal(a, b):
                    raise AssertionError(f"f{fid} {schedule}: card and CPU "
                                         "ladder traces differ")
            if err > 1e-9:
                raise AssertionError(f"f{fid} {schedule}: card vs CPU ladder "
                                     f"rel err {err:.3e}")
            worst[f"f{fid}_{schedule}"] = err
    return worst


def phase_ipop(dev):
    n, budget = 40, 100_000
    fn, inst = bbob.make_fitness(1, n, 1, device=dev)
    fit = bbob.fusable_fitness(inst, (1,), fn)
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res = ipop.run_ipop(fit, n, 5, lam_start=12, kmax_exp=8,
                        max_evals=budget, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cma_gen.LAUNCHES)
    err = res.best_f - float(inst.f_opt)
    lams = [d.lam for d in res.descents]
    if not err <= 1e-8:
        raise AssertionError(f"f1 run: best_f - f_opt = {err}")
    if len(res.descents) < 2:
        raise AssertionError(f"f1 run: {len(res.descents)} descent(s)")
    if any(d.lam != 12 * 2 ** d.k_exp for d in res.descents):
        raise AssertionError(f"f1 run: population sizes {lams}")
    if res.total_fevals > budget:
        raise AssertionError(f"f1 run spent {res.total_fevals} > {budget}")
    if launches["cma_gen_sample_eval"] == 0 or launches["cma_gen_update"] == 0:
        raise AssertionError(f"eval-fused path launches {launches}")
    emit({"phase": "ipop_f1_restarts", "n": n, "best_f_minus_fopt": err,
          "descents": [[d.lam, len(d.gens), d.stop_reason]
                       for d in res.descents],
          "total_fevals": res.total_fevals, "wall_s": wall,
          "launches": launches})
    return launches


def kernel_work(shape, fid, dev):
    """Per kernel, float64 at ``shape``: (kernel call, plain call, one
    PyTorch call of the same product, operations, bytes)."""
    S, lam, n = shape["S"], shape["lam"], shape["n"]
    a, sep = sample_inputs(S, lam, n, torch.float64, dev, fid=fid)
    u = update_inputs(S, lam, n, torch.float64, dev, zero_slot=False)
    lam_nz = int((u["w"] != 0).sum())
    esz = 8
    zd = (a["Z"] * a["D"][:, None, :]).contiguous()
    bt = a["B"].transpose(-1, -2)
    ys = (u["w"].sqrt()[..., None] * u["Y"]).contiguous()
    yst = ys.transpose(-1, -2)
    gemm_flops = 2.0 * S * lam * n * n
    return {
        "cma_gen_sample": (
            lambda: cma_gen.gen_sample(**a), lambda: ref.gen_sample(**a),
            lambda: torch.matmul(zd, bt), gemm_flops,
            esz * S * (3 * lam * n + n * n + 2 * n + 1)),
        "cma_gen_sample_eval": (
            lambda: kernel_eval(a, sep),
            lambda: ref.gen_sample_eval(**a, sep=sep),
            lambda: torch.matmul(zd, bt), gemm_flops + 4.0 * S * lam * n,
            esz * S * (2 * lam * n + lam + n * n + 4 * n + 1)),
        "cma_gen_update": (
            lambda: cma_gen.gen_update(**u), lambda: ref_update(u),
            lambda: torch.matmul(yst, ys),
            S * (n * (n + 1) * lam_nz + 2.0 * lam_nz * n + 4.0 * n * n),
            esz * (S * (3 * n * n + lam_nz * n + lam + 8 * n + 7))),
    }


def phase_table(dev, errs, launches):
    """Per kernel: its launches on each path (``launches`` maps a path to
    its counts), and its time, bound, plain and library time at each path's
    shape; the top-level numbers are those at the phase-3 shape, the
    launches those of both paths together."""
    work = {p: kernel_work(shape, fid, dev)
            for p, (shape, fid) in PATHS.items()}
    rows = []
    for name in SOURCES:
        paths = {}
        for p, w in work.items():
            kern, plain, lib, flops, nbytes = w[name]
            b_ms, b_by = bound(flops, nbytes, torch.float64)
            shape = PATHS[p][0]
            paths[p] = {"shape": [shape["S"], shape["lam"], shape["n"]],
                        "launches": launches[p][name], "ms": time_ms(kern),
                        "plain_ms": time_ms(plain), "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": time_ms(lib)}
        top = paths["main_path_f8"]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": sum(launches[p][name] for p in PATHS),
            "max_abs_err": errs[name],
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "paths": paths})
    emit({"kernels": rows})


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    dev = torch.device("cuda")
    phase_build(dev)
    errs = phase_kernels(dev)
    launches = {"main_path_f8": phase_main_path(dev),
                "ipop_f1_restarts": phase_ipop(dev)}
    phase_table(dev, errs, launches)
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
