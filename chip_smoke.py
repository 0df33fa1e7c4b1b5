#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one GPU and hold its kernels against their
plain PyTorch versions.

    python3 chip_smoke.py

Phases, one JSON line each with its seconds; any failed check raises
(non-zero exit):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   and the build of every kernel from ``src/repro_torch/kernels/csrc``;
2. each kernel against its plain version on the card, at the shapes of
   phase 3 (S=1, λ=3072, n=1000) and phase 4 (S=1, λ=3072, n=40, with the
   f1 instance's coefficients), a ragged one (S=3, λ=37, n=45, one
   all-zero-weight slot) and every shape a bucketed path launches (S=1,
   λ=12, n=1000 of phase 3b; S=1, λ=12·2ᵏ, n=40 for k = 0…7 of phase 4b,
   with the f1 coefficients), float64 (max relative error ≤ 1e-12) and
   float32 (≤ 1e-4); C′ must be exactly symmetric.  The in-kernel RNG
   kernels are fed seed words at and above 2³¹, and must be prefix-stable
   kernel against kernel, bit for bit, at n=1000 and n=40: the first 12
   and 192 rows of a λ=3072 call are a λ=12 and a λ=192 call (Z, Y, X
   and F);
3. the main path at full size: ``run_ipop`` on BBOB f8 (n=1000, λ_max=3072,
   float64, 64 generations) through the sample and update kernels, with
   their launch counts and the time of one batched ``eigh`` at that width;
   plus the ladder at n=8 on the card and on the CPU's plain path (f8, and
   f1/f2 through the eval-fused kernel; both schedules), whose traces must
   agree;
3b. the same problem through ``run_ipop(backend="bucketed",
   impl="kernel_rng")`` for 12·64 evaluations: 64 generations on rung 0,
   padded to 12 rows instead of 3072, sampled by the in-kernel RNG kernel;
   its launches, segments, host pulls (segments + 1), padding and ms per
   generation beside phase 3's;
3c. the bucketed path at n=8, λ_start=16 on the card and on the CPU (f8,
   and f1/f2 through the eval-fused kernels; ``auto`` and ``kernel_rng``):
   every int leaf of the trace and the final carry exactly, every float
   leaf (best values, m, σ, C, the paths) element by element to 1e-9
   (``compare_small_runs``); and on the card bucketed against ladder, the
   ints of every executed generation exactly;
4. a whole IPOP run with restarts: ``run_ipop`` on f1 through the
   eval-fused sample kernel (n=40, λ_max=3072, 100 000 evaluations);
4b. the same run through ``backend="bucketed", impl="kernel_rng"`` (the
   in-kernel RNG eval kernel), then again with the speculative segment
   driver (``overlap=True``), whose result must be bit-identical;
5. the ``{"kernels": [...]}`` line: per kernel and per path (phases 3, 3b,
   4 and 4b) its launches, its time, the plain version's time, one
   PyTorch call's time (none for the Z stream alone) and the least time
   the card could take (bound) at that path's shape; the top-level numbers
   are the phase-3 shape's, so rows 1 and 3 are timed on the same GEMM.

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

from repro_torch import convert  # noqa: E402
from repro_torch.core import bucketed, cmaes, ipop, ladder  # noqa: E402
from repro_torch.core.params import CMAConfig, make_params  # noqa: E402
from repro_torch.fitness import bbob  # noqa: E402
from repro_torch.kernels import _build, cma_gen, ops, ref  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): FP64 on the tensor cores and
# FP32 outside them; HBM3 bandwidth.
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
LAM_START, KMAX = 12, 8                   # λ_max = 12·2⁸ = 3072
GENS = 64                                 # phase 3's generations
BUDGET = 100_000                          # phase 4's evaluations
MAIN = dict(S=1, lam=LAM_START << KMAX, n=1000)   # phase 3, f8
RESTARTS = dict(S=1, lam=LAM_START << KMAX, n=40)  # phase 4, f1 (eval kernel)
RAGGED = dict(S=3, lam=37, n=45)
#: the shapes the bucketed paths launch at: rung 0 of phase 3b, and every
#: bucket 12·2ᵏ of phase 4b below λ_max (which is RESTARTS)
BUCKETS = [(dict(MAIN, lam=LAM_START), None)] + [
    (dict(RESTARTS, lam=LAM_START << k), 1) for k in range(KMAX)]
#: the paths whose launches are counted: shape and the fid of the fitness.
#: The bucketed paths' shapes are those their kernels ran at (rung 0 of
#: phase 3b; the widest bucket phase 4b reached), filled in by main().
PATHS = {"main_path_f8": (MAIN, None), "ipop_f1_restarts": (RESTARTS, 1),
         "bucketed_rng_f8": (dict(MAIN, lam=LAM_START), None),
         "bucketed_rng_f1_restarts": (None, 1)}
_SAMPLE_CU = "src/repro_torch/kernels/csrc/cma_gen_sample.cu"
SOURCES = {
    "cma_gen_sample": (_SAMPLE_CU, "src/repro/kernels/cma_gen.py:91"),
    "cma_gen_sample_eval": (_SAMPLE_CU, "src/repro/kernels/cma_gen.py:322"),
    "cma_gen_update": ("src/repro_torch/kernels/csrc/cma_gen_update.cu",
                       "src/repro/kernels/cma_gen.py:447"),
    "cma_gen_sample_rng": (_SAMPLE_CU, "src/repro/kernels/cma_gen.py:311"),
    "cma_gen_sample_rng_eval": (_SAMPLE_CU,
                                "src/repro/kernels/cma_gen.py:337"),
    "cma_sample_z_rng": (_SAMPLE_CU, "src/repro/kernels/cma_gen.py:362"),
}
#: operations per Z element of the counter stream, for the bound: about 100
#: integer operations of threefry2x32-20, then log1p, cos, sqrt and three
#: multiplies, each counted as one
RNG_OPS = 106


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


def seed_words(S, dev, seed=0):
    """(S, 2) uint32 seed words held in int64, the first one ≥ 2³¹."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, size=(S, 2), dtype=np.uint64).astype(
        np.int64)
    w[0, 0] |= 2 ** 31
    return torch.tensor(w, device=dev)


def rng_args(a):
    """The RNG kernels' operands from ``sample_inputs``' (Z is not used)."""
    return {k: a[k] for k in ("m", "sigma", "B", "D")}


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


def same_bits(name, got, want):
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: not bit-identical")


def same_result(name, got, want):
    """Two IPOPResults, bit for bit: every descent's record, the best value
    and point, the evaluations and the driver's bucket sequence."""
    if not (got.total_fevals == want.total_fevals
            and got.best_f == want.best_f
            and np.array_equal(got.best_x, want.best_x)
            and len(got.descents) == len(want.descents)
            and all(a.k_exp == b.k_exp and a.stop_reason == b.stop_reason
                    and all(np.array_equal(x, y) for x, y in
                            zip(a[2:5], b[2:5]))
                    for a, b in zip(got.descents, want.descents))
            and [sg["bucket"] for sg in got.driver["segments"]]
            == [sg["bucket"] for sg in want.driver["segments"]]):
        raise AssertionError(f"{name}: result not bit-identical")


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
    shapes = [(MAIN, None), (RESTARTS, 1), (RAGGED, None)] + BUCKETS
    for shape, fid in shapes:
        for dtype in (torch.float64, torch.float32):
            S, lam, n = shape["S"], shape["lam"], shape["n"]
            a, sep = sample_inputs(S, lam, n, dtype, dev, fid=fid)
            seeds = seed_words(S, dev, seed=lam + n)
            r = rng_args(a)
            errs_here = {}
            got = cma_gen.gen_sample(**a)
            want = ref.gen_sample(**a)
            errs_here["cma_gen_sample"] = compare("cma_gen_sample", got, want,
                                                  dtype)
            got = kernel_eval(a, sep)
            want = ref.gen_sample_eval(**a, sep=sep)
            errs_here["cma_gen_sample_eval"] = compare(
                "cma_gen_sample_eval", got, want, dtype)
            u = update_inputs(S, lam, n, dtype, dev)
            got = cma_gen.gen_update(**u)
            want = ref_update(u)
            errs_here["cma_gen_update"] = compare("cma_gen_update", got,
                                                  want, dtype)
            if not torch.equal(got[0], got[0].transpose(-1, -2)):
                raise AssertionError("cma_gen_update: C' is not symmetric")
            got = cma_gen.gen_sample_rng(**r, seeds=seeds, lam=lam)
            want = ref.gen_sample_rng(**r, seeds=seeds, lam=lam)
            errs_here["cma_gen_sample_rng"] = compare(
                "cma_gen_sample_rng", got, want, dtype)
            got = cma_gen.gen_sample_rng_eval(*r.values(), seeds, lam, *sep)
            want = ref.gen_sample_rng_eval(*r.values(), seeds, lam, sep)
            errs_here["cma_gen_sample_rng_eval"] = compare(
                "cma_gen_sample_rng_eval", got, want, dtype)
            got = cma_gen.sample_z_rng(seeds, lam, n, dtype)
            want = ref.sample_z_rng(seeds, lam, n, dtype)
            errs_here["cma_sample_z_rng"] = compare(
                "cma_sample_z_rng", (got,), (want,), dtype)
            torch.cuda.synchronize()
            for k, e in errs_here.items():
                if dtype == torch.float64:
                    errs[k] = max(errs[k], e[0])
                rows.append({"kernel": k, "shape": [S, lam, n],
                             "dtype": str(dtype), "max_abs_err": e[0],
                             "max_rel_err": e[1]})
    emit({"phase": "kernels_vs_plain", "checks": rows,
          "rng_prefix_stable": rng_prefix_checks(dev)})
    return errs


def rng_prefix_checks(dev):
    """Kernel against kernel, bit for bit, at both widths the bucketed
    paths run (n = 1000 and 40): the first rows and columns of a λ_max call
    are a narrow call at bucket widths 12 and 192 (the bucket property).
    Seed words ≥ 2³¹ are read as unsigned: the kernel's stream is the plain
    version's, whose words are uint32 by construction, and the words'
    int64 twins below 0 give the same bits."""
    out = {}
    for dtype, n in ((d, n) for d in (torch.float64, torch.float32)
                     for n in (MAIN["n"], RESTARTS["n"])):
        S, lam = MAIN["S"], MAIN["lam"]
        a, sep = sample_inputs(S, lam, n, dtype, dev, fid=1)
        r, seeds = rng_args(a), seed_words(S, dev, seed=5)
        wide_z = cma_gen.sample_z_rng(seeds, lam, n, dtype)
        wide_x = cma_gen.gen_sample_rng(*r.values(), seeds, lam)
        wide_f = cma_gen.gen_sample_rng_eval(*r.values(), seeds, lam, *sep)
        for p in (LAM_START, LAM_START << 4):
            same_bits("cma_sample_z_rng prefix",
                      (cma_gen.sample_z_rng(seeds, p, n, dtype),
                       cma_gen.sample_z_rng(seeds, p, 7, dtype)),
                      (wide_z[:, :p], wide_z[:, :p, :7]))
            same_bits("cma_gen_sample_rng prefix",
                      cma_gen.gen_sample_rng(*r.values(), seeds, p),
                      (t[:, :p] for t in wide_x))
            same_bits("cma_gen_sample_rng_eval prefix",
                      cma_gen.gen_sample_rng_eval(*r.values(), seeds, p,
                                                  *sep),
                      (t[:, :p] for t in wide_f))
        high = seeds.clone()
        high[:, 1] = 2 ** 32 - 1 - high[:, 1] % 7
        got = cma_gen.sample_z_rng(high, 64, n, dtype)
        compare("cma_sample_z_rng unsigned seeds", (got,),
                (ref.sample_z_rng(high, 64, n, dtype),), dtype)
        same_bits("cma_sample_z_rng negative twins",
                  (cma_gen.sample_z_rng(high - 2 ** 32, 64, n, dtype),),
                  (got,))
        out[f"{dtype}_n{n}"] = True
    torch.cuda.synchronize()
    return out


def phase_main_path(dev):
    """run_ipop on f8 at full width through the sample and update kernels,
    then the same ladder at n=8 on the card and on the CPU."""
    n, gens, lam_max = MAIN["n"], GENS, MAIN["lam"]
    fn, inst = bbob.make_fitness(8, n, 1, device=dev)
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res = ipop.run_ipop(fn, n, 11, lam_start=LAM_START, kmax_exp=KMAX,
                        max_evals=10**9, total_gens=gens, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cma_gen.LAUNCHES)
    if launches["cma_gen_sample"] != gens or launches["cma_gen_update"] != gens:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{gens} of the sample and update kernels")
    if not np.isfinite(res.best_f) or res.total_fevals != LAM_START * gens:
        raise AssertionError(f"f8 run: best_f {res.best_f}, fevals "
                             f"{res.total_fevals}")
    d0 = res.descents[0]
    if not (np.isfinite(d0.best_f).all() and (np.diff(d0.best_f) <= 0).all()
            and np.array_equal(d0.gens, np.arange(1, gens + 1))):
        raise AssertionError("f8 run: trace is not a finite best-so-far "
                             "record of every generation")

    # one batched eigh at this width (eigen_interval is 1 at λ_max = 3072,
    # so the ladder runs one every generation; it syncs with the host)
    C = update_inputs(1, LAM_START, n, torch.float64, dev)["C"]
    eigh_ms = time_ms(lambda: cmaes.eigen_decompose(C), reps=3)
    ms_per_gen = wall / gens * 1e3
    emit({"phase": "main_path_f8", "n": n, "lam_max": lam_max, "gens": gens,
          "ms_per_gen": ms_per_gen, "eigh_ms": eigh_ms,
          "launches": launches,
          "best_f_minus_fopt": res.best_f - float(inst.f_opt),
          "padding": {"useful_evals": res.total_fevals,
                      "padded_evals": gens * lam_max},
          "small_ladder_card_vs_cpu_rel_err": small_ladders(dev)})
    return launches, ms_per_gen


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


def bucketed_padding(res, lam_start):
    """Useful against padded evaluations of a bucketed ``run_ipop`` result:
    each segment step pays its bucket's width, each executed generation is
    worth its rung's λ."""
    useful = sum(len(d.gens) * d.lam for d in res.descents)
    padded = sum(sg["gens"] * lam_start * 2 ** sg["bucket"]
                 for sg in res.driver["segments"])
    return {"useful_evals": useful, "padded_evals": padded,
            "waste": padded / max(useful, 1)}


def check_bucketed_run(name, log, launches, sample_kernel):
    """One sample and one update launch per segment step, none of the
    Z-operand kernels, and one pull per boundary."""
    steps = sum(sg["gens"] for sg in log["segments"])
    others = {k: v for k, v in launches.items()
              if k not in (sample_kernel, "cma_gen_update")}
    if (launches[sample_kernel] != steps or launches["cma_gen_update"] != steps
            or any(others.values())):
        raise AssertionError(f"{name}: launches {launches} for {steps} "
                             "generations")
    if log["pulls"] != len(log["segments"]) + 1:
        raise AssertionError(f"{name}: {log['pulls']} pulls for "
                             f"{len(log['segments'])} segments")
    return steps


def phase_bucketed_main(dev, ladder_ms_per_gen):
    """Phase 3's problem through the bucketed backend and the in-kernel RNG
    sample kernel, for 64 generations of rung 0."""
    n, gens, lam_max = MAIN["n"], GENS, MAIN["lam"]
    fn, inst = bbob.make_fitness(8, n, 1, device=dev)
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res = ipop.run_ipop(fn, n, 11, lam_start=LAM_START, kmax_exp=KMAX,
                        max_evals=LAM_START * gens, backend="bucketed",
                        impl="kernel_rng", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cma_gen.LAUNCHES)
    steps = check_bucketed_run("bucketed f8", res.driver, launches,
                               "cma_gen_sample_rng")
    d0 = res.descents[0]
    if (steps != gens or res.total_fevals != LAM_START * gens
            or not np.isfinite(res.best_f)
            or not np.array_equal(d0.gens, np.arange(1, gens + 1))
            or not (np.diff(d0.best_f) <= 0).all()):
        raise AssertionError(f"bucketed f8 run: {steps} steps, fevals "
                             f"{res.total_fevals}, best_f {res.best_f}")
    padding = bucketed_padding(res, LAM_START)
    if padding["padded_evals"] != padding["useful_evals"]:
        raise AssertionError(f"bucketed f8 run: padding {padding} on rung 0")
    emit({"phase": "bucketed_rng_f8", "n": n, "lam_max": lam_max, "gens": gens,
          "ms_per_gen": wall / gens * 1e3,
          "ladder_ms_per_gen": ladder_ms_per_gen, "launches": launches,
          "segments": res.driver["segments"], "pulls": res.driver["pulls"],
          "padding": padding, "ladder_padded_evals": gens * lam_max,
          "best_f_minus_fopt": res.best_f - float(inst.f_opt)})
    return launches


def f_err(a, b, f_opt):
    """Fitness values ``a`` against ``b``, element by element: ``(err,
    drift)``.  ``err`` is the largest |a − b| relative to |b| + |b − f_opt|,
    the value's own magnitude and never less than |f_opt| (relative to |b|
    alone it would blow up where a record crosses 0 on its way to a
    negative f_opt).  ``drift`` is the largest |a − b| beyond 4 ulp of
    ``b`` relative to |b − f_opt|: how far the two runs drifted apart
    against how far they still are from the optimum.  Non-finite values
    must sit in the same places."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    if not (np.array_equal(fin, np.isfinite(a))
            and np.array_equal(a[~fin], b[~fin])):
        return float("inf"), float("inf")
    a, b = a[fin], b[fin]
    if not b.size:
        return 0.0, 0.0
    diff, gap = np.abs(a - b), np.abs(b - f_opt)
    err = diff / np.maximum(np.abs(b) + gap, 1e-300)
    excess = np.maximum(diff - 4 * np.spacing(np.abs(b)), 0.0)
    drift = np.divide(excess, gap, out=np.where(excess > 0, np.inf, 0.0),
                      where=gap > 0)
    return float(err.max()), float(drift.max())


def rel_err(a, b, scale):
    """max |a − b| / scale, per slot where ``scale`` is (S,), else per
    element."""
    if scale.shape != a.shape:
        d = (a - b).abs().reshape(a.shape[0], -1).amax(dim=1)
    else:
        d = (a - b).abs()
    return float((d / scale.clamp_min(1e-300)).max())


def compare_small_runs(name, card, cpu, f_opt):
    """Two ``run_bucketed_single`` results (carry, trace, log): every int
    leaf of the trace and the carry exactly; every float leaf element by
    element, bound by 1e-9 — the best values (trace and carry) by
    ``f_err``, m relative to max(|m|, 1), σ relative to itself, C relative
    to its largest entry, the paths relative to their largest entry.
    Returns the bound errors and, unbound, the drift: the best values'
    (``f_err``) and m against the step scale σ·max D.  best_x is not
    compared: near a converged Rosenbrock optimum a 1e-13 change of f moves
    x along the valley by far more."""
    (c_a, t_a, _), (c_b, t_b, _) = card, cpu
    c_a = convert.ladder_carry(convert.to_numpy(c_a), "cpu")
    t_a = ladder.LadderTrace(*(v.cpu() for v in t_a))
    ints = [(f, getattr(t_a, f), getattr(t_b, f)) for f in t_a._fields
            if not getattr(t_a, f).dtype.is_floating_point]
    ints += [(f, getattr(c_a, f), getattr(c_b, f))
             for f in ("k_idx", "incarnation", "active", "total_fevals")]
    ints += [(f"states.{f}", getattr(c_a.states, f), getattr(c_b.states, f))
             for f in ("gen", "last_eigen_gen", "fevals", "hist_count",
                       "stop", "stop_reason", "restarts")]
    for f, x, y in ints:
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: {f} differs between card and CPU")
    sa, sb = c_a.states, c_b.states
    bests = [(t_a.best_f, t_b.best_f), (t_a.global_best, t_b.global_best),
             (c_a.best_f, c_b.best_f), (sa.best_f, sb.best_f)]
    f_errs = [f_err(x, y, f_opt) for x, y in bests]
    errs = {"best_f": max(e for e, _ in f_errs),
            "sigma": rel_err(sa.sigma, sb.sigma, sb.sigma.abs()),
            "m": rel_err(sa.m, sb.m, sb.m.abs().clamp_min(1.0)),
            "C": rel_err(sa.C, sb.C, sb.C.abs().amax(dim=(1, 2))),
            "p_sigma": rel_err(sa.p_sigma, sb.p_sigma,
                               sb.p_sigma.abs().amax(dim=1)),
            "p_c": rel_err(sa.p_c, sb.p_c, sb.p_c.abs().amax(dim=1))}
    drift = {"best_f_vs_gap": max(d for _, d in f_errs),
             "m_vs_step": rel_err(sa.m, sb.m, sb.sigma * sb.D.amax(dim=1))}
    return errs, drift


def phase_small_bucketed(dev):
    """The bucketed path at n=8 on the card and on the CPU, f8 and f1/f2
    through ``fusable_fitness``, under both sampling tiers, compared by
    ``compare_small_runs``; on the card, bucketed against the padded
    ladder: the ints of every executed generation exactly.

    λ_start = 16 = 2n: with fewer than n weighted rows (μ < n) the first
    covariances have a repeated eigenvalue, whose eigenvectors cuSOLVER and
    LAPACK choose differently, and the two runs then sample different
    populations from the same distribution."""
    kw = dict(n=8, lam_start=16, kmax_exp=2, max_evals=6000)
    worst = {}
    for fid in (8, 1, 2):
        for impl in ("auto", "kernel_rng"):
            runs, fns = {}, {}
            for d in (dev, "cpu"):
                fn, inst = bbob.make_fitness(fid, 8, 1, device=d)
                fns[d] = bbob.fusable_fitness(inst, (fid,), fn) \
                    if fid in bbob.FUSABLE_FIDS else fn
                eng = bucketed.BucketedLadderEngine(impl=impl, device=d, **kw)
                runs[d] = bucketed.run_bucketed_single(eng, 3, fns[d])
            name = f"f{fid}_{impl}"
            errs, drift = compare_small_runs(name, runs[dev], runs["cpu"],
                                             float(inst.f_opt))
            eng_l = ladder.LadderEngine(schedule="sequential", impl=impl,
                                        device=dev, **kw)
            c_l, t_l = eng_l.run(3, fns[dev])
            c_b, t_b, log = runs[dev]
            for f in ("k_idx", "gen", "fevals", "stop_reason", "stopped"):
                if not torch.equal(getattr(t_b, f)[t_b.ran],
                                   getattr(t_l, f)[t_l.ran]):
                    raise AssertionError(f"{name}: bucketed and ladder {f} "
                                         "differ on the card")
            if int(c_b.total_fevals) != int(c_l.total_fevals):
                raise AssertionError(f"{name}: bucketed and ladder fevals")
            worst[name] = {"errs": errs, "drift": drift,
                           "gens": int(t_b.ran.sum()),
                           "segments": len(log["segments"]),
                           "fevals": int(c_b.total_fevals)}
    emit({"phase": "small_bucketed_card_vs_cpu", **kw, "runs": worst})
    bad = {name: {k: v for k, v in w["errs"].items() if not v <= 1e-9}
           for name, w in worst.items()}
    if any(bad.values()):
        raise AssertionError(f"card vs CPU errors above 1e-9: {bad}")


def phase_ipop(dev):
    n, budget = RESTARTS["n"], BUDGET
    fn, inst = bbob.make_fitness(1, n, 1, device=dev)
    fit = bbob.fusable_fitness(inst, (1,), fn)
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res = ipop.run_ipop(fit, n, 5, lam_start=LAM_START, kmax_exp=KMAX,
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
    if any(d.lam != LAM_START * 2 ** d.k_exp for d in res.descents):
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


def phase_bucketed_restarts(dev):
    """Phase 4's run through the bucketed backend and the in-kernel RNG
    eval kernel; then again with the speculative driver, bit-identical.
    Returns the launches and the widest λ the run reached."""
    n, budget = RESTARTS["n"], BUDGET
    fn, inst = bbob.make_fitness(1, n, 1, device=dev)
    fit = bbob.fusable_fitness(inst, (1,), fn)
    kw = dict(lam_start=LAM_START, kmax_exp=KMAX, max_evals=budget,
              impl="kernel_rng")
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res = ipop.run_ipop(fit, n, 5, backend="bucketed", device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cma_gen.LAUNCHES)
    steps = check_bucketed_run("bucketed f1", res.driver, launches,
                               "cma_gen_sample_rng_eval")
    err = res.best_f - float(inst.f_opt)
    if not err <= 1e-8:
        raise AssertionError(f"bucketed f1 run: best_f - f_opt = {err}")
    if len(res.descents) < 2 or any(d.lam != LAM_START * 2 ** d.k_exp
                                    for d in res.descents):
        raise AssertionError("bucketed f1 run: descents "
                             f"{[d.lam for d in res.descents]}")
    if res.total_fevals > budget:
        raise AssertionError(f"bucketed f1 run spent {res.total_fevals}")

    eng = bucketed.BucketedLadderEngine(n=n, overlap=True, device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_o = ipop._result_from_ladder(
        eng.full, *bucketed.run_bucketed_single(eng, 5, fit))
    torch.cuda.synchronize()
    wall_o = time.perf_counter() - t0
    same_result("overlap=True", res_o, res)
    segs_o = res_o.driver["segments"]
    emit({"phase": "bucketed_rng_f1_restarts", "n": n,
          "best_f_minus_fopt": err,
          "descents": [[d.lam, len(d.gens), d.stop_reason]
                       for d in res.descents],
          "total_fevals": res.total_fevals, "steps": steps, "wall_s": wall,
          "ms_per_step": wall / steps * 1e3, "launches": launches,
          "segments": len(res.driver["segments"]),
          "pulls": res.driver["pulls"],
          "padding": bucketed_padding(res, LAM_START),
          "overlap": {"wall_s": wall_o, "segments": len(segs_o),
                      "spec_hits": sum(sg["spec_hit"] for sg in segs_o),
                      "spec_s": sum(sg.get("spec_s", 0.0) for sg in segs_o),
                      "sync_s": sum(sg["sync_s"] for sg in segs_o),
                      "pulls": res_o.driver["pulls"]}})
    return launches, max(d.lam for d in res.descents)


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
    rng_flops = float(RNG_OPS) * S * lam * n
    seeds = seed_words(S, dev)
    r = list(rng_args(a).values())
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
        "cma_gen_sample_rng": (
            lambda: cma_gen.gen_sample_rng(*r, seeds, lam),
            lambda: ref.gen_sample_rng(*r, seeds, lam),
            lambda: torch.matmul(zd, bt), gemm_flops + rng_flops,
            esz * S * (2 * lam * n + n * n + 2 * n + 1) + 8 * S),
        "cma_gen_sample_rng_eval": (
            lambda: cma_gen.gen_sample_rng_eval(*r, seeds, lam, *sep),
            lambda: ref.gen_sample_rng_eval(*r, seeds, lam, sep),
            lambda: torch.matmul(zd, bt),
            gemm_flops + 4.0 * S * lam * n + rng_flops,
            esz * S * (lam * n + lam + n * n + 4 * n + 1) + 8 * S),
        "cma_sample_z_rng": (
            lambda: cma_gen.sample_z_rng(seeds, lam, n),
            lambda: ref.sample_z_rng(seeds, lam, n), None, rng_flops,
            esz * S * lam * n + 8 * S),
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
                        "bound_by": b_by,
                        "library_ms": None if lib is None else time_ms(lib)}
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
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("1_build", phase_build, dev)
    errs = timed("2_kernels", phase_kernels, dev)
    launches = {}
    launches["main_path_f8"], ladder_ms = timed("3_main_path",
                                                phase_main_path, dev)
    launches["bucketed_rng_f8"] = timed("3b_bucketed", phase_bucketed_main,
                                        dev, ladder_ms)
    timed("3c_small_bucketed", phase_small_bucketed, dev)
    launches["ipop_f1_restarts"] = timed("4_ipop", phase_ipop, dev)
    launches["bucketed_rng_f1_restarts"], widest = timed(
        "4b_bucketed_restarts", phase_bucketed_restarts, dev)
    PATHS["bucketed_rng_f1_restarts"] = (dict(RESTARTS, lam=widest), 1)
    timed("5_table", phase_table, dev, errs, launches)
    emit({"phase_seconds": seconds})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
