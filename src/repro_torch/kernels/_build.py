"""Build the CUDA sources of ``kernels/csrc``, load them with ctypes, and
launch their entry points.

Each ``.cu`` file becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` on first use.  The libraries live under
``build/repro_torch/<hash>/`` at the root of the checkout, keyed by a hash
of every source and of the compiler flags, so an edited source is rebuilt
and an unchanged one is reused.  All missing libraries are compiled at
once, one ``nvcc`` process per source.  Nothing here runs at import.

The wrappers (``cma_gen.py``, ``cma_sample.py``, ``cma_update.py``) share
the rest: ``function`` binds an entry point, ``check`` refuses a tensor the
kernel does not take, and ``launch`` calls it on the current stream,
raises on a launch error and counts the launch in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("cma_gen_sample", "cma_gen_update", "cma_sample", "cma_update")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: per kernel label, the calls that launched it
LAUNCHES = {"cma_gen_sample": 0, "cma_gen_sample_eval": 0,
            "cma_gen_update": 0, "cma_gen_sample_rng": 0,
            "cma_gen_sample_rng_eval": 0, "cma_sample_z_rng": 0,
            "cma_sample": 0, "cma_rank_mu_update": 0}
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every missing library, all in parallel; return their paths.
    The compiler's register and shared-memory report goes to
    ``<name>.ptxas.log`` beside each library."""
    global build_seconds
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = [name for name, path in libs.items() if not path.exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name in todo:
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            log = open(out_dir / f"{name}.ptxas.log", "w")
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT), tmp, log)
        failed = []
        for name, (proc, tmp, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(name)
            else:
                os.replace(tmp, libs[name])
        if failed:
            logs = "\n".join((out_dir / f"{n}.ptxas.log").read_text()
                             for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    build_seconds = time.perf_counter() - t0
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, building first if needed."""
    if name not in _loaded:
        libs = build_all()
        for lib_name, path in libs.items():
            _loaded.setdefault(lib_name, ctypes.CDLL(str(path)))
    return _loaded[name]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def function(lib_name: str, fn_name: str, dtype: torch.dtype, argtypes):
    """Entry point ``<fn_name>_<f32|f64>`` of library ``lib_name``."""
    fn = getattr(library(lib_name), f"{fn_name}_{SUFFIX[dtype]}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, t: torch.Tensor, shape, dtype, device) -> int:
    """``t``'s pointer, once it is a contiguous CUDA tensor of ``shape`` and
    ``dtype`` on ``device``; raises otherwise."""
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def launch(fn, label: str, device, *args) -> None:
    """Call ``fn(*args, stream)`` on ``device``'s current stream; raise on
    the launch error it returns, else count the launch under ``label``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{label}: CUDA launch error {err}")
    LAUNCHES[label] += 1
