"""Build the CUDA sources of ``kernels/csrc`` and load them with ctypes.

Each ``.cu`` file becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` on first use.  The libraries live under
``build/repro_torch/<hash>/`` at the root of the checkout, keyed by a hash
of every source and of the compiler flags, so an edited source is rebuilt
and an unchanged one is reused.  All missing libraries are compiled at
once, one ``nvcc`` process per source.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("cma_gen_sample", "cma_gen_update")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
