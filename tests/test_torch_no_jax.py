"""The port stands alone: with jax made unimportable, every module of
repro_torch and chip_smoke.py's helpers import, and neither jax nor the
repro package gets loaded."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import ipop, ladder
from repro_torch.fitness import bbob

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None                 # any `import jax` now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, ".")
import chip_smoke                         # helpers only; main() is not run
assert callable(chip_smoke.main)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m == "repro" or m.startswith(("repro.", "jax"))))
assert not bad, bad
print("OK", len(names))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")
    assert int(out.stdout.split()[1]) >= 14     # every module was imported


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    """``device=None`` means the CUDA device: without one the entry points
    raise instead of running on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, _ = bbob.make_fitness(1, 3, 1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ipop.run_ipop(fn, 3, 0, max_evals=100)
    with pytest.raises(RuntimeError, match="CUDA"):
        ladder.LadderEngine(n=3)


def test_fitness_factories_follow_the_device_rule(monkeypatch):
    """The BBOB factories resolve ``device=None`` as the entry points do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bbob.make_fitness(8, 3, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        bbob.make_instance(1, 3, 1)
    assert bbob.make_instance(1, 3, 1, device="cpu").x_opt.device.type == "cpu"
