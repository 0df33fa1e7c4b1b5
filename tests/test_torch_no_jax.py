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
print("OK", len(names), " ".join(names))
"""
#: modules of the LM slice the walk must reach
LM_MODULES = {"repro_torch.configs.base", "repro_torch.configs.qwen2_0_5b",
              "repro_torch.configs.rwkv6_3b", "repro_torch.models.layers",
              "repro_torch.models.mlp", "repro_torch.models.attention",
              "repro_torch.models.rwkv6", "repro_torch.models.lm",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.rwkv6_wkv", "repro_torch.serve.engine",
              "repro_torch.launch.serve", "repro_torch.data.pipeline",
              "repro_torch.fitness.nn_fitness"}
#: modules of the mesh slice the walk must reach
MESH_MODULES = {"repro_torch.distributed.mesh_engine",
                "repro_torch.distributed.sharding",
                "repro_torch.launch.mesh"}
#: modules of the service slice the walk must reach
SERVICE_MODULES = {"repro_torch.checkpoint.store", "repro_torch.obs",
                   "repro_torch.obs.schema", "repro_torch.obs.registry",
                   "repro_torch.obs.trace", "repro_torch.obs.recorder",
                   "repro_torch.service", "repro_torch.service.queue",
                   "repro_torch.service.allocator",
                   "repro_torch.service.server",
                   "repro_torch.launch.serve_campaigns"}
#: modules of the fleet slice the walk must reach
FLEET_MODULES = {"repro_torch.fleet", "repro_torch.fleet.faults",
                 "repro_torch.fleet.health", "repro_torch.fleet.controller"}


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")
    words = out.stdout.split()
    assert int(words[1]) >= 28                  # every module was imported
    assert LM_MODULES <= set(words[2:]), LM_MODULES - set(words[2:])
    assert MESH_MODULES <= set(words[2:]), MESH_MODULES - set(words[2:])
    assert SERVICE_MODULES <= set(words[2:]), \
        SERVICE_MODULES - set(words[2:])
    assert FLEET_MODULES <= set(words[2:]), FLEET_MODULES - set(words[2:])


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


def test_smoke_names_every_csrc_kernel():
    """chip_smoke.py's no-fallback check looks for ``CSRC_KERNELS`` among
    the profiled kernels: the tuple is every ``__global__`` function of
    ``kernels/csrc``."""
    import ast
    import re
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    named = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", "") == "CSRC_KERNELS")
    src = "".join(p.read_text() for p in sorted(
        (ROOT / "src/repro_torch/kernels/csrc").glob("*.cu*")))
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|"
                      r"\([^()]*\))*\)\s*)?(\w+)\s*\(")
    found = set(decl.findall(src))
    assert len(found) >= 14
    assert set(named) == found, (set(named) ^ found)
