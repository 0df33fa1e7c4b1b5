"""Fault-tolerant training loop.  Port of ``repro/train/trainer.py``.

  * checkpoint/restart: asynchronous checkpoints every ``ckpt_every``
    steps through ``checkpoint/store.py`` (the JAX package's on-disk
    layout, one writer in flight); on (re)start the trainer resumes from
    the newest committed step, and the deterministic data pipeline replays
    from exactly that step;
  * crash containment: a non-finite loss skips the update (the step still
    advances) and counts toward a bounded skip budget;
  * ``history``: one record a step (loss, grad_norm, lr).

The run ends with a blocking checkpoint of the last step, unless the
periodic one just wrote that step: then it waits for that writer (the JAX
package writes the same step twice).

The model, its parameters and moments live on ``device`` (``None``: the
CUDA device, raising without one).  The initial weights are the port's own
draw from ``tc.seed`` (``lm.init_params``), not ``jax.random``'s; a
checkpoint of the JAX package's trainer restores into the same tree.  The
elastic re-placement across meshes is multi-card work (ROADMAP.md, queue A
item 16): ``mesh`` must be None.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import lm
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    # the JAX package's /tmp/repro_ckpt, under $TMPDIR
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    keep_ckpts: int = 3
    log_every: int = 10
    max_skipped: int = 10           # NaN-step budget before aborting
    seed: int = 0
    train: ts_mod.TrainConfig = dataclasses.field(
        default_factory=ts_mod.TrainConfig)


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainerConfig,
                 seq_len: int, global_batch: int, mesh=None,
                 log_fn: Callable[[str], None] = print, *, device=None):
        if mesh is not None:
            raise ts_mod._no_mesh("Trainer(mesh=...)")
        self.cfg, self.tc = cfg, tc
        self.device = resolve_device(device)
        self.log = log_fn
        self.data = SyntheticTokens(cfg, seq_len, global_batch, seed=tc.seed)
        self.step_fn = ts_mod.make_train_step(cfg, tc.train)
        self.history: list[dict] = []
        self._pending_ckpt = None
        self._saved_step: Optional[int] = None

    # -- state --------------------------------------------------------------
    def init_state(self, key: Optional[int] = None):
        key = key if key is not None else self.tc.seed
        params = lm.init_params(self.cfg, key, device=self.device)
        return params, opt_mod.init_opt_state(params)

    def try_restore(self, params, opt_state):
        step = store.latest_step(self.tc.ckpt_dir)
        if step is None:
            return params, opt_state, 0
        tree = store.restore(self.tc.ckpt_dir, step, (params, opt_state))
        self.log(f"[trainer] restored step {step} from {self.tc.ckpt_dir}")
        return tree[0], tree[1], step

    def batch_at(self, step: int) -> dict:
        """The step's batch as int32 tensors on the trainer's device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.data.batch_at(step).items()}

    # -- loop ---------------------------------------------------------------
    def run(self, resume: bool = True):
        params, opt_state = self.init_state()
        start = 0
        if resume:
            params, opt_state, start = self.try_restore(params, opt_state)
        skipped = 0
        t0 = time.time()
        for step in range(start, self.tc.total_steps):
            new_params, new_opt, metrics = self.step_fn(
                params, opt_state, self.batch_at(step))
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                skipped += 1
                self.log(f"[trainer] step {step}: non-finite loss, "
                         f"skipping update ({skipped}/{self.tc.max_skipped})")
                if skipped > self.tc.max_skipped:
                    raise RuntimeError("NaN budget exhausted")
            else:
                params, opt_state = new_params, new_opt
            del new_params, new_opt
            self.history.append({"step": step, "loss": loss,
                                 "grad_norm": float(metrics["grad_norm"]),
                                 "lr": float(metrics["lr"])})
            if step % self.tc.log_every == 0:
                dt = time.time() - t0
                self.log(f"[trainer] step {step} loss={loss:.4f} "
                         f"gnorm={float(metrics['grad_norm']):.3f} "
                         f"({dt:.1f}s)")
            if (step + 1) % self.tc.ckpt_every == 0:
                self._checkpoint(step + 1, params, opt_state)
        if self._saved_step == self.tc.total_steps:
            self._join()                  # that step's writer, not a rewrite
        else:
            self._checkpoint(self.tc.total_steps, params, opt_state,
                             blocking=True)
        return params, opt_state

    def _join(self):
        if self._pending_ckpt is not None:
            self._pending_ckpt.join()
            self._pending_ckpt = None

    def _checkpoint(self, step, params, opt_state, blocking=False):
        self._join()                                  # one writer in flight
        os.makedirs(self.tc.ckpt_dir, exist_ok=True)
        self._pending_ckpt = store.save(
            self.tc.ckpt_dir, step, (params, opt_state), blocking=blocking)
        self._saved_step = step
        store.prune(self.tc.ckpt_dir, self.tc.keep_ckpts)
