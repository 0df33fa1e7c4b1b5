"""Training launcher.  Port of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --steps 200 --seq-len 128 --global-batch 8 [--smoke] \
      [--ckpt-dir ck] [--microbatches 2] [--grad-compress int8]

Runs on the CUDA device unless ``--device`` names another (``--device
cpu``: the plain PyTorch path, for a ``--smoke`` config).  One device:
``--model-parallel`` above 1 raises (multi-card training, ROADMAP.md
queue A item 16).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", choices=("none", "int8"),
                    default="none")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs a device mesh: multi-card training "
            "is not ported (ROADMAP.md, queue A item 16)")

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        train=ts_mod.TrainConfig(
            microbatches=args.microbatches,
            grad_compress=args.grad_compress,
            adamw=opt_mod.AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                                      total_steps=args.steps)))
    trainer = Trainer(cfg, tc, seq_len=args.seq_len,
                      global_batch=args.global_batch, device=args.device)
    trainer.run(resume=not args.no_resume)
    final = trainer.history[-1]["loss"] if trainer.history else float("nan")
    print(f"[train] done: {args.steps} steps, final loss {final:.4f}")
    return trainer


if __name__ == "__main__":
    main()
