"""Serving launcher: batched greedy generation with the step-synchronous
engine, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --smoke --batch 4 --prompt-len 16 --new-tokens 16 --device cpu

Without ``--smoke`` it serves the arch at its published width and depth,
with random weights from seed 0.  Attention archs serve with
``attn_impl="flash"``, so every causal self-attention layer of a prefill
runs the flash attention kernel (``serve_config``).  As in the JAX
package, archs fed by a stub frontend (``musicgen-large``'s frames,
``llama-3.2-vision-90b``'s image embeddings) are refused: ``lm.prefill``
and ``lm.decode_step`` serve them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, override, smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, Request


def serve_config(arch: str, smoke: bool = False, **kw):
    """The config the launcher serves: the arch's published one (or its
    smoke cut) with ``attn_impl="flash"`` and any further ``kw``."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    return override(cfg, **{"attn_impl": "flash", **kw})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help=f"one of {', '.join(ARCHS)}")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = serve_config(args.arch, args.smoke)
    if not cfg.embed_inputs or cfg.family == "vlm":
        raise SystemExit(f"{args.arch}: serve CLI demo supports token-input "
                         "archs (frontend-stub archs are covered by the "
                         "dry-run serve cells)")
    device = resolve_device(args.device)
    params = lm.init_params(cfg, 0, device)
    eng = Engine(cfg, params, max_len=args.max_len, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=(args.prompt_len,),
                                        dtype=np.int32),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.batch)]
    t0 = time.time()
    eng.generate(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_tok = args.batch * args.new_tokens
    print(f"[serve] {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s batched greedy)")
    for i, r in enumerate(reqs[:2]):
        print(f"  req{i}: {r.out[:12]} ...")


if __name__ == "__main__":
    main()
