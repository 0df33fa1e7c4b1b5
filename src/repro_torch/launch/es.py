"""CMA-ES campaign launcher (port of ``repro/launch/es.py``).

  PYTHONPATH=src python -m repro_torch.launch.es --strategy kdist --fid 8 \
      --dim 10 --devices 8 --gens 200 [--device cpu] [--json]

Strategies: seq (paper Alg. 2, ``run_ipop``) | kdist | krep, the last two
on the strategies' default tier (``impl="eager"``) with the virtual devices
as a leading tensor axis.  ``--device`` defaults to the CUDA device and
raises without one; ``--device cpu`` runs the plain path on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.core import prng
from repro_torch.core.device import resolve_device
from repro_torch.core.ipop import run_ipop
from repro_torch.core.strategies import KDistributed, KReplicated
from repro_torch.fitness import bbob


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--strategy", choices=("seq", "kdist", "krep"),
                    default="kdist")
    ap.add_argument("--fid", type=int, default=8)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--instance", type=int, default=1)
    ap.add_argument("--devices", type=int, default=8,
                    help="virtual device count (a leading tensor axis)")
    ap.add_argument("--gens", type=int, default=200)
    ap.add_argument("--max-evals", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    inst = bbob.make_instance(args.fid, args.dim, args.instance,
                              device=device)
    fit = lambda X: bbob.evaluate(args.fid, inst, X)   # noqa: E731
    key = prng.PRNGKey(args.seed, device=device)
    t0 = time.time()

    if args.strategy == "seq":
        res = run_ipop(fit, args.dim, key, max_evals=args.max_evals,
                       device=device)
        best, fevals = res.best_f, res.total_fevals
    elif args.strategy == "kdist":
        kd = KDistributed(n=args.dim, n_devices=args.devices, device=device)
        carry, _ = kd.run_sim(key, fit, total_gens=args.gens)
        best, fevals = float(carry.best_f), int(carry.fevals.sum())
    else:
        kr = KReplicated(n=args.dim, n_devices=args.devices, device=device)
        out = kr.run_sim(key, fit, phase_gens=args.gens,
                         max_evals=args.max_evals)
        best, fevals = out["best_f"], out["fevals"]

    err = best - float(inst.f_opt)
    summary = dict(strategy=args.strategy, fid=args.fid, dim=args.dim,
                   best_error=err, fevals=fevals,
                   wall_s=round(time.time() - t0, 2))
    if args.json:
        print(json.dumps(summary))
    else:
        print(f"[es] {args.strategy} f{args.fid} d{args.dim}: "
              f"error={err:.3e} after {fevals} evals "
              f"({summary['wall_s']}s)")


if __name__ == "__main__":
    main()
