"""Campaign-service CLI: serve a stream of optimization requests (port of
``repro/launch/serve_campaigns.py``: the same flags and the same output
JSON).

  PYTHONPATH=src python -m repro_torch.launch.serve_campaigns \
      [--requests reqs.json | --synthetic 8] [--devices 4] [--device cpu] \
      [--snapshot-dir ckpt --snapshot-every 4] [--resume] [--out results.json] \
      [--metrics-out metrics.jsonl] [--metrics-port 9100] \
      [--trace-out trace.json] [--postmortem-dir pm] \
      [--fleet] [--chaos-kills 1:3:2,...] [--fleet-deadline-s 30] \
      [--fleet-skew 0.5]

``--metrics-out`` appends one JSONL record of every live
``repro_torch.obs`` series per service round (``docs/METRICS.md``);
``--metrics-port`` also serves the text exposition at ``GET /metrics`` and
a JSON ``GET /statusz``.  ``--trace-out PATH`` writes the run's spans on
exit: PATH gets the Chrome ``trace_event`` JSON (ui.perfetto.dev) and
``PATH + 'l'`` the raw span records that ``python -m
repro_torch.obs.trace --summarize`` digests.  ``--postmortem-dir`` arms the
flight recorder: an island death or a job quarantine dumps
``postmortem-<island>-<boundary>.json`` there.

``--devices N`` gives every lane N islands (``make_campaign_mesh(N)``:
round-robin over the visible CUDA devices, eight on one card if N = 8);
``--device cpu`` puts them on the CPU.  The service runs on the CUDA
device unless ``--device`` says otherwise.  ``--fleet`` drives the
service through a ``repro_torch.fleet.FleetController`` (health
monitoring, snapshots every ``--snapshot-every`` rounds, or 4, recovery of
a dead island's rows onto the survivors, skew rebalancing at
``--fleet-skew``); ``--chaos-kills "island:boundary[:down_for],..."``
injects kills and implies ``--fleet``.  Recovery reads the last snapshot
when ``--snapshot-dir`` is given, and replays rows from their requests
otherwise.

``--requests`` takes a JSON list of CampaignRequest dicts, each optionally
carrying an ``arrival_s`` offset; ``--synthetic N`` generates a mixed-dim
BBOB trace instead.  Requests are submitted as their arrival time passes
while the service loop runs, and admitted at the next segment boundary.
``--resume`` restores the newest committed snapshot from
``--snapshot-dir`` instead of starting fresh (custom callables cannot ride
a snapshot: the CLI serves BBOB requests only).
"""
from __future__ import annotations

import argparse
import json
import sys


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", default=None,
                    help="JSON file with a list of request dicts")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate N synthetic BBOB requests instead")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1,
                    help="islands per lane (make_campaign_mesh)")
    ap.add_argument("--device", default=None,
                    help="island device (default: the CUDA device)")
    ap.add_argument("--dims", default="4,8",
                    help="dim menu for --synthetic")
    ap.add_argument("--fids", default="1,8",
                    help="compiled-in BBOB menu (and --synthetic draw set)")
    ap.add_argument("--budget", type=int, default=4000)
    ap.add_argument("--lam-start", type=int, default=8)
    ap.add_argument("--kmax", type=int, default=2)
    ap.add_argument("--rows-per-island", type=int, default=4)
    ap.add_argument("--arrival-gap-s", type=float, default=0.0,
                    help="synthetic inter-arrival gap (0 = all at t=0)")
    ap.add_argument("--queue-ttl-s", type=float, default=None,
                    help="per-request queue TTL stamped on synthetic "
                         "requests (expired while queued -> status=expired)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request run deadline stamped on synthetic "
                         "requests (enforced at segment boundaries)")
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot cadence in service rounds")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-steps", type=int, default=10_000)
    ap.add_argument("--fleet", action="store_true",
                    help="supervise the service with a FleetController "
                         "(health monitoring + snapshot recovery)")
    ap.add_argument("--fleet-deadline-s", type=float, default=30.0,
                    help="boundary-pull deadline before an island is "
                         "suspect")
    ap.add_argument("--fleet-skew", type=float, default=0.5,
                    help="slot-occupancy skew that triggers a lane repack")
    ap.add_argument("--chaos-kills", default=None,
                    help="injected kill schedule "
                         "'island:boundary[:down_for],...' (implies "
                         "--fleet)")
    ap.add_argument("--out", default=None, help="write results JSON here")
    ap.add_argument("--metrics-out", default=None,
                    help="append a metrics JSONL record every service round")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve GET /metrics on 127.0.0.1:PORT (0=ephemeral)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto-loadable trace_event JSON here "
                         "on exit (raw spans land beside it as .jsonl)")
    ap.add_argument("--postmortem-dir", default=None,
                    help="flight-recorder dump directory (island death or "
                         "job quarantine writes postmortem-*.json here)")
    return ap


def main(argv=None):
    return _serve(_parser().parse_args(argv))


def _synthetic_requests(args):
    import numpy as np
    rng = np.random.default_rng(args.seed)
    dims = [int(d) for d in args.dims.split(",")]
    fids = [int(f) for f in args.fids.split(",")]
    reqs = []
    for j in range(args.synthetic):
        spec = {
            "dim": int(rng.choice(dims)),
            "fid": int(rng.choice(fids)),
            "instance": 1,
            "budget": int(args.budget * rng.uniform(0.5, 1.5)),
            "seed": int(rng.integers(0, 2 ** 31)),
            "priority": int(rng.integers(0, 3)),
            "arrival_s": round(j * args.arrival_gap_s, 4),
            "tag": f"synthetic-{j}",
            # stable dedup key: resubmits after shed/backpressure are
            # idempotent — a live or completed ticket is returned as-is
            "dedup_key": f"syn-{args.seed}-{j}",
        }
        if args.queue_ttl_s is not None:
            spec["queue_ttl_s"] = args.queue_ttl_s
        if args.deadline_s is not None:
            spec["deadline_s"] = args.deadline_s
        reqs.append(spec)
    return reqs


def _serve(args):
    import time

    from repro_torch import obs
    from repro_torch.launch.mesh import make_campaign_mesh
    from repro_torch.obs.recorder import recorder as flight_recorder
    from repro_torch.service import (CampaignRequest, CampaignServer,
                                     QueueFull)

    if args.requests:
        with open(args.requests) as fh:
            raw = json.load(fh)
    elif args.synthetic:
        raw = _synthetic_requests(args)
    elif args.resume:
        raw = []                        # serve only the snapshot's jobs
    else:
        raise SystemExit("pass --requests FILE or --synthetic N")
    raw = sorted(raw, key=lambda r: r.get("arrival_s", 0.0))

    fids = tuple(int(f) for f in args.fids.split(","))
    mesh = make_campaign_mesh(args.devices, device=args.device)
    if args.resume:
        if not args.snapshot_dir:
            raise SystemExit("--resume requires --snapshot-dir")
        srv = CampaignServer.restore(args.snapshot_dir, mesh=mesh,
                                     snapshot_every=args.snapshot_every)
        srv.metrics_out = args.metrics_out      # serving-process property
        print(f"[serve] resumed: {srv.stats()}", flush=True)
        raw = []                    # resumed queue/jobs come from the snapshot
    else:
        srv = CampaignServer(bbob_fids=fids, lam_start=args.lam_start,
                             kmax_exp=args.kmax,
                             max_budget=max((r["budget"] for r in raw),
                                            default=args.budget),
                             rows_per_island=args.rows_per_island,
                             mesh=mesh,
                             snapshot_dir=args.snapshot_dir,
                             snapshot_every=args.snapshot_every,
                             metrics_out=args.metrics_out)
    if args.postmortem_dir:
        flight_recorder().out_dir = args.postmortem_dir
    if args.metrics_port is not None:
        _httpd, port = obs.start_metrics_server(port=args.metrics_port,
                                                status_fn=srv.statusz)
        print(f"[serve] metrics at http://127.0.0.1:{port}/metrics, "
              f"status at /statusz", flush=True)

    ctl = None
    if args.fleet or args.chaos_kills:
        from repro_torch.fleet import FaultPlan, FleetConfig
        from repro_torch.fleet.controller import FleetController
        plan = FaultPlan.parse(args.chaos_kills) if args.chaos_kills else None
        ctl = FleetController(srv, FleetConfig(
            snapshot_every=args.snapshot_every or 4, plan=plan,
            deadline_s=args.fleet_deadline_s,
            skew_threshold=args.fleet_skew,
            postmortem_dir=args.postmortem_dir))
        print(f"[serve] fleet supervision on "
              f"(snapshot_every={srv.snapshot_every or ctl.cfg.snapshot_every}"
              f"{', chaos plan ' + args.chaos_kills if plan else ''})",
              flush=True)

    t0 = time.monotonic()
    tickets = []
    specs_by_job = {}
    resubmitted = set()
    for step_i in range(args.max_steps):
        now = time.monotonic() - t0
        while raw and raw[0].get("arrival_s", 0.0) <= now:
            spec = dict(raw.pop(0))
            spec.pop("arrival_s", None)
            try:
                t = srv.submit(CampaignRequest(**spec))
                tickets.append(t)
                specs_by_job[t.job_id] = spec
                print(f"[serve] +job {t.job_id} dim={t.request.dim} "
                      f"fid={t.request.fid} budget={t.request.budget} "
                      f"prio={t.request.priority}", flush=True)
            except QueueFull:
                raw.insert(0, spec)             # backpressure: retry later
                break
        stats = ctl.step() if ctl is not None else srv.step()
        for t in srv.tickets.values():
            if t.done and not getattr(t, "_printed", False):
                t._printed = True
                lat = t.latency_s()
                lat_s = f"{lat:.3f}s" if lat is not None else "n/a (resumed)"
                print(f"[serve] -job {t.job_id} done best_f={t.best_f:.6g} "
                      f"fevals={t.fevals} latency={lat_s}", flush=True)
            elif t.terminal and not getattr(t, "_printed", False):
                t._printed = True
                print(f"[serve] -job {t.job_id} {t.status}"
                      f"{': ' + t.reason if t.reason else ''}", flush=True)
            # resubmit contract: a shed ticket is re-queued once with its
            # original spec — the dedup key makes the retry idempotent
            if (t.status == "shed" and t.job_id in specs_by_job
                    and t.job_id not in resubmitted):
                resubmitted.add(t.job_id)
                retry = dict(specs_by_job[t.job_id])
                retry["arrival_s"] = now
                raw.insert(0, retry)
                print(f"[serve] ~job {t.job_id} shed, resubmitting "
                      f"(dedup_key={retry.get('dedup_key')})", flush=True)
        if (not stats.progressed() and not raw and not len(srv.queue)
                and not srv._resident_jobs()
                and not (ctl is not None and ctl._pending)):
            break
    wall = time.monotonic() - t0

    done = [t for t in srv.tickets.values() if t.done]
    statuses = {}
    for t in srv.tickets.values():
        statuses[t.status] = statuses.get(t.status, 0) + 1
    summary = {
        "wall_s": round(wall, 3),
        "jobs": len(srv.tickets),
        "done": len(done),
        "statuses": statuses,
        "useful_evals": int(sum(t.fevals for t in done)),
        "stats": srv.stats(),
        "results": [{"job_id": t.job_id, "tag": t.request.tag,
                     "dim": t.request.dim, "fid": t.request.fid,
                     "best_f": t.best_f, "fevals": t.fevals,
                     "latency_s": t.latency_s()} for t in sorted(
                         done, key=lambda t: t.job_id)],
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "results"},
                     indent=2))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=2)
        print(f"[serve] wrote {args.out}")
    if args.trace_out:
        n = obs.tracer().export_chrome(args.trace_out)
        nj = obs.tracer().export_jsonl(args.trace_out + "l")
        print(f"[serve] wrote {args.trace_out} ({n} trace events; "
              f"{nj} spans in {args.trace_out}l) — open in ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
