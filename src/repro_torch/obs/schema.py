"""THE metric-name table of the port — a copy of ``repro/obs/schema.py``
with the same 40 series, so ``docs/METRICS.md`` describes both packages.

One ``MetricSpec`` per metric: name, kind (counter / gauge / histogram),
unit, the exact label keys every emission must carry, the emission point,
and a one-line meaning.  ``MetricsRegistry`` (obs/registry.py) refuses any
name or label set not in this table, and ``docs/METRICS.md`` embeds the
table rendered by ``render_markdown`` between markers — so code, registry
and docs cannot drift:

  PYTHONPATH=src python -m repro_torch.obs.schema --check docs/METRICS.md

The port adds no series of its own: a series the JAX package lacks would
make the shared document wrong for one of them.  The whole obs package
imports neither torch nor numpy.

Naming follows the prometheus conventions production governance services
front their metrics with: snake_case, ``_total`` suffix on counters,
``_s`` suffix on second-valued series, subsystem prefix first
(``bucketed_`` the segment driver, ``mesh_`` the S1/S2 mesh engine,
``service_`` the campaign server, ``fleet_`` the supervision layer).  Restart-policy-adjacent names carry a
``policy``-free shape on purpose: when BIPOP & friends (arXiv 1207.0206)
and large-scale strategy tiers (arXiv 2310.05377) land as per-row restart
policies, they extend these series with a ``policy`` label instead of
inventing parallel names.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


def log_buckets(lo: float, hi: float, per_decade: int = 2,
                ) -> Tuple[float, ...]:
    """Fixed log-spaced histogram upper edges from ``lo`` to ``hi``
    inclusive, ``per_decade`` edges per decade.  Edges are rounded to 6
    significant digits so the schema (and therefore the JSONL sink and the
    docs) is reproducible across platforms."""
    import math
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(float(f"{lo * 10 ** (i / per_decade):.6g}")
                 for i in range(n + 1))


#: default edges for second-valued histograms: 10 µs .. 1000 s, 2/decade —
#: wide enough to hold a sub-ms host sync and a multi-minute soak job in
#: the same fixed table (values beyond the last edge land in +Inf).
TIME_BUCKETS_S = log_buckets(1e-5, 1e3, per_decade=2)

#: edges for evaluation-count histograms (fleet lost-work accounting):
#: 1 .. 1e6 evals, one edge per decade — recovery loses whole segments, so
#: decade resolution is plenty and the table stays 7 cells wide.
EVAL_BUCKETS = log_buckets(1, 1e6, per_decade=1)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One metric's contract: everything an emitter and a reader share."""

    name: str
    kind: str                       # COUNTER | GAUGE | HISTOGRAM
    unit: str                       # "s", "evaluations", "jobs", ...
    labels: Tuple[str, ...]         # exact label keys, enforced at emission
    emitted_by: str                 # module:function of the emission point
    help: str                       # one-line meaning
    buckets: Tuple[float, ...] = () # histogram upper edges (+Inf implied)

    def __post_init__(self):
        if self.kind not in (COUNTER, GAUGE, HISTOGRAM):
            raise ValueError(f"unknown metric kind {self.kind!r}")
        if self.kind == HISTOGRAM and not self.buckets:
            object.__setattr__(self, "buckets", TIME_BUCKETS_S)
        if self.kind != HISTOGRAM and self.buckets:
            raise ValueError(f"{self.name}: buckets only apply to histograms")


SCHEMA: Tuple[MetricSpec, ...] = (
    # -- bucketed segment driver (core/bucketed.py:drive_segments) ----------
    MetricSpec("bucketed_segments_total", COUNTER, "segments", ("bucket",),
               "core/bucketed.py:drive_segments",
               "Dispatched bucket segments, by rung bucket."),
    MetricSpec("bucketed_segment_wall_s", HISTOGRAM, "s", ("bucket",),
               "core/bucketed.py:drive_segments",
               "Per-segment wall: dispatch+block unoverlapped, dispatch-only "
               "when overlap=True (the block rides the next sync)."),
    MetricSpec("bucketed_sync_s", HISTOGRAM, "s", (),
               "core/bucketed.py:drive_segments",
               "Boundary host sync: the ONE batched schedule pull "
               "(pull_schedule / pull_schedule_allgather) per segment."),
    MetricSpec("bucketed_spec_dispatch_total", COUNTER, "segments",
               ("outcome",),
               "core/bucketed.py:drive_segments",
               "Speculative double-buffered dispatches, outcome=hit|miss "
               "(miss = bucket changed, speculative output discarded)."),
    MetricSpec("bucketed_useful_evals_total", COUNTER, "evaluations", (),
               "core/bucketed.py:drive_segments",
               "True fitness evaluations progressed between boundary pulls "
               "(delta of the pulled per-member budget counters)."),
    MetricSpec("bucketed_padded_evals_total", COUNTER, "evaluations",
               ("bucket",),
               "core/bucketed.py:drive_segments",
               "Device evaluation rows paid per dispatched segment "
               "(rows x gens x lambda_bucket); padding waste = "
               "padded/useful."),
    MetricSpec("bucketed_eigh_blocks_total", COUNTER, "blocks", ("bucket",),
               "core/bucketed.py:drive_segments",
               "Batched eigendecomposition blocks executed "
               "(seg_gens/eigen_interval per dispatched segment)."),
    MetricSpec("bucketed_eval_fused_generations_total", COUNTER,
               "generations", (),
               "core/bucketed.py:run_campaign_bucketed",
               "Generations dispatched through the eval-fused sample "
               "epilogue (whole fid menu separable and REPRO_EVAL_FUSION "
               "on): fitness computed in the sample kernel, X never "
               "materialized in HBM."),
    # -- mesh engine S1/S2 (distributed/mesh_engine.py) ---------------------
    MetricSpec("mesh_island_dispatch_s", HISTOGRAM, "s",
               ("strategy", "island"),
               "distributed/mesh_engine.py:_drive_concurrent/_drive_ordered",
               "Per-island segment dispatch wall (async enqueue for S2 "
               "islands; island=all for S1's whole-mesh program)."),
    MetricSpec("mesh_island_block_s", HISTOGRAM, "s", ("island",),
               "distributed/mesh_engine.py:_drive_concurrent",
               "S2 per-island blocking schedule pull — where an island "
               "waits on its own running segment."),
    MetricSpec("mesh_exchange_s", HISTOGRAM, "s", ("strategy",),
               "distributed/mesh_engine.py:_drive_concurrent/_drive_ordered",
               "Scalar exchange latency: S1 folds the psum'd budget/best "
               "outputs lazily at the boundary pull (they are ready by "
               "then), S2 folds the per-island host scalars."),
    MetricSpec("mesh_exchange_rounds_total", COUNTER, "rounds",
               ("strategy",),
               "distributed/mesh_engine.py:_drive_concurrent/_drive_ordered",
               "Completed cross-island exchange rounds."),
    MetricSpec("mesh_retirements_total", COUNTER, "islands", ("reason",),
               "distributed/mesh_engine.py:_drive_concurrent",
               "Island retirement events, reason=target (stop_at early "
               "sharing) | exhausted (no member can pay a generation)."),
    # -- campaign service (service/server.py) -------------------------------
    MetricSpec("service_jobs_total", COUNTER, "jobs", ("event",),
               "service/server.py:submit/_admit/_finalize/drain",
               "Job lifecycle events: event=submitted|admitted|completed|"
               "rejected|cancelled|expired|quarantined|shed."),
    MetricSpec("service_job_lifecycle_total", COUNTER, "transitions",
               ("from", "to"),
               "service/server.py:_transition/submit/_settle_shed",
               "Request state-machine edges (new->queued, queued->running, "
               "running->done/cancelled/expired/quarantined, "
               "queued->shed/...): every transition increments exactly one "
               "(from, to) series."),
    MetricSpec("service_shed_total", COUNTER, "jobs", (),
               "service/server.py:_settle_shed",
               "Pending tickets evicted by priority-aware load shedding (a "
               "full queue displaced its lowest-priority entry for a "
               "strictly higher-priority submit)."),
    MetricSpec("service_quarantine_total", COUNTER, "jobs", ("reason",),
               "service/server.py:_finalize",
               "Poison jobs quarantined at a boundary pull, reason="
               "nonfinite (NaN/inf best_f after real evaluations) | "
               "no_progress (flat per-row feval watermark over dispatched "
               "boundaries)."),
    MetricSpec("service_registry_generation", GAUGE, "generation", (),
               "service/server.py:step",
               "Current FitnessRegistry generation: bumps when a callable "
               "is registered on a live server (versioned rollout; new "
               "lanes compile against the new generation, resident lanes "
               "keep running untouched)."),
    MetricSpec("service_queue_depth", GAUGE, "jobs", (),
               "service/server.py:step",
               "Pending admission-queue depth at the end of a service "
               "round."),
    MetricSpec("service_admission_wait_s", HISTOGRAM, "s", (),
               "service/server.py:_admit",
               "submit -> admitted-into-a-row wait (queue time)."),
    MetricSpec("service_time_to_first_ticket_s", HISTOGRAM, "s", (),
               "service/server.py:_island_boundary",
               "submit -> first streamed ticket update."),
    MetricSpec("service_time_to_completion_s", HISTOGRAM, "s", (),
               "service/server.py:_finalize",
               "submit -> done: the per-job completion latency the soak "
               "SLO is written against."),
    MetricSpec("service_slot_occupancy", GAUGE, "fraction",
               ("lane", "island"),
               "service/server.py:step",
               "Occupied fraction of an island's member rows (per-lane "
               "slot occupancy)."),
    MetricSpec("service_boundary_pull_s", HISTOGRAM, "s", ("lane",),
               "service/server.py:_island_boundary",
               "Per-island boundary schedule pull (the service's only "
               "blocking device sync)."),
    MetricSpec("service_segments_total", COUNTER, "segments",
               ("lane", "bucket"),
               "service/server.py:_island_boundary",
               "Island segments dispatched by the service loop."),
    MetricSpec("service_program_cache_hit_rate", GAUGE, "fraction", (),
               "service/server.py:step",
               "Process-wide segment ProgramCache hits/(hits+traces)."),
    MetricSpec("service_snapshot_s", HISTOGRAM, "s", (),
               "service/server.py:snapshot",
               "Wall time of one snapshot() commit."),
    MetricSpec("service_boundaries_total", COUNTER, "rounds", (),
               "service/server.py:step",
               "Completed service rounds (one segment boundary per island "
               "per round)."),
    # -- fleet supervision (fleet/health.py, fleet/controller.py) -----------
    MetricSpec("fleet_island_state", GAUGE, "state", ("island",),
               "fleet/health.py:FleetHealth._set",
               "Island health state gauge: 0=alive, 1=suspect, 2=dead "
               "(emitted on every state transition)."),
    MetricSpec("fleet_failures_total", COUNTER, "islands", ("reason",),
               "fleet/controller.py:IslandSupervisor/_fail_island",
               "Island failure events, reason=killed (fault plan) | "
               "deadline (pull wall over budget) | stalled (no eval "
               "progress while dispatched)."),
    MetricSpec("fleet_recoveries_total", COUNTER, "recoveries", ("mode",),
               "fleet/controller.py:IslandSupervisor/_fail_island/_rejoin",
               "Recovery actions: mode=replayed (engine restored from "
               "snapshot in place) | reassigned (row re-placed on a "
               "survivor) | requeued (no capacity, parked for later) | "
               "rejoined (island re-admitted after down_for)."),
    MetricSpec("fleet_recovery_wall_s", HISTOGRAM, "s", (),
               "fleet/controller.py:IslandSupervisor/_fail_island",
               "Wall time of one failure-to-recovered handling pass "
               "(snapshot load + re-placement)."),
    MetricSpec("fleet_lost_work_evals", HISTOGRAM, "evaluations", (),
               "fleet/controller.py:IslandSupervisor/_fail_island",
               "Fitness evaluations discarded per failure: progress past "
               "the last snapshot that must be re-run (bounds the "
               "snapshot-cadence / lost-work trade).",
               buckets=EVAL_BUCKETS),
    MetricSpec("fleet_pull_retries_total", COUNTER, "retries", ("island",),
               "fleet/controller.py:IslandSupervisor.pull",
               "Boundary pulls re-issued after a corrupt read (regressed "
               "eval counters)."),
    MetricSpec("fleet_rebalances_total", COUNTER, "repacks", ("trigger",),
               "fleet/controller.py:FleetController._maybe_rebalance",
               "Cross-island lane repacks scheduled by the controller, "
               "trigger=skew (occupancy imbalance) | rejoin (island "
               "re-admitted)."),
    # -- causal tracing + flight recorder (obs/trace.py, obs/recorder.py) ---
    MetricSpec("service_trace_spans_total", COUNTER, "spans", ("span",),
               "obs/trace.py:Tracer.end",
               "Finished spans appended to the process-wide tracer ring, "
               "by span name (job|queued|running|recover|segment|pull|"
               "dispatch|block|compile|...)."),
    MetricSpec("service_trace_active", GAUGE, "spans", (),
               "obs/trace.py:Tracer.start/end",
               "Currently open (started, not yet ended) spans — exposed "
               "on /statusz as the live-trace count."),
    MetricSpec("service_trace_dropped_total", COUNTER, "spans", (),
               "obs/trace.py:Tracer.end",
               "Finished spans evicted from the bounded tracer ring "
               "(capacity overflow on a long soak; raise Tracer capacity "
               "or export more often)."),
    MetricSpec("obs_recorder_observations_total", COUNTER, "observations",
               ("island",),
               "obs/recorder.py:FlightRecorder.observe",
               "Boundary observations fed into the per-island flight-"
               "recorder ring (wall, fevals delta, health grade, "
               "verdicts)."),
    MetricSpec("obs_recorder_postmortems_total", COUNTER, "dumps",
               ("trigger",),
               "obs/recorder.py:FlightRecorder.dump",
               "Post-mortem dumps assembled on failure, trigger=dead "
               "(island graded DEAD by fleet supervision) | quarantine "
               "(poison job pulled from a row)."),
)

SPECS: Dict[str, MetricSpec] = {s.name: s for s in SCHEMA}
assert len(SPECS) == len(SCHEMA), "duplicate metric name in SCHEMA"


# ---------------------------------------------------------------------------
# docs generation + drift check
# ---------------------------------------------------------------------------

# the marker names the JAX package's module: the document is shared
BEGIN_MARK = "<!-- BEGIN GENERATED TABLE: repro.obs.schema (do not edit) -->"
END_MARK = "<!-- END GENERATED TABLE -->"


def render_markdown() -> str:
    """The METRICS.md reference table, one row per metric."""
    lines = [
        "| name | type | labels | unit | emitted by | meaning |",
        "|---|---|---|---|---|---|",
    ]
    for s in SCHEMA:
        labels = ", ".join(f"`{v}`" for v in s.labels) or "—"
        help_md = s.help.replace("|", "\\|")     # keep table cells intact
        lines.append(f"| `{s.name}` | {s.kind} | {labels} | {s.unit} "
                     f"| `{s.emitted_by}` | {help_md} |")
    return "\n".join(lines)


def _splice(text: str) -> str:
    """Replace the marked block of a METRICS.md body with the current table;
    raises if the markers are missing."""
    b, e = text.find(BEGIN_MARK), text.find(END_MARK)
    if b < 0 or e < 0 or e < b:
        raise ValueError(f"markers {BEGIN_MARK!r} / {END_MARK!r} not found")
    return (text[:b + len(BEGIN_MARK)] + "\n" + render_markdown() + "\n"
            + text[e:])


def check_file(path: str) -> bool:
    """True iff the generated block in ``path`` matches the live schema."""
    with open(path) as fh:
        text = fh.read()
    return _splice(text) == text


def write_file(path: str):
    with open(path) as fh:
        text = fh.read()
    with open(path, "w") as fh:
        fh.write(_splice(text))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", metavar="METRICS_MD", default=None,
                    help="exit 1 if the file's generated table is stale")
    ap.add_argument("--write", metavar="METRICS_MD", default=None,
                    help="refresh the file's generated table in place")
    args = ap.parse_args(argv)
    if args.write:
        write_file(args.write)
        print(f"[obs.schema] refreshed {args.write}")
        return 0
    if args.check:
        if check_file(args.check):
            print(f"[obs.schema] {args.check} matches the schema")
            return 0
        # show WHAT drifted, not just that it did: unified diff of the
        # file as-is vs the file with the generated block refreshed.
        import difflib
        with open(args.check) as fh:
            current = fh.read()
        diff = difflib.unified_diff(
            current.splitlines(keepends=True),
            _splice(current).splitlines(keepends=True),
            fromfile=f"{args.check} (on disk)",
            tofile=f"{args.check} (from schema)")
        sys.stderr.writelines(diff)
        print(f"[obs.schema] {args.check} is STALE — regenerate with:\n"
              f"  PYTHONPATH=src python -m repro_torch.obs.schema --write "
              f"{args.check}", file=sys.stderr)
        return 1
    ap.error("pass --check or --write")


if __name__ == "__main__":
    sys.exit(main())
