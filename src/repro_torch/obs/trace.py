"""Zero-dependency causal tracing: spans, the process-wide ``Tracer``,
and Perfetto export (port of ``repro/obs/trace.py``).

Where obs/registry.py answers "how much / how often" with aggregate
counters and histograms, this module answers "what happened to THIS job"
and "where did island 3's wall time go": explicit-start/end spans on a
monotonic clock, ring-buffered on a process-wide ``Tracer`` that the
service/engine vertical feeds at the SAME existing host boundaries the
metrics layer uses.  The zero-overhead contract is identical — a span
carries only Python scalars that already crossed the device boundary at a
segment-boundary pull (or host ``perf_counter`` deltas), so tracing adds
zero device syncs and zero compiled programs (pinned, with the metrics
pins, in tests).

Span model
----------

``Span(trace_id, span_id, parent_id, name, t0, t1, attrs)`` — ``t0/t1``
are ``time.perf_counter()`` readings (the tracer records a wall-clock
anchor at construction so exports can surface unix time).  A job's root
span ("job") is started at submit and ended at its terminal lifecycle
edge; its children ("queued", "running", "recover") chain through
``parent_id`` so a recovered job's pre- and post-failure activity share
one trace.  Island-side spans ("segment", "pull", "dispatch", "block",
"compile") carry ``island``/``lane`` attrs and render as per-island lane
tracks.

Read surfaces
-------------

* ``export_jsonl(path)`` — one JSON line per finished span (fsync'd), the
  input format of the offline digest:
  ``python -m repro_torch.obs.trace --summarize trace.jsonl``
  (critical path per job, per-island busy/blocked/idle fractions).
* ``export_chrome(path)`` — Chrome/Perfetto ``trace_event`` JSON
  (``--trace-out`` on launch/serve_campaigns.py): open the
  file directly in https://ui.perfetto.dev — one lane track per island,
  one async track per job.

Like the registry, this module is stdlib-only (no torch, no numpy;
asserted in tests/test_torch_obs.py) and mirrors the
``metrics()/set_metrics()/reset_metrics()`` process-wide singleton with
``tracer()/set_tracer()/reset_tracer()``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.obs import registry as _registry

#: span names whose wall counts as "busy" vs "blocked" in the offline
#: per-island digest (everything else on an island track is neutral).
BUSY_NAMES = ("segment", "dispatch", "compile")
BLOCKED_NAMES = ("pull", "block", "sync", "exchange")


@dataclasses.dataclass
class Span:
    """One timed region.  ``t0``/``t1`` are monotonic ``perf_counter``
    readings; ``t1 is None`` while the span is open.  ``attrs`` holds only
    JSON-able host scalars (enforced at export, not at set — emission must
    stay allocation-cheap)."""

    trace_id: int
    span_id: int
    parent_id: Optional[int]
    name: str
    t0: float
    t1: Optional[float] = None
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def dur(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def to_json(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "t0": round(self.t0, 9), "t1": round(self.t1, 9),
                "dur_s": round(self.dur, 9), "attrs": self.attrs}


class Tracer:
    """Process-wide ring-buffered span store with explicit start/end.

    Thread-safe: starts/ends from the service loop and the metrics HTTP
    thread interleave under one lock.  Finished spans live in a bounded
    ring (oldest evicted first, eviction counted) so a week-long soak
    cannot grow host memory; exports and the flight recorder read the
    ring, they never block emission.
    """

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: List[Span] = []
        self._open: Dict[int, Span] = {}
        self._next_id = 1
        self.dropped = 0
        # wall anchor: perf_counter t maps to unix epoch_unix+(t-epoch_perf)
        self.epoch_unix = time.time()
        self.epoch_perf = time.perf_counter()

    # -- emission -------------------------------------------------------------
    def start(self, name: str, parent: Union[Span, int, None] = None,
              trace_id: Optional[int] = None, **attrs) -> Span:
        """Open a span.  ``parent`` (a Span or span_id) links the causal
        chain; ``trace_id`` defaults to the parent's trace (or a fresh one
        for roots)."""
        t0 = time.perf_counter()
        parent_id = parent.span_id if isinstance(parent, Span) else parent
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            if trace_id is None:
                trace_id = (parent.trace_id if isinstance(parent, Span)
                            else sid)
            s = Span(trace_id=trace_id, span_id=sid, parent_id=parent_id,
                     name=name, t0=t0, attrs=dict(attrs))
            self._open[sid] = s
        reg = _registry.metrics()
        reg.gauge("service_trace_active").set(len(self._open))
        return s

    def end(self, span: Span, **attrs) -> Span:
        """Close a span; extra ``attrs`` merge over the start-time ones
        (terminal status, reasons, hit/miss outcomes land here)."""
        span.t1 = time.perf_counter()
        if attrs:
            span.attrs.update(attrs)
        with self._lock:
            self._open.pop(span.span_id, None)
            if len(self._ring) >= self.capacity:
                del self._ring[0]
                self.dropped += 1
                _registry.metrics().counter(
                    "service_trace_dropped_total").inc()
            self._ring.append(span)
        reg = _registry.metrics()
        reg.counter("service_trace_spans_total", span=span.name).inc()
        reg.gauge("service_trace_active").set(len(self._open))
        return span

    @contextlib.contextmanager
    def span(self, name: str, parent: Union[Span, int, None] = None,
             trace_id: Optional[int] = None, **attrs):
        s = self.start(name, parent=parent, trace_id=trace_id, **attrs)
        try:
            yield s
        finally:
            if s.t1 is None:
                self.end(s)

    def event(self, name: str, parent: Union[Span, int, None] = None,
              trace_id: Optional[int] = None, **attrs) -> Span:
        """Instantaneous marker (t0 == t1) — health transitions, kills."""
        s = self.start(name, parent=parent, trace_id=trace_id, **attrs)
        return self.end(s)

    # -- read surfaces --------------------------------------------------------
    def finished(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def active_count(self) -> int:
        with self._lock:
            return len(self._open)

    def unix(self, t: float) -> float:
        """Map a span perf_counter reading to unix wall time."""
        return self.epoch_unix + (t - self.epoch_perf)

    def reset(self):
        with self._lock:
            self._ring.clear()
            self._open.clear()
            self._next_id = 1
            self.dropped = 0
            self.epoch_unix = time.time()
            self.epoch_perf = time.perf_counter()

    # -- exports --------------------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        """Write every finished span as one JSON line (fsync'd on close,
        same durability contract as ``MetricsRegistry.flush_jsonl``);
        returns the span count."""
        spans = self.finished()
        with open(path, "w") as fh:
            for s in spans:
                fh.write(json.dumps(s.to_json()) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        return len(spans)

    def export_chrome(self, path: str) -> int:
        """Write Chrome/Perfetto ``trace_event`` JSON: job roots and their
        lifecycle children as async ("b"/"e") events — one per-job track —
        island-attributed spans as complete ("X") events on one lane track
        per (lane, island), everything else on a host track."""
        obj = to_chrome(self.finished(), epoch_perf=self.epoch_perf)
        body = json.dumps(obj)
        with open(path, "w") as fh:
            fh.write(body)
            fh.flush()
            os.fsync(fh.fileno())
        return len(obj["traceEvents"])


# ---------------------------------------------------------------------------
# the process-wide tracer
# ---------------------------------------------------------------------------

_DEFAULT: Optional[Tracer] = None
_DEFAULT_LOCK = threading.Lock()


def tracer() -> Tracer:
    """The process-wide tracer every instrumented module emits to."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = Tracer()
    return _DEFAULT


def set_tracer(tr: Tracer) -> Tracer:
    """Swap the process-wide tracer (tests, embedding); returns the
    previous one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev, _DEFAULT = _DEFAULT, tr
    return prev if prev is not None else Tracer()


def reset_tracer():
    """Drop every span in the process-wide tracer."""
    tracer().reset()


# ---------------------------------------------------------------------------
# Chrome/Perfetto trace_event assembly + schema validation
# ---------------------------------------------------------------------------

HOST_PID, ISLAND_PID, JOB_PID = 1, 2, 3


def _island_tid_key(s: Span) -> Tuple[str, str]:
    return (str(s.attrs.get("lane", "")), str(s.attrs.get("island", "")))


def to_chrome(spans: List[Span], epoch_perf: float = 0.0) -> dict:
    """Assemble the ``trace_event`` object for a span list (pure — no
    tracer state), timestamps in µs relative to ``epoch_perf``."""
    def us(t):
        return round((t - epoch_perf) * 1e6, 3)

    events: List[dict] = []
    island_tids: Dict[Tuple[str, str], int] = {}
    job_tracks = 0
    for s in spans:
        if s.t1 is None:
            continue
        if "job" in s.attrs and "island" not in s.attrs:
            jid = f"job:{s.trace_id:x}"
            base = {"cat": "job", "id": jid, "pid": JOB_PID, "tid": 0,
                    "name": s.name}
            events.append({**base, "ph": "b", "ts": us(s.t0),
                           "args": s.attrs})
            events.append({**base, "ph": "e", "ts": us(s.t1)})
            job_tracks += 1
        elif "island" in s.attrs:
            key = _island_tid_key(s)
            tid = island_tids.setdefault(key, len(island_tids))
            events.append({"ph": "X", "cat": "island", "name": s.name,
                           "pid": ISLAND_PID, "tid": tid, "ts": us(s.t0),
                           "dur": us(s.t1) - us(s.t0), "args": s.attrs})
        else:
            events.append({"ph": "X", "cat": "host", "name": s.name,
                           "pid": HOST_PID, "tid": 0, "ts": us(s.t0),
                           "dur": us(s.t1) - us(s.t0), "args": s.attrs})
    meta = [
        {"ph": "M", "name": "process_name", "pid": HOST_PID,
         "args": {"name": "host"}},
        {"ph": "M", "name": "process_name", "pid": ISLAND_PID,
         "args": {"name": "islands"}},
        {"ph": "M", "name": "process_name", "pid": JOB_PID,
         "args": {"name": "jobs"}},
    ]
    for (lane, island), tid in sorted(island_tids.items(),
                                      key=lambda kv: kv[1]):
        label = (f"{lane}/island {island}" if lane
                 else f"island {island}")
        meta.append({"ph": "M", "name": "thread_name", "pid": ISLAND_PID,
                     "tid": tid, "args": {"name": label}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"spans": sum(1 for s in spans
                                       if s.t1 is not None),
                          "job_tracks": job_tracks}}


def validate_chrome(obj: dict) -> List[str]:
    """Schema-check a ``trace_event`` object; returns a list of problems
    (empty == valid).  Used by the chaos gate and the trace tests so a
    malformed export fails CI instead of failing silently in the UI."""
    errs: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["missing top-level traceEvents list"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(evs):
        ph = ev.get("ph")
        if ph not in ("X", "b", "e", "M"):
            errs.append(f"event {i}: unknown ph {ph!r}")
            continue
        if "name" not in ev or "pid" not in ev:
            errs.append(f"event {i}: missing name/pid")
            continue
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"event {i}: non-numeric ts")
        if ph == "X" and not (isinstance(ev.get("dur"), (int, float))
                              and ev["dur"] >= 0):
            errs.append(f"event {i}: X event needs dur >= 0")
        if ph in ("b", "e") and ("id" not in ev or "cat" not in ev):
            errs.append(f"event {i}: async event needs id and cat")
    return errs


# ---------------------------------------------------------------------------
# offline digest (--summarize)
# ---------------------------------------------------------------------------

def load_jsonl(path: str) -> List[dict]:
    """Read a span JSONL file, tolerating a truncated final line (a killed
    process mid-write) — same crash-safe contract as the metrics sink."""
    return list(_registry.read_jsonl(path))


def summarize(spans: List[dict]) -> dict:
    """Offline trace digest: per-job critical path (the sequential chain
    of lifecycle children under each "job" root) and per-island
    busy/blocked/idle fractions over the island's observed window."""
    by_id = {s["span_id"]: s for s in spans}
    children: Dict[int, List[dict]] = {}
    for s in spans:
        if s.get("parent_id") is not None:
            children.setdefault(s["parent_id"], []).append(s)

    jobs = []
    for s in spans:
        if s["name"] != "job":
            continue
        kids = sorted(children.get(s["span_id"], []),
                      key=lambda c: c["t0"])
        phases = {}
        for c in kids:
            phases[c["name"]] = round(
                phases.get(c["name"], 0.0) + c["dur_s"], 9)
        jobs.append({"job": s["attrs"].get("job"),
                     "trace_id": s["trace_id"],
                     "status": s["attrs"].get("status"),
                     "total_s": s["dur_s"],
                     "critical_path_s": round(
                         sum(c["dur_s"] for c in kids), 9),
                     "phases": phases})

    islands: Dict[str, dict] = {}
    for s in spans:
        isl = s["attrs"].get("island")
        if isl is None:
            continue
        key = str(isl)
        rec = islands.setdefault(
            key, {"busy_s": 0.0, "blocked_s": 0.0,
                  "t_lo": s["t0"], "t_hi": s["t1"], "spans": 0})
        rec["spans"] += 1
        rec["t_lo"] = min(rec["t_lo"], s["t0"])
        rec["t_hi"] = max(rec["t_hi"], s["t1"])
        if s["name"] in BUSY_NAMES:
            rec["busy_s"] += s["dur_s"]
        elif s["name"] in BLOCKED_NAMES:
            rec["blocked_s"] += s["dur_s"]
    for key, rec in islands.items():
        window = max(rec["t_hi"] - rec["t_lo"], 1e-12)
        busy, blocked = rec["busy_s"], rec["blocked_s"]
        idle = max(window - busy - blocked, 0.0)
        rec.update(window_s=round(window, 9),
                   busy_frac=round(busy / window, 6),
                   blocked_frac=round(blocked / window, 6),
                   idle_frac=round(idle / window, 6),
                   busy_s=round(busy, 9), blocked_s=round(blocked, 9))
        rec.pop("t_lo"), rec.pop("t_hi")

    return {"spans": len(spans),
            "traces": len({s["trace_id"] for s in spans}),
            "open_parents_missing": sorted(
                {s["parent_id"] for s in spans
                 if s.get("parent_id") is not None
                 and s["parent_id"] not in by_id}),
            "jobs": sorted(jobs, key=lambda j: -j["total_s"]),
            "islands": {k: islands[k] for k in sorted(islands)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--summarize", metavar="TRACE_JSONL", default=None,
                    help="print a JSON digest (per-job critical path, "
                         "per-island busy/blocked/idle) of a span JSONL "
                         "file written by --trace-out")
    ap.add_argument("--validate", metavar="TRACE_JSON", default=None,
                    help="schema-check a Chrome/Perfetto trace_event "
                         "export; exit 1 with the problem list if invalid")
    args = ap.parse_args(argv)
    if args.summarize:
        digest = summarize(load_jsonl(args.summarize))
        print(json.dumps(digest, indent=2))
        return 0
    if args.validate:
        with open(args.validate) as fh:
            errs = validate_chrome(json.load(fh))
        if errs:
            print("\n".join(errs), file=sys.stderr)
            return 1
        print(f"[obs.trace] {args.validate} is a valid trace_event export")
        return 0
    ap.error("pass --summarize or --validate")


if __name__ == "__main__":
    sys.exit(main())
