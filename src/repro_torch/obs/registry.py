"""Zero-dependency metrics runtime: the process-wide ``MetricsRegistry``
(port of ``repro/obs/registry.py``).

Three instrument kinds over labeled series — ``Counter`` (monotone),
``Gauge`` (last value), ``Histogram`` (fixed log-spaced buckets from the
schema) — all created lazily on first emission and validated against
``obs/schema.py``: an unknown metric name, a wrong kind, or a wrong label
set raises at the emission site, so the code cannot emit a series the docs
don't define.

Emission is HOST-SIDE ONLY by design: every instrumented value of the
port is a Python/NumPy scalar that already crossed the device boundary at
an existing segment-boundary pull (or a host ``perf_counter`` delta).  The
registry never touches a tensor and never forces a device sync — the
whole module imports neither torch nor numpy (asserted, together with the
unchanged pull counts, in tests/test_torch_obs.py).

Two read surfaces:

* **JSONL sink** — ``flush_jsonl(path)`` appends ONE line per flush
  ({seq, unix_s, metrics: [...]}); the campaign server calls it at every
  segment boundary when constructed with ``metrics_out=...`` (the
  ``--metrics-out`` flag of launch/serve_campaigns.py).
* **HTTP** — ``start_metrics_server()`` serves ``render_text()`` (a
  prometheus-style exposition) at ``/metrics`` from a daemon thread, for
  dashboards to scrape a long-lived service.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.obs import schema as schema_mod

LabelKey = Tuple[Tuple[str, object], ...]


class Counter:
    """Monotone accumulator.  ``inc`` with a negative value raises — a
    counter that can go down is a gauge."""

    kind = schema_mod.COUNTER
    __slots__ = ("value",)

    def __init__(self, spec):
        self.value = 0.0

    def inc(self, v: float = 1.0):
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self.value += v


class Gauge:
    """Last-written value (e.g. queue depth, slot occupancy)."""

    kind = schema_mod.GAUGE
    __slots__ = ("value",)

    def __init__(self, spec):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` observations with
    ``value <= buckets[i]``, plus one implicit +Inf overflow bucket; bucket
    edges come from the metric's schema entry (log-spaced,
    ``schema.log_buckets``) so every emitter of a name shares one table."""

    kind = schema_mod.HISTOGRAM
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, spec):
        self.buckets = tuple(spec.buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        v = float(v)
        self.sum += v
        self.count += 1
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-resolution quantile estimate (upper edge of the bucket
        holding the q-th observation; None when empty) — a cheap SLO read
        for dashboards; the soak harness computes exact percentiles from
        raw latencies instead."""
        if not self.count:
            return None
        need = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= need and c:
                return (self.buckets[i] if i < len(self.buckets)
                        else float("inf"))
        return float("inf")


_KINDS = {schema_mod.COUNTER: Counter, schema_mod.GAUGE: Gauge,
          schema_mod.HISTOGRAM: Histogram}


class MetricsRegistry:
    """Process-wide labeled-series store, schema-validated at emission.

    ``counter/gauge/histogram(name, **labels)`` returns the live series for
    that (name, labels) pair, creating it on first use.  Thread-safe at the
    series-map level (the HTTP endpoint reads from its own thread); the
    instruments themselves are plain float updates under the GIL.
    """

    def __init__(self, specs: Optional[Dict[str, schema_mod.MetricSpec]]
                 = None):
        self.specs = schema_mod.SPECS if specs is None else specs
        self._series: Dict[Tuple[str, LabelKey], object] = {}
        self._lock = threading.Lock()
        self._flush_seq = 0

    # -- emission -------------------------------------------------------------
    def _get(self, kind: str, name: str, labels: dict):
        spec = self.specs.get(name)
        if spec is None:
            raise KeyError(f"metric {name!r} is not defined in "
                           f"repro_torch.obs.schema.SCHEMA — add it there first")
        if spec.kind != kind:
            raise TypeError(f"metric {name!r} is a {spec.kind}, "
                            f"requested as {kind}")
        if tuple(sorted(labels)) != tuple(sorted(spec.labels)):
            raise ValueError(
                f"metric {name!r} requires labels {sorted(spec.labels)}, "
                f"got {sorted(labels)}")
        key = (name, tuple(sorted(labels.items())))
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.setdefault(key, _KINDS[kind](spec))
        return s

    def counter(self, name: str, **labels) -> Counter:
        return self._get(schema_mod.COUNTER, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(schema_mod.GAUGE, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(schema_mod.HISTOGRAM, name, labels)

    # -- read surfaces --------------------------------------------------------
    def collect(self) -> List[dict]:
        """JSON-able snapshot of every live series (deterministic order)."""
        out = []
        with self._lock:
            items = sorted(self._series.items(), key=lambda kv: kv[0])
        for (name, lkey), s in items:
            rec = {"name": name, "type": s.kind, "labels": dict(lkey)}
            if s.kind == schema_mod.HISTOGRAM:
                rec.update(count=s.count, sum=round(s.sum, 9),
                           buckets=[[le, c] for le, c in
                                    zip(list(s.buckets) + ["+Inf"],
                                        s.counts)])
            else:
                rec["value"] = s.value
            out.append(rec)
        return out

    def flush_jsonl(self, path: str):
        """Append one flush record (all live series) as a single JSON line.
        Lines carry a per-registry ``seq`` and a wall-clock ``unix_s`` so a
        soak run's file replays as a time series.  Each append is flushed
        AND fsync'd before close so a soak killed mid-run (the chaos gate's
        whole point) leaves at most one torn trailing line — which
        ``read_jsonl`` skips on replay."""
        rec = {"seq": self._flush_seq, "unix_s": round(time.time(), 3),
               "metrics": self.collect()}
        self._flush_seq += 1
        with open(path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
            os.fsync(fh.fileno())

    def render_text(self) -> str:
        """Prometheus-style text exposition (the ``/metrics`` body)."""
        by_name: Dict[str, List[Tuple[LabelKey, object]]] = {}
        with self._lock:
            for (name, lkey), s in sorted(self._series.items(),
                                          key=lambda kv: kv[0]):
                by_name.setdefault(name, []).append((lkey, s))
        lines = []
        for name, series in by_name.items():
            spec = self.specs[name]
            lines.append(f"# HELP {name} {spec.help}")
            lines.append(f"# TYPE {name} {spec.kind}")
            for lkey, s in series:
                lbl = _fmt_labels(dict(lkey))
                if s.kind == schema_mod.HISTOGRAM:
                    acc = 0
                    for le, c in zip(list(s.buckets) + ["+Inf"], s.counts):
                        acc += c
                        lbl_le = _fmt_labels({**dict(lkey), "le": le})
                        lines.append(f"{name}_bucket{lbl_le} {acc}")
                    lines.append(f"{name}_sum{lbl} {s.sum:.9g}")
                    lines.append(f"{name}_count{lbl} {s.count}")
                else:
                    lines.append(f"{name}{lbl} {s.value:.9g}")
        return "\n".join(lines) + "\n"

    def reset(self):
        with self._lock:
            self._series.clear()
            self._flush_seq = 0


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + body + "}"


def read_jsonl(path: str) -> Iterator[dict]:
    """Crash-safe JSONL reader: yield each parseable record, skipping a
    torn final line (a process killed mid-``flush_jsonl`` / mid-trace
    export).  A malformed line anywhere BUT the end raises — that is
    corruption, not a crash artifact."""
    with open(path) as fh:
        lines = fh.readlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            yield json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                return                    # torn tail from a dying writer
            raise


# ---------------------------------------------------------------------------
# the process-wide registry
# ---------------------------------------------------------------------------

_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def metrics() -> MetricsRegistry:
    """The process-wide registry every instrumented module emits to."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = MetricsRegistry()
    return _DEFAULT


def set_metrics(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (tests, multi-tenant embedding);
    returns the previous one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev, _DEFAULT = _DEFAULT, reg
    return prev if prev is not None else MetricsRegistry()


def reset_metrics():
    """Drop every series in the process-wide registry."""
    metrics().reset()


# ---------------------------------------------------------------------------
# HTTP /metrics endpoint (optional, in-process)
# ---------------------------------------------------------------------------

def start_metrics_server(registry: Optional[MetricsRegistry] = None,
                         host: str = "127.0.0.1", port: int = 0,
                         status_fn=None):
    """Serve ``registry.render_text()`` at ``GET /metrics`` from a daemon
    thread; returns ``(httpd, port)`` (``port=0`` binds an ephemeral port).
    Call ``httpd.shutdown()`` to stop.  Standard-library only.

    ``status_fn`` (a zero-arg callable returning a JSON-able dict) adds a
    ``GET /statusz`` introspection endpoint next to ``/metrics`` — the
    campaign server passes its ``statusz()`` (lanes, per-island occupancy
    and health grade, registry generation, queue depth, active trace
    count) so an operator can ask a live service "what are you doing"
    without parsing the prometheus exposition.  The callable runs on the
    HTTP thread: it must only read host-side state, never touch a device.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = metrics() if registry is None else registry

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            route = self.path.split("?")[0]
            if route == "/statusz" and status_fn is not None:
                try:
                    body = json.dumps(status_fn(), indent=2).encode("utf-8")
                except Exception as e:       # surface, don't kill the thread
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if route not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = reg.render_text().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *_a):        # silence per-request stderr spam
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="repro-obs-metrics")
    thread.start()
    return httpd, httpd.server_address[1]
