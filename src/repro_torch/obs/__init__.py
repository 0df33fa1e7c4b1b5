"""Service observability (port of ``repro/obs``): schema-validated metrics
with zero dependencies.

``obs/schema.py`` is the single table every metric name, kind, label set
and histogram bucket layout is defined in (and ``docs/METRICS.md`` is
generated from); ``obs/registry.py`` is the runtime — counters, gauges,
log-bucketed histograms on a process-wide ``MetricsRegistry``, a JSONL
sink flushed at segment boundaries, and an optional in-process HTTP
``/metrics`` + ``/statusz`` endpoint.  ``obs/trace.py`` adds the causal
layer — ring-buffered spans on a process-wide ``Tracer`` with JSONL and
Chrome/Perfetto exports — and ``obs/recorder.py`` the flight recorder
(per-island last-K boundary ring, post-mortem dumps on failure).
Instrumentation is host-side only: emitters pass scalars that already
crossed the device boundary at an existing segment-boundary pull, never
tensors (tests/test_torch_obs.py pins the pull count and the program
count against it).
"""
from repro_torch.obs.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, metrics, read_jsonl,
    reset_metrics, set_metrics, start_metrics_server)
from repro_torch.obs.schema import (  # noqa: F401
    SCHEMA, SPECS, MetricSpec, log_buckets, render_markdown)
from repro_torch.obs.trace import (  # noqa: F401
    Span, Tracer, reset_tracer, set_tracer, to_chrome, tracer,
    validate_chrome)
from repro_torch.obs.recorder import (  # noqa: F401
    FlightRecorder, recorder, reset_recorder, set_recorder)
