"""Flight recorder (port of ``repro/obs/recorder.py``): a bounded
per-island ring of boundary observations,
dumped as a post-mortem artifact when supervision declares an island dead
or a job is quarantined.

Every segment-boundary pull already surfaces (host-side) the island's
wall, its summed feval watermark, and — on the service path — the per-row
verdicts; the fleet layer adds a health grade.  ``FlightRecorder.observe``
keeps the last K of those per island, so when ``FleetController``/
``IslandSupervisor`` fail an island (or the server quarantines a job) the
dump is a readable last-K-boundaries timeline instead of a bare "chaos
gate failed": ``postmortem-<island>-<boundary>.json`` holding the trigger,
the timeline, and the most recent trace spans touching that island.

Dumps are opt-in: nothing is written until ``out_dir`` is configured
(``--postmortem-dir`` on launch/serve_campaigns.py); ``dump`` always
returns the record, so in-process callers (tests) can assert on the
timeline without touching disk.
Like the rest of the obs package this module is stdlib-only and never
sees a tensor — observations are scalars that already crossed at the
existing boundary pull.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from repro_torch.obs import registry as _registry
from repro_torch.obs import trace as _trace

#: default ring depth: enough boundaries to cover detection latency
#: (deadline + stall windows are single-digit boundaries) with context.
DEFAULT_K = 16


class FlightRecorder:
    """Per-island bounded observation ring + post-mortem dumper."""

    def __init__(self, k: int = DEFAULT_K, out_dir: Optional[str] = None):
        self.k = int(k)
        self.out_dir = out_dir
        self._lock = threading.Lock()
        self._rings: Dict[str, List[dict]] = {}
        self.dumps = 0

    # -- feed -----------------------------------------------------------------
    def observe(self, island, boundary: int, **fields):
        """Record one boundary observation for ``island`` (wall, fevals
        delta, health grade, verdicts, ... — any JSON-able host scalars).
        O(1): the ring holds the newest K records."""
        rec = {"island": island, "boundary": int(boundary),
               "unix_s": round(time.time(), 3), **fields}
        key = str(island)
        with self._lock:
            ring = self._rings.setdefault(key, [])
            ring.append(rec)
            if len(ring) > self.k:
                del ring[0]
        _registry.metrics().counter("obs_recorder_observations_total",
                                    island=str(island)).inc()
        return rec

    def last(self, island) -> List[dict]:
        with self._lock:
            return list(self._rings.get(str(island), ()))

    def reset(self):
        with self._lock:
            self._rings.clear()
            self.dumps = 0

    # -- dump -----------------------------------------------------------------
    def dump(self, island, boundary: int, trigger: str,
             extra: Optional[dict] = None,
             out_dir: Optional[str] = None) -> dict:
        """Assemble (and, when an out_dir is configured, write) the
        post-mortem for ``island`` at ``boundary``: trigger ∈
        {dead, quarantine, ...}, the last-K timeline, and the newest
        finished trace spans attributed to that island.  Returns the
        record; the written path (if any) is in ``record["path"]``."""
        spans = [s.to_json() for s in _trace.tracer().finished()
                 if str(s.attrs.get("island")) == str(island)][-self.k:]
        rec = {"island": island, "boundary": int(boundary),
               "trigger": trigger, "unix_s": round(time.time(), 3),
               "timeline": self.last(island), "spans": spans,
               "extra": extra or {}}
        _registry.metrics().counter("obs_recorder_postmortems_total",
                                    trigger=trigger).inc()
        self.dumps += 1
        d = self.out_dir if out_dir is None else out_dir
        if d:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"postmortem-{island}-{int(boundary)}.json")
            with open(path, "w") as fh:
                json.dump(rec, fh, indent=2)
                fh.flush()
                os.fsync(fh.fileno())
            rec["path"] = path
        return rec


# ---------------------------------------------------------------------------
# the process-wide recorder
# ---------------------------------------------------------------------------

_DEFAULT: Optional[FlightRecorder] = None
_DEFAULT_LOCK = threading.Lock()


def recorder() -> FlightRecorder:
    """The process-wide flight recorder the boundary pulls feed."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = FlightRecorder()
    return _DEFAULT


def set_recorder(rec: FlightRecorder) -> FlightRecorder:
    """Swap the process-wide recorder (tests); returns the previous one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev, _DEFAULT = _DEFAULT, rec
    return prev if prev is not None else FlightRecorder()


def reset_recorder():
    """Drop every ring in the process-wide recorder."""
    recorder().reset()
