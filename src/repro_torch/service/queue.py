"""Campaign request spec, streaming tickets, and the admission queue (port
of ``repro/service/queue.py``; host-only, no tensor is touched).

A ``CampaignRequest`` is one tenant's optimization job: a BBOB (fid,
instance) pair or a registered fitness callable, a problem dimension, an
evaluation budget, an optional absolute fitness target (early retirement),
and a priority.  Submitting one to the server yields a ``CampaignTicket``
immediately — the job's streaming handle: per-boundary progress updates
while it runs, and the full ``IPOPResult`` once it completes.

The ``AdmissionQueue`` is the service's front door: priority-ordered pending
requests with *backpressure* — beyond ``max_pending`` the queue sheds the
lowest-priority pending ticket to make room for a strictly higher-priority
submit (``status="shed"``, a terminal state the client can retry against),
and refuses the submit itself (``QueueFull``) when nothing pending ranks
below it — so a drowning service degrades by priority, not by dying.
Admission itself (taking a request out of the queue and packing it into a
running lane) only ever happens at segment boundaries (service/server.py).

Every ticket ends in exactly one terminal state::

    queued ──────────────▶ running ──▶ done
       │                     │  │
       ├─▶ expired (TTL)     │  ├─▶ expired (deadline)
       ├─▶ cancelled         │  ├─▶ cancelled
       ├─▶ shed              │  └─▶ quarantined (poison)
       └─▶ rejected          ▼
                           (island recovery re-places, state unchanged)
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Callable, List, Optional, Tuple

JOB_QUEUED = "queued"
JOB_RUNNING = "running"
JOB_DONE = "done"
JOB_REJECTED = "rejected"
JOB_CANCELLED = "cancelled"
JOB_EXPIRED = "expired"
JOB_QUARANTINED = "quarantined"
JOB_SHED = "shed"

#: Statuses a ticket can never leave; every submitted job reaches exactly one.
TERMINAL_STATUSES = frozenset({
    JOB_DONE, JOB_REJECTED, JOB_CANCELLED, JOB_EXPIRED, JOB_QUARANTINED,
    JOB_SHED,
})


def key_words(key) -> List[int]:
    """A key (an int seed, a (2,) tensor, array or sequence) as its two
    32-bit words: a seed s is ``PRNGKey(s)``'s (high, low) words."""
    raw = key.tolist() if hasattr(key, "tolist") else key
    if isinstance(raw, int):
        s = raw & 0xFFFFFFFFFFFFFFFF
        return [s >> 32, s & 0xFFFFFFFF]
    return [int(x) & 0xFFFFFFFF for x in raw]


class QueueFull(RuntimeError):
    """Admission backpressure: the pending queue is at capacity and nothing
    pending ranks strictly below the incoming request's priority."""


@dataclasses.dataclass
class CampaignRequest:
    """One optimization job.

    Exactly one of ``fid`` (BBOB, with ``instance``) or ``fitness`` (the name
    of a callable registered in the server's ``FitnessRegistry``) selects the
    objective.  ``budget`` is the evaluation budget (the ``max_evals`` a
    standalone ``run_ipop`` would get); ``target`` an optional absolute
    fitness value that retires the job early once reached (checked at segment
    boundaries).  ``key`` optionally overrides the PRNG key derived from
    ``seed``: an int seed or a (2,) key (``core/prng.py``), which
    ``run_ipop(backend="service")`` passes for parity with the other
    backends.  ``lam_start``/``kmax_exp``/``dtype`` default to the
    server's configuration; together with ``dim`` they form the dim-class
    routing key (service/allocator.py) — requests in the same class share one
    compiled program family.

    Lifecycle knobs (all optional, all host-side — none is a row operand, so
    none costs a sync or a compile): ``queue_ttl_s`` expires the job if it is
    still queued that long after submit; ``deadline_s`` bounds the job's
    total submit→done age (queued *or* running — enforced at the next segment
    boundary); ``dedup_key`` makes resubmits idempotent — a submit whose key
    maps to a live or completed ticket returns that ticket instead of
    enqueueing a duplicate, while a key whose job ended ``shed``/``expired``/
    ``cancelled`` admits the retry fresh.
    """

    dim: int
    budget: int
    seed: int = 0
    fid: Optional[int] = None
    instance: int = 1
    fitness: Optional[str] = None
    target: Optional[float] = None
    priority: int = 0
    lam_start: Optional[int] = None
    kmax_exp: Optional[int] = None
    dtype: Optional[str] = None
    tag: str = ""
    queue_ttl_s: Optional[float] = None
    deadline_s: Optional[float] = None
    dedup_key: Optional[str] = None
    key: Any = None                     # explicit PRNG key (overrides seed)

    def validate(self):
        if (self.fid is None) == (self.fitness is None):
            raise ValueError("exactly one of fid / fitness must be set")
        if self.dim < 1:
            raise ValueError(f"dim must be >= 1, got {self.dim}")
        if self.budget < 0:
            raise ValueError(f"budget must be >= 0, got {self.budget}")
        for name in ("queue_ttl_s", "deadline_s"):
            v = getattr(self, name)
            if v is not None and v < 0:
                raise ValueError(f"{name} must be >= 0, got {v}")

    def to_meta(self) -> dict:
        """JSON-able form for snapshots: the explicit key as its two 32-bit
        words, as the JAX package writes a key."""
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "key"}
        if self.key is not None:
            d["_key"] = key_words(self.key)
        return d

    @classmethod
    def from_meta(cls, d: dict) -> "CampaignRequest":
        d = dict(d)
        raw = d.pop("_key", None)
        # pre-lifecycle snapshots lack fields added later; dataclass defaults
        # cover them, and unknown future fields are dropped
        names = {f.name for f in dataclasses.fields(cls)}
        req = cls(**{k: v for k, v in d.items() if k in names})
        if raw is not None:
            req.key = [int(x) for x in raw]
        return req


@dataclasses.dataclass
class CampaignTicket:
    """Streaming handle of one submitted job (updated in place by the server).

    ``updates`` is the trajectory tail: one record per segment boundary while
    the job is resident ({boundary, fevals, best_f, k}), capped at
    ``TAIL_CAP`` most-recent entries.  ``result`` (an ``ipop.IPOPResult``
    with the full per-descent trajectory) lands when status turns "done" —
    and, partially, when a running job is cancelled/expired/quarantined (the
    trajectory up to the retirement boundary, with ``reason`` saying why).
    """

    TAIL_CAP = 512

    job_id: int
    request: CampaignRequest
    status: str = JOB_QUEUED
    reason: str = ""
    best_f: float = float("inf")
    fevals: int = 0
    updates: List[dict] = dataclasses.field(default_factory=list)
    result: Any = None
    lane: Optional[tuple] = None
    island: Optional[int] = None
    row: Optional[int] = None
    # host wall-clock timestamps; None on tickets rebuilt from a snapshot
    # (timestamps are not persisted, so a resumed job has no latency)
    submit_s: Optional[float] = None
    admit_s: Optional[float] = None
    done_s: Optional[float] = None
    admit_boundary: Optional[int] = None
    # absolute (monotonic-clock) expiry instants, armed from queue_ttl_s /
    # deadline_s at submit and RE-armed with the full allowance on restore
    # (a restored server has no past wall clock to charge against)
    ttl_at: Optional[float] = None
    deadline_at: Optional[float] = None

    def arm(self, now_s: float):
        """(Re)compute the absolute expiry instants from the request's
        relative allowances, charging from ``now_s``."""
        if self.request.queue_ttl_s is not None:
            self.ttl_at = now_s + self.request.queue_ttl_s
        if self.request.deadline_s is not None:
            self.deadline_at = now_s + self.request.deadline_s

    def push(self, rec: dict):
        """Append one boundary update, dropping the oldest beyond
        ``TAIL_CAP`` (server-side; consumers just read ``updates``)."""
        self.updates.append(rec)
        if len(self.updates) > self.TAIL_CAP:
            del self.updates[:len(self.updates) - self.TAIL_CAP]

    @property
    def done(self) -> bool:
        """True once the full result landed (status ``"done"``)."""
        return self.status == JOB_DONE

    @property
    def terminal(self) -> bool:
        """True once the ticket reached any terminal lifecycle state."""
        return self.status in TERMINAL_STATUSES

    def latency_s(self) -> Optional[float]:
        """submit → done wall-clock latency (the quantity the soak SLO is
        written against); None while running or on a snapshot-restored
        ticket (timestamps are not persisted)."""
        if self.done_s is None or self.submit_s is None:
            return None
        return self.done_s - self.submit_s


def _heap_remove_at(heap: list, i: int):
    """Remove and return ``heap[i]`` in O(log n), preserving the invariant:
    replace with the last element and sift it in whichever direction the
    ordering demands (no full re-heapify)."""
    item = heap[i]
    last = heap.pop()
    if i < len(heap):
        heap[i] = last
        if last < item:
            heapq._siftdown(heap, 0, i)     # may need to rise toward the root
        else:
            heapq._siftup(heap, i)          # may need to sink into the subtree
    return item


class AdmissionQueue:
    """Priority-ordered pending requests with priority-aware backpressure.

    ``submit`` is O(log n); ``take`` scans for the highest-priority request
    (ties broken FIFO) matching a predicate — the server's admission pass
    calls it with "fits a lane with a free row" so a blocked wide job never
    starves narrower ones behind it — and removes just that entry without
    disturbing the rest of the heap.
    """

    def __init__(self, max_pending: int = 256):
        self.max_pending = int(max_pending)
        self._heap: List[Tuple[int, int, CampaignRequest, CampaignTicket]] = []
        self._seq = itertools.count()
        self._ids = itertools.count()
        #: tickets evicted by priority shedding since the last ``drain_shed``
        #: (the server drains these to emit metrics / settle dedup keys)
        self._shed: List[CampaignTicket] = []

    def __len__(self) -> int:
        return len(self._heap)

    def submit(self, req: CampaignRequest, *,
               now_s: float = 0.0) -> CampaignTicket:
        """Validate and enqueue ``req``; returns its fresh ticket (job id
        assigned here).  At ``max_pending`` the *lowest*-priority pending
        ticket is shed — terminal ``status="shed"`` — iff it ranks strictly
        below ``req``; otherwise ``QueueFull`` (the backpressure contract is
        unchanged for equal-or-higher-priority traffic).  ``ValueError`` on
        an invalid request.  ``now_s`` stamps ``ticket.submit_s`` and arms
        the TTL/deadline clocks."""
        req.validate()
        if len(self._heap) >= self.max_pending:
            victim_i = max(range(len(self._heap)),
                           key=lambda i: self._heap[i][:2])
            # heap entries sort (-priority, seq): the max is the lowest
            # priority, youngest.  Shed only on a STRICT priority win.
            if self._heap[victim_i][0] <= -req.priority:
                raise QueueFull(
                    f"admission queue at capacity "
                    f"({self.max_pending} pending)")
            victim = _heap_remove_at(self._heap, victim_i)[3]
            victim.status = JOB_SHED
            victim.reason = ("displaced by a priority-"
                             f"{req.priority} submit")
            self._shed.append(victim)
        ticket = CampaignTicket(job_id=next(self._ids), request=req,
                                submit_s=now_s)
        ticket.arm(now_s)
        heapq.heappush(self._heap,
                       (-req.priority, next(self._seq), req, ticket))
        return ticket

    def take(self, match: Optional[Callable[[CampaignRequest], bool]] = None,
             ) -> Optional[Tuple[CampaignRequest, CampaignTicket]]:
        """Remove and return the best-priority (request, ticket) for which
        ``match`` holds (None matches everything); None if nothing matches.
        One O(n) scan + one O(log n) removal — the heap order survives."""
        best = -1
        for i, item in enumerate(self._heap):
            if match is None or match(item[2]):
                if best < 0 or item[:2] < self._heap[best][:2]:
                    best = i
        if best < 0:
            return None
        item = _heap_remove_at(self._heap, best)
        return (item[2], item[3])

    def remove(self, job_id: int) -> Optional[CampaignTicket]:
        """Pull one still-queued ticket out by job id (cancellation path);
        None if the id is not pending.  Status is left to the caller."""
        for i, item in enumerate(self._heap):
            if item[3].job_id == job_id:
                return _heap_remove_at(self._heap, i)[3]
        return None

    def expire(self, now_s: float) -> List[CampaignTicket]:
        """Retire every pending ticket whose queue-TTL or total deadline has
        passed (terminal ``status="expired"``); returns the expired tickets.
        Host-side bookkeeping only — never touches a device."""
        hit = [item[3] for item in self._heap
               if (item[3].ttl_at is not None and now_s >= item[3].ttl_at)
               or (item[3].deadline_at is not None
                   and now_s >= item[3].deadline_at)]
        for t in hit:                   # re-scan per removal: each removal
            for i, item in enumerate(self._heap):   # re-sifts the heap, so
                if item[3] is t:                    # indices don't survive
                    _heap_remove_at(self._heap, i)
                    break
            t.status = JOB_EXPIRED
            t.reason = ("queue TTL exceeded"
                        if t.ttl_at is not None and now_s >= t.ttl_at
                        else "deadline exceeded while queued")
        return hit

    def drain_shed(self) -> List[CampaignTicket]:
        """Tickets shed since the last drain (server bookkeeping hook)."""
        out, self._shed = self._shed, []
        return out

    def pending(self) -> List[CampaignTicket]:
        """Tickets still queued, in admission (priority, FIFO) order."""
        return [t for (_p, _s, _r, t) in sorted(self._heap)]
