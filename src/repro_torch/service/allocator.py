"""Slot allocation: dim-class routing + free-slot bitmaps over island rows
(port of ``repro/service/allocator.py``).

The service's surface is a fixed grid: each *lane* (one
dim-class) owns ``n_islands × rows_per_island`` member rows of the
rung-bucket slot machinery — stacked ``CMAState`` rows exactly like a
bucketed campaign's batch, padded with inert rows (``active=False``) where
no job lives.  Admission packs a request into a free row of the island with
the most head-room; retirement frees the row for the next tenant.  Because
every per-job quantity (base key, budget, fitness index, instance) is a
*row-indexed operand* of the segment programs — never part of a program
key — jobs join and leave a RUNNING program family without a new program:
programs stay ≤ #buckets × #dim-classes (tests/test_torch_service.py).

Rows are fully relocatable: a member's trajectory depends only on its base
key and its own state, not on which row or island executes it (row-keyed
sampling, ``ladder.slot_key`` over slot 0).  ``repack`` exploits that for
elastic restore — a snapshot taken on P islands re-packs onto P′ without
touching any trajectory.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.service.queue import CampaignRequest


def lane_key(req: CampaignRequest, *, lam_start: int, kmax_exp: int,
             dtype: str, reg_gen: int = 0) -> tuple:
    """Dim-class routing key: requests sharing it run in one lane (one
    program family).  Request fields override the server defaults
    passed as keywords.  ``reg_gen`` is the fitness-registry *generation* the
    lane's programs are traced against (service/server.py): registering a new
    callable on a live server opens generation g+1 — new lanes key against
    it and build fresh program families, while resident generation-g lanes
    keep running their programs untouched."""
    return (int(req.dim),
            int(req.lam_start if req.lam_start is not None else lam_start),
            int(req.kmax_exp if req.kmax_exp is not None else kmax_exp),
            str(req.dtype if req.dtype is not None else dtype),
            int(reg_gen))


class SlotAllocator:
    """Free-slot bitmap per island + host mirrors of per-row job state.

    ``row_jobs[i][r]`` is the resident job id (-1 free); ``budgets`` mirrors
    the device-side per-row budget operand so the host re-bucketing decision
    (``bucketed.next_bucket(budgets=...)``) matches the device gate exactly —
    freed rows keep their last budget until reuse for the same reason.
    """

    def __init__(self, n_islands: int, rows_per_island: int):
        self.n_islands = int(n_islands)
        self.rows_per_island = int(rows_per_island)
        self.free = [np.ones(rows_per_island, bool) for _ in range(n_islands)]
        self.row_jobs = [np.full(rows_per_island, -1, np.int64)
                         for _ in range(n_islands)]
        self.budgets = [np.zeros(rows_per_island, np.int64)
                        for _ in range(n_islands)]

    @property
    def capacity(self) -> int:
        return self.n_islands * self.rows_per_island

    def free_rows(self, island: Optional[int] = None) -> int:
        """Free row count on ``island`` (or lane-wide when None)."""
        if island is not None:
            return int(self.free[island].sum())
        return int(sum(f.sum() for f in self.free))

    def occupied(self) -> List[Tuple[int, int, int]]:
        """(island, row, job_id) triples, deterministic order."""
        out = []
        for i, jobs in enumerate(self.row_jobs):
            for r in np.nonzero(jobs >= 0)[0]:
                out.append((i, int(r), int(jobs[r])))
        return out

    def alloc(self, job_id: int, budget: int,
              island: Optional[int] = None) -> Optional[Tuple[int, int]]:
        """Claim a free row (on ``island``, or the island with the most free
        rows — keeps islands balanced so S2 schedules stay even).  Returns
        (island, row) or None when the lane is full."""
        if island is None:
            frees = [f.sum() for f in self.free]
            island = int(np.argmax(frees))
            if frees[island] == 0:
                return None
        elif not self.free[island].any():
            return None
        row = int(np.argmax(self.free[island]))
        self.free[island][row] = False
        self.row_jobs[island][row] = job_id
        self.budgets[island][row] = budget
        return island, row

    def release(self, island: int, row: int):
        """Free the row for the next tenant (job retirement)."""
        self.free[island][row] = True
        self.row_jobs[island][row] = -1
        # budgets deliberately kept: the device mirror still holds the old
        # value and the row must stay schedule-inert under the same rule

    def to_meta(self) -> dict:
        return {"n_islands": self.n_islands,
                "rows_per_island": self.rows_per_island,
                "row_jobs": [[int(x) for x in jobs]
                             for jobs in self.row_jobs],
                "budgets": [[int(x) for x in b] for b in self.budgets]}

    @classmethod
    def from_meta(cls, meta: dict) -> "SlotAllocator":
        al = cls(meta["n_islands"], meta["rows_per_island"])
        for i, (jobs, buds) in enumerate(zip(meta["row_jobs"],
                                             meta["budgets"])):
            al.row_jobs[i] = np.asarray(jobs, np.int64)
            al.budgets[i] = np.asarray(buds, np.int64)
            al.free[i] = al.row_jobs[i] < 0
        return al

    def repack(self, n_islands: int, rows_per_island: Optional[int] = None,
               ) -> Tuple["SlotAllocator", Dict[int, Tuple[int, int]],
                          List[List[Optional[Tuple[int, int]]]]]:
        """Elastic re-shard: lay the occupied rows out on a new island grid.

        Returns ``(allocator', moves, layout)`` where ``moves[job_id] =
        (new_island, new_row)`` and ``layout[i'][r']`` names the OLD
        ``(island, row)`` each new cell pulls its state from (None → fresh
        inert filler).  Occupied rows fill the new grid island-major in
        deterministic order; capacity grows with padding rows and may shrink
        down to the occupied count.
        """
        occ = self.occupied()
        if rows_per_island is None:
            rows_per_island = max(self.rows_per_island,
                                  -(-len(occ) // int(n_islands)))
        new = SlotAllocator(n_islands, rows_per_island)
        if len(occ) > new.capacity:
            raise ValueError(
                f"cannot repack {len(occ)} resident jobs into "
                f"{n_islands}×{rows_per_island} rows")
        moves: Dict[int, Tuple[int, int]] = {}
        layout: List[List[Optional[Tuple[int, int]]]] = [
            [None] * rows_per_island for _ in range(n_islands)]
        for idx, (i, r, job) in enumerate(occ):
            ni, nr = idx % n_islands, idx // n_islands
            new.free[ni][nr] = False
            new.row_jobs[ni][nr] = job
            new.budgets[ni][nr] = self.budgets[i][r]
            moves[job] = (ni, nr)
            layout[ni][nr] = (i, r)
        return new, moves, layout
