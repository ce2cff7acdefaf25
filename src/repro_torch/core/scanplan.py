"""Scan-horizon planning: commit a data-driven bucket order ahead of time.

LifeRaft's throughput win comes from executing queries "against an
ordering of the data that maximizes data sharing", and §6 frames the
scheduler as the disk-head-scheduling analogue of incremental batch
processing.  The reactive pieces already exist — the lazy-heap scheduler
picks argmax U_a every round — but a purely reactive system discovers
each bucket's I/O need only at the moment it dispatches, so every cache
miss is paid inline.  SharedDB-style shared-scan systems win precisely by
*committing* to a scan plan and streaming data past the batched queries;
CasJobs stages data before the batch window opens.

``ScanPlanner`` is that commitment: it peeks the scheduler's lazy heap
(:meth:`LifeRaftScheduler.peek_topk`, non-mutating) for the next ``H``
buckets the scheduler is about to want, and reorders *that set* into an
elevator sweep over the data layout — ascending layout positions from the
current head, then the stragglers on the way back — exactly how a disk
head (or a sequential bucket file, or an HBM DMA engine walking adapter
slabs) prefers its requests.  The horizon is therefore always a
permutation of the heap's own top-H ("prefix-consistent": no bucket is
invented, none of the top-H is dropped); only the *staging order* within
the horizon is layout-driven.  Dispatch order is untouched — the
scheduler still argmaxes U_a round by round, so decision traces (and the
incremental-vs-oracle bit-identity story) are unaffected by planning.

Horizons are recommitted every round, and arrivals or an alpha hot-swap
can reshuffle priorities so the new horizon drops buckets the old one
promised ("invalidation").  Unchecked, an unlucky bucket could be
promised and dropped forever — staged never, serviced late.  The planner
is starvation-safe: each commit that leaves a candidate bucket behind the
front bumps its deferral count, and once the *oldest pending* bucket has
been deferred ``starvation_deferrals`` times it is forced to the horizon
front regardless of the sweep, so its I/O stages next.  (Service resets
the count.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

__all__ = ["ScanPlanConfig", "ScanPlanner"]


@dataclasses.dataclass(frozen=True)
class ScanPlanConfig:
    """Scan-horizon planning knobs.

    ``horizon`` is the default lookahead H (the ControlLoop's AIMD law
    may override it per round — see ``ControlConfig.prefetch_horizon_*``).
    ``layout_of`` maps a bucket id to its position in the physical data
    layout (the elevator's track number); bucket ids are SFC-ordered by
    construction (§3.1), so identity is the right default for both
    engines.  ``starvation_deferrals`` bounds how many consecutive
    commits may leave the oldest pending bucket behind the front before
    it is forced there.
    """

    horizon: int = 4
    starvation_deferrals: int = 3
    layout_of: Optional[Callable[[int], float]] = None


class ScanPlanner:
    """Commits a lookahead horizon of the scheduler's next-H buckets in
    elevator-sweep order over the data layout."""

    def __init__(
        self, scheduler, config: ScanPlanConfig = ScanPlanConfig()
    ) -> None:
        if config.horizon < 1:
            raise ValueError("horizon must be >= 1")
        self.scheduler = scheduler
        self.cfg = config
        self._layout_of = config.layout_of or float
        self._head: Optional[float] = None  # layout position of the sweep head
        self._direction = 1  # +1: ascending sweep, -1: descending
        self._deferrals: dict[int, int] = {}  # bucket -> commits left behind
        self._committed: tuple[int, ...] = ()
        self.commits = 0
        self.invalidations = 0  # commits whose candidate set shifted

    # -- the commitment ---------------------------------------------------------
    def plan(self, wm, cache, now: float, horizon: Optional[int] = None) -> list[int]:
        """Commit the next horizon: the scheduler's top-H buckets (by
        U_a, via the non-mutating peek) in elevator-sweep staging order.
        Returns bucket ids, first-to-stage first; empty when the
        scheduler is idle or cannot be peeked."""
        h = int(horizon) if horizon else self.cfg.horizon
        peek = getattr(self.scheduler, "peek_topk", None)
        if peek is None or h < 1:
            self._committed = ()
            return []
        candidates = [d.bucket_id for d in peek(wm, cache, now, h)]
        if not candidates:
            self._committed = ()
            return []
        pending, oldest_b = self._pending_and_oldest(wm)
        plan = self._sweep(candidates)
        plan = self._apply_starvation_guard(plan, oldest_b)
        # Bookkeeping: a commit that reshuffles the previous promise is an
        # invalidation; every candidate left behind the front defers once,
        # and so does a previously-promised bucket dropped from the new
        # horizon while still pending — that drop IS the starvation
        # vector.  Counts survive a bucket oscillating in and out of the
        # top-H (they reset only on service or drain), so a bucket the
        # reshuffles keep bouncing at the horizon boundary still
        # accumulates deferrals and is fronted when it next qualifies.
        cand_set = set(candidates)
        if self._committed and set(self._committed) != cand_set:
            self.invalidations += 1
        for b in list(self._deferrals):
            if b not in pending:
                del self._deferrals[b]  # drained: nothing left to starve
        for b in plan[1:]:
            self._deferrals[b] = self._deferrals.get(b, 0) + 1
        for b in self._committed:
            if b in pending and b not in cand_set:
                self._deferrals[b] = self._deferrals.get(b, 0) + 1
        self._deferrals[plan[0]] = 0
        self._committed = tuple(plan)
        self.commits += 1
        return plan

    def note_serviced(self, bucket_ids: Sequence[int]) -> None:
        """Advance the sweep head past the buckets just serviced and reset
        their deferral counts (service is the strongest un-starving)."""
        for b in bucket_ids:
            self._deferrals.pop(b, None)
        if not bucket_ids:
            return
        pos = self._layout_of(bucket_ids[-1])
        if self._head is not None and pos < self._head:
            self._direction = -1
        elif self._head is not None and pos > self._head:
            self._direction = 1
        self._head = pos

    # -- internals ---------------------------------------------------------------
    def _sweep(self, candidates: list[int]) -> list[int]:
        """Elevator order: continue the current direction from the head,
        then turn around for the stragglers.  A permutation of the
        candidates — nothing added, nothing dropped."""
        pos = self._layout_of
        head = self._head if self._head is not None else pos(candidates[0])
        if self._direction >= 0:
            ahead = sorted(
                (b for b in candidates if pos(b) >= head), key=lambda b: (pos(b), b)
            )
            behind = sorted(
                (b for b in candidates if pos(b) < head),
                key=lambda b: (pos(b), b), reverse=True,
            )
        else:
            ahead = sorted(
                (b for b in candidates if pos(b) <= head),
                key=lambda b: (pos(b), b), reverse=True,
            )
            behind = sorted(
                (b for b in candidates if pos(b) > head), key=lambda b: (pos(b), b)
            )
        if not ahead:  # nothing left in this direction: turn the elevator
            self._direction = -self._direction
            return behind
        return ahead + behind

    def _apply_starvation_guard(
        self, plan: list[int], oldest_b: Optional[int]
    ) -> list[int]:
        """Force the oldest pending bucket to the horizon front once
        repeated invalidations have deferred it past the limit."""
        if (
            oldest_b is not None
            and oldest_b in plan
            and plan[0] != oldest_b
            and self._deferrals.get(oldest_b, 0) >= self.cfg.starvation_deferrals
        ):
            plan = [oldest_b] + [b for b in plan if b != oldest_b]
        return plan

    @staticmethod
    def _pending_and_oldest(wm) -> tuple[set[int], Optional[int]]:
        """One walk over the nonempty queues: the pending bucket set (the
        deferral books' domain) and the oldest pending bucket (the
        starvation guard's subject)."""
        pending: set[int] = set()
        best = None
        best_key = None
        for q in wm.nonempty_queues():
            pending.add(q.bucket_id)
            key = (q.oldest_arrival, q.bucket_id)
            if best_key is None or key < best_key:
                best_key = key
                best = q.bucket_id
        return pending, best
