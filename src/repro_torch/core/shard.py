"""Multi-shard execution tier: SFC-range partitioning, routing, stealing.

The paper's SkyQuery setting is a federation (§7 discusses scaling query
throughput across the data), and the production descendants (CasJobs, the
SDSS/NVO grid extension) partition multi-TB batch work across contexts.
Bucket scans are independent once routing is solved, so the data-driven
order parallelizes near-linearly.  This module is the tier that solves
routing:

* ``ShardMap`` — partitions the bucket space into S contiguous **SFC
  ranges** (bucket ids are the Partitioner's SFC-run order, so contiguous
  id ranges ARE contiguous HTM/Morton key ranges), balanced by a greedy
  heuristic over bucket *bytes* rather than bucket count.  Work stealing
  moves a bucket between shards via per-bucket overrides on top of the
  range map.
* ``ShardedDispatch`` — the coordinator: decomposes each query once
  (object indices stay valid against the original query arrays), routes
  the per-bucket slices to their owning shards
  (``WorkloadManager.submit_decomposed``), and joins per-shard
  completions — a query spanning shards completes at the **max** of its
  local completion clocks.  Each shard runs its own scheduler + cache +
  ``DispatchLoop`` over a pluggable in-process transport: the simulator
  drives shards on virtual clocks in deterministic (clock, shard_id)
  order; the cross-match engine wraps the same coordinator protocol with
  threads (``crossmatch.ShardedCrossMatch``).
* **Work stealing** — when a shard's pending bytes drain to the
  ``StealConfig`` low-water mark, it steals the victim's highest-utility
  *unstarted* bucket (the victim scheduler's own top pick): pending units
  migrate with their arrival times intact (the age term survives), the
  thief's clock advances to the newest stolen arrival (no acausal
  service), the victim's in-flight prefetch stage for the bucket cancels
  for its *residual* channel time, and the payload is cache-cold on the
  thief — the next service pays the full ``T_b`` read.  Completion
  bookkeeping moves with the units, so nothing is lost or double-counted.
* The **global control tier** (``ShardControlPlane``, core/control.py)
  waterfills the spill and prefetch byte budgets across shards from
  per-shard telemetry slices, exactly as the ``TenantControlPlane``
  waterfills across tenants; grants land as each loop's
  ``shard_grant`` override and each pipeline's staging byte cap.

The S=1 configuration is a pure refactor of the single-loop path — same
admit/idle-jump/round sequence, same executor arithmetic — which the
golden harness proves bit-identically (``tests/test_shard.py``).
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import deque
from typing import Callable, Mapping, Optional, Sequence

from .control import ShardControlPlane
from .workload import Query, WorkloadManager

__all__ = [
    "ShardMap",
    "StealConfig",
    "StealEvent",
    "ShardRuntime",
    "ShardedDispatch",
    "split_slots",
]


def split_slots(total: int, n_shards: int) -> list[int]:
    """Split ``total`` capacity slots across ``n_shards``, conserving the
    aggregate: the first ``total % n_shards`` shards get one extra slot
    (plain ``total // n_shards`` silently drops the remainder).  Each
    share is floored at 1 so every shard stays runnable — when
    ``total < n_shards`` the aggregate is inflated to ``n_shards``, the
    minimum that keeps all shards live."""
    n_shards = max(1, int(n_shards))
    total = int(total)
    base, rem = divmod(total, n_shards)
    return [max(1, base + (1 if s < rem else 0)) for s in range(n_shards)]


class ShardMap:
    """Bucket -> shard assignment: S contiguous SFC ranges + steal overrides.

    ``cuts`` holds the *last bucket id* of each shard but the final one
    (ascending); ``shard_of`` is a bisect over them, overridden per bucket
    for stolen buckets.  Bucket ids are the Partitioner's SFC-run order,
    so a contiguous id range is a contiguous HTM/Morton key range — the
    natural shard key the ROADMAP names.
    """

    def __init__(self, cuts: Sequence[int], n_shards: int) -> None:
        if n_shards < 1:
            raise ValueError(f"need at least one shard, got {n_shards}")
        if list(cuts) != sorted(cuts) or len(cuts) >= n_shards:
            raise ValueError(f"cuts must be < n_shards ascending ids: {cuts}")
        self.cuts = list(cuts)
        self.n_shards = int(n_shards)
        self.overrides: dict[int, int] = {}  # stolen buckets

    @classmethod
    def from_bucket_bytes(
        cls, bucket_bytes: Mapping[int, float], n_shards: int
    ) -> "ShardMap":
        """Greedy byte-balance heuristic: walk buckets in SFC order
        accumulating bytes, cutting each shard when the running total
        reaches its cumulative share ``(s+1) * total / S`` (or when
        exactly enough buckets remain to keep later shards nonempty).
        One pass, and each shard's byte load lands within one bucket of
        the even split."""
        ids = sorted(bucket_bytes)
        if n_shards < 1:
            raise ValueError(f"need at least one shard, got {n_shards}")
        total = float(sum(bucket_bytes.values()))
        target = total / n_shards if total > 0 else 0.0
        cuts: list[int] = []
        acc = 0.0
        s = 0
        for j, b in enumerate(ids):
            acc += float(bucket_bytes[b])
            remaining_buckets = len(ids) - j - 1
            remaining_shards = n_shards - s - 1
            if s < n_shards - 1 and (
                acc >= target * (s + 1) or remaining_buckets == remaining_shards
            ):
                cuts.append(b)
                s += 1
        return cls(cuts, n_shards)

    @classmethod
    def from_partitioner(cls, partitioner, n_shards: int) -> "ShardMap":
        """Byte-balanced map straight from a catalog ``Partitioner``."""
        return cls.from_bucket_bytes(
            {sp.bucket_id: float(sp.nbytes) for sp in partitioner.specs},
            n_shards,
        )

    @classmethod
    def uniform(cls, n_buckets: int, n_shards: int) -> "ShardMap":
        """Equal-count split (every bucket weighs 1.0)."""
        return cls.from_bucket_bytes({b: 1.0 for b in range(n_buckets)}, n_shards)

    def shard_of(self, bucket_id: int) -> int:
        override = self.overrides.get(bucket_id)
        if override is not None:
            return override
        return bisect.bisect_left(self.cuts, bucket_id)

    def reassign(self, bucket_id: int, shard: int) -> None:
        """Record a steal: the bucket now lives on ``shard`` — future
        query slices for it route there."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range [0, {self.n_shards})")
        if bisect.bisect_left(self.cuts, bucket_id) == shard:
            # Back on its home range: the override would be redundant.
            self.overrides.pop(bucket_id, None)
        else:
            self.overrides[bucket_id] = shard

    def shards(self) -> range:
        return range(self.n_shards)


@dataclasses.dataclass(frozen=True)
class StealConfig:
    """Work-stealing knobs.

    ``low_water_bytes`` — a shard whose pending probe bytes are at or
    below this attempts a steal (0.0: only when fully drained).
    ``min_victim_queues`` — a victim must keep at least this many
    nonempty queues *before* the steal (2 means the victim is never
    emptied by one).
    """

    low_water_bytes: float = 0.0
    min_victim_queues: int = 2


@dataclasses.dataclass(frozen=True)
class StealEvent:
    """One migration, as recorded in ``ShardedDispatch.steals`` and the
    golden traces' conditional ``"steals"`` key."""

    bucket_id: int
    victim: int
    thief: int
    n_units: int
    nbytes: float
    reclaimed_stage_s: float  # victim channel time returned by the cancel
    clock: float  # thief clock after the causality advance


@dataclasses.dataclass
class ShardRuntime:
    """One shard's local execution stack: its own scheduler + cache +
    WorkloadManager behind one shard-local DispatchLoop."""

    shard_id: int
    wm: WorkloadManager
    cache: object
    scheduler: object
    loop: object  # DispatchLoop


class ShardedDispatch:
    """The coordinator: routing, per-query joins, stealing, global grants.

    Construction order (the completion callbacks close over the
    coordinator): build the coordinator first, then each shard's
    ``DispatchLoop`` with ``complete=coord.make_complete(shard_id)``, then
    ``add_shard``.  ``run_virtual`` is the simulator transport — shards
    advance on their own virtual clocks, processed in deterministic
    (clock, shard_id) order; an engine transport (threads) drives the
    same ``deliver``/``maybe_steal``/round protocol itself.
    """

    def __init__(
        self,
        shard_map: ShardMap,
        decompose: Callable[[Query], dict[int, list[int]]],
        *,
        steal: Optional[StealConfig] = None,
        plane: Optional[ShardControlPlane] = None,
        on_steal: Optional[Callable[[StealEvent], None]] = None,
        on_round: Optional[Callable[[int, object], None]] = None,
    ) -> None:
        self.shard_map = shard_map
        self.decompose = decompose
        self.steal = steal
        self.plane = plane
        self.on_steal = on_steal
        self.on_round = on_round
        self.shards: dict[int, ShardRuntime] = {}
        self.queries: dict[int, Query] = {}
        self.owners: dict[int, set[int]] = {}  # qid -> shards still pending
        self.completed: dict[int, float] = {}  # qid -> global completion
        self._local_done: dict[int, float] = {}  # qid -> max local clock
        self._undelivered: dict[int, deque] = {}  # shard -> (query, slice)
        self.steals: list[StealEvent] = []

    # -- shard registration ------------------------------------------------------
    def add_shard(self, rt: ShardRuntime) -> None:
        if rt.shard_id in self.shards:
            raise ValueError(f"duplicate shard id {rt.shard_id}")
        self.shards[rt.shard_id] = rt
        self._undelivered[rt.shard_id] = deque()

    def make_complete(self, shard_id: int):
        """The ``DispatchLoop(complete=...)`` callback for one shard:
        complete each serviced bucket locally, then feed the queries whose
        *local* outstanding set emptied into the global join."""

        def complete(decisions, clock: float) -> None:
            rt = self.shards[shard_id]
            for d in decisions:
                for qid in rt.wm.complete_bucket(d.bucket_id, clock):
                    self._on_local_complete(shard_id, qid, clock)

        return complete

    def _on_local_complete(self, shard_id: int, qid: int, clock: float) -> None:
        owners = self.owners.get(qid)
        if owners is None:
            return
        owners.discard(shard_id)
        t = max(self._local_done.get(qid, clock), clock)
        self._local_done[qid] = t
        if not owners:
            # The join: done everywhere — the query's completion time is
            # the LAST shard's local completion (max over local clocks).
            self.completed[qid] = t

    # -- intake ------------------------------------------------------------------
    def route(self, query: Query) -> None:
        """Decompose once, slice by owning shard, queue the slices for
        delivery when each shard's clock reaches the arrival time."""
        per_bucket = self.decompose(query)
        slices: dict[int, dict[int, list]] = {}
        for b, idx in per_bucket.items():
            slices.setdefault(self.shard_map.shard_of(b), {})[b] = idx
        self.queries[query.query_id] = query
        if not slices:  # degenerate empty query completes on arrival
            self.completed[query.query_id] = query.arrival_time
            return
        self.owners[query.query_id] = set(slices)
        for sid, sl in slices.items():
            self._undelivered[sid].append((query, sl))

    def deliver(self, rt: ShardRuntime) -> None:
        """Hand the shard every routed slice that has arrived by its
        clock — the shard-local ``admit`` of the single-loop harness."""
        dq = self._undelivered[rt.shard_id]
        while dq and dq[0][0].arrival_time <= rt.loop.clock:
            q, sl = dq.popleft()
            rt.wm.submit_decomposed(q, sl)
            rt.loop.observe_arrival(q.arrival_time)

    # -- work stealing -----------------------------------------------------------
    def maybe_steal(self) -> list[StealEvent]:
        """One steal sweep: every shard at/below the low-water mark
        (ascending id — deterministic) steals the best victim's top
        bucket.  Returns the events (empty when nothing moved)."""
        cfg = self.steal
        if cfg is None or len(self.shards) < 2:
            return []
        events: list[StealEvent] = []
        for sid in sorted(self.shards):
            thief = self.shards[sid]
            self.deliver(thief)  # count anything already due first
            if thief.wm.pending_bytes() > cfg.low_water_bytes:
                continue
            victims = [
                v
                for v in self.shards.values()
                if v.shard_id != sid
                and len(v.wm.nonempty_queues()) >= cfg.min_victim_queues
            ]
            if not victims:
                continue
            victim = max(
                victims, key=lambda v: (v.wm.pending_bytes(), -v.shard_id)
            )
            bucket_id = self._victim_top_bucket(victim)
            if bucket_id is None:
                continue
            ev = self.steal_bucket(bucket_id, victim, thief)
            if ev is not None:
                events.append(ev)
        return events

    @staticmethod
    def _victim_top_bucket(victim: ShardRuntime) -> Optional[int]:
        """The victim's highest-utility unstarted bucket — its own
        scheduler's top pick (peeked, never suspended), falling back to
        the byte-heaviest queue for unpeekable schedulers."""
        peek = getattr(victim.scheduler, "peek_topk", None)
        if peek is not None:
            top = peek(victim.wm, victim.cache, victim.loop.clock, 1)
            return top[0].bucket_id if top else None
        queues = victim.wm.nonempty_queues()
        if not queues:
            return None
        return max(queues, key=lambda q: (q.nbytes, -q.bucket_id)).bucket_id

    def steal_bucket(
        self, bucket_id: int, victim: ShardRuntime, thief: ShardRuntime
    ) -> Optional[StealEvent]:
        """Migrate one bucket's pending units victim -> thief, honestly:

        * the victim's in-flight prefetch stage for the bucket cancels,
          reclaiming only the *residual* channel time (the spent part
          stays charged);
        * the thief's clock advances to the newest stolen arrival — it
          cannot service units before they arrived;
        * the payload is cache-cold on the thief: its next service pays
          the full ``T_b`` read (no residency teleports);
        * owner sets move with the units, so the join neither loses nor
          double-counts a completion.
        """
        units = victim.wm.migrate_out(bucket_id)
        if not units:
            return None
        if hasattr(victim.scheduler, "forget"):
            victim.scheduler.forget(bucket_id)
        reclaimed = 0.0
        pipe = getattr(victim.loop, "prefetch", None)
        if pipe is not None:
            reclaimed = pipe.cancel(bucket_id, victim.loop.clock)
        qids = sorted({u.query_id for u in units})
        qmap = {q: self.queries[q] for q in qids if q in self.queries}
        thief.wm.migrate_in(units, qmap)
        self.shard_map.reassign(bucket_id, thief.shard_id)
        newest = max(u.arrival_time for u in units)
        thief.loop.clock = max(thief.loop.clock, newest)
        for qid in qids:
            owners = self.owners.get(qid)
            if owners is None:
                continue
            owners.add(thief.shard_id)
            if qid not in victim.wm.outstanding and not self._qid_undelivered(
                victim.shard_id, qid
            ):
                owners.discard(victim.shard_id)
        ev = StealEvent(
            bucket_id=bucket_id,
            victim=victim.shard_id,
            thief=thief.shard_id,
            n_units=len(units),
            nbytes=float(sum(u.nbytes for u in units)),
            reclaimed_stage_s=reclaimed,
            clock=thief.loop.clock,
        )
        self.steals.append(ev)
        if self.on_steal is not None:
            self.on_steal(ev)
        return ev

    def _qid_undelivered(self, shard_id: int, qid: int) -> bool:
        return any(
            q.query_id == qid for q, _ in self._undelivered[shard_id]
        )

    # -- global control tier ------------------------------------------------------
    def apply_grants(self) -> None:
        """One arbitration round: waterfill the global spill/prefetch byte
        budgets over per-shard telemetry slices and park each shard's
        grant on its loop (consumed by the loop's next round) and its
        pipeline (staging byte cap)."""
        if self.plane is None:
            return
        tels = {
            sid: rt.loop.telemetry() for sid, rt in self.shards.items()
        }
        grants = self.plane.update(tels)
        for sid, rt in self.shards.items():
            g = grants.get(sid)
            rt.loop.shard_grant = g
            pipe = getattr(rt.loop, "prefetch", None)
            if pipe is not None:
                pipe.grant_bytes = g.prefetch_bytes if g is not None else None

    # -- the virtual-clock transport (simulator) ----------------------------------
    def run_virtual(self) -> None:
        """Drive every shard to completion on virtual clocks.

        Deterministic: the runnable shard with the smallest (clock,
        shard_id) rounds next.  With S=1 (and stealing/plane off) this
        reduces exactly to the single-loop harness's sequence — idle-jump
        to the next arrival, admit, round — which is the tentpole's
        bit-identity proof obligation.
        """
        shards = [self.shards[s] for s in sorted(self.shards)]
        while True:
            if self.steal is not None:
                self.maybe_steal()
            runnable = [rt for rt in shards if rt.wm.nonempty_queues()]
            if not runnable:
                waiting = [rt for rt in shards if self._undelivered[rt.shard_id]]
                if not waiting:
                    break  # drained everywhere, nothing left to route
                for rt in waiting:
                    # Idle: jump to the shard's next arrival (same move as
                    # the single-loop harness) and deliver it.
                    rt.loop.clock = max(
                        rt.loop.clock,
                        self._undelivered[rt.shard_id][0][0].arrival_time,
                    )
                    self.deliver(rt)
                continue
            rt = min(runnable, key=lambda r: (r.loop.clock, r.shard_id))
            self.deliver(rt)
            self.apply_grants()
            outcome = rt.loop.round()
            if outcome is not None and self.on_round is not None:
                self.on_round(rt.shard_id, outcome)

    # -- introspection -------------------------------------------------------------
    @property
    def n_pending_queries(self) -> int:
        return len(self.queries) - len(self.completed)

    def response_times(self) -> dict[int, float]:
        return {
            qid: t - self.queries[qid].arrival_time
            for qid, t in self.completed.items()
        }

    def makespan(self) -> float:
        return max((rt.loop.clock for rt in self.shards.values()), default=0.0)
