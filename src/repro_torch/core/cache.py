"""Bucket cache (paper §4: LRU, fixed capacity — 20 buckets in §5).

The cache is managed by the framework, independent of any lower-level
buffer pool, exactly as the paper flushes SQL Server's buffers and manages
bucket residency itself.  phi(i) in Eq. 1 is ``0 if cache.contains(i)``.

The scan-horizon prefetch pipeline (``core/prefetch.py``) made admission
and eviction *demand-aware*:

* ``insert_prefetched`` establishes residency ahead of demand without
  counting an access — the fill is tallied separately
  (``CacheStats.prefetch_fills``) so the hit rate stays an honest demand
  statistic, and the first demand touch of a prefetched entry is split
  out as ``prefetch_hits`` (hits the pipeline manufactured, not locality
  the workload exhibited);
* ``protect`` shields the committed horizon from eviction — evicting a
  bucket that is about to be serviced would turn the prefetch into pure
  waste (the victim walk never picks a protected or pinned entry);
* with a demand probe installed (``set_demand_probe``), the victim walk
  prefers buckets with *zero pending demand* — a resident bucket nobody
  is waiting on is a strictly better victim than one with queued work,
  whatever their LRU order says.

All of it is inert unless a prefetch pipeline wires it up: no protected
set, no demand probe, and no prefetch fills means ``access`` behaves
bit-for-bit as the reactive LRU it always was.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Hashable, Iterable, Optional

__all__ = ["CacheStats", "BucketCache", "CacheOverflowError"]


class CacheOverflowError(RuntimeError):
    """An insert needed a victim but every resident bucket is pinned.

    Historically the cache let residency exceed ``capacity`` silently in
    this case; over-pinning is a caller bug (pins outlive the batch that
    took them) and is now surfaced instead of absorbed.
    """


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    # -- prefetch split (all zero without a prefetch pipeline) ---------------
    prefetch_fills: int = 0  # residencies established ahead of demand
    prefetch_hits: int = 0  # first demand touch of a prefetched entry
    prefetch_unused: int = 0  # prefetched entries evicted untouched (waste)

    @property
    def accesses(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0

    @property
    def demand_hits(self) -> int:
        """Hits the workload's own locality produced (LRU would have had
        them too) — ``hits`` minus the ones the pipeline manufactured."""
        return self.hits - self.prefetch_hits


class BucketCache:
    """LRU cache over bucket ids (payloads optional).

    ``capacity`` counts buckets (uniform size by construction, §3.1), so
    LRU over ids is exact.  ``pin``/``unpin`` support batches in flight.
    """

    def __init__(self, capacity: int = 20) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._entries: OrderedDict[Hashable, object] = OrderedDict()
        self._pinned: set[Hashable] = set()
        self._protected: set[Hashable] = set()  # committed prefetch horizon
        self._prefetched: set[Hashable] = set()  # filled, not demand-touched
        self._demand_of: Optional[Callable[[Hashable], int]] = None
        self.stats = CacheStats()
        self._listeners: list[Callable[[Hashable], None]] = []

    # -- change notification -------------------------------------------------
    def subscribe(self, fn: Callable[[Hashable], None]) -> Callable[[Hashable], None]:
        """Register ``fn(bucket_id)`` to fire whenever a bucket's *residency*
        changes (insert or eviction) — phi(i) in Eq. 1 flipped for that id."""
        self._listeners.append(fn)
        return fn

    def unsubscribe(self, fn: Callable[[Hashable], None]) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def _notify(self, bucket_id: Hashable) -> None:
        for fn in self._listeners:
            fn(bucket_id)

    def contains(self, bucket_id: Hashable) -> bool:
        """Residency probe — does NOT count as an access or touch LRU."""
        return bucket_id in self._entries

    def access(self, bucket_id: Hashable, payload: object = None) -> list[Hashable]:
        """Record a demand access; insert on miss. Returns ids evicted (if
        any).  Raises :class:`CacheOverflowError` when the insert needs a
        victim and every resident bucket is pinned (over-pinning used to
        overflow capacity silently)."""
        evicted: list[Hashable] = []
        if bucket_id in self._entries:
            self.stats.hits += 1
            if bucket_id in self._prefetched:
                # First demand touch of a prefetched fill: the pipeline
                # manufactured this hit; split it out of the locality story.
                self._prefetched.discard(bucket_id)
                self.stats.prefetch_hits += 1
            self._entries.move_to_end(bucket_id)
            if payload is not None:
                self._entries[bucket_id] = payload
            return evicted
        self.stats.misses += 1
        self._entries[bucket_id] = payload
        self._entries.move_to_end(bucket_id)
        self._notify(bucket_id)
        while len(self._entries) > self.capacity:
            victim = self._pick_victim()
            if victim is None:
                # Everything else pinned: undo nothing (the demand read DID
                # happen) but refuse to overflow silently.
                self._evict(bucket_id)
                raise CacheOverflowError(
                    f"cannot insert bucket {bucket_id!r}: all "
                    f"{self.capacity} slots pinned"
                )
            self._evict(victim)
            evicted.append(victim)
        return evicted

    def _evict(self, bucket_id: Hashable) -> None:
        self._entries.pop(bucket_id)
        self.stats.evictions += 1
        if bucket_id in self._prefetched:  # prefetched but never demanded
            self._prefetched.discard(bucket_id)
            self.stats.prefetch_unused += 1
        self._notify(bucket_id)

    def _pick_victim(self, allow_demand: bool = True) -> Optional[Hashable]:
        """LRU victim, skipping pinned and protected entries.  With a
        demand probe installed, a first pass prefers zero-demand buckets
        (nobody is waiting on them); the plain LRU walk is the fallback,
        and is the *entire* policy when no probe is set (the reactive
        baseline's exact behavior).  ``allow_demand=False`` (prefetch
        admission) makes zero demand a hard requirement instead of a
        preference — a speculative fill must never displace work the
        scheduler still needs (cache pollution turns prefetch into a
        net loss on demand-saturated caches)."""
        fallback: Optional[Hashable] = None
        probe = self._demand_of
        for k in self._entries:  # OrderedDict: LRU first
            if k in self._pinned or k in self._protected:
                continue
            if probe is None:
                return k
            if not probe(k):
                return k  # zero pending demand: the preferred victim
            if fallback is None:
                fallback = k
        return fallback if allow_demand else None

    # -- prefetch-side admission ------------------------------------------------
    def insert_prefetched(
        self, bucket_id: Hashable, payload: object = None
    ) -> Optional[list[Hashable]]:
        """Establish residency ahead of demand (the prefetch pipeline's
        fill).  Not an access: hit-rate telemetry only ever counts demand
        reads.  Returns ids evicted to make room, or ``None`` when the
        fill was *refused* — no victim exists (all remaining slots pinned
        or horizon-protected), or, with a demand probe installed, every
        candidate victim still has pending demand (admission control: a
        speculative fill never pollutes the cache by displacing demanded
        work).  A refused prefetch degrades to a plain miss later; it
        never crashes the loop or silently overflows."""
        if bucket_id in self._entries:
            if payload is not None:
                self._entries[bucket_id] = payload
            return []
        evicted: list[Hashable] = []
        while len(self._entries) >= self.capacity:
            victim = self._pick_victim(allow_demand=False)
            if victim is None:
                for b in evicted:  # should be unreachable; stay safe
                    self._entries.setdefault(b, None)
                return None
            self._evict(victim)
            evicted.append(victim)
        self._entries[bucket_id] = payload
        self._entries.move_to_end(bucket_id)
        self._prefetched.add(bucket_id)
        self.stats.prefetch_fills += 1
        self._notify(bucket_id)
        return evicted

    def can_admit_prefetch(self) -> bool:
        """Would a prefetch fill land right now?  True with a free slot or
        an admissible victim (non-pinned, non-protected, and zero-demand
        when a probe is installed).  The pipeline checks before issuing a
        stage so the serial channel never burns time on a read the cache
        is bound to refuse."""
        return (
            len(self._entries) < self.capacity
            or self._pick_victim(allow_demand=False) is not None
        )

    def protect(self, bucket_ids: Iterable[Hashable]) -> None:
        """Replace the eviction-protected set (the committed scan horizon).
        Protection is *capped at capacity - 1* resident slots so a demand
        insert always has at least one victim candidate — the horizon may
        shield its buckets, never wedge the cache."""
        ids = list(dict.fromkeys(bucket_ids))  # de-dup, keep order
        if len(ids) >= self.capacity:
            ids = ids[: self.capacity - 1]
        self._protected = set(ids)

    def protected(self) -> set[Hashable]:
        return set(self._protected)

    def set_demand_probe(
        self, fn: Optional[Callable[[Hashable], int]]
    ) -> None:
        """Install ``fn(bucket_id) -> pending objects`` for demand-aware
        eviction (``None`` restores the plain LRU walk)."""
        self._demand_of = fn

    def note_bypass_miss(self) -> None:
        """Record a read that bypassed residency (an indexed cold read):
        counts as a miss in hit_rate without inserting or evicting."""
        self.stats.misses += 1

    def get(self, bucket_id: Hashable) -> object:
        return self._entries.get(bucket_id)

    def pin(self, bucket_id: Hashable) -> None:
        self._pinned.add(bucket_id)

    def unpin(self, bucket_id: Hashable) -> None:
        self._pinned.discard(bucket_id)

    def invalidate(self, bucket_ids: Iterable[Hashable]) -> None:
        """Drop the given buckets' residency.  Invalidating a *pinned*
        bucket is a hard error: a pin means a batch is reading that
        payload right now, and yanking it mid-flight used to be a quiet
        skip-shaped data race."""
        for b in bucket_ids:
            if b in self._pinned:
                raise ValueError(f"cannot invalidate pinned bucket {b!r}")
            if b in self._entries:
                self._entries.pop(b)
                self._prefetched.discard(b)
                self._notify(b)

    def resident(self) -> list[Hashable]:
        return list(self._entries)

    def __len__(self) -> int:
        return len(self._entries)
