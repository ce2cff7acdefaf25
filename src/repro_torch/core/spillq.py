"""Shared §6 spill-queue primitive: resident-oldest prefix, spilled-youngest
suffix.

LifeRaft §6 trades arrival-order processing against data-driven batching
by spilling overflow workload to secondary storage and paging it back as
memory allows.  Two subsystems need exactly this container: the core
``WorkloadQueue`` (pending work units per bucket) and the serving
engine's per-adapter request queue.  They used to hand-mirror each
other's spill mechanics (push boundary rule, youngest-first eviction,
O(1) byte counters) — policed by a property suite but still two copies.
``SpillQueue`` is the one implementation both rebase on.

The container holds two lists of opaque items:

* ``resident`` — the *oldest* pending items, in memory (the §6 budget
  target);
* ``spilled``  — the *youngest* items, paged to host.

and is parameterized by accessors instead of item types:

* ``bytes_of(item)``   — the item's spillable payload bytes (the budget
  currency; clamp at the call site — see ``CostModel.min_unit_bytes``);
* ``arrival_of(item)`` — the item's arrival time (drives every age cut);
* ``count_of(item)``   — optional object count per item (|W_i| units for
  the core queue; defaults to 1 per item, the serving request case);
* ``order_of(item)``   — optional total-order key used when merging paged
  items back into the resident prefix (defaults to ``arrival_of``; the
  serving queue adds the request id as a tie-break).

Invariants every consumer relies on (property-tested in
``tests/test_partial_spill.py``):

* **conservation** — ``resident_bytes + spilled_bytes == nbytes`` and the
  same for counts, under any interleaving of push/spill/unspill/prune;
* **age cut** — no resident item is younger than any spilled item, so the
  oldest pending item is always resident after a *partial* spill and the
  scheduler's monotone age rebase is untouched by overflow;
* **paged unspill never overshoots** — ``unspill_oldest(budget_bytes=g)``
  pages items back strictly oldest-first and stops *before* the item that
  would exceed ``g`` (the wholesale ``unspill_all`` re-exceeding the §6
  budget in one shot is exactly the thrash §6's incremental
  head-scheduling analogy is designed to avoid);
* while anything is spilled, new (youngest) work lands on the spilled
  side, so an overflowing queue cannot grow its resident footprint behind
  the budget's back — but a late out-of-order arrival older than the
  spill boundary still joins the resident prefix.
"""
from __future__ import annotations

from typing import Callable, Generic, Iterable, Optional, TypeVar

__all__ = ["SpillQueue", "SpillBookkeepingMixin"]

T = TypeVar("T")

_INF = float("inf")


def _one(_item) -> int:
    return 1


class SpillQueue(Generic[T]):
    """Resident-oldest-prefix / spilled-youngest-suffix item queue.

    Byte and count tallies are maintained O(1) on push; spill/unspill are
    O(n log n) in the side they walk (enforcement-rate operations, not
    per-item ones).
    """

    __slots__ = (
        "bucket_id", "resident", "spilled",
        "_size", "_spilled_size", "_bytes", "_spilled_bytes",
        "_spilled_oldest",
        "_bytes_of", "_arrival_of", "_count_of", "_order_of",
    )

    def __init__(
        self,
        bucket_id: int,
        *,
        bytes_of: Callable[[T], float],
        arrival_of: Callable[[T], float],
        count_of: Optional[Callable[[T], int]] = None,
        order_of: Optional[Callable[[T], object]] = None,
    ) -> None:
        self.bucket_id = bucket_id
        self.resident: list[T] = []  # oldest pending work, in memory
        self.spilled: list[T] = []  # youngest, on host
        self._size = 0
        self._spilled_size = 0
        self._bytes = 0.0
        self._spilled_bytes = 0.0
        self._spilled_oldest = _INF  # oldest arrival on the spilled side
        self._bytes_of = bytes_of
        self._arrival_of = arrival_of
        self._count_of = count_of or _one
        self._order_of = order_of or arrival_of

    # -- intake -----------------------------------------------------------------
    def push(self, item: T) -> bool:
        """Enqueue one item.  While any of the queue is spilled, new
        (youngest) work lands on the spilled side so the resident prefix
        stays an age-contiguous cut; an item older than the spill boundary
        (late out-of-order arrival) still joins the resident prefix.
        Returns True iff the item landed spilled."""
        landed_spilled = bool(self.spilled) and (
            self._arrival_of(item) >= self._spilled_oldest
        )
        if landed_spilled:
            self.spilled.append(item)
            self._spilled_size += self._count_of(item)
            self._spilled_bytes += self._bytes_of(item)
        else:
            self.resident.append(item)
        self._size += self._count_of(item)
        self._bytes += self._bytes_of(item)
        return landed_spilled

    def drain(self) -> list[T]:
        """Remove and return everything (both sides; servicing pages the
        spilled suffix back in)."""
        items = self.resident + self.spilled
        self.resident, self.spilled = [], []
        self._size = self._spilled_size = 0
        self._bytes = self._spilled_bytes = 0.0
        self._spilled_oldest = _INF
        return items

    def prune_resident(self, keep: Callable[[T], bool]) -> int:
        """Drop resident items failing ``keep`` (retired work) and rebase
        the tallies.  The spilled side is untouched — spilled items leave
        only by being paged back in or drained.  Returns items dropped."""
        before = len(self.resident)
        self.resident = [x for x in self.resident if keep(x)]
        self._bytes = (
            sum(self._bytes_of(x) for x in self.resident) + self._spilled_bytes
        )
        self._size = (
            sum(self._count_of(x) for x in self.resident) + self._spilled_size
        )
        return before - len(self.resident)

    # -- §6 spill ----------------------------------------------------------------
    def spill_youngest(self, frac: float = 1.0) -> int:
        """Move the youngest resident items to host until the spilled byte
        fraction reaches ``frac`` of the queue's total bytes.  Item
        granularity rounds *up* (spill at least the requested bytes); for
        ``frac < 1`` the oldest item always stays resident.  Stable on
        arrival ties, so repeated partial spills are deterministic.
        Returns the number of items moved."""
        if not self.resident:
            return 0
        target = min(max(frac, 0.0), 1.0) * self._bytes
        keep_oldest = frac < 1.0
        # Youngest == largest arrival time; index tie-break keeps it stable.
        order = sorted(
            range(len(self.resident)),
            key=lambda i: (self._arrival_of(self.resident[i]), i),
        )
        moved = 0
        while self._spilled_bytes < target and order:
            if keep_oldest and len(order) == 1:
                break
            i = order.pop()  # youngest remaining
            item = self.resident[i]
            self._spilled_size += self._count_of(item)
            self._spilled_bytes += self._bytes_of(item)
            moved += 1
        if moved:
            keep = set(order)
            victims = [x for i, x in enumerate(self.resident) if i not in keep]
            self.resident = [self.resident[i] for i in sorted(keep)]
            # Spilled suffix stays youngest-last like the resident list.
            victims.sort(key=self._arrival_of)
            self.spilled.extend(victims)
            self._spilled_oldest = min(
                self._spilled_oldest, self._arrival_of(victims[0])
            )
        return moved

    # -- §6 unspill --------------------------------------------------------------
    def unspill_all(self) -> int:
        """Page every spilled item back into the resident prefix (the
        legacy wholesale mode).  Idempotent.  Returns items restored."""
        moved = len(self.spilled)
        if moved:
            merged = self.resident + self.spilled
            merged.sort(key=self._order_of)
            self.resident = merged
            self.spilled = []
            self._spilled_size = 0
            self._spilled_bytes = 0.0
            self._spilled_oldest = _INF
        return moved

    def unspill_oldest(
        self,
        budget_bytes: Optional[float] = None,
        max_items: Optional[int] = None,
    ) -> int:
        """Page spilled items back into the resident prefix **oldest
        first**, stopping *before* the item that would push the paged-in
        bytes past ``budget_bytes`` (strict: a grant is never overshot —
        the §6 budget-overshoot fix) or past ``max_items``.  Oldest-first
        is also strict: a younger item is never paged in ahead of an older
        one that does not fit.  ``None`` bounds are unlimited (both
        ``None`` == ``unspill_all``).  Returns items restored."""
        if not self.spilled:
            return 0
        if budget_bytes is None and max_items is None:
            return self.unspill_all()
        if max_items is None and budget_bytes >= self._spilled_bytes:
            # A grant covering the whole tracked suffix pages it all in.
            # Comparing against the tally the granter itself read avoids
            # stranding the last item on an ULP difference between the
            # incrementally-accumulated tally and the per-item re-sum.
            return self.unspill_all()
        # The spilled side is *mostly* arrival-ordered, but pushes landing
        # on it only respect the boundary, not the suffix order — sort.
        order = sorted(
            range(len(self.spilled)),
            key=lambda i: (self._arrival_of(self.spilled[i]), i),
        )
        take: list[int] = []
        paged = 0.0
        for i in order:
            if max_items is not None and len(take) >= max_items:
                break
            b = self._bytes_of(self.spilled[i])
            if budget_bytes is not None and paged + b > budget_bytes:
                break  # strict oldest-first: do not skip ahead
            paged += b
            take.append(i)
        if not take:
            return 0
        if len(take) == len(self.spilled):
            return self.unspill_all()
        chosen = set(take)
        moved = [x for i, x in enumerate(self.spilled) if i in chosen]
        self.spilled = [x for i, x in enumerate(self.spilled) if i not in chosen]
        return self._page_in(moved)

    def unspill_items(self, items: Iterable[T]) -> int:
        """Page back exactly the given items (matched by identity) if they
        are on the spilled side — the 'these requests were just serviced'
        path: servicing pages in only what it touched, not the whole
        suffix.  Returns items restored."""
        if not self.spilled:
            return 0
        ids = {id(x) for x in items}
        if not ids:
            return 0
        moved = [x for x in self.spilled if id(x) in ids]
        if not moved:
            return 0
        if len(moved) == len(self.spilled):
            return self.unspill_all()
        self.spilled = [x for x in self.spilled if id(x) not in ids]
        return self._page_in(moved)

    def _page_in(self, moved: list[T]) -> int:
        """Merge paged-in items into the resident prefix and rebuild the
        spilled tallies from what remains (deterministic values independent
        of spill history, so replayed traces stay bit-stable)."""
        merged = self.resident + moved
        merged.sort(key=self._order_of)
        self.resident = merged
        self._spilled_size = sum(self._count_of(x) for x in self.spilled)
        self._spilled_bytes = sum(self._bytes_of(x) for x in self.spilled)
        self._spilled_oldest = min(
            self._arrival_of(x) for x in self.spilled
        )
        return len(moved)

    # -- accounting ---------------------------------------------------------------
    @property
    def size(self) -> int:
        """Total pending count (resident + spilled) — |W_i| in Eq. 1 is
        unchanged by residency."""
        return self._size

    @property
    def resident_size(self) -> int:
        return self._size - self._spilled_size

    @property
    def nbytes(self) -> float:
        """Total pending payload bytes (resident + spilled)."""
        return self._bytes

    @property
    def resident_bytes(self) -> float:
        return self._bytes - self._spilled_bytes

    @property
    def spilled_bytes(self) -> float:
        return self._spilled_bytes

    @property
    def spilled_fraction(self) -> float:
        """sigma(i) in Eq. 1: spilled share of the queue's payload bytes.
        Exactly 0.0 / 1.0 at the ends (a fully spilled queue pays exactly
        T_spill, bit-identical to the legacy boolean semantics)."""
        if not self.spilled or not self._size:
            return 0.0
        if not self.resident:
            return 1.0
        return self._spilled_bytes / self._bytes if self._bytes else 0.0

    @property
    def oldest_arrival(self) -> float:
        """Arrival of the oldest pending item, either side.  O(n) here;
        subclasses that can maintain it O(1) (core WorkloadQueue) override."""
        if not self.resident and not self.spilled:
            return _INF
        return min(
            self._arrival_of(x) for x in self.resident + self.spilled
        )

    def __len__(self) -> int:
        return len(self.resident) + len(self.spilled)

    def __bool__(self) -> bool:
        return self._size > 0

    # -- state snapshot -----------------------------------------------------------
    def snapshot(self, describe: Optional[Callable[[T], object]] = None) -> dict:
        """Plain-data view of the queue's full state — both sides in
        stored order plus the O(1) tallies.  ``describe`` maps an item to
        a JSON-comparable key (defaults to ``repr``).  Used by the
        durability tier to assert journal-replayed state equals live state
        (resident/spilled membership AND order matter: the spill boundary
        and the paged-unspill merge order are part of the decision
        state)."""
        describe = describe or repr
        return {
            "bucket": self.bucket_id,
            "resident": [describe(x) for x in self.resident],
            "spilled": [describe(x) for x in self.spilled],
            "size": self._size,
            "bytes": self._bytes,
            "spilled_size": self._spilled_size,
            "spilled_bytes": self._spilled_bytes,
        }


class SpillBookkeepingMixin:
    """Manager-side §6 bookkeeping over a dict of SpillQueue buckets —
    the spilled-mark set, change notification, and the spill/unspill
    bucket protocol, shared by ``WorkloadManager`` and the serving
    engine's ``AdapterWorkload`` (one copy, like the queue mechanics).

    Host classes provide ``self.queues`` (bucket id -> SpillQueue),
    ``self._spilled`` (set of bucket ids with any spilled work) and
    ``self._notify(bucket_id)`` (incremental-scheduler change tap).
    """

    def is_spilled(self, bucket_id: int) -> bool:
        """True if any of the bucket's pending workload is on host."""
        return bucket_id in self._spilled

    def spilled_fraction(self, bucket_id: int) -> float:
        """sigma(i): the bucket's spilled byte fraction, in [0, 1]."""
        q = self.queues.get(bucket_id)
        return q.spilled_fraction if q else 0.0

    def spilled_buckets(self) -> list[int]:
        return sorted(self._spilled)

    def spill_bucket(self, bucket_id: int, frac: float = 1.0) -> bool:
        """Spill the youngest ``frac`` of the bucket's pending payload
        bytes to host (unit granularity, rounding up; ``frac=1`` spills
        the whole queue — the legacy semantics).  The queue stays
        schedulable but pays a sigma-pro-rated ``T_spill`` read-back
        surcharge in the scheduler score, so it is deprioritized until
        its age term reclaims it (no starvation).  Returns True if any
        unit moved."""
        q = self.queues.get(bucket_id)
        if q is None or not q:
            return False
        if not q.spill_youngest(frac):
            return False
        self._spilled.add(bucket_id)
        self._notify(bucket_id)
        return True

    def unspill_bucket(
        self, bucket_id: int, budget_bytes: Optional[float] = None
    ) -> bool:
        """Page a bucket's spilled workload back into the resident set.
        Idempotent: unspilling an unspilled bucket is a no-op.

        ``budget_bytes`` switches to the *paged* protocol: only the
        grant's worth pages back, oldest units first, never exceeding the
        grant (unit granularity rounds *down* — a grant is a budget, not
        a target).  The bucket stays marked spilled while any suffix
        remains, so sigma keeps pro-rating ``T_spill`` in Eq. 1 and the
        incremental scheduler re-keys it through the change notification.
        """
        if bucket_id not in self._spilled:
            return False
        q = self.queues.get(bucket_id)
        if q is None:
            self._spilled.discard(bucket_id)
            self._notify(bucket_id)
            return True
        if budget_bytes is None:
            q.unspill_all()
            self._spilled.discard(bucket_id)
            self._notify(bucket_id)
            return True
        moved = q.unspill_oldest(budget_bytes=budget_bytes)
        if not q.spilled:  # fully paged back in
            self._spilled.discard(bucket_id)
        if not moved:
            return False
        self._notify(bucket_id)
        return True
