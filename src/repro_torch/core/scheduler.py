"""Schedulers: LifeRaft (aged workload throughput), RR, NoShare (paper §5).

A scheduler's single decision is *which bucket to service next* given the
current workload queues, cache residency, and clock.  Batching (servicing a
bucket evaluates every pending work unit on it in one pass) is handled by
the caller — NoShare is the exception and is modeled by the simulator as
per-query evaluation in arrival order.

Two LifeRaft implementations share one contract:

* ``NaiveLifeRaftScheduler`` — the oracle: rescores every nonempty queue on
  every ``select()`` with ``aged_workload_throughput`` (O(B) per decision).
* ``LifeRaftScheduler`` — incremental: exploits the identity

      U_a(i) = U_t(i)*(1-alpha) + (now - oldest_i)*1e3*alpha
             = [U_t(i)*(1-alpha) - oldest_i*1e3*alpha] + now*1e3*alpha

  The bracketed *rebased priority* S(i) is independent of ``now`` and the
  trailing term is constant across candidates, so argmax_i U_a == argmax_i S
  and S only changes when a bucket's queue or residency changes.  A lazy
  max-heap over S, fed by change notifications from the WorkloadManager and
  BucketCache, makes a decision O(dirty * log B) instead of O(B).  To stay
  decision-identical to the oracle under floating point, the top of the heap
  is widened to a tolerance window and the finalists are re-ranked with the
  oracle's own arithmetic.

``normalized=True`` scoring rescales each term by a workload-independent
constant (U_t by 1/T_m, age by ``cost.age_scale_ms`` — see metrics.py), so
the same rebasing applies with scaled coefficients:

      S_n(i) = U_t(i)*T_m*(1-alpha) - oldest_i*1e3*(1/age_scale_ms)*alpha

and the incremental heap path covers the serving engine's default config
too (the historical O(B) fallback existed only because normalization used
to couple scores through candidate-set maxima).

Per-tenant alphas (``set_tenant_alphas``; the multi-tenant control plane)
break the rebase's one assumption: the dropped trailing term
``now*1e3*alpha`` is only candidate-constant when alpha is.  The index
therefore keeps ONE lazy max-heap per *tenant group* (buckets sharing an
alpha): within a group the rebase argument holds verbatim, and the
cross-group argmax compares the handful of group tops after adding each
group's own ``now``-correction — O(dirty·logB + T) per decision with T
tenant classes.  Scalar alpha is the one-group special case, running the
exact same code path as before.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Mapping, Optional, Protocol

from .cache import BucketCache
from .metrics import CostModel, aged_workload_throughput, workload_throughput
from .workload import WorkloadManager

__all__ = [
    "SchedulerDecision",
    "BucketScheduler",
    "LifeRaftScheduler",
    "NaiveLifeRaftScheduler",
    "RoundRobinScheduler",
    "OrderedScheduler",
]


@dataclasses.dataclass(frozen=True)
class SchedulerDecision:
    bucket_id: int
    score: float
    in_cache: bool
    queue_size: int  # total pending objects (|W_i|, resident + spilled)
    resident_size: Optional[int] = None  # §6 resident prefix (None: untracked)


class BucketScheduler(Protocol):
    def select(
        self, wm: WorkloadManager, cache: BucketCache, now: float
    ) -> Optional[SchedulerDecision]: ...


@dataclasses.dataclass
class _Entry:
    """Per-bucket incremental state (inputs to Eq. 1/2 + the rebased key)."""

    version: int
    key: float  # S(i) = ut*(1-alpha_i) - oldest_ms*alpha_i (scaled if norm.)
    ut: float
    oldest: float
    size: int  # total pending objects (resident + spilled)
    cached: bool
    sigma: float = 0.0  # §6 spilled byte fraction in [0, 1]
    resident: int = 0  # resident-prefix objects (== size unless spilled)
    group: str = ""  # tenant group whose heap holds the live key


class LifeRaftScheduler:
    """Greedy-by-U_a bucket selection (Eq. 2). alpha=0 greedy, alpha=1 aged.

    Incremental by default: subscribes to the WorkloadManager's queue
    changes and the BucketCache's residency changes, maintaining a lazy
    max-heap over the rebased priority (``normalized=True`` uses the same
    machinery with rescaled coefficients).  Falls back to the full rescan
    only when the workload/cache objects do not support ``subscribe``.

    External mutation of queue internals that bypasses
    ``WorkloadManager.submit/complete_bucket`` is invisible to the
    incremental index — call :meth:`rebuild` (or ``mark_dirty(bucket)``)
    after such surgery.
    """

    name = "liferaft"

    def __init__(
        self,
        cost_model: CostModel,
        alpha: float = 0.0,
        normalized: bool = False,
    ) -> None:
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0,1], got {alpha}")
        self.cost_model = cost_model
        self._alpha = float(alpha)
        self.normalized = normalized
        # -- per-tenant alpha (multi-tenant control plane) --------------------
        self._tenant_alphas: Optional[dict[str, float]] = None
        self._tenant_of: Optional[Callable[[int], str]] = None
        # -- incremental state ------------------------------------------------
        self._wm: Optional[WorkloadManager] = None
        self._cache: Optional[BucketCache] = None
        self._entries: dict[int, _Entry] = {}
        # One lazy max-heap of (-key, bucket, version) per tenant group
        # ("" = the scalar-alpha group; per-tenant groups only exist while
        # tenant alphas are set).
        self._heaps: dict[str, list[tuple[float, int, int]]] = {}
        self._dirty: set[int] = set()
        self._version = 0
        self._alpha_dirty = False

    # -- alpha is hot-swappable (adaptive controller) -------------------------
    @property
    def alpha(self) -> float:
        return self._alpha

    @alpha.setter
    def alpha(self, value: float) -> None:
        value = float(value)
        if not 0.0 <= value <= 1.0:
            raise ValueError(f"alpha must be in [0,1], got {value}")
        if value != self._alpha:
            self._alpha = value
            # Every rebased key embeds alpha; defer to a bulk O(B) re-key
            # (the stored ut/oldest inputs are alpha-independent).
            self._alpha_dirty = True

    # -- per-tenant alpha (hot-swappable, like the scalar) ----------------------
    def set_tenant_alphas(
        self,
        alphas: Optional[Mapping[str, float]],
        tenant_of: Optional[Callable[[int], str]] = None,
    ) -> None:
        """Per-tenant Eq. 2 blends: bucket b scores with
        ``alphas[tenant_of(b)]`` (scalar ``.alpha`` for unmapped tenants).
        ``tenant_of`` must be a pure function of workload state that only
        changes when the bucket's queue changes (which notifies the
        incremental index); the WorkloadManager's ``tenant_of_bucket`` —
        tenant of the oldest pending unit — satisfies this.  Passing
        ``None`` reverts to the scalar blend.  Changes trigger the bulk
        O(B) re-key, exactly like scalar alpha hot-swaps."""
        alphas = dict(alphas) if alphas is not None else None
        if alphas is not None:
            for t, a in alphas.items():
                if not 0.0 <= a <= 1.0:
                    raise ValueError(f"alpha[{t!r}] must be in [0,1], got {a}")
            if tenant_of is None:
                raise ValueError("tenant alphas require a tenant_of mapping")
        if alphas != self._tenant_alphas or tenant_of is not self._tenant_of:
            self._tenant_alphas = alphas
            self._tenant_of = tenant_of if alphas is not None else None
            self._alpha_dirty = True

    def _alpha_for(self, bucket_id: int) -> float:
        if self._tenant_alphas is not None and self._tenant_of is not None:
            return self._tenant_alphas.get(
                self._tenant_of(bucket_id), self._alpha
            )
        return self._alpha

    def _group_of(self, bucket_id: int) -> str:
        """Heap-group key: buckets sharing an alpha share a heap (the
        rebased-key comparison is only valid within one alpha)."""
        if self._tenant_alphas is not None and self._tenant_of is not None:
            t = self._tenant_of(bucket_id)
            if t in self._tenant_alphas:
                return t
        return ""

    def _group_alpha(self, group: str) -> float:
        if group and self._tenant_alphas is not None:
            return self._tenant_alphas[group]
        return self._alpha

    def heap_size(self) -> int:
        """Total live+stale heap entries across tenant groups (the
        compaction bound's subject)."""
        return sum(len(h) for h in self._heaps.values())

    # -- public maintenance hooks ---------------------------------------------
    def mark_dirty(self, bucket_id: int) -> None:
        self._dirty.add(bucket_id)

    def forget(self, bucket_id: int) -> None:
        """Drop a bucket from the incremental index *now* (shard work
        stealing: the bucket's queue left this manager wholesale via
        ``migrate_out``).  The queue-change notification already marks it
        dirty; this releases the live entry eagerly so a steal decision
        taken before the next flush cannot see the departed bucket."""
        self._entries.pop(bucket_id, None)
        self._dirty.add(bucket_id)

    def rebuild(self) -> None:
        """Drop the incremental index; it re-seeds on the next select()."""
        self._unbind()
        self._entries.clear()
        self._heaps.clear()
        self._dirty.clear()
        self._alpha_dirty = False

    # -- selection -------------------------------------------------------------
    def select(
        self, wm: WorkloadManager, cache: BucketCache, now: float
    ) -> Optional[SchedulerDecision]:
        if self._use_naive(wm, cache):
            return _naive_select(self, wm, cache, now)
        self._bind(wm, cache)
        self._flush_dirty()
        return self._select_one(now)

    def select_topk(
        self, wm: WorkloadManager, cache: BucketCache, now: float, k: int
    ) -> list[SchedulerDecision]:
        """Top-k distinct buckets by U_a, best first (fused multi-bucket
        execution services all k in one grouped device call)."""
        if k <= 1:
            d = self.select(wm, cache, now)
            return [] if d is None else [d]
        if self._use_naive(wm, cache):
            return _naive_topk(self, wm, cache, now, k)
        self._bind(wm, cache)
        self._flush_dirty()
        out: list[SchedulerDecision] = []
        suspended: list[int] = []
        for _ in range(k):
            d = self._select_one(now)
            if d is None:
                break
            out.append(d)
            # Invalidate the winner so the next pop yields the runner-up.
            self._entries.pop(d.bucket_id, None)
            suspended.append(d.bucket_id)
        self._dirty.update(suspended)  # restore on the next flush
        return out

    def peek_topk(
        self, wm: WorkloadManager, cache: BucketCache, now: float, k: int
    ) -> list[SchedulerDecision]:
        """Non-mutating preview of the next k distinct buckets by U_a,
        best first — the scan planner's lookahead.  Unlike
        :meth:`select_topk` it never suspends winners or touches heap
        entries beyond ordinary dirty-flush maintenance (which ``select``
        would perform identically), so peeking cannot move a decision.
        O(B) over the live entries: planning-rate work, not the select
        hot path, and ranked with the oracle's exact arithmetic so the
        incremental and naive schedulers commit identical horizons."""
        if k <= 0:
            return []
        if self._use_naive(wm, cache):
            return _naive_topk(self, wm, cache, now, k)
        self._bind(wm, cache)
        self._flush_dirty()
        uts, ags = self._key_coeffs()

        def scored():
            for b, e in self._entries.items():
                a = self._group_alpha(e.group)
                age = (now - e.oldest) * 1e3
                yield ((e.ut * uts) * (1.0 - a) + (age * ags) * a, -b, b, e)

        return [
            SchedulerDecision(
                bucket_id=b, score=ua, in_cache=e.cached, queue_size=e.size,
                resident_size=e.resident,
            )
            for ua, _, b, e in heapq.nlargest(k, scored())
        ]

    # -- incremental machinery --------------------------------------------------
    def _use_naive(self, wm, cache) -> bool:
        return not hasattr(wm, "subscribe") or not hasattr(cache, "subscribe")

    def _key_coeffs(self) -> tuple[float, float]:
        """(ut_scale, age_scale) multiplying U_t and age_ms in Eq. 2.

        ``normalized=True`` rescales by the fixed constants from metrics.py;
        both are 1.0 on the paper's raw scales.  The multiplications below
        mirror ``aged_workload_throughput`` term for term so the finalist
        re-rank stays bit-identical to the oracle."""
        if self.normalized:
            return self.cost_model.T_m, 1.0 / self.cost_model.age_scale_ms
        return 1.0, 1.0

    def _unbind(self) -> None:
        for src in (self._wm, self._cache):
            if src is not None and hasattr(src, "unsubscribe"):
                src.unsubscribe(self._on_change)
        self._wm = None
        self._cache = None

    def _bind(self, wm: WorkloadManager, cache: BucketCache) -> None:
        if self._wm is wm and self._cache is cache:
            return
        self._unbind()
        self._entries.clear()
        self._heaps.clear()
        self._dirty.clear()
        self._wm = wm
        self._cache = cache
        wm.subscribe(self._on_change)
        cache.subscribe(self._on_change)
        for q in wm.nonempty_queues():
            self._dirty.add(q.bucket_id)

    def _on_change(self, bucket_id: int) -> None:
        self._dirty.add(bucket_id)

    def _flush_dirty(self) -> None:
        uts, ags = self._key_coeffs()
        if self._alpha_dirty:
            # Bulk re-key: ut/oldest are alpha-independent, so this needs no
            # wm/cache reads — O(B) rebuild instead of B dirty heappushes.
            # (Per-tenant alphas re-key here too: tenant_of(b) only shifts
            # when b's queue changes, which marks b dirty below.)
            self._alpha_dirty = False
            self._heaps = {}
            for b, e in self._entries.items():
                group = self._group_of(b)
                alpha = self._group_alpha(group)
                self._version += 1
                e.version = self._version
                e.group = group
                e.key = e.ut * uts * (1.0 - alpha) - e.oldest * 1e3 * ags * alpha
                self._heaps.setdefault(group, []).append(
                    (-e.key, b, e.version)
                )
            for heap in self._heaps.values():
                heapq.heapify(heap)
        if not self._dirty:
            return
        wm, cache = self._wm, self._cache
        sigma_of = getattr(wm, "spilled_fraction", None)
        is_spilled = getattr(wm, "is_spilled", None)
        for b in self._dirty:
            q = wm.queues.get(b)
            if q is None or not q:
                self._entries.pop(b, None)  # heap entries go stale
                continue
            size = q.size
            cached = bool(cache.contains(b))
            if sigma_of is not None:
                sigma = float(sigma_of(b))
            elif is_spilled is not None:
                sigma = float(bool(is_spilled(b)))
            else:
                sigma = 0.0
            ut = workload_throughput(size, cached, self.cost_model, sigma)
            oldest = q.oldest_arrival
            group = self._group_of(b)
            alpha = self._group_alpha(group)
            key = ut * uts * (1.0 - alpha) - oldest * 1e3 * ags * alpha
            self._version += 1
            self._entries[b] = _Entry(
                self._version, key, ut, oldest, size, cached, sigma,
                getattr(q, "resident_size", size), group,
            )
            heapq.heappush(
                self._heaps.setdefault(group, []), (-key, b, self._version)
            )
        self._dirty.clear()
        if self.heap_size() > 4 * max(len(self._entries), 8):
            self._compact()

    def _compact(self) -> None:
        self._heaps = {}
        for b, e in self._entries.items():
            self._heaps.setdefault(e.group, []).append((-e.key, b, e.version))
        for heap in self._heaps.values():
            heapq.heapify(heap)

    def _pop_stale(self, group: str) -> None:
        heap = self._heaps.get(group, [])
        while heap:
            _, b, ver = heap[0]
            e = self._entries.get(b)
            if e is None or e.version != ver:
                heapq.heappop(heap)
            else:
                return

    def _select_one(self, now: float) -> Optional[SchedulerDecision]:
        groups = []
        for g in self._heaps:
            self._pop_stale(g)
            if self._heaps[g]:
                groups.append(g)
        if not groups:
            return None
        uts, ags = self._key_coeffs()
        # The rebased key S drops the trailing now*1e3*alpha term, which is
        # only constant *within* a group (one alpha); cross-group
        # comparison adds each group's correction back.  One group ==
        # scalar alpha == the historical single-heap path.
        corr = {
            g: (now * 1e3) * ags * self._group_alpha(g) for g in groups
        }
        best_est = max(-self._heaps[g][0][0] + corr[g] for g in groups)
        finalists: list[tuple[int, _Entry]] = []
        for g in groups:
            heap = self._heaps[g]
            alpha_g = self._group_alpha(g)
            s_max_g = -heap[0][0]
            # Widen to a tolerance window: the rebased key and the oracle's
            # U_a formula round differently, so any bucket within a few-ulp
            # band of the top could be the oracle argmax.  1e-9 relative is
            # ~4000x the double-precision rounding error of either formula.
            tol = 1e-9 * (abs(s_max_g) + abs(now) * 1e3 * ags * alpha_g + 1.0)
            popped: list[tuple[float, int, int]] = []
            while heap:
                negk, b, ver = heap[0]
                e = self._entries.get(b)
                if e is None or e.version != ver:
                    heapq.heappop(heap)
                    continue
                if -negk + corr[g] < best_est - tol:
                    break
                heapq.heappop(heap)
                popped.append((negk, b, ver))
                finalists.append((b, e))
            for item in popped:
                heapq.heappush(heap, item)
        # Re-rank finalists with the oracle's exact arithmetic + tie-break
        # (same multiply order as aged_workload_throughput; uts/ags are 1.0
        # on the raw scales, where x * 1.0 is an IEEE identity; the group
        # alpha IS the oracle's per-bucket alpha).
        def ua(be):
            b, e = be
            a = self._group_alpha(e.group)
            age = (now - e.oldest) * 1e3
            return ((e.ut * uts) * (1.0 - a) + (age * ags) * a, -b)

        b, e = max(finalists, key=ua)
        return SchedulerDecision(
            bucket_id=b,
            score=ua((b, e))[0],
            in_cache=e.cached,
            queue_size=e.size,
            resident_size=e.resident,
        )


class NaiveLifeRaftScheduler(LifeRaftScheduler):
    """The O(B)-per-decision oracle: full rescore on every select().

    Kept as the reference implementation the incremental scheduler is
    property-tested against, and as the baseline in BENCH_scheduler."""

    name = "liferaft-naive"

    def select(self, wm, cache, now):
        return _naive_select(self, wm, cache, now)

    def select_topk(self, wm, cache, now, k):
        if k <= 1:
            d = self.select(wm, cache, now)
            return [] if d is None else [d]
        return _naive_topk(self, wm, cache, now, k)

    def peek_topk(self, wm, cache, now, k):
        return _naive_topk(self, wm, cache, now, k) if k > 0 else []


def _naive_scores(sched, wm, cache, now):
    queues = wm.nonempty_queues()
    if not queues:
        return None
    sizes = {q.bucket_id: q.size for q in queues}
    resident = {
        q.bucket_id: getattr(q, "resident_size", q.size) for q in queues
    }
    cached = {q.bucket_id: cache.contains(q.bucket_id) for q in queues}
    sigma_of = getattr(wm, "spilled_fraction", None)
    is_spilled = getattr(wm, "is_spilled", None)
    if sigma_of is not None:
        spilled = {b: float(sigma_of(b)) for b in sizes}
    elif is_spilled is not None:
        spilled = {b: float(bool(is_spilled(b))) for b in sizes}
    else:
        spilled = None
    alpha_map = (
        {b: sched._alpha_for(b) for b in sizes}
        if sched._tenant_alphas is not None
        else None
    )
    ages = wm.ages_ms(now)
    ua = aged_workload_throughput(
        sizes, ages, cached, sched.cost_model, sched.alpha, sched.normalized,
        spilled, alpha_map,
    )
    return sizes, resident, cached, ua


def _naive_select(sched, wm, cache, now) -> Optional[SchedulerDecision]:
    scored = _naive_scores(sched, wm, cache, now)
    if scored is None:
        return None
    sizes, resident, cached, ua = scored
    # Deterministic tie-break on bucket id for reproducibility.
    best = max(ua, key=lambda b: (ua[b], -b))
    return SchedulerDecision(
        bucket_id=best,
        score=ua[best],
        in_cache=cached[best],
        queue_size=sizes[best],
        resident_size=resident[best],
    )


def _naive_topk(sched, wm, cache, now, k) -> list[SchedulerDecision]:
    scored = _naive_scores(sched, wm, cache, now)
    if scored is None:
        return []
    sizes, resident, cached, ua = scored
    order = sorted(ua, key=lambda b: (ua[b], -b), reverse=True)
    return [
        SchedulerDecision(
            bucket_id=b, score=ua[b], in_cache=cached[b], queue_size=sizes[b],
            resident_size=resident[b],
        )
        for b in order[:k]
    ]


class RoundRobinScheduler:
    """The paper's RR baseline: service buckets in increasing SFC/HTM id
    order, cycling; oblivious to queue length and age."""

    name = "rr"

    def __init__(self, cost_model: CostModel) -> None:
        self.cost_model = cost_model
        self._cursor = -1

    def select(
        self, wm: WorkloadManager, cache: BucketCache, now: float
    ) -> Optional[SchedulerDecision]:
        queues = sorted(q.bucket_id for q in wm.nonempty_queues())
        if not queues:
            return None
        nxt = next((b for b in queues if b > self._cursor), queues[0])
        self._cursor = nxt
        q = wm.queue(nxt)
        return SchedulerDecision(
            bucket_id=nxt,
            score=0.0,
            in_cache=cache.contains(nxt),
            queue_size=q.size,
        )

    def select_topk(self, wm, cache, now, k):
        decisions = []
        seen = set()
        for _ in range(max(k, 1)):
            d = self.select(wm, cache, now)
            if d is None or d.bucket_id in seen:
                break
            seen.add(d.bucket_id)
            decisions.append(d)
        return decisions


class OrderedScheduler:
    """Pure arrival-order bucket selection == LifeRaft(alpha=1).

    Kept as an explicit class for readability in benchmarks; batching/I-O
    sharing still applies (paper: 'even when evaluating queries in order,
    the system benefits from data sharing')."""

    name = "ordered"

    def __init__(self, cost_model: CostModel) -> None:
        self._inner = LifeRaftScheduler(cost_model, alpha=1.0)

    def select(self, wm, cache, now):
        return self._inner.select(wm, cache, now)
