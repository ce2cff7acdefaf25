"""Event-driven scheduler simulator (drives the paper's §5 experiments).

Replays a query trace (arrival times + per-object bucket ranges) against a
scheduling policy, the LRU bucket cache, and the empirical cost model, and
reports query throughput / response time / cache hit-rate — the quantities
in Figs. 7 & 8.

This is the same discrete-event harness the serving engine reuses for
capacity planning; on hardware the costs come from the roofline model
instead of (T_b, T_m) disk constants.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from .cache import BucketCache
from .control import ControlLoop, ShardControlPlane, TenantControlPlane
from .dispatch import DispatchLoop
from .hybrid import HybridPlanner
from .metrics import CostModel, per_tenant_latency
from .prefetch import PrefetchConfig, build_pipeline, prefetch_stats
from .scheduler import (
    BucketScheduler,
    LifeRaftScheduler,
    NaiveLifeRaftScheduler,
    RoundRobinScheduler,
)
from .shard import (
    ShardedDispatch,
    ShardMap,
    ShardRuntime,
    StealConfig,
    split_slots,
)
from .workload import Query, WorkloadManager

__all__ = [
    "SimResult",
    "simulate_batched",
    "simulate_sharded",
    "simulate_noshare",
    "run_policy",
]


@dataclasses.dataclass
class SimResult:
    policy: str
    makespan: float
    n_queries: int
    query_throughput: float  # completed queries / makespan
    object_throughput: float  # matched objects / makespan
    mean_response: float
    p95_response: float
    std_response: float
    cache_hit_rate: float
    busy_time: float
    n_batches: int
    indexed_batches: int = 0
    n_dispatches: int = 0  # scheduling rounds (== n_batches unless fused)
    device_dispatches: int = 0  # device calls (< rounds under shared plans)
    shared_batch_occupancy: float = 0.0  # mean query fill of shared calls
    # per tenant class: {tenant: {n, p50/p95/mean_response, throughput}}
    per_tenant: dict = dataclasses.field(default_factory=dict)
    # prefetch pipeline rollup (empty without one): staged/fills/refused/
    # demand_waits/stall_s + the CacheStats demand-vs-prefetch hit split
    prefetch: dict = dataclasses.field(default_factory=dict)
    # work-steal migrations (sharded harness only; 0 elsewhere)
    steals: int = 0

    def row(self) -> dict:
        return dataclasses.asdict(self)


def _collect(
    policy: str,
    wm: WorkloadManager,
    cache: BucketCache,
    makespan: float,
    busy: float,
    n_batches: int,
    total_objects: int,
    indexed_batches: int = 0,
    n_dispatches: int | None = None,
    device_dispatches: int | None = None,
    shared_batch_occupancy: float = 0.0,
) -> SimResult:
    responses = wm.response_times()
    resp = np.array(sorted(responses.values()), dtype=np.float64)
    makespan = max(makespan, 1e-9)
    tenants = sorted({q.tenant for q in wm.queries.values()})
    per_tenant = (
        per_tenant_latency(responses, wm.tenant_of_query, makespan, tenants)
        if len(tenants) > 1
        else {}
    )
    return SimResult(
        policy=policy,
        makespan=makespan,
        n_queries=len(resp),
        query_throughput=len(resp) / makespan,
        object_throughput=total_objects / makespan,
        mean_response=float(resp.mean()) if len(resp) else 0.0,
        p95_response=float(np.percentile(resp, 95)) if len(resp) else 0.0,
        std_response=float(resp.std()) if len(resp) else 0.0,
        cache_hit_rate=cache.stats.hit_rate,
        busy_time=busy,
        n_batches=n_batches,
        indexed_batches=indexed_batches,
        n_dispatches=n_batches if n_dispatches is None else n_dispatches,
        device_dispatches=(
            (n_batches if n_dispatches is None else n_dispatches)
            if device_dispatches is None
            else device_dispatches
        ),
        shared_batch_occupancy=shared_batch_occupancy,
        per_tenant=per_tenant,
    )


class _ExecState:
    """Counters the cost-model executor accumulates across rounds (and, in
    the sharded harness, across shards)."""

    __slots__ = ("indexed_batches", "total_objects")

    def __init__(self) -> None:
        self.indexed_batches = 0
        self.total_objects = 0


def _make_executor(wm, cache, cost, hybrid, shared_plan, share_width, state, loop_box):
    """The simulator's cost-model executor, shared verbatim by the
    single-loop and sharded harnesses (one copy of the arithmetic is what
    makes the S=1 configuration bit-identical by construction).
    ``loop_box`` is a one-element list filled with the DispatchLoop after
    construction (the executor is built first)."""

    def execute(decisions, vector) -> float:
        round_cost = 0.0
        for decision in decisions:
            # Re-probe residency: within a fused round an earlier bucket's
            # insertion can evict a later one; cost must track the actual
            # read (for fuse_k == 1 this equals the decision snapshot).
            in_cache = cache.contains(decision.bucket_id)
            # sigma-pro-rated §6 read-back (== full T_spill for a wholly
            # spilled queue) — mirrors CrossMatchEngine._plan_and_fetch
            # and the scheduler's Eq. 1 so priced and charged costs agree.
            sigma = wm.spilled_fraction(decision.bucket_id)
            if hybrid is not None:
                plan = hybrid.plan(decision.queue_size, in_cache)
                step = plan.est_cost + cost.T_spill * sigma
                if plan.strategy == "indexed":
                    state.indexed_batches += 1
                    # Same accounting as CrossMatchEngine._plan_and_fetch:
                    # resident indexed reads are hits, cold ones are misses
                    # that establish no residency.
                    if in_cache:
                        cache.access(decision.bucket_id)
                    else:
                        cache.note_bypass_miss()
                else:
                    cache.access(decision.bucket_id)
            else:
                step = cost.batch_cost(decision.queue_size, in_cache, sigma)
                cache.access(decision.bucket_id)
            round_cost += step
            state.total_objects += decision.queue_size
        if shared_plan:
            # Shared-plan accounting: the round's distinct pending queries
            # share ceil(Q / width) masked calls (vs. the legacy one call
            # per round), and the chunk fill feeds the share_width law.
            width = max(
                1, getattr(vector, "share_width", 0) or share_width
            )
            qids = {
                u.query_id
                for d in decisions
                for u in (
                    wm.queue(d.bucket_id).units
                    + wm.queue(d.bucket_id).spilled_units
                )
            }
            n_chunks = max(1, -(-len(qids) // width))
            loop_box[0].note_device_dispatches(
                n_chunks,
                shared_occupancy=len(qids) / (n_chunks * width)
                if qids
                else 0.0,
            )
        return round_cost

    return execute


def simulate_batched(
    queries: Sequence[Query],
    bucket_of_range: Callable[[int, int], np.ndarray],
    scheduler: BucketScheduler,
    cost: CostModel,
    cache_capacity: int = 20,
    hybrid: Optional[HybridPlanner] = None,
    alpha_hook: Optional[Callable[[float], float]] = None,
    bucket_of_keys=None,
    fuse_k: int = 1,
    control: Optional[ControlLoop | TenantControlPlane] = None,
    on_round=None,
    prefetch: bool | PrefetchConfig = False,
    shared_plan: bool = False,
    share_width: int = 8,
    obs=None,
) -> SimResult:
    """Batched policies (LifeRaft any alpha, RR): one bucket batch at a time.

    The scheduling round itself (controller consult, alpha hot-swap, spill
    enforcement, top-k select, clock/completion) is the shared
    ``DispatchLoop`` — the same inner loop both engines run; this harness
    supplies only the cost-model executor.

    ``control`` plugs in the closed-loop ControlLoop (alpha/fuse_k/spill per
    round); it overrides ``alpha_hook`` and the static ``fuse_k``.  A
    ``TenantControlPlane`` runs one control vector per tenant class —
    queries are classed by their ``meta['tenant']`` tag, buckets by the
    tenant of their oldest pending unit — and ``SimResult.per_tenant``
    reports the per-class p50/p95/throughput rollup.
    ``alpha_hook(t) -> alpha`` remains for open-loop retuning on arrivals.
    ``fuse_k > 1`` services the top-k buckets per scheduling round (the
    fused multi-bucket execution path); residency/cost accounting stays
    per-bucket, but only one dispatch is counted.
    ``prefetch`` (off by default) wires the scan-horizon pipeline: bucket
    staging runs on a simulated serial I/O channel overlapping compute,
    and rounds pay only the residual stall for demanded in-flight buckets
    (``core/prefetch.py``; H is ControlLoop-sized when
    ``prefetch_horizon_max`` is set).
    ``shared_plan`` (off by default) models shared query plans: the
    round's pending queries evaluate in ceil(Q / share_width) masked
    device calls instead of one per bucket (``share_width`` is the static
    ceiling; a ControlLoop with ``share_width_max`` set resizes it per
    round).  Costs and decisions are unchanged — the simulator tracks
    only the device-dispatch/occupancy accounting.
    ``obs`` (off by default) attaches the ``repro_torch.obs`` metrics/tracing
    tap to the loop — a pure side-channel consumer chained via
    ``add_round_tap``, so decisions and goldens are unchanged; pass an
    ``Observability`` instance to export its registry/trace afterwards.
    """
    queries = sorted(queries, key=lambda q: q.arrival_time)
    wm = WorkloadManager(
        bucket_of_range, bucket_of_keys, probe_bytes=cost.probe_bytes,
        min_unit_bytes=cost.min_unit_bytes,
    )
    cache = BucketCache(cache_capacity)
    i = 0
    state = _ExecState()
    loop_box: list = []
    execute = _make_executor(
        wm, cache, cost, hybrid, shared_plan, share_width, state, loop_box
    )

    loop = DispatchLoop(
        scheduler, wm, cache, execute, control=control, fuse_k=fuse_k,
        tenant_of=wm.tenant_of_bucket, on_round=on_round,
        prefetch=build_pipeline(prefetch, scheduler, cache, cost.T_b),
    )
    loop_box.append(loop)
    if obs:
        from ..obs import ensure as _obs_ensure  # lazy: off-path never imports

        _obs_ensure(obs).attach_loop(loop, track=0, clock="virtual")

    def admit(until: float) -> None:
        nonlocal i
        while i < len(queries) and queries[i].arrival_time <= until:
            q = queries[i]
            wm.submit(q)
            loop.observe_arrival(q.arrival_time)
            if (
                control is None
                and alpha_hook is not None
                and isinstance(scheduler, LifeRaftScheduler)
            ):
                scheduler.alpha = alpha_hook(q.arrival_time)
            i += 1

    while i < len(queries) or wm.n_pending_queries:
        if not wm.nonempty_queues():
            # Idle: jump to the next arrival.
            loop.clock = max(loop.clock, queries[i].arrival_time)
            admit(loop.clock)
            continue
        admit(loop.clock)
        outcome = loop.round()
        assert outcome is not None

    name = getattr(scheduler, "name", type(scheduler).__name__)
    if isinstance(scheduler, LifeRaftScheduler):
        name = f"{scheduler.name}(a={scheduler.alpha:g})"
    if isinstance(control, TenantControlPlane):
        name = f"{name}+mt"
    elif control is not None:
        name = f"{name}+ctl"
    if loop.prefetch is not None:
        name = f"{name}+pf"
    if shared_plan:
        name = f"{name}+sp"
    result = _collect(
        name, wm, cache, loop.clock, loop.busy, loop.batches,
        state.total_objects, state.indexed_batches, loop.dispatches,
        loop.device_dispatches, loop.shared_batch_occupancy,
    )
    if loop.prefetch is not None:
        result.prefetch = prefetch_stats(loop.prefetch, cache)
    return result


def simulate_sharded(
    queries: Sequence[Query],
    bucket_of_range: Callable[[int, int], np.ndarray],
    cost: CostModel,
    *,
    scheduler_factory: Callable[[], BucketScheduler],
    n_shards: int = 1,
    shard_map: Optional[ShardMap] = None,
    bucket_bytes: Optional[dict[int, float]] = None,
    cache_capacity: int = 20,
    bucket_of_keys=None,
    fuse_k: int = 1,
    control_factory: Optional[Callable[[], ControlLoop]] = None,
    steal: Optional[StealConfig] = None,
    plane: Optional[ShardControlPlane] = None,
    prefetch: bool | PrefetchConfig = False,
    hybrid: Optional[HybridPlanner] = None,
    shared_plan: bool = False,
    share_width: int = 8,
    on_round: Optional[Callable[[int, object], None]] = None,
    on_steal=None,
    obs=None,
) -> SimResult:
    """Multi-shard harness: S shard-local DispatchLoops on virtual clocks
    behind one ``ShardedDispatch`` coordinator (``core/shard.py``).

    Buckets partition by SFC range (``shard_map``, or byte-balanced from
    ``bucket_bytes``, or an equal split when neither is given); each query
    is decomposed once and its slices routed to the owning shards, with
    completion a join over per-shard completions.  ``cache_capacity`` is
    the **aggregate** across shards — slots are split evenly with the
    remainder going to the lowest shard ids (``split_slots``), so an
    S-vs-1 comparison holds total cache slots equal.
    ``scheduler_factory`` / ``control_factory`` build one instance per
    shard (schedulers and control loops hold per-workload state and
    cannot be shared).  ``steal`` enables work stealing; ``plane`` wires
    the cross-shard ``ShardControlPlane`` byte arbiter.  ``on_round``
    receives ``(shard_id, DispatchOutcome)`` — the golden recorder's tap.

    With ``n_shards=1`` (stealing and plane off) the round sequence, the
    executor arithmetic, and therefore the decision trace are identical
    to :func:`simulate_batched` — the proof of safety.
    """
    queries = sorted(queries, key=lambda q: q.arrival_time)
    if shard_map is None:
        if bucket_bytes is not None:
            shard_map = ShardMap.from_bucket_bytes(bucket_bytes, n_shards)
        else:
            # No byte profile: equal-count split over the bucket span the
            # trace actually touches.
            router_probe = WorkloadManager(bucket_of_range, bucket_of_keys)
            touched = sorted(
                {
                    b
                    for q in queries
                    for b in router_probe.decompose(q)
                }
            )
            shard_map = ShardMap.from_bucket_bytes(
                {b: 1.0 for b in touched} or {0: 1.0}, n_shards
            )
    router = WorkloadManager(
        bucket_of_range, bucket_of_keys, probe_bytes=cost.probe_bytes,
        min_unit_bytes=cost.min_unit_bytes,
    )
    coord = ShardedDispatch(
        shard_map, router.decompose, steal=steal, plane=plane,
        on_steal=on_steal, on_round=on_round,
    )
    state = _ExecState()
    caps = split_slots(cache_capacity, n_shards)
    runtimes: list[ShardRuntime] = []
    for sid in range(n_shards):
        wm = WorkloadManager(
            bucket_of_range, bucket_of_keys, probe_bytes=cost.probe_bytes,
            min_unit_bytes=cost.min_unit_bytes,
        )
        cache = BucketCache(caps[sid])
        sched = scheduler_factory()
        loop_box: list = []
        execute = _make_executor(
            wm, cache, cost, hybrid, shared_plan, share_width, state, loop_box
        )
        loop = DispatchLoop(
            sched, wm, cache, execute,
            control=control_factory() if control_factory is not None else None,
            fuse_k=fuse_k,
            tenant_of=wm.tenant_of_bucket,
            complete=coord.make_complete(sid),
            prefetch=build_pipeline(prefetch, sched, cache, cost.T_b),
        )
        loop_box.append(loop)
        if loop.prefetch is not None and bucket_bytes is not None:
            loop.prefetch.nbytes_of = lambda b, _bb=bucket_bytes: _bb.get(b, 0.0)
        rt = ShardRuntime(sid, wm, cache, sched, loop)
        runtimes.append(rt)
        coord.add_shard(rt)

    if obs:
        from ..obs import ensure as _obs_ensure  # lazy: off-path never imports

        _o = _obs_ensure(obs)
        for rt in runtimes:
            _o.attach_loop(rt.loop, track=rt.shard_id, clock="virtual")
        coord.on_steal = _o.chain_steal_tap(coord.on_steal)

    for q in queries:
        coord.route(q)
    coord.run_virtual()
    # Conservation: the join must have resolved every routed query.
    assert all(not owners for owners in coord.owners.values()), (
        "unresolved cross-shard joins after drain"
    )

    sched0 = runtimes[0].scheduler
    name = getattr(sched0, "name", type(sched0).__name__)
    if isinstance(sched0, LifeRaftScheduler):
        name = f"{sched0.name}(a={sched0.alpha:g})"
    if control_factory is not None:
        name = f"{name}+ctl"
    if runtimes[0].loop.prefetch is not None:
        name = f"{name}+pf"
    name = f"{name}+S{n_shards}"
    if steal is not None:
        name = f"{name}st"

    responses = coord.response_times()
    resp = np.array(sorted(responses.values()), dtype=np.float64)
    makespan = max(coord.makespan(), 1e-9)
    hits = sum(rt.cache.stats.hits for rt in runtimes)
    accesses = sum(rt.cache.stats.accesses for rt in runtimes)
    tenants = sorted({q.tenant for q in coord.queries.values()})
    per_tenant = (
        per_tenant_latency(
            responses,
            lambda qid: coord.queries[qid].tenant,
            makespan,
            tenants,
        )
        if len(tenants) > 1
        else {}
    )
    result = SimResult(
        policy=name,
        makespan=makespan,
        n_queries=len(resp),
        query_throughput=len(resp) / makespan,
        object_throughput=state.total_objects / makespan,
        mean_response=float(resp.mean()) if len(resp) else 0.0,
        p95_response=float(np.percentile(resp, 95)) if len(resp) else 0.0,
        std_response=float(resp.std()) if len(resp) else 0.0,
        cache_hit_rate=hits / accesses if accesses else 0.0,
        busy_time=sum(rt.loop.busy for rt in runtimes),
        n_batches=sum(rt.loop.batches for rt in runtimes),
        indexed_batches=state.indexed_batches,
        n_dispatches=sum(rt.loop.dispatches for rt in runtimes),
        device_dispatches=sum(rt.loop.device_dispatches for rt in runtimes),
        per_tenant=per_tenant,
    )
    if any(rt.loop.prefetch is not None for rt in runtimes):
        rollup: dict = {}
        for rt in runtimes:
            if rt.loop.prefetch is None:
                continue
            for k, v in prefetch_stats(rt.loop.prefetch, rt.cache).items():
                rollup[k] = rollup.get(k, 0) + v
        result.prefetch = rollup
    result.steals = len(coord.steals)
    return result


def simulate_noshare(
    queries: Sequence[Query],
    bucket_of_range: Callable[[int, int], np.ndarray],
    cost: CostModel,
    cache_capacity: int = 20,
    bucket_of_keys=None,
) -> SimResult:
    """NoShare baseline: each query evaluated independently, arrival order.

    No batching across queries — every query pays its own bucket reads
    (through the shared cache, which models the DB buffer pool)."""
    queries = sorted(queries, key=lambda q: q.arrival_time)
    wm = WorkloadManager(bucket_of_range, bucket_of_keys)
    cache = BucketCache(cache_capacity)
    clock = 0.0
    busy = 0.0
    n_batches = 0
    total_objects = 0
    for q in queries:
        units = wm.submit(q)
        clock = max(clock, q.arrival_time)
        for u in sorted(units, key=lambda u: u.bucket_id):
            step = cost.batch_cost(u.size, cache.contains(u.bucket_id))
            cache.access(u.bucket_id)
            clock += step
            busy += step
            total_objects += u.size
            n_batches += 1
        # All this query's buckets are done; nothing shared with others.
        for u in units:
            wm.complete_bucket(u.bucket_id, clock)
    return _collect("noshare", wm, cache, clock, busy, n_batches, total_objects)


def run_policy(
    policy: str,
    queries: Sequence[Query],
    bucket_of_range: Callable[[int, int], np.ndarray],
    cost: CostModel,
    alpha: float = 0.0,
    cache_capacity: int = 20,
    hybrid: Optional[HybridPlanner] = None,
    normalized: bool = False,
    bucket_of_keys=None,
    fuse_k: int = 1,
    control: Optional[ControlLoop] = None,
    on_round=None,
    prefetch: bool | PrefetchConfig = False,
    shared_plan: bool = False,
    share_width: int = 8,
    obs=None,
) -> SimResult:
    """Convenience dispatcher used by benchmarks:
    'noshare'|'rr'|'liferaft'|'liferaft-naive'."""
    if policy == "noshare":
        return simulate_noshare(
            queries, bucket_of_range, cost, cache_capacity,
            bucket_of_keys=bucket_of_keys,
        )
    if policy == "rr":
        sched: BucketScheduler = RoundRobinScheduler(cost)
    elif policy == "liferaft":
        sched = LifeRaftScheduler(cost, alpha=alpha, normalized=normalized)
    elif policy == "liferaft-naive":
        sched = NaiveLifeRaftScheduler(cost, alpha=alpha, normalized=normalized)
    else:
        raise ValueError(f"unknown policy {policy!r}")
    return simulate_batched(
        queries, bucket_of_range, sched, cost, cache_capacity, hybrid,
        bucket_of_keys=bucket_of_keys, fuse_k=fuse_k, control=control,
        on_round=on_round, prefetch=prefetch, shared_plan=shared_plan,
        share_width=share_width, obs=obs,
    )
