"""LifeRaft continuous-batching serving engine (multi-tenant LLM decode).

The paper's scheduler, re-instantiated for TPU serving:

  bucket          = a LoRA adapter's weights (expensive resident state)
  T_b             = adapter load cost (host->HBM transfer at hbm_bw)
  T_m             = marginal decode cost per request in the batch
  workload queue  = pending requests per adapter
  bucket cache    = fixed number of HBM adapter slots (LRU)
  hybrid strategy = tiny batches run the gathered multi-adapter path
                    (indexed join); contended adapters run a dense batch
                    (sequential scan) — kernels/grouped_matmul
  U_a             = Eq. 2 drives which adapter's batch runs next;
                    NoShare == per-request FCFS, RR == adapter round-robin

The scheduling round itself is the shared ``DispatchLoop``
(core/dispatch.py) — the same inner loop the cross-match engine and the
simulator run.  ``AdapterWorkload`` implements the WorkloadManager
protocol (change subscriptions, spill marks) over the per-adapter request
queues, so the incremental lazy-heap scheduler index applies to serving's
``normalized=True`` default instead of the historical O(B) rescan façade.

§6 future work is implemented through the control plane: straggler
absorption (an aged bucket's priority grows until scheduled) and workload
overflow (``ServeConfig.spill_budget`` — pending queues spill to host
when the budget is exceeded, paying ``spill_penalty_s`` to page back in).
With ``adaptive=True`` a ``ControlLoop`` retunes alpha / fuse_k / spill
every round from live queue state.

The engine runs in two modes: the default advances a virtual clock with
the roofline cost model (capacity planning, Fig. 7/8-style sweeps);
``decode_batch_fn`` executes real decode steps of a (small) model on the
current devices alongside.

This is the port's copy of ``repro.serving.engine``: it holds no JAX and
replays the reference's ``serving_*`` goldens bit-identically.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..core.cache import BucketCache
from ..core.control import (
    ControlConfig,
    ControlLoop,
    TenantControlPlane,
    TenantPolicy,
)
from ..core.dispatch import DispatchLoop
from ..core.metrics import CostModel, dispatch_stats, per_tenant_latency
from ..core.prefetch import PrefetchConfig, build_pipeline, prefetch_stats
from ..core.scheduler import LifeRaftScheduler, RoundRobinScheduler
from ..core.shard import ShardMap, StealConfig, StealEvent, split_slots
from ..core.spillq import SpillBookkeepingMixin, SpillQueue
from ..core.workload import DEFAULT_TENANT

__all__ = [
    "Request",
    "AdapterSpec",
    "ServeConfig",
    "AdapterWorkload",
    "LifeRaftEngine",
    "ShardedServingEngine",
]


@dataclasses.dataclass
class Request:
    request_id: int
    adapter_id: int
    arrival_time: float
    prompt_len: int
    max_new_tokens: int
    tokens_done: int = 0
    finish_time: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.tokens_done >= self.max_new_tokens


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    adapter_id: int
    nbytes: int  # adapter weight bytes (sets T_b via hbm_bw)
    tenant: str = DEFAULT_TENANT  # tenant class (interactive vs batch)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    policy: str = "liferaft"  # liferaft | rr | noshare
    alpha: float = 0.25
    adapter_slots: int = 4  # HBM bucket-cache capacity
    max_batch: int = 32
    decode_quantum: int = 16  # tokens decoded per scheduled batch
    hbm_bw: float = 819e9
    per_token_cost: float = 2e-4  # T_m seconds per request-token (marginal)
    hybrid_threshold: int = 2  # batches below this use the gathered path
    fuse_k: int = 1  # adapters serviced per dispatch (grouped-matmul fusion)
    # -- shared query plans ----------------------------------------------------
    # Group the round's adapter batches into ONE masked decode call per
    # share_width-sized chunk (grouped matmul over the adapter axis)
    # instead of one device call per adapter.  In shared mode
    # ``decode_batch_fn`` is called as ``fn(group, quantum)`` with
    # ``group = [(adapter_id, batch), ...]``.  Cost accounting per
    # decision is unchanged, so decisions and completions are identical
    # with the switch off or on.
    shared_plan: bool = False
    share_width: int = 4  # adapters per shared decode call (static ceiling)
    share_width_max: int = 0  # >0 with adaptive: ControlLoop sizes the width
    # -- closed-loop control plane (core/control.py) --------------------------
    adaptive: bool = False  # retune alpha/fuse_k/spill every round
    fuse_k_max: int = 8
    alpha_step: float = 0.1
    control_halflife_s: float = 2.0  # arrival EWMA halflife (request scale)
    rate_knee: float = 200.0  # req/s at which saturation maxes out
    depth_knee: float = 64.0  # pending requests at which backlog maxes out
    spill_budget: Optional[int] = None  # §6 overflow: resident request budget
    spill_budget_bytes: Optional[float] = None  # byte-accurate §6 budget
    spill_penalty_s: float = 0.0  # T_spill host read-back surcharge
    kv_bytes_per_token: float = 1.0  # spillable host state per prompt token
    min_unit_bytes: float = 1.0  # floor per request (no zero-byte free-riders)
    # Legacy §6 unspill: page a queue's whole spilled suffix back in one
    # shot (on service and under low-water) instead of the paged
    # oldest-first protocol.  Wholesale paging can re-exceed the budget
    # the moment it lands — keep it off unless replaying old traces.
    wholesale_unspill: bool = False
    # -- scan-horizon prefetch (core/prefetch.py) ------------------------------
    # Stage the next adapters' weights into HBM ahead of their dispatch
    # (host->HBM DMA modeled as one serial channel overlapping decode).
    # Off by default: the reactive LRU path replays bit-identically.
    prefetch: bool = False
    prefetch_horizon: int = 4  # planner lookahead H (static, or AIMD init)
    prefetch_depth: int = 2  # stages in flight (2 == double buffering)
    prefetch_horizon_max: int = 0  # >0 with adaptive: ControlLoop sizes H
    # -- multi-tenant control plane (one ControlVector per adapter class) ------
    tenant_policies: Optional[tuple[TenantPolicy, ...]] = None


class _AdapterQueue(SpillQueue):
    """One adapter's pending request list on the shared ``SpillQueue``
    primitive (``core/spillq.py``) — the same resident-prefix /
    spilled-suffix container the core WorkloadQueue runs on, so the §6
    spill mechanics exist exactly once.  §6 overflow pages the *youngest*
    requests' prompt state to host (``prompt_len * kv_bytes_per_token``
    each, floored at ``min_unit_bytes`` so zero-length prompts cannot
    free-ride the budget); the oldest keep their state resident."""

    __slots__ = ("_probe_bytes", "_min_unit_bytes")

    def __init__(
        self,
        bucket_id: int,
        probe_bytes: float = 1.0,
        min_unit_bytes: float = 1.0,
    ) -> None:
        super().__init__(
            bucket_id,
            bytes_of=self._rbytes,
            arrival_of=lambda r: r.arrival_time,
            order_of=lambda r: (r.arrival_time, r.request_id),
        )
        self._probe_bytes = probe_bytes
        self._min_unit_bytes = min_unit_bytes

    def _rbytes(self, r: Request) -> float:
        return max(r.prompt_len * self._probe_bytes, self._min_unit_bytes)

    # Historical names for the two sides (the engine and the property
    # suite read these directly).
    @property
    def requests(self) -> list[Request]:
        """Resident prefix (the oldest pending requests)."""
        return self.resident

    @property
    def spilled_requests(self) -> list[Request]:
        """Spilled suffix (the youngest, on host)."""
        return self.spilled

    def all_requests(self) -> list[Request]:
        """Resident prefix first (the oldest work), then the spilled tail."""
        return self.resident + self.spilled

    def _drop_finished(self) -> None:
        """Trim finished requests (resident only — retire pages serviced
        requests in first) and rebase the byte counter."""
        self.prune_resident(lambda r: not r.done)


class AdapterWorkload(SpillBookkeepingMixin):
    """WorkloadManager protocol (subscriptions, ages, §6 spill marks) over
    per-adapter request queues.

    Having a stable, subscribable workload object — instead of the façades
    the old ``_select`` helper rebuilt on every call — is what lets the
    serving engine ride the scheduler's incremental heap index.

    ``probe_bytes`` prices one prompt token's spillable host state (KV /
    prompt cache) for the §6 byte budget (``min_unit_bytes`` floors the
    per-request price — a zero-length prompt still occupies request
    state); ``tenant_of_adapter`` maps each adapter to its tenant class
    for the multi-tenant control plane.  ``wholesale_unspill`` restores
    the legacy whole-suffix paging on service."""

    def __init__(
        self,
        adapter_ids=(),
        probe_bytes: float = 1.0,
        tenants: Optional[dict[int, str]] = None,
        min_unit_bytes: float = 1.0,
        wholesale_unspill: bool = False,
    ) -> None:
        self.probe_bytes = float(probe_bytes)
        self.min_unit_bytes = float(min_unit_bytes)
        self.wholesale_unspill = bool(wholesale_unspill)
        self.queues: dict[int, _AdapterQueue] = {
            a: _AdapterQueue(a, self.probe_bytes, self.min_unit_bytes)
            for a in adapter_ids
        }
        self._tenants: dict[int, str] = dict(tenants or {})
        self._listeners: list[Callable[[int], None]] = []
        self._spilled: set[int] = set()

    # -- change notification ---------------------------------------------------
    def subscribe(self, fn: Callable[[int], None]) -> Callable[[int], None]:
        self._listeners.append(fn)
        return fn

    def unsubscribe(self, fn: Callable[[int], None]) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def _notify(self, adapter_id: int) -> None:
        for fn in self._listeners:
            fn(adapter_id)

    # -- intake / service ------------------------------------------------------
    def push(self, req: Request) -> None:
        self.queue(req.adapter_id).push(req)
        self._notify(req.adapter_id)

    def take(self, adapter_id: int, n: int) -> list[Request]:
        """The next batch, oldest (resident) work first (does not remove;
        ``retire`` trims finished).  Taking spilled requests is fine —
        servicing pays the T_spill surcharge and pages them back in."""
        return self.queues[adapter_id].all_requests()[:n]

    def retire(self, adapter_id: int, serviced=None) -> None:
        """Drop finished requests after a dispatch.  Servicing pages back
        in only the requests that were actually in the batch
        (``serviced``) — paging the *whole* spilled suffix on every
        dispatch was the §6 wholesale-unspill budget overshoot: one
        serviced adapter could re-exceed ``spill_budget_bytes`` in one
        shot and re-engage spill next round.  Only the explicit
        ``wholesale_unspill`` legacy flag restores that whole-suffix
        paging (mirroring WorkloadManager.complete_bucket's drain); a
        caller that does not know its batch (``serviced=None``) pages in
        nothing rather than everything."""
        q = self.queues[adapter_id]
        if self.wholesale_unspill:
            q.unspill_all()
        elif serviced is not None:
            q.unspill_items(serviced)
        q._drop_finished()
        if not q.spilled_requests:
            self._spilled.discard(adapter_id)
        self._notify(adapter_id)

    # -- shard migration (work stealing) ---------------------------------------
    def migrate_out(self, adapter_id: int) -> list[Request]:
        """Drain one adapter's whole pending queue (resident prefix first,
        then the spilled tail) for migration to another shard.  The queue
        object is dropped — ``queue()`` recreates it lazily if the
        adapter's future arrivals ever route back here."""
        q = self.queues.pop(adapter_id, None)
        if q is None:
            return []
        self._spilled.discard(adapter_id)
        reqs = q.drain()
        if reqs:
            self._notify(adapter_id)
        return reqs

    def migrate_in(self, requests: list[Request]) -> list[Request]:
        """Land migrated requests: resident, original arrival times (the
        §6 spill state does not migrate — the thief's own control loop
        re-spills under its budget if it must)."""
        touched: set[int] = set()
        for r in requests:
            self.queue(r.adapter_id).push(r)
            touched.add(r.adapter_id)
        for a in sorted(touched):
            self._notify(a)
        return requests

    # -- scheduler-facing protocol ---------------------------------------------
    def nonempty_queues(self) -> list[_AdapterQueue]:
        return [q for q in self.queues.values() if q]

    def queue(self, adapter_id: int) -> _AdapterQueue:
        # get-or-create without constructing a throwaway queue per call
        # (this sits on the per-request intake hot path).
        q = self.queues.get(adapter_id)
        if q is None:
            q = self.queues[adapter_id] = _AdapterQueue(
                adapter_id, self.probe_bytes, self.min_unit_bytes
            )
        return q

    def ages_ms(self, now: float) -> dict[int, float]:
        return {
            a: (now - q.oldest_arrival) * 1e3
            for a, q in self.queues.items()
            if q
        }

    def pending_objects(self) -> int:
        return sum(q.size for q in self.queues.values())

    def resident_objects(self) -> int:
        return sum(q.resident_size for q in self.queues.values() if q)

    def pending_bytes(self) -> float:
        return sum(q.nbytes for q in self.queues.values() if q)

    def resident_bytes(self) -> float:
        return sum(q.resident_bytes for q in self.queues.values() if q)

    def tenant_of_adapter(self, adapter_id: int) -> str:
        return self._tenants.get(adapter_id, DEFAULT_TENANT)

    def tenant_pending(self, tenant: str) -> tuple[int, float]:
        """(pending requests, pending prompt-state bytes) for one tenant
        class, both residency sides — the admission controller's view
        (spilling must not launder quota headroom)."""
        objs, nbytes = 0, 0.0
        for a, q in self.queues.items():
            if self.tenant_of_adapter(a) != tenant or not q:
                continue
            objs += q.size
            nbytes += q.nbytes
        return objs, nbytes

    # -- state snapshot ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-data view of the full workload state (queue contents +
        order on both residency sides, spill marks) for the durability
        tier's replayed-state == live-state assertions."""

        def req(r: Request) -> list:
            return [
                int(r.request_id), int(r.adapter_id), float(r.arrival_time),
                int(r.prompt_len), int(r.tokens_done),
            ]

        return {
            "queues": {
                int(a): q.snapshot(req)
                for a, q in sorted(self.queues.items())
                if q
            },
            "spilled": sorted(int(a) for a in self._spilled),
        }

    # -- §6 workload overflow ---------------------------------------------------
    # is_spilled / spilled_fraction / spill_bucket / unspill_bucket /
    # spilled_buckets come from SpillBookkeepingMixin — ONE copy of the
    # §6 bucket protocol, shared with the core WorkloadManager.


class LifeRaftEngine:
    def __init__(
        self,
        adapters: list[AdapterSpec],
        config: ServeConfig = ServeConfig(),
        decode_batch_fn: Optional[Callable] = None,
        control: Optional[ControlLoop | TenantControlPlane] = None,
        obs=None,
    ) -> None:
        self.cfg = config
        self.adapters = {a.adapter_id: a for a in adapters}
        mean_bytes = float(np.mean([a.nbytes for a in adapters])) if adapters else 1.0
        self.cost = CostModel(
            T_b=mean_bytes / config.hbm_bw,
            T_m=config.per_token_cost,
            T_spill=config.spill_penalty_s,
            probe_bytes=config.kv_bytes_per_token,
            min_unit_bytes=config.min_unit_bytes,
        )
        if config.policy == "rr":
            self.scheduler = RoundRobinScheduler(self.cost)
        else:
            alpha = 1.0 if config.policy == "noshare" else config.alpha
            self.scheduler = LifeRaftScheduler(self.cost, alpha=alpha, normalized=True)
        self.cache = BucketCache(config.adapter_slots)
        self.workload = AdapterWorkload(
            [a.adapter_id for a in adapters],
            probe_bytes=self.cost.probe_bytes,
            tenants={a.adapter_id: a.tenant for a in adapters},
            min_unit_bytes=self.cost.min_unit_bytes,
            wholesale_unspill=config.wholesale_unspill,
        )
        self.decode_batch_fn = decode_batch_fn
        self.completed: list[Request] = []
        self.indexed_batches = 0
        self.tokens_served = 0
        self._inflight: dict[int, list[Request]] = {}
        if control is None and config.tenant_policies:
            # Multi-tenant plane: one ControlVector per adapter class, the
            # global §6 byte budget arbitrated across classes.
            control = TenantControlPlane(
                list(config.tenant_policies),
                global_budget_bytes=config.spill_budget_bytes,
                halflife_s=config.control_halflife_s,
            )
        elif control is None and config.adaptive:
            control = ControlLoop(
                ControlConfig(
                    alpha_init=config.alpha,
                    alpha_step=config.alpha_step,
                    halflife_s=config.control_halflife_s,
                    rate_knee=config.rate_knee,
                    depth_knee=config.depth_knee,
                    fuse_k_init=config.fuse_k,
                    fuse_k_max=config.fuse_k_max,
                    spill_budget_objects=config.spill_budget,
                    spill_budget_bytes=config.spill_budget_bytes,
                    wholesale_unspill=config.wholesale_unspill,
                    prefetch_horizon_init=config.prefetch_horizon,
                    prefetch_horizon_max=(
                        config.prefetch_horizon_max if config.prefetch else 0
                    ),
                    share_width_init=max(1, config.share_width),
                    share_width_max=(
                        config.share_width_max if config.shared_plan else 0
                    ),
                )
            )
        self.control = control
        pf_cfg = (
            PrefetchConfig(
                horizon=config.prefetch_horizon, depth=config.prefetch_depth
            )
            if config.prefetch
            else False
        )
        self.loop = DispatchLoop(
            self.scheduler,
            self.workload,
            self.cache,
            self._execute,
            control=control,
            tenant_of=self.workload.tenant_of_adapter,
            fuse_k=config.fuse_k,
            complete=self._complete,
            batch_capacity=config.max_batch,
            # Staging cost is per adapter: its weight bytes over HBM bw
            # (exactly the t_load the demand path would have paid inline).
            prefetch=build_pipeline(
                pf_cfg, self.scheduler, self.cache,
                lambda a: self.adapters[a].nbytes / self.cfg.hbm_bw,
            ),
        )
        self.obs = None
        if obs:
            # Lazy import: with obs off (the default) the hot path never
            # touches repro_torch.obs.  The tap is a pure add_round_tap consumer.
            from ..obs import ensure as _obs_ensure

            self.obs = _obs_ensure(obs)
            self.obs.attach_loop(self.loop, track=0, clock="virtual")

    # ------------------------------------------------------------- views
    @property
    def clock(self) -> float:
        return self.loop.clock

    @clock.setter
    def clock(self, value: float) -> None:
        self.loop.clock = value

    @property
    def batches(self) -> int:
        return self.loop.batches

    @property
    def queues(self) -> dict[int, list[Request]]:
        return {a: q.requests for a, q in self.workload.queues.items()}

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        self.clock = max(self.clock, req.arrival_time)
        self.workload.push(req)
        self.loop.observe_arrival(req.arrival_time)

    # ------------------------------------------------------------- execution
    def _prepare_decision(self, d) -> tuple[int, list[Request], float]:
        """Per-decision accounting shared by both executor paths: take the
        batch, charge adapter load + §6 read-back + quantum decode time,
        and advance token state.  Returns (adapter, batch, step_time)."""
        adapter = d.bucket_id
        batch = self.workload.take(adapter, self.cfg.max_batch)
        self._inflight[adapter] = batch
        t_load = 0.0
        if not self.cache.contains(adapter):
            t_load = self.adapters[adapter].nbytes / self.cfg.hbm_bw
        if self.workload.is_spilled(adapter):
            # §6 host read-back surcharge, pro-rated by the spilled
            # byte fraction (== T_spill for a fully spilled queue).
            t_load += self.cost.T_spill * self.workload.spilled_fraction(
                adapter
            )
        use_indexed = (
            len(batch) < self.cfg.hybrid_threshold
            and not self.cache.contains(adapter)
        )
        if use_indexed:
            # Gathered multi-adapter path: no residency established, but
            # hit_rate must see the miss (symmetric accounting, same as
            # CrossMatchEngine._plan_and_fetch).
            self.indexed_batches += 1
            self.cache.note_bypass_miss()
            t_load = t_load * 0.25  # stream only the rows touched
        else:
            self.cache.access(adapter)

        quantum = self.cfg.decode_quantum
        # Load + quantum decode steps for the batch.
        step_time = t_load + quantum * self.cfg.per_token_cost * max(
            len(batch), 1
        )
        for r in batch:
            r.tokens_done += quantum
            self.tokens_served += quantum
        return adapter, batch, step_time

    def _execute(self, decisions, vector) -> float:
        """DispatchLoop executor: load + quantum decode for each selected
        adapter's batch — one device call per adapter, or one masked
        grouped call per share_width chunk under ``shared_plan``."""
        if self.cfg.shared_plan:
            return self.execute_shared(decisions, vector)
        step_time = 0.0
        self._inflight = {}
        for d in decisions:
            adapter, batch, t = self._prepare_decision(d)
            step_time += t
            if self.decode_batch_fn is not None:
                self.decode_batch_fn(adapter, batch, self.cfg.decode_quantum)
        self.loop.note_device_dispatches(len(decisions))
        return step_time

    def execute_shared(self, decisions, vector=None) -> float:
        """Shared-plan executor: the round's adapter batches decode in
        ceil(k / share_width) masked grouped calls instead of k private
        ones.  Per-decision cost accounting is identical to the off path
        (the virtual clock and every completion time are unchanged); only
        the device-call grouping — and the real ``decode_batch_fn``
        invocation shape, ``fn([(adapter, batch), ...], quantum)`` —
        differs."""
        width = max(
            1, getattr(vector, "share_width", 0) or self.cfg.share_width
        )
        step_time = 0.0
        self._inflight = {}
        prepared: list[tuple[int, list[Request]]] = []
        for d in decisions:
            adapter, batch, t = self._prepare_decision(d)
            step_time += t
            prepared.append((adapter, batch))
        chunks = [
            prepared[i : i + width] for i in range(0, len(prepared), width)
        ]
        for group in chunks:
            if self.decode_batch_fn is not None:
                self.decode_batch_fn(group, self.cfg.decode_quantum)
        occupancy = (
            len(prepared) / (len(chunks) * width) if prepared else 0.0
        )
        self.loop.note_device_dispatches(
            len(chunks), shared_occupancy=occupancy
        )
        return step_time

    def _complete(self, decisions, now: float) -> None:
        """Completions share the dispatch finish time (the fused call
        returns all segments at once)."""
        for d in decisions:
            adapter = d.bucket_id
            batch = self._inflight.get(adapter, ())
            for r in batch:
                if r.done and r.finish_time is None:
                    r.finish_time = now
                    self.completed.append(r)
            # Only the serviced requests page back in — the unserviced
            # spilled tail stays on host, within the §6 budget.
            self.workload.retire(adapter, batch)
        self._inflight = {}

    # ------------------------------------------------------------- scheduling
    def step(self) -> Optional[int]:
        """Schedule + execute one dispatch (one adapter batch, or the top-k
        adapters fused into a single grouped call when ``fuse_k > 1``).
        Returns the highest-priority adapter id, or None when idle."""
        if self.cfg.policy == "noshare":
            return self._step_noshare()
        outcome = self.loop.round()
        return None if outcome is None else outcome.decisions[0].bucket_id

    def _step_noshare(self) -> Optional[int]:
        """Paper's NoShare baseline: FCFS across all adapters, one request
        at a time, no batching; every request pays its own state load."""
        pending = [
            (q.requests[0].arrival_time, a)
            for a, q in self.workload.queues.items()
            if q
        ]
        if not pending:
            return None
        _, adapter = min(pending)
        req = self.workload.queues[adapter].requests[0]
        t_load = self.adapters[adapter].nbytes / self.cfg.hbm_bw
        quantum = self.cfg.decode_quantum
        if self.decode_batch_fn is not None:
            self.decode_batch_fn(adapter, [req], quantum)
        req.tokens_done += quantum
        self.tokens_served += quantum
        step_time = t_load + quantum * self.cfg.per_token_cost
        self.clock += step_time
        self.loop.busy += step_time
        self.loop.batches += 1
        self.loop.dispatches += 1
        self.loop.device_dispatches += 1
        if req.done and req.finish_time is None:
            req.finish_time = self.clock
            self.completed.append(req)
        self.workload.retire(adapter, [req])
        return adapter

    def run(self, requests: list[Request]) -> dict:
        """Replay a request trace to completion; returns summary metrics."""
        pending = sorted(requests, key=lambda r: r.arrival_time)
        i = 0
        while i < len(pending) or self.workload.nonempty_queues():
            if not self.workload.nonempty_queues():
                self.clock = max(self.clock, pending[i].arrival_time)
            while i < len(pending) and pending[i].arrival_time <= self.clock:
                self.submit(pending[i])
                i += 1
            if self.workload.nonempty_queues():
                self.step()
        return self.summary()

    def summary(self) -> dict:
        resp = [r.finish_time - r.arrival_time for r in self.completed]
        vec = self.loop.last_vector
        dstats = dispatch_stats(self.loop)
        response_by_id = {
            r.request_id: r.finish_time - r.arrival_time for r in self.completed
        }
        adapter_of = {r.request_id: r.adapter_id for r in self.completed}
        tenants = sorted({a.tenant for a in self.adapters.values()})
        per_tenant = (
            per_tenant_latency(
                response_by_id,
                lambda rid: self.workload.tenant_of_adapter(adapter_of[rid]),
                max(self.clock, 1e-9),
                tenants,
            )
            if len(tenants) > 1
            else {}
        )
        return {
            "policy": self.cfg.policy,
            "alpha": getattr(self.scheduler, "alpha", None),
            "adaptive": self.control is not None,
            "multi_tenant": isinstance(self.control, TenantControlPlane),
            "fuse_k": vec.fuse_k if vec is not None else self.cfg.fuse_k,
            "n_completed": len(self.completed),
            "makespan": self.clock,
            "token_throughput": self.tokens_served / max(self.clock, 1e-9),
            "request_throughput": len(self.completed) / max(self.clock, 1e-9),
            "mean_response": float(np.mean(resp)) if resp else 0.0,
            "p95_response": float(np.percentile(resp, 95)) if resp else 0.0,
            "cache_hit_rate": self.cache.stats.hit_rate,
            "batches": self.batches,
            "device_dispatches": dstats["device_dispatches"],
            "shared_batch_occupancy": dstats["shared_batch_occupancy"],
            "indexed_batches": self.indexed_batches,
            "spilled": self.workload.spilled_buckets(),
            "per_tenant": per_tenant,
            "prefetch": (
                prefetch_stats(self.loop.prefetch, self.cache)
                if self.loop.prefetch is not None
                else {}
            ),
        }


class ShardedServingEngine:
    """Multi-shard serving: S :class:`LifeRaftEngine` replicas, adapters
    partitioned by weight bytes.

    Here the shard key is the adapter id (serving's bucket): each
    adapter's whole request queue lives on exactly one shard, so no
    request ever needs a cross-shard join — routing is a lookup and
    stealing migrates an adapter's entire pending queue.  Every replica
    holds the full adapter spec table (identical ``T_b``); only the HBM
    ``adapter_slots`` are split so aggregate cache stays equal to the
    single-engine baseline.

    The drive is virtual lockstep (the simulator's transport): the
    least-clock shard with work steps next, idle shards at the steal
    low-water mark take the byte-heaviest victim's top adapter —
    scheduler state forgotten on the victim, in-flight weight stage
    canceled for the residual channel time, requests landing resident
    with original arrivals and the thief's clock advanced to the newest
    one (no time travel, no free cache warmth).
    """

    def __init__(
        self,
        adapters: list[AdapterSpec],
        config: ServeConfig = ServeConfig(),
        n_shards: int = 2,
        *,
        shard_map: Optional[ShardMap] = None,
        steal: Optional[StealConfig] = None,
        decode_batch_fn: Optional[Callable] = None,
        obs=None,
    ) -> None:
        self.n_shards = max(1, int(n_shards))
        self.shard_map = shard_map or ShardMap.from_bucket_bytes(
            {a.adapter_id: float(a.nbytes) for a in adapters}, self.n_shards
        )
        self.steal = steal
        self.steals: list[StealEvent] = []
        # Aggregate HBM slots are conserved across the split: the first
        # ``slots % S`` shards carry one extra (plain ``slots // S``
        # silently dropped the remainder — shards are NOT interchangeable
        # replicas of capacity).
        slot_split = split_slots(config.adapter_slots, self.n_shards)
        self.engines = [
            LifeRaftEngine(
                adapters,
                dataclasses.replace(config, adapter_slots=slot_split[sid]),
                decode_batch_fn=decode_batch_fn,
            )
            for sid in range(self.n_shards)
        ]
        # Decision-log taps for the durability tier (and any recorder):
        # ``on_round(shard_id, outcome)`` fires after each shard-local
        # round, ``on_steal(event)`` after each migration, preserving the
        # cross-shard interleaving order.
        self.on_round: Optional[Callable] = None
        self.on_steal: Optional[Callable] = None
        for sid, eng in enumerate(self.engines):
            eng.loop.add_round_tap(self._make_round_tap(sid))
        self._obs = None
        if obs:
            from ..obs import ensure as _obs_ensure  # lazy: off-path clean

            self._obs = _obs_ensure(obs)
            for sid, eng in enumerate(self.engines):
                self._obs.attach_loop(eng.loop, track=sid, clock="virtual")

    def _make_round_tap(self, sid: int):
        def tap(outcome):
            if self.on_round is not None:
                self.on_round(sid, outcome)

        return tap

    # -- routing ---------------------------------------------------------------
    def _owner(self, req: Request) -> LifeRaftEngine:
        return self.engines[self.shard_map.shard_of(req.adapter_id)]

    def submit(self, req: Request) -> None:
        self._owner(req).submit(req)

    # -- work stealing ---------------------------------------------------------
    def _maybe_steal(self) -> None:
        cfg = self.steal
        if cfg is None or self.n_shards < 2:
            return
        for sid, thief in enumerate(self.engines):
            if thief.workload.pending_bytes() > cfg.low_water_bytes:
                continue
            victims = [
                (vid, v)
                for vid, v in enumerate(self.engines)
                if vid != sid
                and len(v.workload.nonempty_queues()) >= cfg.min_victim_queues
            ]
            if not victims:
                continue
            vid, victim = max(
                victims, key=lambda t: (t[1].workload.pending_bytes(), -t[0])
            )
            peek = getattr(victim.scheduler, "peek_topk", None)
            if peek is not None:
                top = peek(victim.workload, victim.cache, victim.clock, 1)
                adapter = top[0].bucket_id if top else None
            else:
                queues = victim.workload.nonempty_queues()
                adapter = (
                    max(
                        queues, key=lambda q: (q.nbytes, -q.bucket_id)
                    ).bucket_id
                    if queues
                    else None
                )
            if adapter is None:
                continue
            reqs = victim.workload.migrate_out(adapter)
            if not reqs:
                continue
            if hasattr(victim.scheduler, "forget"):
                victim.scheduler.forget(adapter)
            reclaimed = 0.0
            if victim.loop.prefetch is not None:
                reclaimed = victim.loop.prefetch.cancel(adapter, victim.clock)
            thief.workload.migrate_in(reqs)
            self.shard_map.reassign(adapter, sid)
            newest = max(r.arrival_time for r in reqs)
            thief.clock = max(thief.clock, newest)
            thief.loop.observe_arrival(newest)
            ev = StealEvent(
                bucket_id=adapter,
                victim=vid,
                thief=sid,
                n_units=len(reqs),
                nbytes=float(
                    sum(
                        max(
                            r.prompt_len * victim.workload.probe_bytes,
                            victim.workload.min_unit_bytes,
                        )
                        for r in reqs
                    )
                ),
                reclaimed_stage_s=reclaimed,
                clock=thief.clock,
            )
            self.steals.append(ev)
            if self.on_steal is not None:
                self.on_steal(ev)
            if self._obs is not None:
                self._obs.note_steal(ev)

    # -- virtual lockstep drive ------------------------------------------------
    def step(self) -> Optional[int]:
        """One lockstep iteration, the unit the service daemon pumps: a
        steal sweep, then one round on the least-clock shard with work.
        Returns that shard's serviced adapter id, or None when every shard
        is idle.  (``run`` keeps its own historical loop — it interleaves
        trace admission between the sweep and the round.)"""
        self._maybe_steal()
        runnable = [e for e in self.engines if e.workload.nonempty_queues()]
        if not runnable:
            return None
        eng = min(runnable, key=lambda e: (e.clock, self.engines.index(e)))
        return eng.step()

    def run(self, requests: list[Request]) -> dict:
        pending = sorted(requests, key=lambda r: r.arrival_time)
        i = 0
        while True:
            self._maybe_steal()
            # Admit every arrival its owner's clock has reached.
            while (
                i < len(pending)
                and pending[i].arrival_time <= self._owner(pending[i]).clock
            ):
                self.submit(pending[i])
                i += 1
            runnable = [
                e for e in self.engines if e.workload.nonempty_queues()
            ]
            if runnable:
                eng = min(
                    runnable, key=lambda e: (e.clock, self.engines.index(e))
                )
                eng.step()
                continue
            if i < len(pending):
                nxt = pending[i]
                owner = self._owner(nxt)
                owner.clock = max(owner.clock, nxt.arrival_time)
                self.submit(nxt)
                i += 1
                continue
            return self.summary()

    # -- metrics ---------------------------------------------------------------
    def summary(self) -> dict:
        completed = [r for eng in self.engines for r in eng.completed]
        resp = [r.finish_time - r.arrival_time for r in completed]
        hits = sum(eng.cache.stats.hits for eng in self.engines)
        accesses = sum(eng.cache.stats.accesses for eng in self.engines)
        makespan = max(eng.clock for eng in self.engines)
        tokens = sum(eng.tokens_served for eng in self.engines)
        return {
            "policy": f"{self.engines[0].cfg.policy}+S{self.n_shards}"
            + ("st" if self.steal is not None else ""),
            "n_shards": self.n_shards,
            "n_completed": len(completed),
            "makespan": makespan,
            "token_throughput": tokens / max(makespan, 1e-9),
            "request_throughput": len(completed) / max(makespan, 1e-9),
            "mean_response": float(np.mean(resp)) if resp else 0.0,
            "p95_response": float(np.percentile(resp, 95)) if resp else 0.0,
            "cache_hit_rate": hits / accesses if accesses else 0.0,
            "batches": sum(eng.batches for eng in self.engines),
            "steals": len(self.steals),
        }
