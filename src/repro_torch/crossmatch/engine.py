"""End-to-end cross-match engine: core scheduler + real join compute.

This is the paper's Fig. 3 wired together:

  Query Pre-Processor  -> WorkloadManager.submit
  Workload Manager     -> per-bucket workload queues + ages
  LifeRaft Scheduler   -> argmax U_a bucket selection (incremental index)
  Join Evaluator       -> hybrid plan + the cross-match kernel
  Bucket Cache         -> LRU over bucket payloads

The join itself runs on the device through the port's CUDA kernels
(``repro_torch.kernels.crossmatch``; on ``device="cpu"`` their plain
PyTorch versions): probe objects of *every* pending query for the chosen
bucket are batched into one device call — the paper's single shared
pass.  With ``fuse_k > 1`` the engine goes one step further: the top-k
buckets by U_a are evaluated in ONE segment-masked device call
(``crossmatch_fused``), amortizing dispatch across buckets the way the
paper amortizes disk reads across queries.  Probe batches are padded to
powers of two inside the kernel wrappers, as in the reference.

Per-query predicates (here: magnitude cuts) are applied on the matched
tuples before results are routed back to their parent queries.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np

from ..core.cache import BucketCache
from ..core.control import ControlLoop, TenantControlPlane
from ..core.dispatch import DispatchLoop
from ..core.hybrid import HybridPlanner
from ..core.metrics import CostModel, dispatch_stats, per_tenant_latency
from ..core.prefetch import PrefetchConfig, build_pipeline
from ..core.scheduler import BucketScheduler, LifeRaftScheduler, SchedulerDecision
from ..core.shard import ShardMap, StealConfig, StealEvent, split_slots
from ..core.workload import Query, WorkloadManager
from ..kernels.crossmatch import ops as cm_ops
from .catalog import SkyCatalog

__all__ = ["MatchResult", "CrossMatchEngine", "ShardedCrossMatch"]


@dataclasses.dataclass
class MatchResult:
    """Per-query cross-match output."""

    query_id: int
    probe_idx: np.ndarray  # indices into the query's probe list
    match_obj: np.ndarray  # matched catalog object row (global index)
    best_dot: np.ndarray  # cos(angular distance) of the best match
    n_candidates: np.ndarray  # matches within the radius (probabilistic join)


class CrossMatchEngine:
    def __init__(
        self,
        catalog: SkyCatalog,
        scheduler: Optional[BucketScheduler] = None,
        cost_model: Optional[CostModel] = None,
        cache_capacity: int = 20,
        match_radius_rad: float = 1e-3,
        hybrid: Optional[HybridPlanner] = None,
        device=None,
        mag_cut: float = 24.0,
        fuse_k: int = 1,
        control: Optional[ControlLoop | TenantControlPlane] = None,
        prefetch: bool | PrefetchConfig = False,
        shared_plan: bool = False,
        share_width: int = 8,
        obs=None,
    ) -> None:
        self.catalog = catalog
        self.cost_model = cost_model or CostModel()
        self.scheduler = scheduler or LifeRaftScheduler(self.cost_model, alpha=0.25)
        # Queries are tenant-classed by their meta['tenant'] tag; probe
        # bytes price the §6 overflow budget (CostModel.probe_bytes).
        self.wm = WorkloadManager(
            catalog.partitioner.buckets_for_range,
            probe_bytes=self.cost_model.probe_bytes,
            min_unit_bytes=self.cost_model.min_unit_bytes,
        )
        self.cache = BucketCache(cache_capacity)
        self.cos_thr = float(np.cos(match_radius_rad))
        self.hybrid = hybrid
        # The device picks the join path: CUDA kernels on ``cuda`` (the
        # default, which must exist), plain PyTorch on ``cpu``.
        self.device = cm_ops.resolve_device(device)
        self.mag_cut = mag_cut
        self.fuse_k = max(1, int(fuse_k))
        # Shared query plans: evaluate the whole query batch's predicates
        # in ONE masked device call (per share_width-sized chunk) instead
        # of one dispatch per predicate class.  Off by default; the
        # per-query predicate surface is meta['radius'] / meta['mag_cut'].
        self.shared_plan = bool(shared_plan)
        self.share_width = max(1, int(share_width))
        self._pred_cache: dict[int, tuple[float, float]] = {}
        self._has_query_predicates = False
        self.results: dict[int, list[MatchResult]] = {}
        self.max_probe_batch = 0  # largest probe batch sent to the device
        # The shared scheduling inner loop; the controller (when given) is
        # consulted there, once per round, never here.  With ``prefetch``
        # on, horizon buckets are staged by real threaded store reads
        # while cost accounting stays on the virtual T_b channel.
        self.loop = DispatchLoop(
            self.scheduler, self.wm, self.cache, self._execute,
            control=control, fuse_k=self.fuse_k,
            tenant_of=self.wm.tenant_of_bucket,
            prefetch=build_pipeline(
                prefetch, self.scheduler, self.cache, self.cost_model.T_b,
                fetch=self.catalog.store.read,
                # Elevator sweep in *file* order: bucket id is an SFC run,
                # not a physical address (Partitioner.layout_position).
                layout_of=self.catalog.partitioner.layout_position,
            ),
        )
        self.obs = None
        if obs:
            # Lazy import (off-path never touches repro_torch.obs).  The join
            # runs on the device, so spans ride on perf_counter marks; each
            # round copies its results to the host (``.cpu()`` synchronises),
            # so a round's wall span holds its device time.  Decisions still
            # come off the tap only.
            from ..obs import ensure as _obs_ensure

            self.obs = _obs_ensure(obs)
            self.obs.attach_loop(self.loop, track=0, clock="wall")

    # -- loop-owned counters (kept as attributes for back-compat) --------------
    @property
    def sim_clock(self) -> float:
        return self.loop.clock

    @sim_clock.setter
    def sim_clock(self, value: float) -> None:
        self.loop.clock = value

    @property
    def batches(self) -> int:
        return self.loop.batches  # buckets serviced

    @property
    def dispatches(self) -> int:
        return self.loop.dispatches  # device calls (== batches unless fused)

    # -- intake ----------------------------------------------------------------
    def submit(self, query: Query) -> None:
        self.wm.submit(query)
        self._note_submitted(query)

    def submit_decomposed(self, query: Query, per_bucket) -> None:
        """Shard-router intake: the coordinator decomposed the query once
        centrally; this engine receives only its shard's bucket slice."""
        self.wm.submit_decomposed(query, per_bucket)
        self._note_submitted(query)

    def _note_submitted(self, query: Query) -> None:
        self.loop.observe_arrival(query.arrival_time)
        self.results.setdefault(query.query_id, [])
        meta = query.meta or {}
        if "radius" in meta or "mag_cut" in meta:
            self._has_query_predicates = True

    # -- per-query predicates -----------------------------------------------------
    def _pred_of(self, query_id: int) -> tuple[float, float]:
        """(cos threshold, mag cut) for one query: its own
        meta['radius'] / meta['mag_cut'] when present, the engine-wide
        defaults otherwise."""
        pred = self._pred_cache.get(query_id)
        if pred is None:
            meta = self.wm.queries[query_id].meta or {}
            thr = (
                float(np.cos(float(meta["radius"])))
                if "radius" in meta
                else self.cos_thr
            )
            pred = (thr, float(meta.get("mag_cut", self.mag_cut)))
            self._pred_cache[query_id] = pred
        return pred

    def _pred_rows(self, owners: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Per-probe-row (cos threshold, mag cut) vectors from the rows'
        owning queries — the host-side gather that turns per-query
        predicates into the shared kernel's threshold operand."""
        if owners.size == 0:
            return np.empty(0, np.float32), np.empty(0, np.float64)
        uniq, inv = np.unique(owners, return_inverse=True)
        preds = np.array([self._pred_of(int(qid)) for qid in uniq], np.float64)
        return preds[inv, 0].astype(np.float32), preds[inv, 1]

    # -- per-bucket plumbing ---------------------------------------------------
    def _plan_and_fetch(self, decision: SchedulerDecision):
        """Hybrid plan + bucket payload with unified cache accounting:
        every resident read records a hit via ``cache.access`` (the indexed
        plan used to read through ``cache.get`` and skew the hit-rate);
        only scan plans establish residency on a miss.

        Residency is re-probed here rather than taken from the decision:
        within a fused dispatch an earlier bucket's insertion can evict a
        later one, and plan/cost must reflect the read that actually
        happens (the decision's snapshot only fed the priority score)."""
        b = decision.bucket_id
        in_cache = self.cache.contains(b)
        plan = (
            self.hybrid.plan(decision.queue_size, in_cache)
            if self.hybrid
            else None
        )
        if in_cache:
            payload = self.cache.get(b)
            self.cache.access(b)  # counts the hit, refreshes LRU
        else:
            payload = self.catalog.store.read(b)  # the 'disk read'
            if plan is None or plan.strategy == "scan":
                self.cache.access(b, payload)
            else:
                # Indexed cold read: no residency, but hit_rate must see
                # the miss or skewed stats return (symmetric accounting).
                self.cache.note_bypass_miss()
        cost = (
            plan.est_cost
            if plan is not None
            else self.cost_model.batch_cost(
                decision.queue_size, in_cache, self.wm.spilled_fraction(b)
            )
        )
        return plan, payload, cost

    def _gather_probes(self, bucket_id: int):
        q = self.wm.queue(bucket_id)
        # Servicing evaluates the whole queue — the spilled suffix is paged
        # back in for the pass (T_spill already charged in the cost).
        units = q.units + q.spilled_units
        if not units:  # zero-query bucket (public execute_shared callers)
            return (
                [],
                np.empty((0, 3), np.float64),
                np.empty(0, np.int64),
                np.empty(0, np.int64),
            )
        probe_pos = np.concatenate(
            [
                self.wm.queries[u.query_id].payload["positions"][u.object_idx]
                for u in units
            ]
        )
        owners = np.concatenate(
            [np.full(u.size, u.query_id, dtype=np.int64) for u in units]
        )
        probe_local = np.concatenate([u.object_idx for u in units])
        return units, probe_pos, owners, probe_local

    def _route(
        self, bucket_id, units, owners, probe_local, best_idx, best_dot, n_cand,
        payload, mag_cut_row=None,
    ) -> None:
        matched = n_cand > 0
        # Per-query predicate on the joined tuples (paper: "query specific
        # predicates are applied on the output tuples that succeed").
        # ``mag_cut_row`` carries each row's owning query's own cut when
        # queries have heterogeneous predicates.
        mags = np.asarray(payload["mags"])[
            np.clip(best_idx, 0, len(payload["mags"]) - 1)
        ]
        matched &= mags <= (self.mag_cut if mag_cut_row is None else mag_cut_row)
        global_rows = self.catalog.partitioner.object_slice(bucket_id)
        for u in units:
            sel = (owners == u.query_id) & matched
            if not sel.any():
                continue
            self.results[u.query_id].append(
                MatchResult(
                    query_id=u.query_id,
                    probe_idx=probe_local[sel],
                    match_obj=global_rows[best_idx[sel]],
                    best_dot=best_dot[sel],
                    n_candidates=n_cand[sel],
                )
            )

    # -- one scheduling step -----------------------------------------------------
    def step(self) -> Optional[int]:
        """Service one scheduling round (1 bucket, or top-k fused); returns
        the highest-priority bucket id serviced, or None if idle."""
        outcome = self.loop.round()
        return None if outcome is None else outcome.decisions[0].bucket_id

    def _execute(self, decisions, vector) -> float:
        """DispatchLoop executor: route the round to the shared-plan path,
        the per-predicate-class path (heterogeneous predicates without a
        shared plan), or the historical batched/fused path.  Returns the
        round's wall-clock cost."""
        if self.shared_plan:
            return self.execute_shared(decisions, vector)
        if self._has_query_predicates:
            return self._execute_per_predicate(decisions)
        return self._execute_batched(decisions)

    def _execute_batched(self, decisions) -> float:
        """The historical homogeneous-predicate path: one device call per
        round (single bucket, or the fuse_k segment-masked fused call)."""
        total_cost = 0.0
        if len(decisions) == 1:
            decision = decisions[0]
            b = decision.bucket_id
            _, payload, cost = self._plan_and_fetch(decision)
            total_cost += cost
            units, probe_pos, owners, probe_local = self._gather_probes(b)
            self.max_probe_batch = max(self.max_probe_batch, len(probe_pos))
            # --- the shared pass: one batched device call for every query ---
            best_idx, best_dot, n_cand = cm_ops.crossmatch(
                np.asarray(payload["positions"], dtype=np.float32),
                probe_pos.astype(np.float32),
                self.cos_thr,
                device=self.device,
            )
            self._route(
                b, units, owners, probe_local,
                best_idx.cpu().numpy(), best_dot.cpu().numpy(),
                n_cand.cpu().numpy(),
                payload,
            )
        else:
            # --- fused multi-bucket pass: top-k buckets, ONE device call ---
            per_bucket = []
            bucket_parts, probe_parts, bseg, pseg = [], [], [], []
            row_off = 0
            for s, decision in enumerate(decisions):
                b = decision.bucket_id
                _, payload, cost = self._plan_and_fetch(decision)
                total_cost += cost
                units, probe_pos, owners, probe_local = self._gather_probes(b)
                pos = np.asarray(payload["positions"], dtype=np.float32)
                bucket_parts.append(pos)
                probe_parts.append(probe_pos.astype(np.float32))
                bseg.append(np.full(len(pos), s, np.int32))
                pseg.append(np.full(len(probe_pos), s, np.int32))
                per_bucket.append(
                    (b, payload, units, owners, probe_local, row_off,
                     len(probe_pos))
                )
                row_off += len(pos)
            self.max_probe_batch = max(
                self.max_probe_batch, sum(len(p) for p in probe_parts)
            )
            best_idx, best_dot, n_cand = cm_ops.crossmatch_fused(
                np.concatenate(bucket_parts),
                np.concatenate(probe_parts),
                np.concatenate(bseg),
                np.concatenate(pseg),
                self.cos_thr,
                device=self.device,
            )
            best_idx = best_idx.cpu().numpy()
            best_dot = best_dot.cpu().numpy()
            n_cand = n_cand.cpu().numpy()
            p_off = 0
            for b, payload, units, owners, probe_local, row_off, n_p in per_bucket:
                sl = slice(p_off, p_off + n_p)
                p_off += n_p
                local_idx = np.clip(
                    best_idx[sl] - row_off, 0, len(payload["mags"]) - 1
                )
                self._route(
                    b, units, owners, probe_local,
                    local_idx, best_dot[sl], n_cand[sl], payload,
                )

        return total_cost

    def _execute_per_predicate(self, decisions) -> float:
        """Per-predicate-class baseline: queries carry their own radii /
        mag cuts, so the static-``cos_thr`` kernel needs one device call
        per (bucket, distinct threshold) pair — the dispatch storm the
        shared plan collapses.  Kept as the off-path so ``shared_plan``
        stays a pure performance switch with bit-equal results."""
        total_cost = 0.0
        n_calls = 0
        for decision in decisions:
            b = decision.bucket_id
            _, payload, cost = self._plan_and_fetch(decision)
            total_cost += cost
            units, probe_pos, owners, probe_local = self._gather_probes(b)
            self.max_probe_batch = max(self.max_probe_batch, len(probe_pos))
            pos = np.asarray(payload["positions"], dtype=np.float32)
            probes32 = probe_pos.astype(np.float32)
            thr_row, mag_row = self._pred_rows(owners)
            best_idx = np.zeros(len(owners), np.int64)
            best_dot = np.zeros(len(owners), np.float32)
            n_cand = np.zeros(len(owners), np.int64)
            for thr in np.unique(thr_row):
                sel = thr_row == thr
                bi, bd, nc = cm_ops.crossmatch(
                    pos, probes32[sel], float(thr), device=self.device
                )
                best_idx[sel] = bi.cpu().numpy()
                best_dot[sel] = bd.cpu().numpy()
                n_cand[sel] = nc.cpu().numpy()
                n_calls += 1
            self._route(
                b, units, owners, probe_local, best_idx, best_dot, n_cand,
                payload, mag_cut_row=mag_row,
            )
        self.loop.note_device_dispatches(n_calls)
        return total_cost

    def execute_shared(self, bucket_group, vector=None) -> float:
        """Shared-plan executor: ONE masked device call (per share_width
        chunk) for the whole bucket group x query batch.

        ``bucket_group`` is the round's SchedulerDecisions (bare bucket ids
        are accepted and looked up).  All pending queries' predicates are
        gathered into per-probe-row threshold/mag-cut vectors and the join
        runs through ``crossmatch_shared`` — the (queries x objects) mask —
        so k buckets and Q predicate classes cost ceil(Q / share_width)
        dispatches instead of k*Q.  The hybrid planner's group plan is the
        third break-even axis: members it sends down the indexed path keep
        private per-predicate calls (tiny batches don't pay the shared
        scan), the scan members share the masked kernel.
        """
        decisions = [
            d
            if hasattr(d, "bucket_id")
            else SchedulerDecision(
                bucket_id=int(d),
                score=0.0,
                in_cache=self.cache.contains(int(d)),
                queue_size=self.wm.queue(int(d)).size,
            )
            for d in bucket_group
        ]
        width = getattr(vector, "share_width", 0) or self.share_width
        total_cost = 0.0
        n_calls = 0

        # Group plan (third axis): members that still prefer indexed
        # probes peel off to their own calls; the rest share one plan.
        if self.hybrid is not None and hasattr(self.hybrid, "plan_group"):
            plans = self.hybrid.plan_group(
                [
                    (d.queue_size, self.cache.contains(d.bucket_id))
                    for d in decisions
                ]
            )
        else:
            plans = [None] * len(decisions)

        shared, indexed = [], []
        for decision, plan in zip(decisions, plans):
            if plan is not None and plan.strategy == "indexed":
                indexed.append(decision)
            else:
                shared.append(decision)
        if indexed:
            total_cost += self._execute_per_predicate(indexed)

        if not shared:
            return total_cost

        per_bucket = []
        bucket_parts, probe_parts, bseg, pseg = [], [], [], []
        row_off = 0
        for s, decision in enumerate(shared):
            b = decision.bucket_id
            _, payload, cost = self._plan_and_fetch(decision)
            total_cost += cost
            units, probe_pos, owners, probe_local = self._gather_probes(b)
            pos = np.asarray(payload["positions"], dtype=np.float32)
            bucket_parts.append(pos)
            probe_parts.append(probe_pos.astype(np.float32))
            bseg.append(np.full(len(pos), s, np.int32))
            pseg.append(np.full(len(probe_pos), s, np.int32))
            per_bucket.append(
                (b, payload, units, owners, probe_local, row_off,
                 len(probe_pos))
            )
            row_off += len(pos)
        bucket_cat = np.concatenate(bucket_parts)
        probes_cat = np.concatenate(probe_parts)
        bseg_cat = np.concatenate(bseg)
        pseg_cat = np.concatenate(pseg)
        owners_cat = np.concatenate([pb[3] for pb in per_bucket])
        self.max_probe_batch = max(self.max_probe_batch, len(probes_cat))
        thr_row, mag_row = self._pred_rows(owners_cat)

        # Chunk the query batch by share_width (the AIMD-bounded compile
        # ceiling): each chunk's probe rows go through one shared call
        # against the same concatenated bucket payload, and outputs are
        # scattered back into full-length arrays so routing below is
        # order-identical to the fused path.
        qids = list(dict.fromkeys(owners_cat.tolist()))  # first-appearance
        best_idx = np.zeros(len(owners_cat), np.int64)
        best_dot = np.zeros(len(owners_cat), np.float32)
        n_cand = np.zeros(len(owners_cat), np.int64)
        chunks = [qids[i : i + width] for i in range(0, len(qids), width)] or [[]]
        for chunk in chunks:
            rows = np.isin(owners_cat, chunk)
            if not rows.any():
                continue
            bi, bd, nc = cm_ops.crossmatch_shared(
                bucket_cat,
                probes_cat[rows],
                bseg_cat,
                pseg_cat[rows],
                thr_row[rows],
                device=self.device,
            )
            best_idx[rows] = bi.cpu().numpy()
            best_dot[rows] = bd.cpu().numpy()
            n_cand[rows] = nc.cpu().numpy()
            n_calls += 1
        occupancy = (
            len(qids) / (len(chunks) * width) if qids and chunks else 0.0
        )
        self.loop.note_device_dispatches(n_calls, shared_occupancy=occupancy)

        p_off = 0
        for b, payload, units, owners, probe_local, row_off, n_p in per_bucket:
            sl = slice(p_off, p_off + n_p)
            p_off += n_p
            local_idx = np.clip(
                best_idx[sl] - row_off, 0, len(payload["mags"]) - 1
            )
            self._route(
                b, units, owners, probe_local,
                local_idx, best_dot[sl], n_cand[sl], payload,
                mag_cut_row=mag_row[sl],
            )
        return total_cost

    # -- drive a whole trace -------------------------------------------------------
    def run(self, queries: Sequence[Query]) -> dict[int, list[MatchResult]]:
        """Arrival-ordered replay: admit, then drain between arrivals."""
        for q in sorted(queries, key=lambda q: q.arrival_time):
            self.sim_clock = max(self.sim_clock, q.arrival_time)
            self.submit(q)
        while self.step() is not None:
            pass
        self.close()  # reap prefetch workers; they respawn if reused
        return self.results

    def close(self) -> None:
        """Release the prefetch staging threads (no-op without prefetch;
        step()-driven callers should close when done)."""
        if self.loop.prefetch is not None:
            self.loop.prefetch.close()

    # -- metrics --------------------------------------------------------------------
    def summary(self) -> dict:
        rt = self.wm.response_times()
        tenants = sorted({q.tenant for q in self.wm.queries.values()})
        dstats = dispatch_stats(self.loop)
        return {
            "n_queries": len(rt),
            "n_batches": self.batches,
            "n_dispatches": self.dispatches,
            "device_dispatches": dstats["device_dispatches"],
            "shared_batch_occupancy": dstats["shared_batch_occupancy"],
            "mean_response": float(np.mean(list(rt.values()))) if rt else 0.0,
            "cache_hit_rate": self.cache.stats.hit_rate,
            "makespan": self.sim_clock,
            "per_tenant": per_tenant_latency(
                rt, self.wm.tenant_of_query, max(self.sim_clock, 1e-9), tenants
            )
            if len(tenants) > 1
            else {},
        }


class ShardedCrossMatch:
    """Multi-shard cross-match: S shard-local engines over one catalog.

    Buckets are partitioned by SFC range (bucket ids are the
    Partitioner's SFC-run order) weighted by bucket bytes.  Each query
    is decomposed ONCE centrally and its per-bucket slices routed to the
    owning shards — object indices stay valid against the original query
    arrays, so ``_gather_probes`` on any shard reads the same positions
    the single-engine path would.  A query may span shards; its result
    set is the union of per-shard matches (buckets are disjoint across
    shards, so the union cannot double-count).

    Transport is threaded: each shard's :class:`DispatchLoop` drains on
    its own thread under a per-shard lock.  With ``steal`` set, a thread
    that runs dry at the low-water mark steals the byte-heaviest
    victim's highest-utility unstarted bucket under both shard locks
    (acquired in ascending id order — no deadlock), migrating pending
    units and canceling the victim's in-flight prefetch stage for the
    residual channel time only.  The stolen payload is cache-cold on the
    thief: its next service pays the full read.
    """

    def __init__(
        self,
        catalog: SkyCatalog,
        n_shards: int = 2,
        *,
        shard_map: Optional[ShardMap] = None,
        steal: Optional[StealConfig] = None,
        scheduler_factory=None,
        cost_model: Optional[CostModel] = None,
        cache_capacity: int = 20,
        control_factory=None,
        **engine_kwargs,
    ) -> None:
        self.catalog = catalog
        self.n_shards = max(1, int(n_shards))
        self.cost_model = cost_model or CostModel()
        self.shard_map = shard_map or ShardMap.from_partitioner(
            catalog.partitioner, self.n_shards
        )
        self.steal = steal
        self.steals: list[StealEvent] = []
        # Aggregate cache slots stay equal to a single-engine run with the
        # same ``cache_capacity`` — each shard gets its slice, remainder
        # slots going to the lowest shard ids (split_slots conserves sum).
        caps = split_slots(cache_capacity, self.n_shards)
        self.engines = [
            CrossMatchEngine(
                catalog,
                scheduler=scheduler_factory() if scheduler_factory else None,
                cost_model=self.cost_model,
                cache_capacity=caps[sid],
                control=control_factory() if control_factory else None,
                **engine_kwargs,
            )
            for sid in range(self.n_shards)
        ]
        # Router: decompose once, centrally; never services anything.
        self.router = WorkloadManager(
            catalog.partitioner.buckets_for_range,
            probe_bytes=self.cost_model.probe_bytes,
            min_unit_bytes=self.cost_model.min_unit_bytes,
        )
        self._locks = [threading.Lock() for _ in range(self.n_shards)]
        self._steal_lock = threading.Lock()
        # Drain-thread fault channel: a thread that dies mid-drain records
        # (shard id, exception) here and trips the abort flag so sibling
        # shards stop instead of spinning/stealing against a dead peer;
        # ``run`` re-raises at join time with the originating shard id.
        self._drain_errors: list[tuple[int, BaseException]] = []
        self._abort = threading.Event()

    # -- intake ----------------------------------------------------------------
    def submit(self, query: Query) -> None:
        per_bucket = self.router.decompose(query)
        slices: dict[int, dict[int, object]] = {}
        for b, idx in per_bucket.items():
            slices.setdefault(self.shard_map.shard_of(b), {})[b] = idx
        if not slices:
            # No matching buckets: shard 0 records the empty completion.
            self.engines[0].submit_decomposed(query, {})
            return
        for sid, sl in slices.items():
            self.engines[sid].submit_decomposed(query, sl)

    # -- threaded drain --------------------------------------------------------
    def run(self, queries: Sequence[Query]) -> dict[int, list[MatchResult]]:
        """Admit the whole trace, drain every shard on its own thread,
        merge per-shard result lists per query."""
        for q in sorted(queries, key=lambda q: q.arrival_time):
            for eng in self.engines:
                eng.sim_clock = max(eng.sim_clock, q.arrival_time)
            self.submit(q)
        threads = [
            threading.Thread(target=self._drain_guard, args=(sid,), daemon=True)
            for sid in range(self.n_shards)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for eng in self.engines:
            eng.close()
        if self._drain_errors:
            sid, exc = self._drain_errors[0]
            raise RuntimeError(
                f"shard {sid} drain thread died: {exc!r}"
            ) from exc
        return self.collect_results()

    def _drain_guard(self, sid: int) -> None:
        """Exception fence around one shard's drain loop: locks are
        released by their ``with`` blocks, the failure is recorded with
        its shard id, and the abort flag stops the sibling loops so the
        join in ``run`` returns instead of waiting on steals from a dead
        shard."""
        try:
            self._drain(sid)
        except BaseException as exc:  # noqa: BLE001 — re-raised at join
            self._drain_errors.append((sid, exc))
            self._abort.set()

    def _drain(self, sid: int) -> None:
        eng = self.engines[sid]
        while not self._abort.is_set():
            with self._locks[sid]:
                serviced = eng.step()
            if serviced is not None:
                continue
            if self.steal is not None and self._try_steal(sid):
                continue
            return

    def _try_steal(self, thief_id: int) -> bool:
        """One steal attempt by an idle shard.  Victim choice happens
        under the steal lock (serialized decisions); the migration itself
        holds both shard locks so neither loop can be mid-round."""
        cfg = self.steal
        with self._steal_lock:
            thief = self.engines[thief_id]
            if thief.wm.pending_bytes() > cfg.low_water_bytes:
                return False
            victims = [
                s
                for s in range(self.n_shards)
                if s != thief_id
                and len(self.engines[s].wm.nonempty_queues())
                >= cfg.min_victim_queues
            ]
            if not victims:
                return False
            vid = max(
                victims,
                key=lambda s: (self.engines[s].wm.pending_bytes(), -s),
            )
            victim = self.engines[vid]
            lo, hi = sorted((thief_id, vid))
            with self._locks[lo], self._locks[hi]:
                bucket_id = self._victim_top_bucket(victim)
                if bucket_id is None:
                    return False
                units = victim.wm.migrate_out(bucket_id)
                if not units:
                    return False
                if hasattr(victim.scheduler, "forget"):
                    victim.scheduler.forget(bucket_id)
                reclaimed = 0.0
                if victim.loop.prefetch is not None:
                    reclaimed = victim.loop.prefetch.cancel(
                        bucket_id, victim.loop.clock
                    )
                qids = sorted({u.query_id for u in units})
                qmap = {
                    q: victim.wm.queries[q]
                    for q in qids
                    if q in victim.wm.queries
                }
                thief.wm.migrate_in(units, qmap)
                self.shard_map.reassign(bucket_id, thief_id)
                thief.sim_clock = max(
                    thief.sim_clock, max(u.arrival_time for u in units)
                )
                for q in qmap.values():
                    thief.results.setdefault(q.query_id, [])
                    meta = q.meta or {}
                    if "radius" in meta or "mag_cut" in meta:
                        thief._has_query_predicates = True
                self.steals.append(
                    StealEvent(
                        bucket_id=bucket_id,
                        victim=vid,
                        thief=thief_id,
                        n_units=len(units),
                        nbytes=float(sum(u.nbytes for u in units)),
                        reclaimed_stage_s=reclaimed,
                        clock=thief.sim_clock,
                    )
                )
                return True

    @staticmethod
    def _victim_top_bucket(victim: CrossMatchEngine) -> Optional[int]:
        peek = getattr(victim.scheduler, "peek_topk", None)
        if peek is not None:
            top = peek(victim.wm, victim.cache, victim.loop.clock, 1)
            return top[0].bucket_id if top else None
        queues = victim.wm.nonempty_queues()
        if not queues:
            return None
        return max(queues, key=lambda q: (q.nbytes, -q.bucket_id)).bucket_id

    # -- results / metrics -----------------------------------------------------
    def collect_results(self) -> dict[int, list[MatchResult]]:
        merged: dict[int, list[MatchResult]] = {}
        for eng in self.engines:
            for qid, lst in eng.results.items():
                merged.setdefault(qid, []).extend(lst)
        return merged

    def response_times(self) -> dict[int, float]:
        """Per-query latency: the slowest shard's completion (the join)."""
        out: dict[int, float] = {}
        for eng in self.engines:
            for qid, t in eng.wm.response_times().items():
                out[qid] = max(out.get(qid, 0.0), t)
        return out

    def summary(self) -> dict:
        rt = self.response_times()
        hits = sum(eng.cache.stats.hits for eng in self.engines)
        accesses = sum(eng.cache.stats.accesses for eng in self.engines)
        return {
            "n_queries": len(rt),
            "n_shards": self.n_shards,
            "n_batches": sum(eng.batches for eng in self.engines),
            "n_dispatches": sum(eng.dispatches for eng in self.engines),
            "mean_response": float(np.mean(list(rt.values()))) if rt else 0.0,
            "cache_hit_rate": hits / accesses if accesses else 0.0,
            "makespan": max(eng.sim_clock for eng in self.engines),
            "steals": len(self.steals),
        }
