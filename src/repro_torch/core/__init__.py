"""repro_torch.core — the paper's contribution: data-driven batch scheduling.

The port's own copies of the JAX-free decision layer, the write-ahead
journal and the event-driven simulator; every module is held to the
same decision-log goldens as its counterpart in ``repro``.

Public surface:
  * space-filling curves (``sfc``): HTM trixel ids, Morton codes
  * ``Partitioner``/``BucketStore``: equal-count bucket partitioning
  * ``WorkloadManager``: query pre-processing into per-bucket work units
  * ``SpillQueue``: the shared §6 resident-prefix/spilled-suffix queue
    primitive both engines' workload queues are built on (``spillq``)
  * ``CostModel`` + Eq.1/Eq.2 metrics
  * ``BucketCache``: LRU residency (phi in Eq. 1)
  * schedulers: ``LifeRaftScheduler`` (alpha in [0,1]), ``RoundRobinScheduler``
  * ``HybridPlanner``: scan-vs-indexed per-batch plan (paper §3.4)
  * ``AlphaController``: workload-adaptive alpha (paper §4)
  * ``ControlLoop``/``ControlVector``: the closed-loop control plane that
    drives alpha, fuse_k and §6 spill from live telemetry (``control``)
  * ``DispatchLoop``: the one scheduling inner loop shared by both engines
    and the simulator (``dispatch``)
  * ``ScanPlanner``/``PrefetchPipeline``: the scan-horizon prefetch
    subsystem — commit the scheduler's next-H buckets in elevator-sweep
    order and stage their I/O ahead of compute (``scanplan``/``prefetch``)
  * ``ShardMap``/``ShardedDispatch``: the multi-shard execution tier —
    SFC-range bucket partitioning, shard-local dispatch loops, work
    stealing, and the ``ShardControlPlane`` global byte arbiter
    (``shard``)
  * ``simulate``: the event-driven harness behind Figs. 7/8
"""
from .bucket import BucketSpec, BucketStore, Partitioner
from .cache import BucketCache, CacheOverflowError, CacheStats
from .hybrid import HybridCostModel, HybridPlanner, JoinPlan
from .metrics import (
    PAPER_COST_MODEL,
    CostModel,
    aged_workload_throughput,
    dispatch_stats,
    per_tenant_latency,
    workload_throughput,
)
from .adaptive import AlphaController, SaturationEstimator, TradeoffPoint, TradeoffTable
from .control import (
    AdmissionController,
    AdmissionQuota,
    AdmissionRejected,
    ControlConfig,
    ControlLoop,
    ControlVector,
    ShardControlPlane,
    ShardGrant,
    Telemetry,
    TenantControlPlane,
    TenantPolicy,
    apply_spill,
    unspill_price,
    waterfill,
)
from .journal import (
    TRACE_SCHEMA_VERSION,
    Journal,
    JournalCorrupt,
    diff_entries,
    encode_outcome,
    encode_steal,
    format_entry,
    load_trace,
    save_trace,
)
from .dispatch import DispatchLoop, DispatchOutcome
from .prefetch import PrefetchConfig, PrefetchPipeline, build_pipeline
from .scanplan import ScanPlanConfig, ScanPlanner
from .scheduler import (
    LifeRaftScheduler,
    NaiveLifeRaftScheduler,
    OrderedScheduler,
    RoundRobinScheduler,
    SchedulerDecision,
)
from .shard import (
    ShardMap,
    ShardRuntime,
    ShardedDispatch,
    StealConfig,
    StealEvent,
    split_slots,
)
from .simulate import (
    SimResult,
    run_policy,
    simulate_batched,
    simulate_noshare,
    simulate_sharded,
)
from .spillq import SpillQueue
from .workload import Query, WorkloadManager, WorkloadQueue, WorkUnit
from . import sfc

__all__ = [
    "BucketSpec",
    "BucketStore",
    "Partitioner",
    "BucketCache",
    "CacheOverflowError",
    "CacheStats",
    "HybridCostModel",
    "HybridPlanner",
    "JoinPlan",
    "PAPER_COST_MODEL",
    "CostModel",
    "aged_workload_throughput",
    "dispatch_stats",
    "per_tenant_latency",
    "workload_throughput",
    "AlphaController",
    "SaturationEstimator",
    "TradeoffPoint",
    "TradeoffTable",
    "AdmissionController",
    "AdmissionQuota",
    "AdmissionRejected",
    "ControlConfig",
    "ControlLoop",
    "ControlVector",
    "Telemetry",
    "ShardControlPlane",
    "ShardGrant",
    "TenantControlPlane",
    "TenantPolicy",
    "apply_spill",
    "unspill_price",
    "waterfill",
    "SpillQueue",
    "DispatchLoop",
    "DispatchOutcome",
    "PrefetchConfig",
    "PrefetchPipeline",
    "build_pipeline",
    "ScanPlanConfig",
    "ScanPlanner",
    "LifeRaftScheduler",
    "NaiveLifeRaftScheduler",
    "OrderedScheduler",
    "RoundRobinScheduler",
    "SchedulerDecision",
    "ShardMap",
    "ShardRuntime",
    "ShardedDispatch",
    "StealConfig",
    "StealEvent",
    "split_slots",
    "TRACE_SCHEMA_VERSION",
    "Journal",
    "JournalCorrupt",
    "diff_entries",
    "encode_outcome",
    "encode_steal",
    "format_entry",
    "load_trace",
    "save_trace",
    "SimResult",
    "run_policy",
    "simulate_batched",
    "simulate_noshare",
    "simulate_sharded",
    "Query",
    "WorkloadManager",
    "WorkloadQueue",
    "WorkUnit",
    "sfc",
]
