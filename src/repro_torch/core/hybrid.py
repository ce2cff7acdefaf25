"""Hybrid join strategy (paper §3.4, Fig. 2).

Per scheduled bucket, choose between:
  * ``scan``    — one sequential pass over the whole bucket, cost
                  T_b*phi + T_m*|W|   (amortized, wins for big queues);
  * ``indexed`` — random index probes, cost |W| * T_probe
                  (wins for tiny queues; no bucket read at all).

The paper observes the break-even near |W| ~ 3% of the bucket size and up
to a 20x gap for 40 MB buckets.  We expose the analytic break-even and let
engines pick per-batch.  On the TPU side the same dichotomy is
dense-batched kernel vs sparse gather (``kernels/grouped_matmul`` hybrid
path).
"""
from __future__ import annotations

import dataclasses

from .metrics import CostModel

__all__ = ["HybridCostModel", "HybridPlanner", "JoinPlan"]


@dataclasses.dataclass(frozen=True)
class HybridCostModel(CostModel):
    """Extends the paper's (T_b, T_m) with an indexed-probe cost.

    ``T_probe`` is the per-object cost of an index lookup: a disk seek +
    small read in the paper; a sparse gather + small matmul on TPU.
    Defaults put the break-even at |W| = 3% * objects_per_bucket for the
    paper's SDSS constants (T_b=1.2s, 10k-object buckets):
        scan(W) = indexed(W)  =>  T_b + T_m*W = T_probe*W
        W* = T_b / (T_probe - T_m);  3% of 10k = 300 => T_probe ~ 4.13 ms.
    """

    T_probe: float = 4.13e-3
    # Fixed per-device-call overhead (kernel launch + host sync).  Zero by
    # default so single-bucket plans are unchanged; a shared plan amortizes
    # it across every scan member of the group (the third break-even axis).
    T_dispatch: float = 0.0

    def indexed_cost(self, queue_size: int) -> float:
        return self.T_probe * queue_size

    def scan_cost(self, queue_size: int, in_cache: bool) -> float:
        return self.batch_cost(queue_size, in_cache)

    def break_even_queue(self) -> float:
        """|W| above which a scan wins (cache-cold)."""
        denom = self.T_probe - self.T_m
        return float("inf") if denom <= 0 else self.T_b / denom


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    strategy: str  # "scan" | "indexed"
    est_cost: float
    queue_size: int
    in_cache: bool


class HybridPlanner:
    """Chooses the per-bucket plan; optionally pinned by a fixed threshold.

    ``threshold_frac``: if given, mimic the paper's pre-determined threshold
    (fraction of bucket object count); otherwise use the analytic costs.
    """

    def __init__(
        self,
        cost: HybridCostModel,
        objects_per_bucket: int,
        threshold_frac: float | None = None,
    ) -> None:
        self.cost = cost
        self.objects_per_bucket = objects_per_bucket
        self.threshold_frac = threshold_frac

    def plan(self, queue_size: int, in_cache: bool) -> JoinPlan:
        scan = self.cost.scan_cost(queue_size, in_cache)
        idx = self.cost.indexed_cost(queue_size)
        if self.threshold_frac is not None:
            use_scan = queue_size >= self.threshold_frac * self.objects_per_bucket
        else:
            # A cached bucket's scan has no T_b term and nearly always wins.
            use_scan = scan <= idx
        return JoinPlan(
            strategy="scan" if use_scan else "indexed",
            est_cost=scan if use_scan else idx,
            queue_size=queue_size,
            in_cache=in_cache,
        )

    def plan_group(
        self, members: list[tuple[int, bool]]
    ) -> list[JoinPlan]:
        """Shared-plan break-even: plan a whole fuse group at once.

        ``members`` is [(queue_size, in_cache), ...] for the buckets a
        shared device call would cover.  Scan members split ONE kernel
        launch, so each one's scan cost carries only ``T_dispatch / s``
        (s = number of scan members) while an indexed member pays the full
        ``T_dispatch`` for its private probe call — batching the query
        axis moves the scan-vs-indexed break-even toward scan as the group
        grows.  This is the plan's third axis: queue size, cache
        residency, and now group size.  With ``T_dispatch == 0`` (the
        default cost model) every decision matches per-member ``plan()``.

        Fixed point in one descending pass: members are ranked by how much
        scan beats indexed; a member joins the scan set only if it still
        prefers scan with the launch overhead split s ways *including
        itself*, and each join only further cheapens scan for the rest.
        """
        overhead = getattr(self.cost, "T_dispatch", 0.0)
        base = [
            (self.cost.scan_cost(qs, ic), self.cost.indexed_cost(qs), qs, ic)
            for qs, ic in members
        ]
        if overhead <= 0.0:
            return [self.plan(qs, ic) for qs, ic in members]
        order = sorted(range(len(base)), key=lambda i: base[i][0] - base[i][1])
        plans: list[JoinPlan | None] = [None] * len(base)
        scan_set: list[int] = []
        for i in order:
            scan, idx, qs, ic = base[i]
            s = len(scan_set) + 1
            if self.threshold_frac is not None:
                use_scan = qs >= self.threshold_frac * self.objects_per_bucket
            else:
                use_scan = scan + overhead / s <= idx + overhead
            if use_scan:
                scan_set.append(i)
        s = max(len(scan_set), 1)
        for i, (scan, idx, qs, ic) in enumerate(base):
            if i in scan_set:
                plans[i] = JoinPlan("scan", scan + overhead / s, qs, ic)
            else:
                plans[i] = JoinPlan("indexed", idx + overhead, qs, ic)
        return plans
