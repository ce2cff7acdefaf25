"""The SkyQuery cross-match cell the port's card runs drive.

The paper's SDSS bucket width (10,000 objects a bucket) cut in depth to
100 buckets (1,000,000 objects), and a 200-query trace of 386k probe
objects; three engines over it:

* ``A``: ``fuse_k=1``, one bucket a round (the single-bucket join, K1);
* ``B``: ``fuse_k=4``, the top four buckets in one fused join (K2);
* ``C``: ``fuse_k=4`` with shared plans of width 8 and a radius and
  magnitude cut per query (the shared-plan join K3, and K1 for the
  members the hybrid planner sends to the index).

``chip_smoke.py`` drives all three on the card; the recovery drill
(``smoke_recovery``) runs C under the service daemon.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import CostModel, HybridCostModel, HybridPlanner, LifeRaftScheduler
from ..crossmatch import (
    CrossMatchEngine,
    TraceConfig,
    make_catalog,
    make_trace,
    queries_from_records,
)

__all__ = ["N_OBJECTS", "N_QUERIES", "make_skyquery_catalog", "trace_records",
           "make_engine", "queries_for"]

N_OBJECTS = 1_000_000
N_QUERIES = 200
OBJECTS_PER_BUCKET = 10_000


def make_skyquery_catalog(n_objects: int = N_OBJECTS):
    """The cell's catalog; ``n_objects`` below the default cuts its depth
    (fewer buckets of the same width)."""
    return make_catalog(n_objects=n_objects,
                        objects_per_bucket=OBJECTS_PER_BUCKET, htm_level=10,
                        seed=3)


def trace_records(cat, n_queries: int = N_QUERIES) -> list[dict]:
    """The cell's trace as plain records (``queries_for`` makes fresh
    queries of them for each run)."""
    trace = make_trace(cat, TraceConfig(n_queries=n_queries, arrival_rate=1.0,
                                        objects_median=1000, seed=4))
    return [dataclasses.asdict(q) for q in trace]


def make_engine(cat, kind: str, device, obs=None) -> CrossMatchEngine:
    """Engine ``kind`` (``A``, ``B`` or ``C``) of the cell on ``device``."""
    cost = CostModel(T_b=1.2, T_m=0.13e-3)
    hybrid = HybridPlanner(
        HybridCostModel(T_b=1.2, T_m=0.13e-3, T_probe=4.13e-3),
        objects_per_bucket=OBJECTS_PER_BUCKET,
    )
    extra = {
        "A": dict(fuse_k=1),
        "B": dict(fuse_k=4),
        "C": dict(fuse_k=4, shared_plan=True, share_width=8),
    }[kind]
    return CrossMatchEngine(
        cat, scheduler=LifeRaftScheduler(cost, alpha=0.25), cost_model=cost,
        cache_capacity=20, match_radius_rad=5e-3, hybrid=hybrid,
        device=device, obs=obs, **extra,
    )


def queries_for(records, kind: str, n: int):
    """Fresh queries of the first ``n`` records for one run of engine
    ``kind``; C's get a radius and a magnitude cut each (seeded, drawn in
    query order, so the first ``n`` get the same ones at any ``n``)."""
    qs = queries_from_records(records[:n])
    if kind == "C":
        rng = np.random.default_rng(5)
        for q in qs:
            q.meta["radius"] = float(rng.choice([2.5e-3, 5e-3, 1e-2]))
            q.meta["mag_cut"] = float(rng.choice([23.0, 24.0, 25.0]))
    return qs
