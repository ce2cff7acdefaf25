"""SkyQuery-like query trace generation + workload statistics.

The paper's trace (§5.1): 2,000 long-running cross-match queries; the top
ten buckets are reused by 61% of queries (Fig. 5); 2% of buckets capture
50% of the workload (Fig. 6); temporally-close queries overlap in data
access.  ``make_trace`` generates traces with those properties (hotspot
Zipf popularity + temporal locality + Poisson/bursty arrivals) and
``workload_stats`` verifies them.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.sfc import htm_id, _normalize
from ..core.workload import Query
from .catalog import SkyCatalog

__all__ = ["TraceConfig", "make_trace", "workload_stats", "cone_sample"]


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_queries: int = 2_000
    arrival_rate: float = 0.25  # queries/sec (the paper's 'saturation')
    bursty: bool = False  # Markov-modulated burst arrivals
    burst_factor: float = 8.0
    burst_p: float = 0.05  # P(enter burst) per arrival
    # Query shape
    n_hotspots: int = 32
    zipf_s: float = 1.4  # hotspot popularity exponent
    hotspot_frac: float = 0.75  # queries targeting a hotspot (vs random sky)
    temporal_locality: float = 0.6  # P(reuse previous query's hotspot)
    objects_median: int = 400
    objects_sigma: float = 1.0  # lognormal sigma for per-query object count
    cone_radius_med: float = 0.06  # radians
    fullsky_frac: float = 0.04  # long 'navigate the entire sky' queries
    match_level_offset: int = 2  # bounding range = ancestor trixel this much coarser
    seed: int = 0


def cone_sample(center: np.ndarray, radius: float, n: int, rng) -> np.ndarray:
    """Uniform sample of ``n`` unit vectors within angular ``radius`` of center."""
    z = rng.uniform(np.cos(radius), 1.0, size=n)
    phi = rng.uniform(0.0, 2 * np.pi, size=n)
    r = np.sqrt(1 - z**2)
    local = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)
    # Rotate +z to center.
    c = center / np.linalg.norm(center)
    if abs(c[2]) > 0.9999:
        return local if c[2] > 0 else local * np.array([1.0, 1.0, -1.0])
    axis = np.cross([0.0, 0.0, 1.0], c)
    axis = axis / np.linalg.norm(axis)
    ang = np.arccos(np.clip(c[2], -1, 1))
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
    return _normalize(local @ R.T)


def _zipf_probs(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


def make_trace(catalog: SkyCatalog, cfg: TraceConfig = TraceConfig()) -> list[Query]:
    """Generate a cross-match trace against ``catalog``.

    Each query carries the probe objects' unit vectors (payload) and
    per-object HTM bounding ranges; the WorkloadManager maps these to
    buckets via the catalog partitioner.
    """
    rng = np.random.default_rng(cfg.seed)
    hot = _normalize(rng.normal(size=(cfg.n_hotspots, 3)))
    probs = _zipf_probs(cfg.n_hotspots, cfg.zipf_s)
    level = catalog.level
    shift = np.uint64(2 * cfg.match_level_offset)

    queries: list[Query] = []
    t = 0.0
    in_burst = False
    prev_hotspot = 0
    for qid in range(cfg.n_queries):
        # --- arrivals (Poisson, optionally Markov-modulated bursts) ---
        rate = cfg.arrival_rate * (cfg.burst_factor if in_burst else 1.0)
        t += rng.exponential(1.0 / rate)
        if cfg.bursty:
            if in_burst:
                in_burst = rng.random() > 0.3  # bursts are short
            else:
                in_burst = rng.random() < cfg.burst_p

        # --- spatial target ---
        fullsky = rng.random() < cfg.fullsky_frac
        if fullsky:
            n_obj = int(
                rng.lognormal(np.log(cfg.objects_median * 8), cfg.objects_sigma)
            )
            pos = _normalize(rng.normal(size=(max(n_obj, 1), 3)))
        else:
            if rng.random() < cfg.hotspot_frac:
                if rng.random() < cfg.temporal_locality:
                    h = prev_hotspot
                else:
                    h = int(rng.choice(cfg.n_hotspots, p=probs))
                prev_hotspot = h
                center = hot[h]
            else:
                center = _normalize(rng.normal(size=3))
            radius = rng.lognormal(np.log(cfg.cone_radius_med), 0.6)
            n_obj = int(rng.lognormal(np.log(cfg.objects_median), cfg.objects_sigma))
            pos = cone_sample(center, min(radius, np.pi), max(n_obj, 1), rng)

        ids = htm_id(pos, level=level)
        anc = ids >> shift
        lo = anc << shift
        hi = ((anc + np.uint64(1)) << shift) - np.uint64(1)
        queries.append(
            Query(
                query_id=qid,
                arrival_time=t,
                keys_lo=lo,
                keys_hi=hi,
                payload={"positions": pos},
                meta={"fullsky": fullsky},
            )
        )
    return queries


def workload_stats(
    queries: Sequence[Query], bucket_of_range, n_buckets: int,
    bucket_of_keys=None,
) -> dict:
    """Fig. 5 / Fig. 6 statistics for a trace.

    Returns top-10 bucket query-coverage fraction, the bucket fraction
    capturing 50% of workload objects, and the per-bucket histograms.
    """
    touch = np.zeros(n_buckets, dtype=np.int64)  # queries touching bucket
    load = np.zeros(n_buckets, dtype=np.int64)  # objects routed to bucket
    per_query_buckets: list[set[int]] = []
    for q in queries:
        bs: set[int] = set()
        if bucket_of_keys is not None and q.n_objects:
            lo_b = bucket_of_keys(q.keys_lo)
            hi_b = bucket_of_keys(q.keys_hi)
            simple = lo_b == hi_b
            np.add.at(load, lo_b[simple].astype(np.int64), 1)
            bs.update(np.unique(lo_b[simple]).astype(int).tolist())
            for i in np.nonzero(~simple)[0]:
                for b in range(int(lo_b[i]), int(hi_b[i]) + 1):
                    load[b] += 1
                    bs.add(b)
        else:
            for i in range(q.n_objects):
                for b in bucket_of_range(int(q.keys_lo[i]), int(q.keys_hi[i])):
                    load[int(b)] += 1
                    bs.add(int(b))
        for b in bs:
            touch[b] += 1
        per_query_buckets.append(bs)
    top10 = set(np.argsort(-touch)[:10].tolist())
    frac_queries_top10 = (
        sum(1 for bs in per_query_buckets if bs & top10) / max(len(queries), 1)
    )
    order = np.argsort(-load)
    csum = np.cumsum(load[order])
    total = max(int(csum[-1]), 1)
    k50 = int(np.searchsorted(csum, 0.5 * total)) + 1
    return {
        "touch": touch,
        "load": load,
        "top10_query_frac": frac_queries_top10,
        "bucket_frac_for_50pct": k50 / n_buckets,
        "gini_load": _gini(load),
    }


def _gini(x: np.ndarray) -> float:
    x = np.sort(np.asarray(x, dtype=np.float64))
    n = len(x)
    if n == 0 or x.sum() == 0:
        return 0.0
    cum = np.cumsum(x)
    return float((n + 1 - 2 * (cum / cum[-1]).sum()) / n)
