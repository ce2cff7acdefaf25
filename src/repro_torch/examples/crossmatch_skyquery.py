"""End-to-end cross-match: real join compute through the LifeRaft engine.

The port of ``examples/crossmatch_skyquery.py``.  Unlike quickstart.py
(pure scheduling simulation), this drives the full Fig. 3 architecture:
Query Pre-Processor -> Workload Manager -> LifeRaft Scheduler -> Join
Evaluator (the cross-match kernel) -> Bucket Cache, and reports both
scheduling metrics and actual match results.  On ``cuda`` every join is a
launch of the port's kernel (``fuse_k=1``: the single-bucket join K1); on
``cpu`` its plain PyTorch version.  The summary goes to stdout and, with
the device and the run's wall, to ``--out``.

    python -m repro_torch.examples.crossmatch_skyquery [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..benchmarks.common import device_record, write_report
from ..core import CostModel, HybridCostModel, HybridPlanner, LifeRaftScheduler
from ..crossmatch import CrossMatchEngine, TraceConfig, make_catalog, make_trace
from ..device import resolve_device

__all__ = ["make_engine", "run", "main"]

RADIUS = 5e-3


def make_engine(device, alpha: float = 0.25) -> CrossMatchEngine:
    cat = make_catalog(n_objects=40_000, objects_per_bucket=400, htm_level=8,
                       seed=3)
    cost = CostModel(T_b=1.2, T_m=0.13e-3)
    hybrid = HybridPlanner(
        HybridCostModel(T_b=1.2, T_m=0.13e-3, T_probe=4.13e-3),
        objects_per_bucket=400,
    )
    return CrossMatchEngine(
        cat,
        scheduler=LifeRaftScheduler(cost, alpha=alpha),
        cost_model=cost,
        cache_capacity=20,
        match_radius_rad=RADIUS,
        hybrid=hybrid,
        device=device,
    )


def run(queries: int = 60, alpha: float = 0.25, device=None,
        out_path: str | None = "BENCH_torch_crossmatch_skyquery.json",
        verbose: bool = True) -> dict:
    """Run the example; returns its report."""
    dev = resolve_device(device)
    engine = make_engine(dev, alpha)
    trace = make_trace(
        engine.catalog, TraceConfig(n_queries=queries, arrival_rate=1.0,
                                    objects_median=200, seed=4),
    )
    if verbose:
        print(f"running {len(trace)} cross-match queries "
              f"({dev.type} join path)...")
    t0 = time.perf_counter()
    results = engine.run(trace)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_matches = sum(len(r.probe_idx) for groups in results.values()
                    for r in groups)
    s = engine.summary()
    # probabilistic-join sanity: matched pairs really are within the radius
    dots = [float(r.best_dot.min()) for groups in results.values()
            for r in groups if len(r.best_dot)]
    report = {
        "queries": queries,
        "summary": s,
        "matched_objects": n_matches,
        "min_matched_cos": min(dots) if dots else None,
        "threshold_cos": float(np.cos(RADIUS)),
        "wall_s": wall,
        "device": device_record(dev),
    }
    if verbose:
        print(f"  queries completed : {s['n_queries']}")
        print(f"  bucket batches    : {s['n_batches']}")
        print(f"  matched objects   : {n_matches}")
        print(f"  mean response     : {s['mean_response']:.1f}s (simulated)")
        print(f"  cache hit rate    : {s['cache_hit_rate']:.2f}")
        if dots:
            print(f"  min matched cos   : {min(dots):.6f} "
                  f"(threshold {np.cos(RADIUS):.6f})")
    if out_path:
        write_report(out_path, report)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (the kernels; needs a card) or cpu (their "
                         "plain versions)")
    ap.add_argument("--queries", type=int, default=60)
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--out", default="BENCH_torch_crossmatch_skyquery.json")
    args = ap.parse_args(argv)
    return run(args.queries, args.alpha, args.device, args.out)


if __name__ == "__main__":
    main()
