"""Quickstart: the LifeRaft scheduler in 40 lines.

The port of ``examples/quickstart.py``: builds a small bucketed sky
catalog, generates a SkyQuery-like query trace, and compares NoShare /
RR / LifeRaft schedulers on throughput and response time using the
paper's cost model.  Host only (the simulator); ``--device`` names where
the report says it ran and, as everywhere, must exist.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from ..benchmarks.common import device_record, write_report
from ..core import PAPER_COST_MODEL, run_policy
from ..crossmatch import TraceConfig, make_catalog, make_trace
from ..device import resolve_device

__all__ = ["run", "main"]


def run(device=None, out_path: str | None = "BENCH_torch_quickstart.json",
        verbose: bool = True) -> dict:
    dev = resolve_device(device)
    if verbose:
        print("building catalog (50k objects, 500 buckets)...")
    cat = make_catalog(n_objects=50_000, objects_per_bucket=100, htm_level=8)
    trace = make_trace(
        cat,
        TraceConfig(n_queries=400, arrival_rate=0.5, zipf_s=1.6, seed=1),
    )
    if verbose:
        print(f"replaying {len(trace)} queries under three schedulers:\n")
    bok = cat.partitioner.bucket_of_keys
    rows = []
    for policy, alpha in [("noshare", 0.0), ("rr", 0.0),
                          ("liferaft", 0.0), ("liferaft", 0.5)]:
        r = run_policy(
            policy, trace, cat.partitioner.buckets_for_range, PAPER_COST_MODEL,
            alpha=alpha, cache_capacity=20, bucket_of_keys=bok,
        )
        rows.append(r)
        if verbose:
            print(
                f"  {r.policy:16s} throughput={r.query_throughput:7.4f} q/s  "
                f"mean-response={r.mean_response:8.1f}s  "
                f"cache-hit={r.cache_hit_rate:.2f}"
            )
    base = rows[0].query_throughput
    best = max(rows, key=lambda r: r.query_throughput)
    speedup = best.query_throughput / base
    if verbose:
        print(f"\nLifeRaft speedup over NoShare: {speedup:.2f}x  "
              f"(paper reports ~2x)")
    report = {
        "policies": {r.policy: {"query_throughput": r.query_throughput,
                                "mean_response": r.mean_response,
                                "cache_hit_rate": r.cache_hit_rate}
                     for r in rows},
        "speedup_over_noshare": speedup,
        "device": device_record(dev),
    }
    if out_path:
        write_report(out_path, report)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    ap.add_argument("--out", default="BENCH_torch_quickstart.json")
    args = ap.parse_args(argv)
    return run(args.device, args.out)


if __name__ == "__main__":
    main()
