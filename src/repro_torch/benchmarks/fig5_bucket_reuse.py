"""Paper Fig. 5: top-ten buckets by reuse -- the workload's suitability for
batching.  Paper: the top 10 buckets are accessed by 61% of all queries and
temporally-close queries overlap (which benefits caching).

The port of ``benchmarks/fig5_bucket_reuse.py`` (host only: the trace's
statistics).  ``python -m repro_torch.benchmarks.fig5_bucket_reuse``"""
from __future__ import annotations

import argparse

import numpy as np

from ..crossmatch import workload_stats
from ..device import resolve_device
from .common import device_record, emit, workload, write_report

__all__ = ["stats", "run", "main"]

_STATS_CACHE: dict = {}


def stats():
    if "s" not in _STATS_CACHE:
        cat, trace = workload()
        _STATS_CACHE["s"] = (
            workload_stats(trace, cat.partitioner.buckets_for_range, cat.n_buckets,
                           bucket_of_keys=cat.partitioner.bucket_of_keys),
            cat,
            trace,
        )
    return _STATS_CACHE["s"]


def run(verbose: bool = True, device=None,
        out_path: str | None = "BENCH_torch_fig5_bucket_reuse.json") -> dict:
    dev = resolve_device(device)
    s, cat, trace = stats()
    touch = np.sort(s["touch"])[::-1]
    if verbose:
        print("  top-10 buckets by #queries touching them:", touch[:10].tolist())
        print(f"  fraction of queries touching a top-10 bucket: "
              f"{s['top10_query_frac']:.2%} (paper: 61%)")
    emit(
        "fig5_bucket_reuse", 0.0,
        f"top10_query_frac={s['top10_query_frac']:.3f};paper=0.61",
    )
    report = {
        "top10_touch": touch[:10].tolist(),
        "top10_query_frac": s["top10_query_frac"],
        "bucket_frac_for_50pct": s["bucket_frac_for_50pct"],
        "gini_load": s["gini_load"],
        "device": device_record(dev),
    }
    if out_path:
        write_report(out_path, report)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default="BENCH_torch_fig5_bucket_reuse.json")
    args, _ = ap.parse_known_args(argv)
    return run(device=args.device, out_path=args.out)


if __name__ == "__main__":
    main()
