"""Paper Fig. 6: cumulative workload by bucket.  Paper: 2% of buckets
capture 50% of the workload; the long tail is what starves under greedy.

The port of ``benchmarks/fig6_workload_cdf.py`` (host only).
``python -m repro_torch.benchmarks.fig6_workload_cdf``"""
from __future__ import annotations

import argparse

import numpy as np

from ..device import resolve_device
from .common import device_record, emit, write_report
from .fig5_bucket_reuse import stats

__all__ = ["run", "main"]


def run(verbose: bool = True, device=None,
        out_path: str | None = "BENCH_torch_fig6_workload_cdf.json") -> dict:
    dev = resolve_device(device)
    s, cat, trace = stats()
    load = np.sort(s["load"])[::-1].astype(np.float64)
    csum = np.cumsum(load) / max(load.sum(), 1)
    marks = {}
    for frac in (0.25, 0.5, 0.75, 0.9):
        k = int(np.searchsorted(csum, frac)) + 1
        marks[frac] = k / cat.n_buckets
    if verbose:
        for frac, bucket_frac in marks.items():
            print(f"  {bucket_frac:7.2%} of buckets capture {frac:.0%} of workload")
        print(f"  (paper: 2% of buckets capture 50%)  gini={s['gini_load']:.3f}")
    emit(
        "fig6_workload_cdf", 0.0,
        f"bucket_frac_for_50pct={marks[0.5]:.4f};paper=0.02;gini={s['gini_load']:.3f}",
    )
    report = {
        "bucket_frac_by_workload_frac": {str(k): v for k, v in marks.items()},
        "gini_load": s["gini_load"],
        "device": device_record(dev),
    }
    if out_path:
        write_report(out_path, report)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default="BENCH_torch_fig6_workload_cdf.json")
    args, _ = ap.parse_known_args(argv)
    return run(device=args.device, out_path=args.out)


if __name__ == "__main__":
    main()
