"""Driver harness -- one section per paper table/figure + system benches.

The port of ``benchmarks/run.py``.  Prints ``name,us_per_call,derived``
CSV lines (one per benchmark) between human-readable sections; each
section writes its ``BENCH_torch_*.json`` report into ``--out-dir``.
Roofline tables come from ``launch/dryrun.py`` artifacts (``build/dryrun``)
and are summarized by ``roofline_table``.  A failed section is reported and the harness
carries on; it exits non-zero if any failed.

    python -m repro_torch.benchmarks.run [--device cpu] [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args(argv)
    t0 = time.time()
    from . import (  # noqa: E402
        bench_adaptive,
        bench_obs,
        bench_prefetch,
        bench_scheduler,
        bench_shard,
        bench_sharedplan,
        fig2_hybrid_join,
        fig5_bucket_reuse,
        fig6_workload_cdf,
        fig7_schedulers,
        fig8_tradeoff,
        ft_bench,
        kernel_bench,
        roofline_table,
        serving_bench,
    )

    sections = [
        ("Fig.2 hybrid join (scan vs index break-even)", fig2_hybrid_join),
        ("Fig.5 bucket reuse (top-10 coverage)", fig5_bucket_reuse),
        ("Fig.6 cumulative workload CDF", fig6_workload_cdf),
        ("Fig.7 schedulers (throughput / response / cache)", fig7_schedulers),
        ("Fig.8 saturation trade-off + adaptive alpha", fig8_tradeoff),
        ("Scheduler hot path: incremental vs naive + compile counts", bench_scheduler),
        ("Adaptive control plane: closed loop vs best static alpha", bench_adaptive),
        ("Prefetch: scan-horizon staging vs reactive LRU", bench_prefetch),
        ("Shared plans: masked multi-query kernel vs per-predicate", bench_sharedplan),
        ("Sharding: multi-shard tier + work stealing vs one loop", bench_shard),
        ("Observability: obs-on/off overhead + snapshot/Perfetto artifacts", bench_obs),
        ("Serving: multi-tenant LifeRaft engine", serving_bench),
        ("Kernels: micro-benchmarks", kernel_bench),
        ("Fault tolerance: goodput under failures", ft_bench),
        ("Roofline: dry-run artifact summary", roofline_table),
    ]
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = 0
    for title, mod in sections:
        print(f"\n=== {title} ===", flush=True)
        name = mod.__name__.rsplit(".", 1)[1]
        report = name.replace("bench_", "") if name.startswith("bench_") else name
        argv_ = ["--out", str(out_dir / f"BENCH_torch_{report}.json")]
        if args.device is not None:
            argv_ += ["--device", args.device]
        try:
            mod.main(argv_)
        except Exception as e:  # keep the harness running
            failures += 1
            print(f"  BENCH-ERROR {title}: {type(e).__name__}: {e}", flush=True)
    print(f"\n[benchmarks] done in {time.time() - t0:.0f}s, failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
