"""Paper Fig. 7: query throughput + response time by scheduling algorithm.

The port of ``benchmarks/fig7_schedulers.py`` (host only: the simulator).
Claims validated (paper §5.2):
  * LifeRaft greedy (alpha=0) >= ~2x NoShare query throughput (Fig. 7a)
  * RR ~ LifeRaft(alpha=1) throughput (neither models contention)
  * NoShare has the WORST mean response time (Fig. 7b)
  * greedy response ~ 2x the pure age-based scheduler (last-mile effect)
  * cache hit-rate gap: ~40% (alpha=0) vs ~7% (alpha=1) (paper §6)

``python -m repro_torch.benchmarks.fig7_schedulers``
"""
from __future__ import annotations

import argparse

from ..core import run_policy
from ..device import resolve_device
from .common import CACHE_CAPACITY, COST, device_record, emit, workload, write_report

__all__ = ["run", "main"]


def run(verbose: bool = True, device=None,
        out_path: str | None = "BENCH_torch_fig7_schedulers.json") -> dict:
    dev = resolve_device(device)
    cat, trace = workload()
    bor = cat.partitioner.buckets_for_range
    rows = {}
    plans = [("noshare", 0.0), ("rr", 0.0)] + [
        ("liferaft", a) for a in (0.0, 0.25, 0.5, 0.75, 1.0)
    ]
    for pol, a in plans:
        r = run_policy(pol, trace, bor, COST, alpha=a, cache_capacity=CACHE_CAPACITY,
                       bucket_of_keys=cat.partitioner.bucket_of_keys)
        rows[r.policy] = r
        if verbose:
            print(
                f"  {r.policy:18s} qtp={r.query_throughput:7.4f}/s "
                f"resp={r.mean_response:9.1f}s p95={r.p95_response:9.1f}s "
                f"std={r.std_response:8.1f} hit={r.cache_hit_rate:5.3f} "
                f"batches={r.n_batches}"
            )
    g, ns = rows["liferaft(a=0)"], rows["noshare"]
    ordered, rr = rows["liferaft(a=1)"], rows["rr"]
    derived = (
        f"greedy/noshare_throughput={g.query_throughput / ns.query_throughput:.2f}x;"
        f"rr_vs_a1={rr.query_throughput / ordered.query_throughput:.2f};"
        f"noshare_worst_resp={ns.mean_response >= max(r.mean_response for r in rows.values()) - 1e-9};"
        f"greedy_resp/a1_resp={g.mean_response / max(ordered.mean_response, 1e-9):.2f};"
        f"hit_a0={g.cache_hit_rate:.2f};hit_a1={ordered.cache_hit_rate:.2f}"
    )
    emit("fig7_schedulers", 0.0, derived)
    report = {
        "policies": {k: r.row() for k, r in rows.items()},
        "derived": derived,
        "device": device_record(dev),
    }
    if out_path:
        write_report(out_path, report)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default="BENCH_torch_fig7_schedulers.json")
    args, _ = ap.parse_known_args(argv)
    return run(device=args.device, out_path=args.out)


if __name__ == "__main__":
    main()
