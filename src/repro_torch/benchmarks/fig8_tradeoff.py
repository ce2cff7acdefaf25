"""Paper Fig. 8 + Fig. 4: throughput/response trade-off curves by workload
saturation, and the resulting adaptive-alpha selection (paper §4).

The port of ``benchmarks/fig8_tradeoff.py`` (host only: the simulator).
Paper anchors: at 0.1 qps, alpha 0 -> 1 cuts response ~54% for ~7%
throughput; at 0.5 qps the same move is unattractive (~20% for ~20%).
The produced TradeoffTable drives AlphaController (tolerance=0.2).

``python -m repro_torch.benchmarks.fig8_tradeoff``"""
from __future__ import annotations

import argparse

from ..core import AlphaController, TradeoffPoint, TradeoffTable, run_policy
from ..device import resolve_device
from .common import CACHE_CAPACITY, COST, device_record, emit, workload, write_report

__all__ = ["ALPHAS", "SATURATIONS", "run", "main"]

ALPHAS = (0.0, 0.25, 0.5, 0.75, 1.0)
SATURATIONS = (0.1, 0.25, 0.5)


def run(verbose: bool = True, n_queries: int = 800, device=None,
        out_path: str | None = "BENCH_torch_fig8_tradeoff.json") -> dict:
    dev = resolve_device(device)
    table = TradeoffTable()
    points = {}
    for sat in SATURATIONS:
        cat, trace = workload(n_queries=n_queries, arrival_rate=sat, seed=13)
        bor = cat.partitioner.buckets_for_range
        pts = []
        for a in ALPHAS:
            r = run_policy("liferaft", trace, bor, COST, alpha=a,
                           cache_capacity=CACHE_CAPACITY,
                           bucket_of_keys=cat.partitioner.bucket_of_keys)
            pts.append(TradeoffPoint(a, r.query_throughput, r.mean_response))
        table.add(sat, pts)
        tmax = max(p.throughput for p in pts)
        rmax = max(p.response for p in pts)
        points[str(sat)] = [{"alpha": p.alpha, "throughput": p.throughput,
                             "response": p.response} for p in pts]
        if verbose:
            print(f"  saturation={sat} qps:")
            for p in pts:
                print(
                    f"    alpha={p.alpha:4.2f} throughput={p.throughput / tmax:6.3f} "
                    f"response={p.response / rmax:6.3f}  (abs {p.throughput:.4f}/s, {p.response:.0f}s)"
                )
    # Adaptive selection per the paper's tolerance rule
    choices = {s: table.select_alpha(s, tolerance=0.2) for s in SATURATIONS}
    ctl = AlphaController(table, tolerance=0.2, initial_alpha=0.0, halflife_s=30.0)
    a = 0.0
    for t in range(40):
        a = ctl.update_on_arrival(t * 10.0)  # 0.1 qps arrivals
    if verbose:
        print(f"  alpha choices @ 20% tolerance: {choices} (paper: 1.0 @ low, 0.25 @ high)")
        print(f"  controller drifted to alpha={a:.2f} under 0.1 qps arrivals")
    lo, hi = min(SATURATIONS), max(SATURATIONS)
    emit(
        "fig8_tradeoff", 0.0,
        f"alpha_low_sat={choices[lo]};alpha_high_sat={choices[hi]};"
        f"paper_low=1.0;paper_high=0.25",
    )
    report = {
        "n_queries": n_queries,
        "points": points,
        "alpha_choices": {str(s): c for s, c in choices.items()},
        "controller_alpha": a,
        "device": device_record(dev),
    }
    if out_path:
        write_report(out_path, report)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default="BENCH_torch_fig8_tradeoff.json")
    args, _ = ap.parse_known_args(argv)
    return run(device=args.device, out_path=args.out)


if __name__ == "__main__":
    main()
