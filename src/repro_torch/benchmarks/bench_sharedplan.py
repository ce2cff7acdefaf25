"""BENCH_sharedplan: shared query plans vs per-predicate dispatch.

The port of ``benchmarks/bench_sharedplan.py``.  Emits
``BENCH_torch_sharedplan.json`` with three measurements:

1. ``device_dispatch_reduction`` — a high-overlap cross-match trace
   (few hotspots, high temporal locality) with heterogeneous per-query
   predicates, run with ``shared_plan`` off (one kernel per predicate
   class per round) and on (one masked kernel per width chunk).
   Acceptance: >= 2x fewer device dispatches AND bit-equal per-query
   results (best_dot compared at the float32 bit level).
   On ``cuda`` the per-predicate run joins through K1 (the engine's
   per-predicate path: one single-bucket call a bucket and threshold) and
   the shared run through K3 (a threshold a probe), instances of one
   segment kernel with the same ``__fmaf_rn`` chain.
2. ``compile_bounding`` — K distinct predicates through one shared call
   at a fixed pow2 shape pair (41 -> 64 bucket rows, 11 -> 16 probes) add
   exactly one padded-shape key (``ops.ShapeLog``), the counterpart of the
   reference's jit-cache entry (``bench_scheduler`` says why).
3. ``share_width_law`` — informational: the AIMD ``share_width`` law on
   the simulator (final width, occupancy trajectory endpoints).

Run: ``python -m repro_torch.benchmarks.bench_sharedplan [--device cpu] [--out PATH]``
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

import torch

from ..core import ControlConfig, ControlLoop, CostModel, run_policy
from ..core.workload import Query
from ..crossmatch import CrossMatchEngine, TraceConfig, make_catalog, make_trace
from ..device import resolve_device
from ..kernels.crossmatch import ops as cm_ops
from .common import device_record, emit

DISPATCH_GATE = 2.0

RADII = [2e-3, 4e-3, 8e-3]
MAG_CUTS = [23.0, 24.0, 25.0]


def _identity_range(lo, hi):
    return np.arange(lo, hi + 1)


def _overlap_workload(seed=17):
    """High-overlap regime: 4 hotspots, strong temporal locality, so many
    live queries land on the same buckets each round — the one-stone
    sharing opportunity the paper's batch windows create."""
    catalog = make_catalog(
        n_objects=6_000, objects_per_bucket=100, htm_level=6, seed=seed
    )
    trace = make_trace(
        catalog,
        TraceConfig(
            n_queries=48, arrival_rate=6.0, n_hotspots=4, zipf_s=1.2,
            hotspot_frac=0.95, temporal_locality=0.85, objects_median=60,
            objects_sigma=0.6, cone_radius_med=0.04, fullsky_frac=0.0,
            seed=seed + 2,
        ),
    )
    rng = np.random.default_rng(seed + 4)
    for q in trace:
        q.meta["radius"] = float(rng.choice(RADII))
        q.meta["mag_cut"] = float(rng.choice(MAG_CUTS))
    return catalog, trace


def _results_bit_equal(a, b) -> bool:
    if set(a) != set(b):
        return False
    key = lambda r: int(r.probe_idx.min()) if len(r.probe_idx) else -1
    for qid in a:
        ra, rb = sorted(a[qid], key=key), sorted(b[qid], key=key)
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if not (
                np.array_equal(x.probe_idx, y.probe_idx)
                and np.array_equal(x.match_obj, y.match_obj)
                and np.array_equal(
                    x.best_dot.astype(np.float32).view(np.int32),
                    y.best_dot.astype(np.float32).view(np.int32),
                )
                and np.array_equal(x.n_candidates, y.n_candidates)
            ):
                return False
    return True


# -------------------------------------------- 1. device dispatch reduction
def bench_dispatch_reduction(seed=17, device=None) -> dict:
    dev = resolve_device(device)

    def run(shared):
        catalog, trace = _overlap_workload(seed)
        eng = CrossMatchEngine(
            catalog, match_radius_rad=4e-3, fuse_k=4,
            shared_plan=shared, share_width=16, device=dev,
        )
        results = eng.run(trace)
        return results, eng.summary()

    res_off, sum_off = run(False)
    res_on, sum_on = run(True)
    off_d = int(sum_off["device_dispatches"])
    on_d = int(sum_on["device_dispatches"])
    reduction = off_d / max(on_d, 1)
    equal = _results_bit_equal(res_off, res_on)
    return {
        "trace_queries": 48,
        "predicate_classes": len(RADII),
        "per_predicate_dispatches": off_d,
        "shared_dispatches": on_d,
        "reduction": reduction,
        "shared_batch_occupancy": sum_on["shared_batch_occupancy"],
        "results_bit_equal": equal,
        "gate": DISPATCH_GATE,
        "passed": bool(equal and reduction >= DISPATCH_GATE),
    }


# ------------------------------------------------- 2. compile bounding
def bench_compile_bounding(k=8, device=None) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    v = rng.normal(size=(41, 3))  # pads to 64
    bucket = v / np.linalg.norm(v, axis=1, keepdims=True)
    with cm_ops.ShapeLog() as log:
        for i in range(k):
            p = rng.normal(size=(11, 3))  # pads to 16
            probes = p / np.linalg.norm(p, axis=1, keepdims=True)
            thr = np.full(11, 0.9 + 0.005 * i, np.float32)
            cm_ops.crossmatch_shared(bucket, probes, np.zeros(41),
                                     np.zeros(11), thr, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    new_entries = len(log.padded)
    return {
        "distinct_predicates": k,
        "new_cache_entries": new_entries,
        "bounded": new_entries <= 1,
    }


# ------------------------------------------------- 3. share_width AIMD law
def bench_width_law(seed=43) -> dict:
    rng = np.random.default_rng(seed)
    qs, t = [], 0.0
    for qid in range(200):
        t += float(rng.exponential(0.02))
        b = int(rng.integers(0, 50))
        ks = np.full(int(rng.integers(1, 14)), b, dtype=np.uint64)
        qs.append(Query(qid, t, ks, ks))
    widths = []
    ctl = ControlLoop(ControlConfig(
        alpha_init=0.5, alpha_step=0.2, halflife_s=3.0, rate_knee=6.0,
        depth_knee=500.0, fuse_k_max=4, share_width_init=2, share_width_max=8,
    ))
    r = run_policy(
        "liferaft", qs, _identity_range, CostModel(T_b=0.8, T_m=2e-4),
        cache_capacity=8, normalized=True, control=ctl,
        shared_plan=True, share_width=2,
        on_round=lambda o: widths.append(int(o.vector.share_width)),
    )
    return {
        "initial_width": widths[0] if widths else 0,
        "final_width": widths[-1] if widths else 0,
        "max_width": max(widths, default=0),
        "device_dispatches": r.device_dispatches,
        "shared_batch_occupancy": r.shared_batch_occupancy,
    }


def run(out_path: str = "BENCH_torch_sharedplan.json", verbose: bool = True,
        device=None) -> dict:
    dev = resolve_device(device)
    report = {
        "device_dispatch_reduction": bench_dispatch_reduction(device=dev),
        "compile_bounding": bench_compile_bounding(device=dev),
        "share_width_law": bench_width_law(),
        "device": device_record(dev),
    }
    dr = report["device_dispatch_reduction"]
    cb = report["compile_bounding"]
    wl = report["share_width_law"]
    pathlib.Path(out_path).write_text(json.dumps(report, indent=2) + "\n")
    if verbose:
        print(
            f"  device dispatches: {dr['per_predicate_dispatches']} -> "
            f"{dr['shared_dispatches']} ({dr['reduction']:.2f}x, gate "
            f"{dr['gate']}x; bit-equal={dr['results_bit_equal']}, "
            f"occupancy {dr['shared_batch_occupancy']:.2f})"
        )
        print(
            f"  compile bounding: {cb['distinct_predicates']} predicates -> "
            f"{cb['new_cache_entries']} cache entries"
        )
        print(
            f"  share_width law: {wl['initial_width']} -> {wl['final_width']} "
            f"(max {wl['max_width']})"
        )
        print(f"  wrote {out_path}")
    emit(
        "bench_sharedplan",
        dr["reduction"],
        f"reduction={dr['reduction']:.2f}x;bit_equal={int(dr['results_bit_equal'])}",
    )
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    ap.add_argument("--out", default="BENCH_torch_sharedplan.json")
    args, _ = ap.parse_known_args(argv)
    report = run(args.out, device=args.device)
    assert report["device_dispatch_reduction"]["passed"], report[
        "device_dispatch_reduction"
    ]
    assert report["compile_bounding"]["bounded"], report["compile_bounding"]


if __name__ == "__main__":
    main()
