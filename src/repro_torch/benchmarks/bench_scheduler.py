"""BENCH_scheduler: the scheduling->execution hot path, before vs after.

The port of ``benchmarks/bench_scheduler.py``.  Emits
``BENCH_torch_scheduler.json`` with four measurements:

1. ``select_at_1k_buckets`` — per-decision cost of ``select()`` with ~1k
   nonempty bucket queues under submit churn: the naive O(B) rescan vs the
   incremental lazy-heap index (acceptance: >= 5x).
2. ``decision_equivalence`` — both schedulers replay the same 500-query
   SkyQuery-style trace in lockstep; every decision (bucket id AND score)
   must be bit-identical (acceptance: 0 mismatches).
3. ``compile_count`` — compile work while the cross-match engine runs the
   500-query trace with power-of-two shape bucketing.  The reference
   counts entries of JAX's jit cache.  The port compiles nothing per
   shape (one CUDA library takes every shape), so ``shapes_compiled``
   counts the distinct (join, pow2 bucket rows, pow2 probe rows, static
   arguments) the section's calls map to (``ops.ShapeLog``): the shapes
   the reference compiles from a cold cache, on either device
   (acceptance: <= log2(max probe batch) + 1).  On ``cuda`` the section also counts the kernel library's
   builds or loads (``library_loads``: 1 where the section loads it
   first, 0 after; acceptance <= 1) and the distinct launch shapes
   (``launch_shapes``: the card gets the real probe rows, so nearly one a
   batch size; informational).  ``within_bound`` holds both gates.
4. ``fused_dispatch`` — batches and rounds at ``fuse_k`` 1 and 4 (on the
   card each round one kernel launch).

Run: ``python -m repro_torch.benchmarks.bench_scheduler [--device cpu] [--out PATH]``
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import time

import numpy as np
import torch

from ..core import (
    BucketCache,
    CostModel,
    LifeRaftScheduler,
    NaiveLifeRaftScheduler,
    PAPER_COST_MODEL,
)
from ..core.workload import Query, WorkloadManager
from ..crossmatch import CrossMatchEngine, TraceConfig, make_catalog, make_trace
from ..device import resolve_device
from ..kernels.crossmatch import kernel as cm_kernel
from ..kernels.crossmatch import ops as cm_ops
from .common import device_record, emit


# ---------------------------------------------------------------- 1. select cost
def _identity_range(lo, hi):
    return np.arange(lo, hi + 1)


def _loaded_manager(n_buckets=1000, n_queries=3000, seed=0):
    wm = WorkloadManager(_identity_range)
    rng = np.random.default_rng(seed)
    for qid in range(n_queries):
        ks = rng.integers(0, int(n_buckets * 1.1), 5).astype(np.uint64)
        wm.submit(Query(qid, qid * 1e-3, ks, ks))
    return wm


def bench_select(n_buckets=1000, rounds=200, alpha=0.3) -> dict:
    out = {}
    for label, cls in (("naive", NaiveLifeRaftScheduler), ("incremental", LifeRaftScheduler)):
        wm = _loaded_manager(n_buckets)
        cache = BucketCache(20)
        sched = cls(CostModel(), alpha=alpha)
        rng = np.random.default_rng(1)
        sched.select(wm, cache, 3.0)  # bind / warm
        elapsed = 0.0
        qid = 10_000
        for r in range(rounds):
            now = 3.0 + r * 1e-3
            t0 = time.perf_counter()
            d = sched.select(wm, cache, now)
            elapsed += time.perf_counter() - t0
            # churn between decisions: a submit and a completion
            ks = rng.integers(0, 1100, 5).astype(np.uint64)
            wm.submit(Query(qid, now, ks, ks))
            qid += 1
            if r % 4 == 3:
                cache.access(d.bucket_id)
                wm.complete_bucket(d.bucket_id, now)
        out[f"{label}_us"] = elapsed / rounds * 1e6
        out[f"{label}_nonempty_buckets"] = len(wm.nonempty_queues())
    out["speedup"] = out["naive_us"] / out["incremental_us"]
    return out


# ------------------------------------------------------- 2. decision equivalence
def bench_equivalence(n_queries=500) -> dict:
    cat = make_catalog(n_objects=40_000, objects_per_bucket=128, htm_level=7, seed=3)
    trace = make_trace(
        cat,
        TraceConfig(n_queries=n_queries, arrival_rate=0.5, objects_median=150,
                    seed=17),
    )
    cost = PAPER_COST_MODEL
    sides = {}
    for label, cls in (("inc", LifeRaftScheduler), ("nai", NaiveLifeRaftScheduler)):
        sides[label] = dict(
            sched=cls(cost, alpha=0.25),
            wm=WorkloadManager(cat.partitioner.buckets_for_range,
                               cat.partitioner.bucket_of_keys),
            cache=BucketCache(20),
        )
    queries = sorted(trace, key=lambda q: q.arrival_time)
    clock, i, decisions, mismatches = 0.0, 0, 0, 0
    wm_i = sides["inc"]["wm"]
    while i < len(queries) or wm_i.n_pending_queries:
        if not wm_i.nonempty_queues():
            clock = max(clock, queries[i].arrival_time)
        while i < len(queries) and queries[i].arrival_time <= clock:
            for s in sides.values():
                s["wm"].submit(queries[i])
            i += 1
        ds = {
            k: s["sched"].select(s["wm"], s["cache"], clock)
            for k, s in sides.items()
        }
        if ds["inc"] is None and ds["nai"] is None:
            continue
        decisions += 1
        if ds["inc"] is None or ds["nai"] is None:
            # One-sided idle is itself a divergence; report it, don't crash.
            mismatches += 1
            break
        if (
            ds["inc"].bucket_id != ds["nai"].bucket_id
            or ds["inc"].score != ds["nai"].score
        ):
            mismatches += 1
        d = ds["nai"]
        step = cost.batch_cost(d.queue_size, d.in_cache)
        clock += step
        for k, s in sides.items():
            s["cache"].access(ds[k].bucket_id)
            s["wm"].complete_bucket(ds[k].bucket_id, clock)
    return {
        "trace_queries": n_queries,
        "decisions": decisions,
        "mismatches": mismatches,
        "bit_identical": mismatches == 0,
    }


# ---------------------------------------------------------- 3. compile counting
def bench_compiles(n_queries=500, device=None) -> dict:
    dev = resolve_device(device)
    cat = make_catalog(n_objects=20_000, objects_per_bucket=128, htm_level=7, seed=5)
    trace = make_trace(
        cat,
        TraceConfig(n_queries=n_queries, arrival_rate=1.0, objects_median=120,
                    seed=23),
    )
    loads_before = cm_kernel.LIBRARY.loads
    eng = CrossMatchEngine(cat, match_radius_rad=2e-3, device=dev)
    with cm_ops.ShapeLog() as log:
        eng.run(trace)
    shapes = len(log.padded)
    max_probes = max(eng.max_probe_batch, 2)
    bound = int(math.log2(1 << (max_probes - 1).bit_length())) + 1
    out = {
        "trace_queries": n_queries,
        "batches": eng.batches,
        "max_probe_batch": max_probes,
        "shapes_compiled": shapes,
        "bound_log2_max_probes_plus_1": bound,
        "within_bound": 0 <= shapes <= bound,
    }
    if dev.type == "cuda":
        loads = cm_kernel.LIBRARY.loads - loads_before
        out["library_loads"] = loads
        out["launch_shapes"] = len(log.launched)
        out["within_bound"] = out["within_bound"] and loads <= 1
    return out


# ------------------------------------------------------------- 4. fused dispatch
def bench_fused(n_queries=120, device=None) -> dict:
    dev = resolve_device(device)
    cat = make_catalog(n_objects=20_000, objects_per_bucket=128, htm_level=7, seed=5)
    trace = make_trace(
        cat,
        TraceConfig(n_queries=n_queries, arrival_rate=1.0, objects_median=120,
                    seed=29),
    )
    out = {}
    for k in (1, 4):
        eng = CrossMatchEngine(cat, match_radius_rad=2e-3, fuse_k=k,
                               device=dev)
        t0 = time.perf_counter()
        eng.run(trace)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[f"fuse_k={k}"] = {
            "batches": eng.batches,
            "dispatches": eng.dispatches,
            "wall_s": round(time.perf_counter() - t0, 3),
        }
    return out


def run(out_path: str = "BENCH_torch_scheduler.json", verbose: bool = True,
        device=None) -> dict:
    dev = resolve_device(device)
    report = {
        "select_at_1k_buckets": bench_select(),
        "decision_equivalence": bench_equivalence(),
        "compile_count": bench_compiles(device=dev),
        "fused_dispatch": bench_fused(device=dev),
        "device": device_record(dev),
    }
    sel = report["select_at_1k_buckets"]
    eq = report["decision_equivalence"]
    cc = report["compile_count"]
    pathlib.Path(out_path).write_text(json.dumps(report, indent=2) + "\n")
    if verbose:
        print(
            f"  select@1k: naive={sel['naive_us']:.1f}us "
            f"incremental={sel['incremental_us']:.1f}us "
            f"speedup={sel['speedup']:.1f}x"
        )
        print(
            f"  equivalence: {eq['decisions']} decisions, "
            f"{eq['mismatches']} mismatches"
        )
        print(
            f"  compiles: {cc['shapes_compiled']} shapes "
            f"(bound {cc['bound_log2_max_probes_plus_1']}, "
            f"max batch {cc['max_probe_batch']})"
        )
        print(f"  wrote {out_path}")
    emit(
        "bench_scheduler",
        sel["incremental_us"],
        f"speedup={sel['speedup']:.1f}x;mismatches={eq['mismatches']};"
        f"shapes={cc['shapes_compiled']}/{cc['bound_log2_max_probes_plus_1']}",
    )
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    ap.add_argument("--out", default="BENCH_torch_scheduler.json")
    # Tolerate stray argv (argparse's SystemExit would kill the harness).
    args, _ = ap.parse_known_args(argv)
    report = run(args.out, device=args.device)
    assert report["select_at_1k_buckets"]["speedup"] >= 5.0
    assert report["decision_equivalence"]["bit_identical"]
    assert report["compile_count"]["within_bound"]


if __name__ == "__main__":
    main()
