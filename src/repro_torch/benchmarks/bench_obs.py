"""BENCH_obs: the observability layer must be (nearly) free.

Emits ``BENCH_torch_obs.json`` with two sections:

1. ``overhead`` — the same saturating adaptive simulation run obs-OFF
   and obs-ON (full tap: metrics + tracer + explain), interleaved
   min-of-N wall times.  Acceptance: obs-on throughput >= ``GATE``
   (0.97x) of obs-off — the tap budget documented in
   docs/observability.md.
2. ``artifacts`` — a skewed 4-shard run with work stealing, exported as
   the consolidated ``OBS_torch_snapshot.json`` (metrics + control explain
   + trace rollup) and ``OBS_torch_trace.perfetto.json`` (one track per shard,
   steal arrows), both beside the report.  Acceptance: >= 1 steal
   captured, valid JSON on disk.

The port of ``benchmarks/bench_obs.py`` (host only), with the
reference's gates; the overhead gate is a host-wall ratio, held here in
``main`` and not in the tests.

Run: ``python -m repro_torch.benchmarks.bench_obs [--device cpu] [--out PATH]``
"""
from __future__ import annotations

import argparse
import json
import pathlib
from time import perf_counter

import numpy as np

from ..core import (
    ControlConfig,
    ControlLoop,
    CostModel,
    LifeRaftScheduler,
    StealConfig,
    simulate_batched,
    simulate_sharded,
)
from ..core.workload import Query
from ..obs import Observability

from ..device import resolve_device
from .common import device_record, emit

GATE = 0.97  # obs-on / obs-off throughput ratio floor


def _identity_range(lo, hi):
    return np.arange(lo, hi + 1)


def _trace(seed, n=1200, buckets=64, gap=0.004, depth=(10, 60), skew=False):
    rng = np.random.default_rng(seed)
    qs, t = [], 0.0
    for qid in range(n):
        t += float(rng.exponential(gap))
        b = int(rng.integers(0, buckets))
        if skew:
            b = b * b // buckets
        ks = np.full(int(rng.integers(*depth)), b, dtype=np.uint64)
        qs.append(Query(qid, t, ks, ks))
    return qs


def _cost():
    return CostModel(T_b=0.08, T_m=2e-4, T_spill=0.2, probe_bytes=8.0)


def _control():
    return ControlLoop(ControlConfig(
        alpha_init=0.5, alpha_step=0.2, halflife_s=2.0,
        rate_knee=12.0, depth_knee=1_200.0, fuse_k_max=3,
        spill_budget_bytes=6_000.0,
    ))


def _run_once(obs=None) -> float:
    """One adaptive, spill-engaging simulation; returns wall seconds."""
    cost = _cost()
    qs = _trace(23)
    t0 = perf_counter()
    simulate_batched(
        qs, _identity_range,
        LifeRaftScheduler(cost, 0.5, normalized=True), cost,
        cache_capacity=8, fuse_k=2, control=_control(), obs=obs,
    )
    return perf_counter() - t0


def bench_overhead(reps: int = 3) -> dict:
    _run_once()  # warmup (allocator, imports, caches)
    offs, ons = [], []
    rounds_observed = 0
    for _ in range(reps):  # interleaved so drift hits both sides equally
        offs.append(_run_once(obs=None))
        obs = Observability()
        ons.append(_run_once(obs=obs))
        rounds_observed = int(
            obs.registry.counter("liferaft_rounds_total", track="0").value
        )
    t_off, t_on = min(offs), min(ons)
    ratio = t_off / t_on  # obs-on throughput relative to obs-off
    return {
        "t_off_s": t_off,
        "t_on_s": t_on,
        "throughput_ratio": ratio,
        "rounds_observed": rounds_observed,
        "gate": GATE,
        "passed": ratio >= GATE and rounds_observed > 0,
    }


def export_artifacts(
    snapshot_path: str = "OBS_torch_snapshot.json",
    trace_path: str = "OBS_torch_trace.perfetto.json",
) -> dict:
    """Skewed sharded run with stealing -> consolidated obs artifacts."""
    obs = Observability()
    cost = _cost()
    simulate_sharded(
        _trace(71, n=600, skew=True), _identity_range, cost,
        scheduler_factory=lambda: LifeRaftScheduler(
            cost, 0.5, normalized=True
        ),
        n_shards=4, cache_capacity=8, fuse_k=2,
        steal=StealConfig(low_water_bytes=0.0),
        obs=obs,
    )
    snap = obs.snapshot()
    trace = obs.perfetto()
    pathlib.Path(snapshot_path).write_text(json.dumps(snap, indent=1) + "\n")
    pathlib.Path(trace_path).write_text(json.dumps(trace) + "\n")
    steals = snap["trace"]["steals"]
    tracks = snap["trace"]["tracks"]
    return {
        "snapshot_path": snapshot_path,
        "trace_path": trace_path,
        "rounds": snap["trace"]["rounds"],
        "steals": steals,
        "tracks": tracks,
        "trace_events": len(trace["traceEvents"]),
        "passed": steals >= 1 and tracks == [0, 1, 2, 3],
    }


def run(out_path: str = "BENCH_torch_obs.json", verbose: bool = True,
        device=None) -> dict:
    dev = resolve_device(device)
    report = {
        "overhead": bench_overhead(),
        "artifacts": export_artifacts(
            str(pathlib.Path(out_path).with_name("OBS_torch_snapshot.json")),
            str(pathlib.Path(out_path).with_name(
                "OBS_torch_trace.perfetto.json")),
        ),
    }
    ov = report["overhead"]
    ar = report["artifacts"]
    report["device"] = device_record(dev)
    pathlib.Path(out_path).write_text(json.dumps(report, indent=2) + "\n")
    if verbose:
        print(
            f"  overhead: obs-on {ov['throughput_ratio']:.3f}x of obs-off "
            f"(gate {ov['gate']}x, {ov['rounds_observed']} rounds observed)"
        )
        print(
            f"  artifacts: {ar['rounds']} spans / {ar['steals']} steals "
            f"across tracks {ar['tracks']} -> {ar['snapshot_path']}, "
            f"{ar['trace_path']}"
        )
        print(f"  wrote {out_path}")
    emit(
        "bench_obs",
        ov["throughput_ratio"],
        f"ratio={ov['throughput_ratio']:.3f}x;steals={ar['steals']}",
    )
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    ap.add_argument("--out", default="BENCH_torch_obs.json")
    # Tolerate stray argv (argparse's SystemExit would kill benchmarks.run).
    args, _ = ap.parse_known_args(argv)
    report = run(args.out, device=args.device)
    assert report["overhead"]["passed"], report["overhead"]
    assert report["artifacts"]["passed"], report["artifacts"]


if __name__ == "__main__":
    main()
