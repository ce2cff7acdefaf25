"""Shared driver fixtures: the SkyQuery-scale workload of the Fig. 5/6/7/8
drivers, timing that waits for the device, the report's device record,
and the H100's peaks with the bound rule every kernel time is held to.

The port of ``benchmarks/common.py``: the fixtures and ``emit`` are the
reference's; ``time_call`` synchronises the card and reports CUDA-event
time beside the host wall.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from ..core import PAPER_COST_MODEL, HybridCostModel
from ..crossmatch import TraceConfig, make_catalog, make_trace

__all__ = [
    "CATALOG_KW", "TRACE_KW", "CACHE_CAPACITY", "COST", "HYBRID_COST",
    "PEAK_FP32_FLOPS", "PEAK_BF16_FLOPS", "PEAK_BYTES",
    "Timing", "workload", "time_call", "bound", "emit", "device_record",
    "write_report",
]

# Scaled SkyQuery setup: the paper uses 20k x 10k-object (40 MB) buckets
# with a 20-bucket cache (0.1%) and a 2,000-query long-running trace.  We
# scale objects down 100x but keep the ratios that drive the scheduler:
# cache/buckets = 1%, Zipf bucket popularity, temporal locality, and the
# measured cost constants T_b = 1.2 s, T_m = 0.13 ms.
CATALOG_KW = dict(n_objects=200_000, objects_per_bucket=100, htm_level=8, seed=7)
TRACE_KW = dict(
    n_queries=2_000,
    arrival_rate=0.25,
    n_hotspots=24,
    zipf_s=1.6,
    hotspot_frac=0.8,
    temporal_locality=0.6,
    objects_median=300,
    objects_sigma=1.1,
    cone_radius_med=0.05,
    fullsky_frac=0.03,
    seed=11,
)
CACHE_CAPACITY = 20
COST = PAPER_COST_MODEL
HYBRID_COST = HybridCostModel(T_b=1.2, T_m=0.13e-3, T_probe=4.13e-3)

# H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 outside the tensor
# cores, bf16 dense tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

_cache: dict = {}


def workload(n_queries: int | None = None, arrival_rate: float | None = None,
             seed: int | None = None):
    """(catalog, trace) memoized across driver modules."""
    kw = dict(TRACE_KW)
    if n_queries is not None:
        kw["n_queries"] = n_queries
    if arrival_rate is not None:
        kw["arrival_rate"] = arrival_rate
    if seed is not None:
        kw["seed"] = seed
    key = ("cat",)
    if key not in _cache:
        _cache[key] = make_catalog(**CATALOG_KW)
    cat = _cache[key]
    tkey = tuple(sorted(kw.items()))
    if tkey not in _cache:
        _cache[tkey] = make_trace(cat, TraceConfig(**kw))
    return cat, _cache[tkey]


@dataclasses.dataclass(frozen=True)
class Timing:
    """Medians over a call's repetitions.  ``wall_us``: the host clock
    around the call, which on the card ends in ``torch.cuda.synchronize``;
    ``device_us``: CUDA events recorded before and after the call (the
    stream's elapsed time, idle gaps while the host prepares included),
    None on the CPU."""

    wall_us: float
    device_us: Optional[float]


def time_call(fn, *args, device="cpu", reps: int = 5, warmup: int = 2,
              **kw) -> Timing:
    """Time ``fn(*args, **kw)`` on ``device`` after ``warmup`` calls."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn(*args, **kw)
    if cuda:
        torch.cuda.synchronize()
    walls, devs = [], []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        fn(*args, **kw)
        if cuda:
            end.record()
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
        if cuda:
            devs.append(start.elapsed_time(end) * 1e3)
    return Timing(float(np.median(walls)),
                  float(np.median(devs)) if cuda else None)


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of ``nbytes`` (each input read once, each output written
    once) at ``PEAK_BYTES`` and ``flops`` at ``peak_flops``, the peak for
    their type."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.2f},{derived}")


def device_record(device) -> str:
    """What a report says it ran on: ``"cpu"``, or the card's name and
    power limit as ``nvidia-smi`` gives them."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def write_report(path, report: dict) -> None:
    pathlib.Path(path).write_text(json.dumps(report, indent=2) + "\n")
