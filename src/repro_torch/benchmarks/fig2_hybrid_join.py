"""Paper Fig. 2: non-indexed scan vs spatial-index join speed-up as a
function of workload-queue size.

The port of ``benchmarks/fig2_hybrid_join.py``.  Two views:
  (a) the paper's cost model (T_b=1.2s, T_m=0.13ms, T_probe=4.13ms):
      break-even at |W| ~ 3% of a 10k-object bucket, up to ~20x gap;
  (b) real compute on the device: the scan is one single-bucket join
      (K1 on ``cuda``) of w probes over the paper's SDSS bucket width
      (10,000 rows, HTM-sorted); the indexed path is w joins of one probe
      over a 64-row neighbourhood each.  Per w: the host wall of a call
      (ending in a synchronise on the card), its CUDA-event time (the
      stream's elapsed time, idle gaps while the host prepares included),
      and on the card the device part alone (``ops.prepared_crossmatch``:
      the padded inputs already on the card, 20 calls between one pair of
      events over 20; the indexed path's w joins 5 times over 5).  Every
      call pads its bucket on the host and copies it to the card: both
      walls hold that.

The measured break-even is the w at which w indexed joins cost one scan,
from the smallest w's times (per-probe index cost = indexed / w), beside
the cost model's.

    python -m repro_torch.benchmarks.fig2_hybrid_join [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..core import HybridPlanner
from ..core.sfc import htm_id, unit_vectors
from ..device import resolve_device
from ..kernels.crossmatch import ops as cm_ops
from .common import HYBRID_COST, device_record, emit, time_call, write_report

__all__ = ["BUCKET", "NEIGHBORHOOD", "WIDTHS", "make_bucket", "model_view",
           "measured_view", "run", "main"]

BUCKET = 10_000
NEIGHBORHOOD = 64
WIDTHS = (8, 64, 256, 1024)
THR = float(np.cos(0.01))
SCAN_PASSES = 20  # device-part timing: calls between one pair of events
INDEX_PASSES = 5


def model_view(verbose=True):
    planner = HybridPlanner(HYBRID_COST, objects_per_bucket=BUCKET)
    be = HYBRID_COST.break_even_queue()
    rows = []
    for w in (10, 30, 100, 300, 1000, 3000, 10000):
        scan = HYBRID_COST.scan_cost(w, in_cache=False)
        idx = HYBRID_COST.indexed_cost(w)
        rows.append((w, idx / scan, planner.plan(w, False).strategy))
        if verbose:
            print(f"  |W|={w:6d}  index/scan={idx / scan:6.2f}x  plan={rows[-1][2]}")
    if verbose:
        print(f"  analytic break-even |W|*={be:.0f} ({be / BUCKET:.1%} of bucket; paper ~3%)")
    return be, rows


def make_bucket() -> np.ndarray:
    """The measured view's bucket: 10,000 unit vectors in HTM order."""
    bucket = unit_vectors(BUCKET, seed=1).astype(np.float32)
    order = np.argsort(htm_id(bucket, level=10), kind="stable")
    return bucket[order]


def _device_part_us(joins, dev, passes: int) -> Optional[float]:
    """CUDA-event time of one pass over ``joins`` (prepared joins), over
    ``passes`` passes between one pair of events; None on the CPU."""
    if dev.type != "cuda":
        return None
    for j in joins:  # warm-up
        j()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(passes):
        for j in joins:
            j()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / passes


def measured_view(verbose=True, device=None, widths=WIDTHS):
    """(rows, joins, calls): a row of times per w; each w's scan inputs
    and outputs (``joins``: w, bucket, probes, (idx, dot, cnt)); and the
    joins run in all (on ``cuda`` each one kernel launch)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    bucket = make_bucket()
    rows, joins = [], []
    calls = 0

    def join(b, p):
        nonlocal calls
        calls += 1
        return cm_ops.crossmatch(b, p, THR, device=dev)

    def prepared(b, p):
        run = cm_ops.prepared_crossmatch(b, p, THR, dev)

        def counted():
            nonlocal calls
            calls += 1
            return run()

        return counted

    for w in widths:
        probes = bucket[rng.integers(0, BUCKET, w)] + 1e-4
        probes /= np.linalg.norm(probes, axis=1, keepdims=True)
        # scan: one batched pass over the whole bucket
        joins.append(dict(w=w, bucket=bucket, probes=probes,
                          scan=join(bucket, probes)))
        t_scan = time_call(lambda: join(bucket, probes)[0], device=dev)
        # indexed: per-probe gathered neighborhood (random access pattern)
        idx0 = rng.integers(0, BUCKET - NEIGHBORHOOD, w)
        gathered = np.stack([bucket[i : i + NEIGHBORHOOD] for i in idx0])

        def indexed():
            outs = []
            for i in range(w):  # per-probe random probes -- the index path
                outs.append(join(gathered[i], probes[i : i + 1])[0])
            return outs

        t_idx = time_call(indexed, reps=3, warmup=1, device=dev)
        scan_dev = idx_dev = None
        if dev.type == "cuda":
            scan_dev = _device_part_us([prepared(bucket, probes)], dev,
                                       SCAN_PASSES)
            idx_dev = _device_part_us(
                [prepared(gathered[i], probes[i : i + 1]) for i in range(w)],
                dev, INDEX_PASSES)
        ratio = t_idx.wall_us / t_scan.wall_us
        rows.append(dict(
            w=w, scan_wall_us=t_scan.wall_us, scan_event_us=t_scan.device_us,
            scan_device_part_us=scan_dev, indexed_wall_us=t_idx.wall_us,
            indexed_event_us=t_idx.device_us, indexed_device_part_us=idx_dev,
            indexed_over_scan=ratio,
            winner="scan" if t_scan.wall_us < t_idx.wall_us else "indexed",
        ))
        if verbose:
            part = (f"; device part scan={scan_dev:.1f}us "
                    f"indexed={idx_dev:.1f}us" if scan_dev is not None else "")
            print(
                f"  |W|={w:5d}  scan={t_scan.wall_us:10.0f}us  "
                f"indexed={t_idx.wall_us:10.0f}us  ratio={ratio:6.2f}x -> "
                f"{rows[-1]['winner']}{part}"
            )
    return rows, joins, calls


def break_even(rows, key: str) -> Optional[float]:
    """Probes at which w indexed joins cost one scan, from the smallest
    w's ``<key>`` times: scan / (indexed / w)."""
    r = rows[0]
    scan, idx = r[f"scan_{key}"], r[f"indexed_{key}"]
    if scan is None or idx is None:
        return None
    return scan / (idx / r["w"])


def run(verbose: bool = True, device=None,
        out_path: str | None = "BENCH_torch_fig2_hybrid_join.json",
        widths=WIDTHS, joins_out: Optional[list] = None) -> dict:
    """Both views; returns the report (``joins_out``, if given, receives
    the measured view's scan joins)."""
    dev = resolve_device(device)
    if verbose:
        print(" cost-model view (paper constants):")
    be, model_rows = model_view(verbose)
    if verbose:
        print(f" measured view ({dev.type}):")
    rows, joins, calls = measured_view(verbose, dev, widths)
    if joins_out is not None:
        joins_out.extend(joins)
    wall_be = break_even(rows, "wall_us")
    part_be = break_even(rows, "device_part_us")
    if verbose:
        part = (f", device part alone {part_be:.1f} probes"
                if part_be is not None else "")
        print(f"  measured break-even: {wall_be:.1f} probes "
              f"({wall_be / BUCKET:.4%} of bucket) on the wall{part}; "
              f"cost model {be:.0f} ({be / BUCKET:.1%})")
    emit(
        "fig2_hybrid_join",
        rows[-1]["scan_wall_us"],
        f"break_even_frac={be / BUCKET:.4f};paper=0.03;"
        f"measured_frac={wall_be / BUCKET:.6f}",
    )
    report = {
        "model": {
            "break_even_queue": be,
            "break_even_frac": be / BUCKET,
            "rows": [{"w": w, "index_over_scan": r, "plan": p}
                     for w, r, p in model_rows],
        },
        "measured": rows,
        "measured_break_even": {
            "wall_probes": wall_be,
            "wall_frac": wall_be / BUCKET,
            "device_part_probes": part_be,
        },
        "joins": calls,
        "device": device_record(dev),
    }
    if out_path:
        write_report(out_path, report)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    ap.add_argument("--out", default="BENCH_torch_fig2_hybrid_join.json")
    args, _ = ap.parse_known_args(argv)
    return run(device=args.device, out_path=args.out)


if __name__ == "__main__":
    main()
