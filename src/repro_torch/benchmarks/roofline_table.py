"""Summarize the dry-run's artifacts into the roofline table.

The port of ``benchmarks/roofline_table.py``: it reads the JSON files
``python -m repro_torch.launch.dryrun --all [--multi-pod]`` writes under
``build/dryrun`` (``--dir``), prints one row a cell of the 16x16 mesh --
the three roofline terms from the H100 SXM's data-sheet constants
(``launch/roofline.py``; derived, not measured), the dominant term and
the argument bytes a rank holds against the card's 80 GB -- and writes
the rows of both meshes to ``--out`` when given.

    python -m repro_torch.benchmarks.roofline_table [--dir build/dryrun]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from .common import emit, write_report

DRYRUN_DIR = pathlib.Path("build/dryrun")


def load_cells(mesh: str = "16x16", tag: str | None = None,
               directory=DRYRUN_DIR) -> list[dict]:
    cells = []
    for f in sorted(pathlib.Path(directory).glob("*.json")):
        r = json.loads(f.read_text())
        if r.get("mesh") != mesh:
            continue
        tagged = "__" in f.stem.replace(
            f"{r['arch']}__{r['shape']}__{r['mesh']}", ""
        )
        if tag is None and tagged:
            continue
        if tag is not None and not f.stem.endswith(f"__{tag}"):
            continue
        cells.append(r)
    return cells


def arg_gb(r: dict) -> float:
    return r["memory_analysis"]["argument_bytes"] / 1e9


def fmt_row(r: dict) -> str:
    dom = r["dominant"][:4]
    return (
        f"  {r['arch']:26s} {r['shape']:12s} "
        f"tc={r['t_compute_s']:9.4f}s tm={r['t_memory_s']:9.4f}s "
        f"tx={r['t_collective_s']:9.4f}s dom={dom:4s} "
        f"useful={r.get('useful_flop_ratio', 0):6.3f} "
        f"mfu_ub={r.get('mfu_upper_bound', 0):6.3f} "
        f"args={arg_gb(r):7.2f}GB/{r.get('hbm_bytes', 80e9) / 1e9:.0f}"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(DRYRUN_DIR))
    ap.add_argument("--out", default=None, help="JSON report of the rows")
    ap.add_argument("--device", default=None,
                    help="accepted for the harness; the table reads files")
    args = ap.parse_args(argv)
    single = load_cells("16x16", directory=args.dir)
    multi = load_cells("2x16x16", directory=args.dir)
    if not single:
        print("  (no dry-run artifacts yet -- run "
              "python -m repro_torch.launch.dryrun --all [--multi-pod])")
        emit("roofline_table", 0.0, "cells=0")
        return
    print(f"  single-pod cells: {len(single)}; multi-pod cells: {len(multi)}")
    by_dom = {}
    for r in single:
        by_dom.setdefault(r["dominant"], []).append(r)
        print(fmt_row(r))
    doms = {k: len(v) for k, v in by_dom.items()}
    worst = min(single, key=lambda r: r.get("mfu_upper_bound", 0))
    most_coll = max(single, key=lambda r: r["t_collective_s"] / max(
        r["t_compute_s"] + r["t_memory_s"] + r["t_collective_s"], 1e-12))
    over = [f"{r['arch']}/{r['shape']}" for r in single
            if r["memory_analysis"]["argument_bytes"] > r.get("hbm_bytes", 80e9)]
    print(f"  dominant-term histogram: {doms}")
    print(f"  worst mfu_upper_bound: {worst['arch']}/{worst['shape']}"
          f" = {worst.get('mfu_upper_bound', 0):.4f}")
    print(f"  most collective-bound: {most_coll['arch']}/{most_coll['shape']}")
    print(f"  arguments over one card's memory at 16x16: {over or 'none'}")
    if args.out:
        keys = ("arch", "shape", "mesh", "kind", "t_compute_s", "t_memory_s",
                "t_collective_s", "dominant", "useful_flop_ratio",
                "mfu_upper_bound", "memory_analysis", "trace_s")
        write_report(args.out, {"rows": [{k: r.get(k) for k in keys}
                                         for r in single + multi]})
    emit(
        "roofline_table", 0.0,
        f"single={len(single)};multi={len(multi)};doms={doms}",
    )


if __name__ == "__main__":
    main()
