"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size.

    python3 -m liferaft_bench.control --workload <cell> --seeds 11,12,... \\
        [--control-seeds 11,12,13] [--margins 0.1,0.2] [--out FILE]
    python3 -m liferaft_bench.control --workload <cell> --seeds 21,22,23 \\
        --fault token_altered

For each seed: the cell's set-up from that seed, one request batch served
through the timed path (the window's own loop and step, at the cell's
batch and lengths), the same sample a run compares drawn from it, and the
numbers of ``check.py`` for the program.  On the control seeds also the
control's: the reference in fp8 (every product's operands rounded to
float8 e4m3, the step below the configuration's bf16) in the program's
place, read on the same prompts and tokens (``control_<number>``; its
gaps are those of the token fp8 puts first).  ``--margins`` reads every
number again at other routing margins (``<number>@<margin>``).  With
``--fault`` (a name of ``faults.FAULTS``) the fault is planted in the
timed path after the warm steps, as the tests plant it at a tiny cut, and
each seed's line also says whether the cell's limits find it
(``correct``).  Each seed's readings are one JSON line on standard output
(and in ``--out``).

A limit lies above the largest program reading over a dozen seeds or more
and below the smallest control reading; ``limits/<cell>.json`` keeps the
readings it was set from.  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import faults, manifest

__all__ = ["readings", "main"]


def readings(cell, seed: int, device: str, control: str | None,
             log=print, margins: tuple = (), fault: str | None = None) -> dict:
    """One seed's readings (and, with ``control``, those of the reference
    in that precision in the program's place; with ``fault``, of the
    program with that fault planted, and the cell's verdict on them)."""
    import torch

    from . import check, serve
    from .reference.decoder import spec_from_config

    spec = spec_from_config(cell.config)
    t = time.perf_counter()
    server = serve.Server(cell, spec, seed, device, log)
    server.warm(cell.mix["warm_steps"], log)
    if fault is not None:
        faults.plant(fault, server)
    window = server.run_window(0.0)
    server.finish()
    sample = check.Sample.take(server, window.batches, cell.mix, seed)
    server.close()
    served_s = time.perf_counter() - t
    t = time.perf_counter()
    out = check.compare(spec, server.weights, sample, cell.mix, seed, device,
                        cell.limits.get("routing_margin", 0.0), control,
                        margins)
    out.update(seed=seed, served_s=served_s,
               reference_s=time.perf_counter() - t)
    if fault is not None:
        out.update(fault=fault, correct=check.judge(out, cell.limits)[0])
    del server
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m liferaft_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, type=_seeds)
    ap.add_argument("--control-seeds", default="", type=_seeds)
    ap.add_argument("--margins", default="", type=lambda t: tuple(
        float(x) for x in t.split(",") if x),
        help="routing margins to read the numbers at besides the cell's")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS),
                    help="plant this fault in the timed path")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    m = manifest.load()
    cell = manifest.cell(m, args.workload)
    from .run import _environment

    _environment()
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    from . import serve

    serve.build_kernels(print)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in dict.fromkeys(args.seeds + args.control_seeds):
            r = readings(cell, seed, "cuda",
                         "fp8" if seed in args.control_seeds else None,
                         log=lambda *a: None, margins=args.margins,
                         fault=args.fault)
            r["cell"] = cell.name
            line = json.dumps(r)
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
