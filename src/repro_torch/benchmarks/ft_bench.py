"""Fault-tolerance benchmark: goodput under failures and stragglers at
simulated 256-worker scale — checkpoint/restart + backup-task mitigation.

The port of ``benchmarks/ft_bench.py`` on the port's ``dist`` (host
only): the same five scenarios, the same rows.  Its verbose line reads
``FTResult.n_stragglers`` (the reference's reads a field ``FTResult``
does not have, so its ``run()`` raises ``AttributeError``).
``python -m repro_torch.benchmarks.ft_bench``"""
from __future__ import annotations

import argparse
import dataclasses

from ..device import resolve_device
from ..dist import simulate_training_with_failures
from .common import device_record, emit, write_report

__all__ = ["run", "main"]

SCENARIOS = [
    ("clean", dict(failure_rate=0.0, straggler_rate=0.0)),
    ("failures", dict(failure_rate=2e-7, straggler_rate=0.0)),
    ("stragglers_nobackup", dict(failure_rate=0.0, straggler_rate=0.05,
                                 straggler_slowdown=6.0, backup_tasks=False)),
    ("stragglers_backup", dict(failure_rate=0.0, straggler_rate=0.05,
                               straggler_slowdown=6.0, backup_tasks=True)),
    ("both", dict(failure_rate=2e-7, straggler_rate=0.05,
                  straggler_slowdown=6.0, backup_tasks=True)),
]


def run(verbose: bool = True, device=None,
        out_path: str | None = "BENCH_torch_ft_bench.json") -> dict:
    """{scenario: (FTResult, goodput in steps/s)}, as the reference's."""
    dev = resolve_device(device)
    rows = {}
    base = dict(n_steps=1000, n_workers=256, step_time=1.0,
                checkpoint_every=50, seed=3)
    for name, kw in SCENARIOS:
        r = simulate_training_with_failures(**base, **kw)
        goodput = r.steps_done / r.wall_time
        rows[name] = (r, goodput)
        if verbose:
            print(
                f"  {name:22s} wall={r.wall_time:8.0f}s goodput={goodput:6.3f} steps/s "
                f"failures={r.n_failures} lost={r.lost_steps} "
                f"stragglers={r.n_stragglers} backups={r.n_backup_dispatches}"
            )
    mit = rows["stragglers_backup"][1] / rows["stragglers_nobackup"][1]
    emit("ft_bench", 0.0, f"backup_task_goodput_gain={mit:.2f}x")
    if out_path:
        write_report(out_path, {
            "scenarios": {name: dict(dataclasses.asdict(r), goodput=g)
                          for name, (r, g) in rows.items()},
            "backup_task_goodput_gain": mit,
            "device": device_record(dev),
        })
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default="BENCH_torch_ft_bench.json")
    args, _ = ap.parse_known_args(argv)
    return run(device=args.device, out_path=args.out)


if __name__ == "__main__":
    main()
