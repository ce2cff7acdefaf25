"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m liferaft_bench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the checkout's root, on a machine with the card the cell asks for.
Set-up (load or build K4 and K5, make the weights and the prefilled K/V
from the seed, warm the cell's shapes) is timed from the process's start
to the first timed step (``setup_s``).  The window then serves request
batches in a closed loop for ``--seconds``; ``decode_tokens_per_s`` is
every token delivered over the whole window, ``decode_itl_p95_ms`` the
95th percentile of every token's gap.  With ``--trace 1`` the second half
of the window runs under the profiler (the first half, untraced, gives
the host-clock metrics) and the result carries the per-layer metrics,
each read by its own ``metrics/<name>.py``.  Either way the batch in flight decodes
to its end after the window, and a sample of the finished requests is held
to the reference (``check.py``).

The last line of standard output is the result (JSON); the last lines of
standard error are the numbers compared, each beside its limit.  Without a
card, on a manifest that breaks the rules, or where JAX or the JAX package
is loaded, it exits non-zero and prints no result.
"""
from __future__ import annotations

import time

_IMPORTED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

from . import ROOT, imports, manifest  # noqa: E402

__all__ = ["Context", "run_cell", "main"]


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from /proc; the
    module's import where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return _IMPORTED
    age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - max(age, 0.0)


def _environment() -> None:
    """The program's build and kernel caches at fixed paths in the
    checkout, and the checkout's ``src`` first on the path."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    src = str(ROOT / "src")
    if sys.path[:1] != [src]:
        sys.path.insert(0, src)


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads: the cell's sizes and mix;
    the traced part of the window (its steps and each one's position) and
    the trace (None where the run ran on no card); the untraced part
    before it (host clock, steps' positions); K5's calls in the traced
    part ((active experts, routed rows, d_in, d_out, itemsize), None where
    not recorded) and the device's peak memory (0 on no card)."""

    spec: object
    mix: dict
    batch: int
    itemsize: int
    steps: int
    positions: list
    trace: object
    untraced_s: float
    untraced_positions: list
    k5_calls: object = None
    memory_peak_bytes: int = 0


def _loadavg() -> str:
    try:
        with open("/proc/loadavg") as f:
            return " ".join(f.read().split()[:3])
    except OSError:
        return "unknown"


def host_times() -> tuple:
    """(the machine's steal and iowait seconds, summed over its CPUs; this
    process's CPU seconds): read twice, their difference says whether a
    slow span waited on the host's other tenants, on the disk or on its
    own work.  Zeros where /proc cannot be read."""
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        hz = os.sysconf("SC_CLK_TCK")
        return (int(cpu[8]) / hz, int(cpu[5]) / hz, time.process_time())
    except (OSError, ValueError, IndexError):
        return (0.0, 0.0, time.process_time())


def host_line(before: tuple, after: tuple) -> str:
    steal, iowait, own = (b - a for a, b in zip(before, after))
    return (f"steal {steal:.2f} s, iowait {iowait:.2f} s (all CPUs), this "
            f"process's CPU {own:.2f} s")


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run_cell(m: dict, cell, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", t_start: float | None = None,
             log=print, server_hook=None, stamps=(),
             host_start: tuple | None = None) -> dict:
    """Set up, serve the window, check; the result as a dict (its
    ``checks`` last).  ``server_hook(server)``, where given, is called on
    the set-up server before the window (the tests plant faults so).
    ``stamps``: (what, perf_counter time) of set-up's steps before this
    call, logged first; ``host_start``: ``host_times()`` at the harness's
    start."""
    import numpy as np
    import torch

    from . import check, serve, trace
    from .reference.decoder import spec_from_config

    t_start = process_start() if t_start is None else t_start
    host_start = host_times() if host_start is None else host_start
    outer = log

    def log(msg):  # every line stamped with the seconds since the start
        outer(f"[{time.perf_counter() - t_start:9.3f} s] {msg}")

    for what, at in stamps:
        outer(f"[{at - t_start:9.3f} s] set-up: {what}")
    log("set-up: the harness's modules imported")
    cuda = torch.device(device).type == "cuda"
    spec = spec_from_config(cell.config)
    mix = cell.mix
    if cuda:
        log(f"card: {_card_line()}; host load {_loadavg()}")
        serve.build_kernels(log)
        torch.cuda.reset_peak_memory_stats()
    server = serve.Server(cell, spec, seed, device, log)
    server.warm(mix["warm_steps"], log)
    if server_hook is not None:
        server_hook(server)
    probe = None
    if trace_on and spec.n_experts:
        from repro_torch.models import moe
        probe = trace.K5Probe(moe)
    prof = []

    def start_trace():
        if probe is not None:
            probe.on = True
        if cuda:
            prof.append(trace.start())

    host_set = host_times()
    with probe if probe is not None else contextlib.nullcontext():
        window = server.run_window(seconds, start_trace if trace_on else None)
        host_end = host_times()
        window_s = window.t_end - window.t0
        if trace_on and window.half is None:
            raise RuntimeError("the window ended before its traced half")
        tr = (trace.stop(prof[0], window.t_end - window.t_half) if prof
              else None)
    setup_s = window.t0 - t_start
    B = server.B
    log(f"host over the set-up from the harness's start: "
        f"{host_line(host_start, host_set)}; over the window: "
        f"{host_line(host_set, host_end)}")
    log(serve.summary_line(window, B) + f"; host load {_loadavg()}")
    distinct = serve.distinct_tokens(window.batches, window.steps)
    log(f"distinct tokens a step: min {min(distinct)}, median "
        f"{float(np.median(distinct))} of {B}")
    k5_calls = probe.calls() if probe is not None else None
    if probe is not None:
        if not k5_calls:
            raise RuntimeError(
                "K5's probe recorded no call in the traced half: "
                "models.moe.grouped_matmul_fn is no longer called as "
                "(x, tile_gid, w, bt, tile_rows)")
        act = [c[0] for c in k5_calls]
        routed = [c[1] for c in k5_calls]
        log(f"K5 calls {len(act)}: active experts a call min {min(act)}, "
            f"mean {float(np.mean(act)):.3f}, max {max(act)} of "
            f"{spec.n_experts}; routed rows a call min {min(routed)}, max "
            f"{max(routed)} of {B * spec.top_k}")
        if min(routed) != B * spec.top_k or max(routed) != B * spec.top_k:
            raise RuntimeError(
                f"K5 calls routed {min(routed)}-{max(routed)} rows, not "
                f"every one of the batch's {B * spec.top_k} expert choices: "
                f"the port's expert capacity dropped tokens, which the "
                f"published routing does not")
    attempted = len(window.batches) * B
    server.finish()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    sample = check.Sample.take(server, window.batches, mix, seed)
    server.close()
    t = time.perf_counter()
    numbers = check.compare(spec, server.weights, sample, mix, seed, device,
                            cell.limits.get("routing_margin", 0.0))
    log(f"check: {len(sample.picked)} sequences ({len(sample.last_rows)} "
        f"with their K/V) x {mix['new_tokens']} tokens against the reference "
        f"in {time.perf_counter() - t:.3f} s")
    correct, checks = check.judge(numbers, cell.limits)

    tokens = window.steps * B
    metrics = {}
    if not trace_on:
        e2e = {
            "decode_tokens_per_s": (tokens / window_s, "tokens/s"),
            "decode_itl_p95_ms": (
                serve.p95(np.repeat(np.asarray(window.gaps), B)) * 1e3, "ms"),
            "setup_s": (setup_s, "s"),
        }
        for e in manifest.end_to_end_of(m, cell.name):
            value, unit = e2e[e["name"]]
            metrics[e["name"]] = {"value": value, "unit": unit}
    else:
        h = window.half
        ctx = Context(spec, mix, B, server.weights["embed"].element_size(),
                      window.steps - h, window.positions[h:], tr,
                      sum(window.gaps[:h]), window.positions[:h], k5_calls,
                      peak)
        for p in manifest.per_layer_of(m, cell.name):
            value = manifest.reader(p["name"])(ctx)
            if value is not None:
                metrics[p["name"]] = {"value": value, "unit": p["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": 0, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.top_idle()}
        log(f"trace: {len(tr.kernels)} kernels, {tr.n_copies} copies, busy "
            f"{tr.busy_s:.6f} of {tr.window_s:.6f} s")
    result["checks"] = checks
    return result


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m liferaft_bench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_start = process_start()
    host_start = host_times()
    stamps = [("interpreter up, harness imported", _IMPORTED)]
    args = _parse(argv)
    try:
        m = manifest.load()
        cell = manifest.cell(m, args.workload)
    except manifest.ManifestError as exc:
        print(f"BENCHMARK.json: {exc}", file=sys.stderr)
        return 3
    bad = imports.reference_violations()
    if bad:
        print(f"the reference imports {bad}", file=sys.stderr)
        return 3
    import torch

    stamps.append(("torch imported", time.perf_counter()))
    chips = cell.entry["chips"]
    available = torch.cuda.is_available()
    stamps.append(("CUDA driver up", time.perf_counter()))
    if not available or torch.cuda.device_count() < chips:
        print(f"{cell.name} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    _environment()
    try:
        import repro_torch
    except ImportError as exc:
        print(f"the port is not in this checkout: {exc}", file=sys.stderr)
        return 1
    stamps.append(("repro_torch imported", time.perf_counter()))
    if not repro_torch.__file__.startswith(str(ROOT / "src") + os.sep):
        print(f"repro_torch comes from {repro_torch.__file__}, not this "
              f"checkout", file=sys.stderr)
        return 1
    try:
        result = run_cell(m, cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", t_start, stamps=stamps,
                          host_start=host_start)
    except Exception:
        traceback.print_exc()
        return 1
    found = imports.loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
