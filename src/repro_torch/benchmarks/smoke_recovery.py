"""Kill -9 recovery drill for the port's durable service tier.

1. The parent starts a child: a fresh interpreter (``subprocess``), which
   shares no CUDA state with the parent, builds the same engine and waits.
2. The parent runs the daemon's client loop uninterrupted over a journal
   of its own: the reference decision log, round count R, journal records.
3. The child runs the same loop over the drill's journal, and the parent
   ``SIGKILL``\\ s it once that journal holds ceil(R / 3) round records.
4. The parent recovers a fresh daemon on the same device over the killed
   journal (replay re-executes every journaled round, on the card the
   joins too) and finishes the trace with the same loop.
5. Gate: the recovered journal's records equal the uninterrupted run's
   byte for byte, every acked submission completed, the engine state
   equals the uninterrupted run's, and on the cross-match engine every
   query's results equal it bit for bit and, on the card, each daemon's
   kernel launches add up to its device dispatches (replayed rounds
   counted).

Engines: ``crossmatch`` is the SkyQuery cell's engine C (``skyquery``:
fused top-4 joins with shared plans, a radius and magnitude cut per
query) over its 1,000,000-object catalog and 200-query trace;
``serving`` is the reference drill's LifeRaft serving daemon (8 adapters,
150 requests, no decode: its decisions run on the host).

Journals go under a temporary directory: removed on success, left with
their path printed on failure.

    python -m repro_torch.benchmarks.smoke_recovery                  # on the card
    python -m repro_torch.benchmarks.smoke_recovery --device cpu \\
        --engine crossmatch --objects 100000 --n 30                   # a cut cell
    python -m repro_torch.benchmarks.smoke_recovery --device cpu --engine serving
"""
from __future__ import annotations

import argparse
import math
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..core import Journal
from ..device import resolve_device
from ..kernels.crossmatch import kernel as cm_kernel
from ..serving import (
    AdapterSpec,
    CrossMatchHost,
    LifeRaftEngine,
    Request,
    ServeConfig,
    ServiceDaemon,
    ServingHost,
)
from . import skyquery

__all__ = ["DrillFailed", "serving_daemon", "serving_trace",
           "crossmatch_daemon", "drive", "journal_records", "cut_journal",
           "segments_equal", "results_equal", "run_drill", "main"]

_SRC = pathlib.Path(__file__).resolve().parents[2]
_ENTRY = b'{"type":"entry"'  # how a round record's line starts
DEFAULT_N = {"crossmatch": skyquery.N_QUERIES, "serving": 150}
# The child's wall-clock pause after each submit: the serving daemon's
# whole run takes well under a second without it, too short to be killed
# mid-run by a parent polling its journal.
THROTTLE_S = 0.02
TIMEOUT_S = 600.0  # the child's startup included


class DrillFailed(RuntimeError):
    """A check of the drill failed; the journals were left in place."""


# ---------------------------------------------------------------- engines
def serving_trace(n: int) -> list[Request]:
    """The reference drill's requests: 8 adapters round-robin by 5, 10 ms
    apart, prompts of 32-128 tokens, 48 new tokens each."""
    return [
        Request(request_id=i, adapter_id=(i * 5) % 8, arrival_time=0.01 * i,
                prompt_len=32 + (i % 7) * 16, max_new_tokens=48)
        for i in range(n)
    ]


def serving_daemon(journal_dir) -> ServiceDaemon:
    """The reference drill's serving daemon: 8 adapters of 1-8 MB in two
    tenants, 5 slots, fused pairs, the closed control loop."""
    adapters = [
        AdapterSpec(a, nbytes=(a + 1) * 1_000_000,
                    tenant="interactive" if a % 2 else "batch")
        for a in range(8)
    ]
    cfg = ServeConfig(adapter_slots=5, fuse_k=2, adaptive=True)
    return ServiceDaemon(ServingHost(LifeRaftEngine(adapters, cfg)),
                         journal_dir)


def crossmatch_daemon(cat, journal_dir, device) -> ServiceDaemon:
    """The SkyQuery cell's engine C on ``device`` behind a daemon."""
    return ServiceDaemon(
        CrossMatchHost(skyquery.make_engine(cat, "C", device)), journal_dir)


def drive(daemon, items, throttle_s: float = 0.0) -> float:
    """The daemon's client loop: run rounds up to each arrival, then
    submit it durably.  Returns the wall seconds spent in ``submit`` (the intake,
    fsync included).  ``throttle_s`` slows the wall clock only; the
    engines' clocks, and so every decision, are unaffected."""
    intake = 0.0
    for it in sorted(items, key=lambda it: it.arrival_time):
        daemon.pump(until=it.arrival_time)
        t0 = time.perf_counter()
        daemon.submit(it)
        intake += time.perf_counter() - t0
        if throttle_s:
            time.sleep(throttle_s)
    daemon.pump()
    return intake


# ---------------------------------------------------------------- journals
def journal_records(journal_dir) -> list[bytes]:
    """Every record line of a journal, segment by segment, as written,
    without the segments' ``open`` headers.  A line a crash tore stays in
    (a restart seals it), so it shows as a difference."""
    out = []
    for seg in sorted(pathlib.Path(journal_dir).glob("seg-*.jsonl")):
        out += [ln for ln in seg.read_bytes().split(b"\n")
                if ln and not ln.startswith(b'{"type":"open"')]
    return out


def cut_journal(src, dst, rounds: int) -> int:
    """Copy the records of journal ``src`` into a new journal ``dst`` up to
    and including its ``rounds``-th round record; returns the records
    copied."""
    recs = Journal(src).replay()
    seen = n = 0
    for n, rec in enumerate(recs, 1):
        seen += rec.get("type") == "entry"
        if seen == rounds:
            break
    out = Journal(dst)
    for rec in recs[:n]:
        out.append(rec)
    out.close()
    return n


def segments_equal(a, b) -> bool:
    """Two journals' segment files equal, name by name and byte for byte."""
    sa = sorted(pathlib.Path(a).glob("seg-*.jsonl"))
    sb = sorted(pathlib.Path(b).glob("seg-*.jsonl"))
    return ([p.name for p in sa] == [p.name for p in sb]
            and all(x.read_bytes() == y.read_bytes() for x, y in zip(sa, sb)))


def results_equal(a: dict, b: dict) -> bool:
    """Two cross-match engines' per-query results equal bit for bit, in
    the order the rounds produced them."""
    if sorted(a) != sorted(b):
        return False
    for qid in a:
        if len(a[qid]) != len(b[qid]):
            return False
        for x, y in zip(a[qid], b[qid]):
            for f in ("probe_idx", "match_obj", "best_dot", "n_candidates"):
                u, v = np.asarray(getattr(x, f)), np.asarray(getattr(y, f))
                if u.dtype != v.dtype or u.tobytes() != v.tobytes():
                    return False
    return True


class _RoundCounter:
    """Counts the round records flushed to a journal another process
    writes, reading only each segment's new whole lines."""

    def __init__(self, journal_dir: pathlib.Path) -> None:
        self.dir = journal_dir
        self.offsets: dict = {}
        self.count = 0

    def __call__(self) -> int:
        for seg in sorted(self.dir.glob("seg-*.jsonl")):
            start = self.offsets.get(seg, 0)
            with open(seg, "rb") as fh:
                fh.seek(start)
                data = fh.read()
            end = data.rfind(b"\n") + 1
            self.offsets[seg] = start + end
            self.count += sum(ln.startswith(_ENTRY)
                              for ln in data[:end].split(b"\n"))
        return self.count


# ---------------------------------------------------------------- the drill
class _Setup:
    """What both processes build for one engine: the daemon and fresh
    items for each run (the engines keep state on them)."""

    def __init__(self, engine: str, device, n: int, n_objects: int,
                 cell=None) -> None:
        self.engine, self.device, self.n = engine, device, n
        if engine == "crossmatch":
            self.cat, records = cell or (
                skyquery.make_skyquery_catalog(n_objects), None)
            self.records = (records or skyquery.trace_records(self.cat))[:n]

    def daemon(self, journal_dir) -> ServiceDaemon:
        if self.engine == "crossmatch":
            return crossmatch_daemon(self.cat, journal_dir, self.device)
        return serving_daemon(journal_dir)

    def items(self) -> list:
        if self.engine == "crossmatch":
            return skyquery.queries_for(self.records, "C", self.n)
        return serving_trace(self.n)

    def dispatches(self, daemon) -> int:
        """The engine's device dispatches (the serving daemon has none)."""
        if self.engine == "crossmatch":
            return daemon.host.engine.summary()["device_dispatches"]
        return 0


def run_child(args) -> int:
    setup = _Setup(args.engine, resolve_device(args.device), args.n,
                   args.objects)
    if sys.stdin.readline() != "go\n":  # the parent's go, after its run
        return 1  # the parent went away without one
    daemon = setup.daemon(args.dir)
    drive(daemon, setup.items(), THROTTLE_S)
    daemon.close()
    return 0


def _start_child(args, journal_dir: pathlib.Path) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_SRC) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.benchmarks.smoke_recovery",
           "--child", "--engine", args.engine, "--device", str(args.device),
           "--dir", str(journal_dir), "--n", str(args.n), "--objects",
           str(args.objects)]
    return subprocess.Popen(cmd, env=env, stdin=subprocess.PIPE)


def run_drill(engine: str = "crossmatch", device=None, *, n=None,
              n_objects: int = skyquery.N_OBJECTS, workdir=None, cell=None,
              log=print) -> dict:
    """The whole drill; returns its numbers, raises :class:`DrillFailed`
    (journals left under ``workdir``) if a check fails.  ``cell`` hands
    the parent a cross-match catalog and trace records already made
    (``skyquery``'s at ``n_objects``); the child makes its own."""
    dev = resolve_device(device)
    args = argparse.Namespace(engine=engine, device=dev,
                              n=DEFAULT_N[engine] if n is None else n,
                              objects=n_objects)
    work = pathlib.Path(workdir or tempfile.mkdtemp(prefix="smoke-recovery-"))
    golden_dir, journal_dir = work / "uninterrupted", work / "killed"
    for d in (golden_dir, journal_dir):
        if d.exists():
            shutil.rmtree(d)
    child = _start_child(args, journal_dir)
    try:
        setup = _Setup(engine, dev, args.n, n_objects, cell)
        return _drill(args, setup, child, work, golden_dir, journal_dir, log)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def _drill(args, setup, child, work, golden_dir, journal_dir, log):
    items = setup.items()
    out = {"engine": args.engine, "device": str(args.device),
           "items": len(items)}

    # 2. uninterrupted
    cm_kernel.reset_launches()
    t0 = time.perf_counter()
    golden = setup.daemon(golden_dir)
    journal = out["submit_journal_s"] = {"append": 0.0, "fsync": 0.0}

    def tap(rtype, total_s, fsync_s):  # the journal's latency tap
        if rtype == "submit":
            journal["append"] += total_s
            journal["fsync"] += fsync_s

    golden.journal.obs_tap = tap
    out["intake_s"] = drive(golden, items)
    out["wall_s"] = time.perf_counter() - t0
    golden.close()
    out["rounds"] = len(golden.entries)
    out["launches"] = {"uninterrupted": dict(cm_kernel.LAUNCHES)}
    out["dispatches"] = {"uninterrupted": setup.dispatches(golden)}
    want = journal_records(golden_dir)
    target = math.ceil(out["rounds"] / 3)
    log(f"[drill] uninterrupted: {out['rounds']} rounds, {len(want)} journal "
        f"records, {len(golden.completed())} completed; wall "
        f"{out['wall_s']:.3f}s, intake {out['intake_s']:.3f}s, of it the "
        f"submit records' journal appends {journal['append']:.3f}s "
        f"(json.dumps, write, fsync; the fsyncs {journal['fsync']:.3f}s)")

    # 3. the child over the drill's journal, killed at a third of the rounds
    child.stdin.write(b"go\n")
    child.stdin.close()
    counted = _RoundCounter(journal_dir)
    deadline = time.perf_counter() + TIMEOUT_S
    while (child.poll() is None and counted() < target
           and time.perf_counter() < deadline):
        time.sleep(0.005)
    if child.poll() is not None:
        raise DrillFailed(f"the child exited (rc {child.returncode}) before "
                          f"its journal held {target} round records; "
                          f"journals left under {work}")
    if counted.count < target:
        raise DrillFailed(f"the child's journal held {counted.count} round "
                          f"records after {TIMEOUT_S:.0f}s; journals left "
                          f"under {work}")
    os.kill(child.pid, signal.SIGKILL)
    child.wait()
    out["killed_at_rounds"] = counted()
    log(f"[drill] child killed (SIGKILL) with {out['killed_at_rounds']} of "
        f"{out['rounds']} round records in its journal")

    # 4. recover and finish
    cm_kernel.reset_launches()
    t0 = time.perf_counter()
    rec = setup.daemon(journal_dir)
    out["recovery_s"] = time.perf_counter() - t0
    out["replayed_rounds"] = len(rec.entries)
    acked = set(rec.acked)
    out["acked_at_recovery"] = len(acked)
    drive(rec, setup.items())
    rec.close()
    out["launches"]["recovered"] = dict(cm_kernel.LAUNCHES)
    out["dispatches"]["recovered"] = setup.dispatches(rec)
    log(f"[drill] recovered: {out['replayed_rounds']} rounds replayed in "
        f"{out['recovery_s']:.3f}s, {len(acked)} acked submissions; finished "
        f"with {len(rec.entries)} rounds")

    # 5. the gate
    failures = []
    got = journal_records(journal_dir)
    if got != want:
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                     min(len(got), len(want)))
        failures.append(f"journal records differ from the uninterrupted run's "
                        f"at record {first} ({len(got)} vs {len(want)})")
    completed = rec.completed()
    missing = sorted(k for k in acked
                     if int(k.rsplit("-", 1)[1]) not in completed)
    if missing:
        failures.append(f"acked but never completed: {missing[:10]}")
    if rec.state_fingerprint() != golden.state_fingerprint():
        failures.append("engine state differs from the uninterrupted run's")
    if args.engine == "crossmatch":
        if not results_equal(golden.host.engine.results,
                             rec.host.engine.results):
            failures.append("per-query results differ from the "
                            "uninterrupted run's")
        if args.device.type == "cuda":
            for run in ("uninterrupted", "recovered"):
                n = sum(out["launches"][run].values())
                if n != out["dispatches"][run]:
                    failures.append(f"{run}: {n} kernel launches for "
                                    f"{out['dispatches'][run]} device "
                                    f"dispatches")
    if failures:
        raise DrillFailed("; ".join(failures) + f"; journals left under {work}")
    log(f"[drill] OK: {len(got)} journal records equal, {len(acked)} acked "
        f"pre-kill, {len(completed)} completed, state equal"
        + (", results bit-equal" if args.engine == "crossmatch" else ""))
    shutil.rmtree(work)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="kill -9 recovery drill of the port's service daemon")
    ap.add_argument("--engine", default="crossmatch",
                    choices=sorted(DEFAULT_N))
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    ap.add_argument("--n", type=int, default=None,
                    help="queries or requests (default: 200 or 150)")
    ap.add_argument("--objects", type=int, default=skyquery.N_OBJECTS,
                    help="cross-match catalog objects (10,000 a bucket)")
    ap.add_argument("--dir", default=None,
                    help="work directory (default: a new temporary one)")
    ap.add_argument("--child", action="store_true",
                    help="internal: the process the drill kills")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.child:
        return run_child(args)
    try:
        out = run_drill(args.engine, args.device, n=args.n,
                        n_objects=args.objects, workdir=args.dir)
    except DrillFailed as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 1
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
