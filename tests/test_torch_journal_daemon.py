"""The port's write-ahead journal and service daemon held against the JAX
reference's.

* ``Journal`` mechanics (rotation, restart, torn tail, corruption) on the
  port's copy, whose segment files equal the reference's byte for byte;
  and the one place it differs: a torn tail is sealed before a restart
  buries it mid-journal, where the reference's next replay raises.
* The daemon over the single, sharded and cross-match engines on
  ``device="cpu"`` writes segment files byte-equal to the reference
  daemon's on the same submissions.
* A journal the reference daemon wrote and crashed out of mid-run is
  recovered by the port's daemon, which finishes with the uninterrupted
  reference run's journal.
* The truncation property: replayed state equals live state at any record
  count of a recorded run.
* Admission rejections, idempotent resubmission, the write-ahead ack and
  ``RecoveryError`` behave as in the reference.
* The kill -9 drill (``repro_torch.benchmarks.smoke_recovery``) at a cut
  size, and the launcher's decoding engine under the daemon.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro import crossmatch as jcm  # noqa: E402
from repro import serving as jsrv  # noqa: E402
from repro.core import Journal as JJournal  # noqa: E402
from repro.core import JournalCorrupt as JCorrupt  # noqa: E402
from repro.core import StealConfig as JSteal  # noqa: E402
from repro.core import AdmissionController as JAdm  # noqa: E402
from repro.core import AdmissionQuota as JQuota  # noqa: E402
from repro.core import AdmissionRejected as JRejected  # noqa: E402
from repro_torch import crossmatch as tcm  # noqa: E402
from repro_torch import serving as tsrv  # noqa: E402
from repro_torch.benchmarks import smoke_recovery as drill  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AdmissionController,
    AdmissionQuota,
    AdmissionRejected,
    Journal,
    JournalCorrupt,
    StealConfig,
    diff_entries,
)
from repro_torch.launch import serve as tserve  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


# ----------------------------------------------------------- both packages
@dataclasses.dataclass
class Pkg:
    """One package's side of a scenario: its serving and cross-match
    modules, its steal config, and the device argument its cross-match
    engine takes."""

    srv: object
    cm: object
    Steal: type
    cm_kw: dict


REF = Pkg(jsrv, jcm, JSteal, {})
PORT = Pkg(tsrv, tcm, StealConfig, {"device": "cpu"})
_CATALOGS: dict = {}


def _adapters(pkg, n=6):
    return [pkg.srv.AdapterSpec(a, nbytes=(a + 1) * 1_000_000,
                                tenant="interactive" if a % 2 else "batch")
            for a in range(n)]


def _cfg(pkg, **kw):
    return pkg.srv.ServeConfig(**{**dict(adapter_slots=3, fuse_k=2,
                                         adaptive=True), **kw})


def _catalog(pkg):
    """test_durability's catalog; the port's generator gives the same
    arrays (tests/test_torch_port_boundaries.py)."""
    if pkg.cm not in _CATALOGS:
        _CATALOGS[pkg.cm] = pkg.cm.make_catalog(
            n_objects=3000, objects_per_bucket=200, seed=5)
    return _CATALOGS[pkg.cm]


def _engine(pkg, kind, **cfg):
    if kind == "serving":
        return pkg.srv.LifeRaftEngine(_adapters(pkg), _cfg(pkg, **cfg))
    if kind == "sharded":
        return pkg.srv.ShardedServingEngine(
            _adapters(pkg), _cfg(pkg, **cfg), n_shards=3,
            steal=pkg.Steal(low_water_bytes=50.0))
    return pkg.cm.CrossMatchEngine(_catalog(pkg), cache_capacity=4, fuse_k=2,
                                   **pkg.cm_kw)


def _daemon(pkg, kind, journal_dir, **kw):
    eng = _engine(pkg, kind, **kw.pop("cfg", {}))
    host = (pkg.srv.CrossMatchHost if kind == "crossmatch"
            else pkg.srv.ServingHost)(eng)
    return pkg.srv.ServiceDaemon(host, journal_dir, **kw)


def _items(pkg, kind, n=None):
    if kind == "crossmatch":
        trace = pkg.cm.make_trace(_catalog(pkg), pkg.cm.TraceConfig(
            n_queries=n or 12, seed=9, objects_median=60, arrival_rate=2.0))
        return trace
    return [pkg.srv.Request(request_id=i, adapter_id=(i * 5) % 6,
                            arrival_time=0.01 * i,
                            prompt_len=32 + (i % 7) * 16, max_new_tokens=32)
            for i in range(n or 40)]


CRASH_AFTER = {"serving": 20, "sharded": 25, "crossmatch": 7}
KINDS = sorted(CRASH_AFTER)


def _crash(daemon, items, after):
    """Drive the first ``after`` submissions and abandon the daemon without
    closing it: the in-process stand-in for kill -9."""
    for it in items[:after]:
        daemon.pump(until=it.arrival_time)
        daemon.submit(it)


# ================================================================== journal
class TestJournal:
    def test_rotation_and_replay_order(self, tmp_path):
        j = Journal(tmp_path / "j", segment_bytes=256)
        recs = [{"type": "entry", "entry": {"i": i, "pad": "x" * 40}}
                for i in range(50)]
        for r in recs:
            j.append(r)
        j.close()
        assert len(j.segments()) > 1
        assert Journal(tmp_path / "j").replay() == recs

    def test_restart_opens_new_segment(self, tmp_path):
        for i in range(2):
            j = Journal(tmp_path / "j")
            j.append({"type": "entry", "entry": {"i": i}})
            j.close()
        assert len(j.segments()) == 2
        assert [r["entry"]["i"] for r in j.replay()] == [0, 1]

    def test_torn_tail_dropped(self, tmp_path):
        j = Journal(tmp_path / "j")
        for k in ("a", "b"):
            j.append({"type": "submit", "key": k, "item": {}})
        j.close()
        with open(j.segments()[-1], "a", encoding="utf-8") as fh:
            fh.write('{"type":"submit","key":"c","it')
        assert [r["key"] for r in Journal(tmp_path / "j").replay()] == ["a", "b"]

    def test_mid_journal_corruption_raises(self, tmp_path):
        j = Journal(tmp_path / "j")
        for k in ("a", "b", "c"):
            j.append({"type": "submit", "key": k, "item": {}})
        j.close()
        seg = j.segments()[0]
        lines = seg.read_text().splitlines()
        lines[1] = lines[1][: len(lines[1]) // 2]
        seg.write_text("\n".join(lines) + "\n")
        with pytest.raises(JournalCorrupt):
            Journal(tmp_path / "j").replay()

    @pytest.mark.parametrize("segment_bytes", [200, 1 << 20])
    def test_segments_equal_the_reference(self, tmp_path, segment_bytes):
        recs = [{"type": "entry", "entry": {"i": i, "s": 0.1 * i}}
                for i in range(30)]
        for name, J in (("t", Journal), ("j", JJournal)):
            for part in (recs[:12], recs[12:]):  # a restart between them
                j = J(tmp_path / name, segment_bytes=segment_bytes, kind="x")
                for r in part:
                    j.append(r, sync=r["entry"]["i"] % 5 == 0)
                j.close()
        assert drill.segments_equal(tmp_path / "t", tmp_path / "j")

    @pytest.mark.parametrize("tail,kept", [('{"type":"submit","key":"c","it',
                                            ["a", "b"]),
                                           ('{"type":"submit","key":"c"}',
                                            ["a", "b", "c"])])
    def test_restart_seals_a_torn_tail(self, tmp_path, tail, kept):
        """A crash tore the last line (or cut only its newline); a restart
        appends; the next restart must still replay.  The reference's
        journal buries a torn line mid-journal and then raises."""
        for name, J in (("t", Journal), ("j", JJournal)):
            j = J(tmp_path / name)
            for k in ("a", "b"):
                j.append({"type": "submit", "key": k, "item": {}})
            j.close()
            with open(j.segments()[-1], "a", encoding="utf-8") as fh:
                fh.write(tail)
            j = J(tmp_path / name)
            assert [r["key"] for r in j.replay()] == kept
            j.append({"type": "submit", "key": "d", "item": {}})
            j.close()
        assert [r["key"] for r in Journal(tmp_path / "t").replay()] == kept + ["d"]
        if kept == ["a", "b"]:
            with pytest.raises(JCorrupt):
                JJournal(tmp_path / "j").replay()


# ======================================================= against the reference
@pytest.mark.parametrize("kind", KINDS)
def test_daemon_segments_equal_the_reference(tmp_path, kind):
    runs = {}
    for name, pkg in (("t", PORT), ("j", REF)):
        d = _daemon(pkg, kind, tmp_path / name)
        drill.drive(d, _items(pkg, kind))
        d.close()
        runs[name] = d
    assert drill.segments_equal(tmp_path / "t", tmp_path / "j")
    assert runs["t"].entries == runs["j"].entries
    assert runs["t"].completed() == runs["j"].completed()
    assert runs["t"].state_fingerprint() == runs["j"].state_fingerprint()


@pytest.mark.parametrize("kind", KINDS)
def test_port_recovers_a_reference_journal(tmp_path, kind):
    golden = _daemon(REF, kind, tmp_path / "golden")
    drill.drive(golden, _items(REF, kind))
    golden.close()
    _crash(_daemon(REF, kind, tmp_path / "crashed"), _items(REF, kind),
           CRASH_AFTER[kind])
    rec = _daemon(PORT, kind, tmp_path / "crashed")
    assert 0 < len(rec.entries) < len(golden.entries)
    drill.drive(rec, _items(PORT, kind))
    rec.close()
    assert diff_entries(golden.entries, rec.entries) == []
    assert (drill.journal_records(tmp_path / "crashed")
            == drill.journal_records(tmp_path / "golden"))
    assert rec.completed() == golden.completed()
    assert rec.state_fingerprint() == golden.state_fingerprint()


# ================================================= truncation property
def _record_run(kind):
    """Drive a port daemon one operation at a time, capturing the engine
    state at every journal record count reached."""
    dirpath = tempfile.mkdtemp(prefix="rec-")
    try:
        d = _daemon(PORT, kind, dirpath)
        points = {d.journal.appended: d.state_fingerprint()}

        def settle(until):
            while d.host.has_work() and (until is None
                                         or d.host.clock() < until):
                if d.host.step() is None:
                    break
                points[d.journal.appended] = d.state_fingerprint()

        for it in _items(PORT, kind, 24 if kind != "crossmatch" else None):
            settle(it.arrival_time)
            d.submit(it)
            points[d.journal.appended] = d.state_fingerprint()
        settle(None)
        d.close()
        return d.journal.replay(), points
    finally:
        shutil.rmtree(dirpath)


_RECORDED: dict = {}


def _check_truncation(kind, draw):
    if kind not in _RECORDED:
        _RECORDED[kind] = _record_run(kind)
    records, points = _RECORDED[kind]
    counts = sorted(points)
    t = counts[draw % len(counts)]
    tmp = tempfile.mkdtemp(prefix="truncation-")
    try:
        trunc = Journal(tmp)
        for rec in records[:t]:
            trunc.append(rec)
        trunc.close()
        d = _daemon(PORT, kind, tmp)
        fp = d.state_fingerprint()
        d.close()
        assert fp == points[t], f"state diverged at truncation point {t}"
    finally:
        shutil.rmtree(tmp)


class TestTruncationProperty:
    @settings(max_examples=5, deadline=None)
    @given(st.integers(min_value=0, max_value=10_000))
    def test_crossmatch_state_matches_at_any_truncation(self, draw):
        _check_truncation("crossmatch", draw)

    @settings(max_examples=6, deadline=None)
    @given(st.integers(min_value=0, max_value=10_000))
    def test_serving_state_matches_at_any_truncation(self, draw):
        _check_truncation("serving", draw)

    @settings(max_examples=4, deadline=None)
    @given(st.integers(min_value=0, max_value=10_000))
    def test_sharded_state_matches_at_any_truncation(self, draw):
        _check_truncation("sharded", draw)


# ================================================================ behaviour
def _rejections(pkg, Adm, Quota, Rejected, journal_dir):
    adm = Adm({"batch": Quota(max_queue_depth=2)})
    d = _daemon(pkg, "serving", journal_dir, admission=adm)
    rejected = []
    for r in _items(pkg, "serving", 10):  # no pumping: queues only grow
        try:
            d.submit(r)
        except Rejected:
            rejected.append(r.request_id)
    with pytest.raises(Rejected):  # the cached 429 re-raised
        d.submit(_items(pkg, "serving", 10)[rejected[0]])
    d.close()
    return adm, rejected


def test_rejections_journaled_and_replayed_as_the_reference(tmp_path):
    adm, rejected = _rejections(PORT, AdmissionController, AdmissionQuota,
                                AdmissionRejected, tmp_path / "t")
    _, want = _rejections(REF, JAdm, JQuota, JRejected, tmp_path / "j")
    assert rejected == want and rejected
    assert drill.segments_equal(tmp_path / "t", tmp_path / "j")
    d2 = _daemon(PORT, "serving", tmp_path / "t", admission=adm)
    for rid in rejected:
        assert d2.disposition(f"req-{rid}") == "rejected"
        with pytest.raises(AdmissionRejected):
            d2.submit(_items(PORT, "serving", 10)[rid])
    d2.close()


def test_retry_after_drain_admits(tmp_path):
    adm = AdmissionController({"batch": AdmissionQuota(max_queue_depth=2)})
    d = _daemon(PORT, "serving", tmp_path / "j", admission=adm)
    reqs = [r for r in _items(PORT, "serving", 12) if r.adapter_id % 2 == 0]
    for r in reqs:
        try:
            d.submit(r)
        except AdmissionRejected:
            got = r.request_id
            break
    d.pump()
    assert d.submit(_items(PORT, "serving", 12)[got],
                    retry=True)["status"] == "acked"
    d.close()
    d2 = _daemon(PORT, "serving", tmp_path / "j", admission=adm)
    assert d2.disposition(f"req-{got}") == "acked"
    d2.close()


def test_idempotent_resubmission_and_write_ahead_ack(tmp_path):
    d = _daemon(PORT, "serving", tmp_path / "j")
    assert d.submit(_items(PORT, "serving", 1)[0])["status"] == "acked"
    recs = Journal(tmp_path / "j").replay()  # durable before pump or close
    assert [(r["type"], r["key"]) for r in recs] == [("submit", "req-0")]
    before = d.journal.appended
    assert d.submit(_items(PORT, "serving", 1)[0])["status"] == "duplicate"
    assert d.journal.appended == before  # duplicates are not journaled
    d.close()


def test_recovery_refuses_divergent_engine(tmp_path):
    d = _daemon(PORT, "serving", tmp_path / "j")
    drill.drive(d, _items(PORT, "serving", 10))
    d.close()
    with pytest.raises(tsrv.RecoveryError):
        _daemon(PORT, "serving", tmp_path / "j",
                cfg=dict(adaptive=False, alpha=0.9))


def test_recovery_tolerates_torn_tail(tmp_path):
    d = _daemon(PORT, "serving", tmp_path / "j")
    _crash(d, _items(PORT, "serving", 8), 8)
    d.journal._fh.write('{"type":"entry","ent')  # crash mid-append
    d.journal._fh.flush()
    rec = _daemon(PORT, "serving", tmp_path / "j")
    drill.drive(rec, _items(PORT, "serving", 8))
    rec.close()
    golden = _daemon(PORT, "serving", tmp_path / "g")
    drill.drive(golden, _items(PORT, "serving", 8))
    golden.close()
    assert diff_entries(golden.entries, rec.entries) == []
    assert (drill.journal_records(tmp_path / "j")
            == drill.journal_records(tmp_path / "g"))


# ============================================================ the drills
@pytest.mark.parametrize("args", [
    ["--engine", "serving", "--n", "60"],
    ["--engine", "crossmatch", "--objects", "40000", "--n", "10"],
], ids=["serving", "crossmatch"])
def test_kill9_drill(tmp_path, args):
    """SIGKILL a journaling daemon mid-run, recover, and require the
    uninterrupted run's journal, every acked item completed, equal state
    (and, for the cross-match, equal results)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.smoke_recovery",
         "--device", "cpu", "--dir", str(tmp_path / "work"), *args],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=280)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    assert "[drill] OK" in proc.stdout
    assert not (tmp_path / "work").exists()  # removed on success


def test_launcher_engine_under_the_daemon(tmp_path):
    """The launcher's trace and decoding engine (smoke config, on the
    CPU) behind the daemon journal what the ``--no-decode`` engine does;
    a copy cut after half its rounds recovers, re-decoding, to the same
    journal."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import registry as models

    args = tserve.build_parser().parse_args(
        ["--arch", "moonshot-v1-16b-a3b", "--requests", "6", "--device", "cpu"])
    cfg = smoke_config(args.arch)
    params = models.init_params(cfg, torch.Generator().manual_seed(0))

    def run(journal_dir, decode):
        stats = tserve.DecodeStats()
        fn = (tserve.make_decode_fn(cfg, params, "cpu", stats) if decode
              else None)
        d = tsrv.ServiceDaemon(
            tsrv.ServingHost(tserve.make_engine(args, fn)), journal_dir)
        drill.drive(d, tserve.make_requests(args.requests, args.tenants,
                                            args.rate))
        d.close()
        return d, stats

    full, stats = run(tmp_path / "decode", True)
    run(tmp_path / "dry", False)
    assert stats.steps > 0
    assert drill.segments_equal(tmp_path / "decode", tmp_path / "dry")
    half = len(full.entries) // 2
    drill.cut_journal(tmp_path / "decode", tmp_path / "cut", half)
    rec, rstats = run(tmp_path / "cut", True)
    assert (drill.journal_records(tmp_path / "cut")
            == drill.journal_records(tmp_path / "decode"))
    assert rstats.steps == stats.steps  # the replay re-decoded its half
