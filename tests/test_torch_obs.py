"""The port's observability layer held against the JAX reference's.

* All 14 goldens replay bit-identically through the port with ``obs`` on
  (and the tap fired): the layer only reads what the decision taps hand
  it.
* On the virtual clock (the simulator and serving scenarios) nothing
  wall-clock enters the registry, so the port's metrics snapshot,
  Prometheus text and Perfetto trace equal the reference's exactly.
* The cross-match engine ticks on the wall clock: one round span per
  round, the round counter equal to the rounds.
* The service daemon's endpoints: admission verdicts equal the
  reference's, journal append/fsync histograms count every synced record.
* With ``obs`` off, ``repro_torch.obs`` is never imported (subprocess).
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import replay  # noqa: E402
from repro.core import AdmissionController as JAdm  # noqa: E402
from repro.core import AdmissionQuota as JQuota  # noqa: E402
from repro.core import AdmissionRejected as JRejected  # noqa: E402
from repro.obs import Observability as JObs  # noqa: E402
from repro import serving as jsrv  # noqa: E402
from repro_torch.core import AdmissionController as TAdm  # noqa: E402
from repro_torch.core import AdmissionQuota as TQuota  # noqa: E402
from repro_torch.core import AdmissionRejected as TRejected  # noqa: E402
from repro_torch.obs import MetricsRegistry, Observability as TObs  # noqa: E402
from repro_torch import serving as tsrv  # noqa: E402
from test_torch_simulate import port_replay  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
VIRTUAL = sorted(n for n in replay.SCENARIOS if not n.startswith("crossmatch"))
_MEMO: dict = {}


def _obs_run(pkg: str, name: str):
    """One obs-on run of a golden scenario through ``pkg`` (``port`` or
    ``ref``), shared across tests."""
    key = (pkg, name)
    if key not in _MEMO:
        obs = TObs() if pkg == "port" else JObs()
        scenarios = port_replay.SCENARIOS if pkg == "port" else replay.SCENARIOS
        _MEMO[key] = (obs, scenarios[name](obs=obs))
    return _MEMO[key]


def _rounds(obs) -> float:
    series = obs.snapshot()["metrics"]["liferaft_rounds_total"]["series"]
    return sum(s["value"] for s in series)


@pytest.mark.parametrize("name", sorted(replay.SCENARIOS))
def test_goldens_bit_identical_with_obs_on(name):
    obs, got = _obs_run("port", name)
    expect = replay.load_trace(replay.GOLDEN_DIR / f"{name}.json")
    divergence = replay.diff_traces(expect, got)
    assert not divergence, "\n".join(divergence)
    assert got == expect
    assert _rounds(obs) == len([e for e in got if "steal" not in e])


@pytest.mark.parametrize("name", VIRTUAL)
def test_virtual_clock_exports_equal_the_reference(name):
    port, _ = _obs_run("port", name)
    ref, _ = _obs_run("ref", name)
    assert port.snapshot() == ref.snapshot()
    assert port.prometheus() == ref.prometheus()
    assert port.perfetto() == ref.perfetto()


@pytest.mark.parametrize("name", ["crossmatch_fused", "crossmatch_sharedplan"])
def test_crossmatch_wall_clock_spans_one_a_round(name):
    obs, got = _obs_run("port", name)
    doc = json.loads(json.dumps(obs.perfetto()))
    spans = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["name"] == "round"]
    assert len(spans) == len(got) == _rounds(obs)
    assert all(e["dur"] >= 0 for e in spans)


def test_steal_arrows_cross_tracks():
    evs = _obs_run("port", "sim_shard_steal")[0].perfetto()["traceEvents"]
    starts = {e["id"]: e for e in evs
              if e.get("cat") == "steal" and e["ph"] == "s"}
    finishes = [e for e in evs if e.get("cat") == "steal" and e["ph"] == "f"]
    assert starts and len(starts) == len(finishes)
    assert all(f["tid"] != starts[f["id"]]["tid"] for f in finishes)


def test_histogram_edges_match_reference():
    from repro.obs import MetricsRegistry as JRegistry

    hists = []
    for reg in (MetricsRegistry(), JRegistry()):
        h = reg.histogram("t_seconds", "ladder", buckets=(1.0, 2.0, 5.0))
        for v in (0.5, 1.0, 1.5, 5.0, 7.0, -1.0):
            h.observe(v)
        hists.append(h)
    t, j = hists
    assert list(t.cumulative()) == list(j.cumulative())
    assert dict(t.cumulative())[5.0] == 5  # 5.0 lands in le=5.0
    assert (t.count, t.sum) == (j.count, j.sum)
    assert [t.quantile(q) for q in (0.5, 0.95, 1.0)] == [
        j.quantile(q) for q in (0.5, 0.95, 1.0)]
    with pytest.raises(ValueError, match="ascending"):
        MetricsRegistry().histogram("bad_seconds", "", buckets=(2.0, 1.0))


# ------------------------------------------------------------ daemon endpoints
def _daemon_run(srv, Obs, Adm, Quota, Rejected, journal_dir):
    adapters = [srv.AdapterSpec(a, nbytes=(a + 1) * 1_000_000,
                                tenant="interactive" if a % 2 else "batch")
                for a in range(6)]
    obs = Obs()
    eng = srv.LifeRaftEngine(
        adapters, srv.ServeConfig(adapter_slots=3, fuse_k=2, adaptive=True),
        obs=obs)
    d = srv.ServiceDaemon(srv.ServingHost(eng), journal_dir,
                          admission=Adm({"batch": Quota(max_queue_depth=2)}),
                          obs=obs)
    verdicts = []
    for i in range(12):  # no pumping: the batch tenant must hit its quota
        try:
            d.submit(srv.Request(i, (i * 5) % 6, 0.01 * i, 32 + (i % 7) * 16,
                                 32))
            verdicts.append("acked")
        except Rejected as exc:
            verdicts.append(exc.reason)
    d.pump()
    d.close()
    return d, verdicts


def test_daemon_endpoints_match_reference(tmp_path):
    port, tv = _daemon_run(tsrv, TObs, TAdm, TQuota, TRejected, tmp_path / "t")
    ref, jv = _daemon_run(jsrv, JObs, JAdm, JQuota, JRejected, tmp_path / "j")
    assert tv == jv and "queue_depth" in tv
    tm = port.metrics_snapshot()["metrics"]
    jm = ref.metrics_snapshot()["metrics"]
    for family in ("liferaft_admission_total",
                   "liferaft_admission_rejected_total",
                   "liferaft_rounds_total"):
        assert tm[family] == jm[family]
    fsyncs = tm["liferaft_journal_fsync_seconds"]["series"][0]
    assert fsyncs["count"] == len(tv) and fsyncs["sum"] > 0.0
    text = port.metrics_text()
    assert "# TYPE liferaft_admission_total counter" in text
    assert "liferaft_journal_fsync_seconds_bucket" in text


def test_obs_off_endpoints_are_empty(tmp_path):
    eng = tsrv.LifeRaftEngine([tsrv.AdapterSpec(0, 1)], tsrv.ServeConfig())
    d = tsrv.ServiceDaemon(tsrv.ServingHost(eng), tmp_path / "j")
    assert d.metrics_text() == "" and d.metrics_snapshot() == {}
    d.close()


def test_obs_never_imported_when_disabled():
    """Every engine, the simulator and the daemon with ``obs`` off leave
    ``repro_torch.obs`` out of ``sys.modules``."""
    code = (
        "import sys, tempfile\n"
        "import test_torch_simulate as t\n"
        "for name in ('sim_raw_fused', 'sim_shard_steal', 'serving_static',\n"
        "             'crossmatch_sharedplan'):\n"
        "    t.port_replay.SCENARIOS[name]()\n"
        "from repro_torch.benchmarks import smoke_recovery as s\n"
        "d = s.serving_daemon(tempfile.mkdtemp())\n"
        "s.drive(d, s.serving_trace(10))\n"
        "d.close()\n"
        "bad = sorted(m for m in sys.modules if m.startswith('repro_torch.obs'))\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "CLEAN" in res.stdout
