"""The port's host-only drivers held against the reference's, on the CPU.

``examples/quickstart.py``, the Fig. 5-8 drivers and ``bench_shard``,
``bench_obs``, ``bench_adaptive``, ``bench_prefetch`` and
``serving_bench`` run on the simulator, the cost model and the serving
engine's simulated clock: the port's copies (``device="cpu"``) must give
the reference's reports key by key, wall-clock fields aside
(``bench_obs``'s overhead times and the gate read from them).  Fig. 5-7
take the reference's 2,000-query trace; here the same 100-query cut of it
is patched into both packages' ``common.TRACE_KW`` (and their memo caches
emptied), and Fig. 8 runs at 20 queries a saturation (its 800 take
minutes: every query touches dozens of buckets).  The harness
(``repro_torch.benchmarks.run``) is checked with its sections' ``main``
replaced: one failing section must not stop it, and it exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import runpy
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the reference's ``benchmarks`` package

import benchmarks.bench_adaptive as j_adaptive  # noqa: E402
import benchmarks.bench_obs as j_obs  # noqa: E402
import benchmarks.bench_prefetch as j_prefetch  # noqa: E402
import benchmarks.bench_shard as j_shard  # noqa: E402
import benchmarks.common as j_common  # noqa: E402
import benchmarks.fig5_bucket_reuse as j_fig5  # noqa: E402
import benchmarks.fig6_workload_cdf as j_fig6  # noqa: E402
import benchmarks.fig7_schedulers as j_fig7  # noqa: E402
import benchmarks.fig8_tradeoff as j_fig8  # noqa: E402
import benchmarks.serving_bench as j_serving  # noqa: E402
from repro.core import AlphaController  # noqa: E402
from repro_torch.benchmarks import bench_adaptive as t_adaptive  # noqa: E402
from repro_torch.benchmarks import bench_obs as t_obs  # noqa: E402
from repro_torch.benchmarks import bench_prefetch as t_prefetch  # noqa: E402
from repro_torch.benchmarks import bench_shard as t_shard  # noqa: E402
from repro_torch.benchmarks import common as t_common  # noqa: E402
from repro_torch.benchmarks import fig5_bucket_reuse as t_fig5  # noqa: E402
from repro_torch.benchmarks import fig6_workload_cdf as t_fig6  # noqa: E402
from repro_torch.benchmarks import fig7_schedulers as t_fig7  # noqa: E402
from repro_torch.benchmarks import fig8_tradeoff as t_fig8  # noqa: E402
from repro_torch.benchmarks import ft_bench as t_ft  # noqa: E402
from repro_torch.benchmarks import run as t_run  # noqa: E402
from repro_torch.benchmarks import serving_bench as t_serving  # noqa: E402
from repro_torch.examples import quickstart as t_quick  # noqa: E402

CPU = "cpu"
CUT_QUERIES = 100
FIG8_QUERIES = 20


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small ops: the test workers share the
    host's cores, and thread pools fighting over them cost more than the
    ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cut_trace(monkeypatch):
    """The same 100-query cut of the Fig. 5-7 trace in both packages."""
    for common, fig5 in ((j_common, j_fig5), (t_common, t_fig5)):
        monkeypatch.setitem(common.TRACE_KW, "n_queries", CUT_QUERIES)
        monkeypatch.setattr(common, "_cache", {})
        monkeypatch.setattr(fig5, "_STATS_CACHE", {})


def test_quickstart_prints_the_reference_report(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(sys, "argv", ["quickstart.py"])
    runpy.run_path(str(ROOT / "examples" / "quickstart.py"), run_name="__main__")
    want = capsys.readouterr().out
    report = t_quick.run(device=CPU, out_path=tmp_path / "q.json")
    assert capsys.readouterr().out == want
    assert json.loads((tmp_path / "q.json").read_text()) == json.loads(
        json.dumps(report))
    assert report["device"] == "cpu" and len(report["policies"]) == 4


def test_fig5_and_fig6_match_reference(cut_trace, tmp_path):
    want5 = j_fig5.run(verbose=False)
    got5 = t_fig5.run(verbose=False, device=CPU, out_path=tmp_path / "5.json")
    for k in ("top10_query_frac", "bucket_frac_for_50pct", "gini_load"):
        assert got5[k] == want5[k]
    assert got5["top10_touch"] == sorted(want5["touch"].tolist(),
                                         reverse=True)[:10]
    stats, _, _ = t_fig5.stats()
    for k in ("touch", "load"):
        assert stats[k].tolist() == want5[k].tolist()
    want6 = j_fig6.run(verbose=False)
    got6 = t_fig6.run(verbose=False, device=CPU, out_path=None)
    assert got6["bucket_frac_by_workload_frac"] == {
        str(k): v for k, v in want6.items()}


def test_fig7_matches_reference(cut_trace):
    want = j_fig7.run(verbose=False)
    got = t_fig7.run(verbose=False, device=CPU, out_path=None)
    assert got["policies"] == {k: dataclasses.asdict(r) for k, r in want.items()}


def test_fig8_matches_reference():
    table, choices = j_fig8.run(verbose=False, n_queries=FIG8_QUERIES)
    got = t_fig8.run(verbose=False, n_queries=FIG8_QUERIES, device=CPU, out_path=None)
    assert got["alpha_choices"] == {str(s): a for s, a in choices.items()}
    for sat in j_fig8.SATURATIONS:
        want = [{"alpha": p.alpha, "throughput": p.throughput,
                 "response": p.response} for p in table.curve(sat)]
        assert got["points"][str(sat)] == want
    ctl = AlphaController(table, tolerance=0.2, initial_alpha=0.0,
                          halflife_s=30.0)
    a = 0.0
    for t in range(40):
        a = ctl.update_on_arrival(t * 10.0)
    assert got["controller_alpha"] == a


@pytest.mark.parametrize("name", ["shard", "prefetch", "adaptive"])
def test_bench_report_matches_reference(name, tmp_path):
    j_mod = {"shard": j_shard, "prefetch": j_prefetch,
             "adaptive": j_adaptive}[name]
    t_mod = {"shard": t_shard, "prefetch": t_prefetch,
             "adaptive": t_adaptive}[name]
    want = j_mod.run(str(tmp_path / "ref.json"), verbose=False)
    got = t_mod.run(str(tmp_path / "port.json"), verbose=False, device=CPU)
    assert got.pop("device") == "cpu"
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def test_bench_obs_matches_reference(tmp_path, monkeypatch):
    """The overhead section's times and the gate read from them are wall
    clock; the rounds observed and the exported artifacts must agree."""
    monkeypatch.chdir(tmp_path)  # the reference's artifacts go to cwd
    want = j_obs.run(str(tmp_path / "ref.json"), verbose=False)
    (tmp_path / "port").mkdir()
    got = t_obs.run(str(tmp_path / "port" / "port.json"), verbose=False,
                    device=CPU)
    assert got["overhead"]["rounds_observed"] == want["overhead"]["rounds_observed"]
    assert set(got["overhead"]) == set(want["overhead"])
    ga, wa = dict(got["artifacts"]), dict(want["artifacts"])
    assert pathlib.Path(ga.pop("snapshot_path")).name == "OBS_torch_snapshot.json"
    assert pathlib.Path(ga.pop("trace_path")).name == "OBS_torch_trace.perfetto.json"
    wsnap, wtrace = wa.pop("snapshot_path"), wa.pop("trace_path")
    assert ga == wa and ga["passed"]
    assert json.loads((tmp_path / "port" / "OBS_torch_snapshot.json")
                      .read_text()) == json.loads(pathlib.Path(wsnap).read_text())
    assert json.loads((tmp_path / "port" / "OBS_torch_trace.perfetto.json")
                      .read_text()) == json.loads(pathlib.Path(wtrace).read_text())


def test_serving_bench_matches_reference():
    want = j_serving.run(verbose=False)
    got = t_serving.run(verbose=False, device=CPU, out_path=None)
    assert json.loads(json.dumps(got["policies"], default=float)) == \
        json.loads(json.dumps(want, default=float))


def test_harness_runs_every_section_and_fails_if_one_fails(monkeypatch,
                                                           tmp_path, capsys):
    calls = []
    mods = _harness_sections()
    for i, mod in enumerate(mods):
        def fake(argv, name=mod.__name__, fail=(i == 1)):
            calls.append((name, argv))
            if fail:
                raise AssertionError("gate")
        monkeypatch.setattr(mod, "main", fake)
    rc = t_run.main(["--device", "cpu", "--out-dir", str(tmp_path)])
    assert rc == 1
    assert [c[0] for c in calls] == [m.__name__ for m in mods]
    assert all(c[1][-2:] == ["--device", "cpu"] for c in calls)
    assert calls[5][1][1] == str(tmp_path / "BENCH_torch_scheduler.json")
    out = capsys.readouterr().out
    assert "BENCH-ERROR" in out and "failures=1" in out
    assert "Fault tolerance" in out and "Roofline" in out


def _harness_sections():
    from repro_torch.benchmarks import (
        bench_scheduler, bench_sharedplan, kernel_bench, fig2_hybrid_join,
        roofline_table)
    return [fig2_hybrid_join, t_fig5, t_fig6, t_fig7, t_fig8, bench_scheduler,
            t_adaptive, t_prefetch, bench_sharedplan, t_shard, t_obs,
            t_serving, kernel_bench, t_ft, roofline_table]
