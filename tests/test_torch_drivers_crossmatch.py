"""The port's device-facing drivers held against the reference's, on the CPU.

Each test runs a driver of ``repro_torch`` on ``device="cpu"`` (the plain
PyTorch versions of the kernels) and the reference's driver
(``benchmarks/<name>.py``, ``examples/<name>.py``) on the same inputs:

* ``examples/crossmatch_skyquery.py``: the printed summary, line for line
  (the first line names the join path and differs);
* ``fig2_hybrid_join``: the cost-model view equal; in the measured view
  both drivers' ``time_call`` is replaced by a recorder that runs each
  timed call once and keeps what it returns, so the best indices of every
  scan and indexed join are compared (equal), and each w's scan of the
  port is held to the reference's join on the same inputs under the join
  contract (2^-23, ``assert_join_close``);
* ``bench_scheduler``: ``select_at_1k_buckets`` (the counts; its times are
  wall clock), ``decision_equivalence``, ``compile_count`` (the port's
  padded-shape count against the reference's ``jit_cache_size`` delta,
  run in a subprocess so its jit cache starts empty) and
  ``fused_dispatch`` (all but its wall), at 60 and 40 queries where the
  reference's jit compiles take minutes at 500 and 120;
* ``bench_sharedplan``: all three sections, equal key by key;
* ``kernel_bench``: the recorded outputs of each timed call: K1's indices
  equal, K5 in f32 and the reference's f32 result both within the f32
  dot-product bound of the float64 product (d = 1024 > 512, as
  ``tests/test_torch_kernels_cuda.py`` says), K5 in bf16 and K4 in bf16
  against the reference's f32 at its bf16 tolerance, 5e-2.
"""
from __future__ import annotations

import json
import os
import pathlib
import runpy
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the reference's ``benchmarks`` package

import benchmarks.bench_scheduler as j_sched  # noqa: E402
import benchmarks.bench_sharedplan as j_shared  # noqa: E402
import benchmarks.fig2_hybrid_join as j_fig2  # noqa: E402
import benchmarks.kernel_bench as j_kb  # noqa: E402
from repro.kernels.crossmatch import ops as jops  # noqa: E402
from repro_torch.benchmarks import bench_scheduler as t_sched  # noqa: E402
from repro_torch.benchmarks import bench_sharedplan as t_shared  # noqa: E402
from repro_torch.benchmarks import fig2_hybrid_join as t_fig2  # noqa: E402
from repro_torch.benchmarks import kernel_bench as t_kb  # noqa: E402
from repro_torch.benchmarks.common import Timing  # noqa: E402
from repro_torch.examples import crossmatch_skyquery as t_sky  # noqa: E402
from test_torch_kernels_cuda import assert_join_close  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small ops: the test workers share the
    host's cores, and thread pools fighting over them cost more than the
    ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorder(outputs, timing):
    """A ``time_call`` that runs the call once and records its output."""
    def time_call(fn, *args, **kw):
        for k in ("device", "reps", "warmup"):
            kw.pop(k, None)
        outputs.append(fn(*args, **kw))
        return timing
    return time_call


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


# ------------------------------------------------------------------ example
def test_crossmatch_skyquery_prints_the_reference_summary(monkeypatch, capsys,
                                                          tmp_path):
    monkeypatch.setattr(sys, "argv", ["crossmatch_skyquery.py", "--queries",
                                      "20"])
    runpy.run_path(str(ROOT / "examples" / "crossmatch_skyquery.py"),
                   run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    report = t_sky.run(queries=20, device=CPU,
                       out_path=tmp_path / "report.json")
    got = capsys.readouterr().out.splitlines()
    assert got[0].endswith("(cpu join path)...")
    assert got[1:] == want[1:]
    assert json.loads((tmp_path / "report.json").read_text())["device"] == "cpu"
    assert report["summary"]["n_queries"] == 20


# ------------------------------------------------------------------ Fig. 2
def test_fig2_cost_model_view_matches_reference():
    assert t_fig2.model_view(False) == j_fig2.model_view(False)


def test_fig2_measured_view_joins_match_reference(monkeypatch):
    j_out, t_out = [], []
    monkeypatch.setattr(j_fig2, "time_call", _recorder(j_out, 1.0))
    monkeypatch.setattr(t_fig2, "time_call", _recorder(t_out, Timing(1.0, None)))
    j_rows = j_fig2.measured_view(verbose=False)
    t_rows, joins, calls = t_fig2.measured_view(verbose=False, device=CPU)
    assert [r[0] for r in j_rows] == [r["w"] for r in t_rows] == list(t_fig2.WIDTHS)
    # per w: the scan's indices, then the list of w indexed joins' indices
    assert len(j_out) == len(t_out) == 2 * len(t_fig2.WIDTHS)
    for j, t in zip(j_out, t_out):
        if isinstance(j, list):
            assert len(j) == len(t)
            for a, b in zip(j, t):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
    for join in joins:
        want = jops.crossmatch(join["bucket"], join["probes"], t_fig2.THR)
        assert_join_close(join["scan"], want, join["bucket"], join["probes"],
                          t_fig2.THR)
    assert calls == sum(2 + w for w in t_fig2.WIDTHS)


def test_fig2_report_on_cpu(tmp_path):
    report = t_fig2.run(verbose=False, device=CPU, widths=(8, 64),
                        out_path=tmp_path / "fig2.json")
    on_disk = json.loads((tmp_path / "fig2.json").read_text())
    assert on_disk["device"] == "cpu"
    assert on_disk["model"]["break_even_frac"] == pytest.approx(0.03)
    for row in report["measured"]:
        assert row["scan_event_us"] is None and row["scan_device_part_us"] is None
        assert row["scan_wall_us"] > 0 and row["indexed_wall_us"] > 0
    assert report["measured_break_even"]["device_part_probes"] is None
    # each w: the kept scan, 2 + 5 timed scans and 1 + 3 timed index passes
    assert report["joins"] == sum(8 + 4 * w for w in (8, 64))


# ------------------------------------------------------------------ scheduler
def test_scheduler_select_section_counts_match_reference():
    keys = ("naive_nonempty_buckets", "incremental_nonempty_buckets")
    j, t = j_sched.bench_select(), t_sched.bench_select()
    assert {k: j[k] for k in keys} == {k: t[k] for k in keys}
    assert set(j) == set(t)


def test_scheduler_decision_equivalence_matches_reference():
    assert t_sched.bench_equivalence() == j_sched.bench_equivalence()


def test_compile_count_matches_reference_jit_cache():
    """The reference counts its jit cache's new entries; it runs in a fresh
    interpreter so the cache starts empty."""
    code = ("import json, benchmarks.bench_scheduler as b; "
            "print(json.dumps(b.bench_compiles(60)))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = t_sched.bench_compiles(60, device=CPU)
    assert got == want
    assert got["within_bound"] and got["shapes_compiled"] > 1


def test_fused_dispatch_matches_reference():
    def drop_wall(r):
        return {k: {kk: vv for kk, vv in v.items() if kk != "wall_s"}
                for k, v in r.items()}

    assert drop_wall(t_sched.bench_fused(40, device=CPU)) == \
        drop_wall(j_sched.bench_fused(40))


# ------------------------------------------------------------------ shared plan
def test_sharedplan_dispatch_reduction_matches_reference():
    got = t_shared.bench_dispatch_reduction(device=CPU)
    want = j_shared.bench_dispatch_reduction()
    assert got == want
    assert got["passed"] and got["results_bit_equal"]


def test_sharedplan_compile_bounding_and_width_law_match_reference():
    assert t_shared.bench_compile_bounding(device=CPU) == \
        j_shared.bench_compile_bounding()
    assert t_shared.bench_width_law() == j_shared.bench_width_law()


def test_compile_bounding_counts_within_its_section():
    """A section counts the keys of its own calls, whatever ran before."""
    first = t_shared.bench_compile_bounding(device=CPU)
    again = t_shared.bench_compile_bounding(device=CPU)
    assert first["new_cache_entries"] == again["new_cache_entries"] == 1


# ------------------------------------------------------------------ kernels
def _f32_bound_ok(y, x, sizes, w):
    """y within sqrt(d) * 2^-24 * sum|x||w| of the float64 product."""
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    gid = np.repeat(np.arange(len(sizes)), sizes)
    for g in range(len(sizes)):
        rows = gid == g
        exact = x64[rows] @ w64[g]
        tol = np.sqrt(x.shape[1]) * 2.0**-24 * (np.abs(x64[rows]) @ np.abs(w64[g]))
        assert (np.abs(y[rows] - exact) <= tol).all()


def test_kernel_bench_outputs_match_reference(monkeypatch):
    j_out, t_out = [], []
    monkeypatch.setattr(j_kb, "time_call", _recorder(j_out, 1.0))
    monkeypatch.setattr(t_kb, "time_call", _recorder(t_out, Timing(1.0, None)))
    j_kb.run(verbose=False)
    report = t_kb.run(verbose=False, device=CPU, out_path=None)
    # K1; K5 bf16 and f32 (port) against K5 f32 (reference); K4
    assert len(j_out) == 3 and len(t_out) == 4
    np.testing.assert_array_equal(np.asarray(j_out[0]), t_out[0].numpy())
    x, w = t_kb.grouped_inputs()
    _f32_bound_ok(np.asarray(j_out[1], np.float64), x, t_kb.GMM_SIZES, w)
    _f32_bound_ok(_as_np(t_out[2]).astype(np.float64), x, t_kb.GMM_SIZES, w)
    np.testing.assert_allclose(_as_np(t_out[1]), np.asarray(j_out[1]),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(_as_np(t_out[3]), np.asarray(j_out[2]),
                               rtol=5e-2, atol=5e-2)
    names = [(r["name"], r["dtype"]) for r in report["kernels"]]
    assert names == [("crossmatch", "float32"), ("grouped_matmul", "bfloat16"),
                     ("grouped_matmul", "float32"),
                     ("paged_attention", "bfloat16")]
    assert all(r["device_ms"] is None and r["max_abs_err"] is None
               for r in report["kernels"])
    assert not t_kb.check(report)
    k1, _, k5_f32, k4 = report["kernels"]
    assert k1["bound_by"] == "operations"  # 4 FMAs a pair, FP32 peak
    assert k1["bound_ms"] == pytest.approx(8.0 * 10_000 * 1_024 / 67e12 * 1e3)
    assert k5_f32["bound_ms"] == pytest.approx(2.0 * 4096 * 1024 ** 2 / 67e12 * 1e3)
    assert k4["bound_by"] == "bytes"  # the K/V pages at 3.35 TB/s
