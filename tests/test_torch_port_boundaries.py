"""The port's boundaries: what it imports, where it runs, and the data it
shares with the JAX reference.

* No file of ``src/repro_torch/``, nor ``chip_smoke.py``, ``k4_tune.py``
  or ``cm_tune.py``, imports ``jax`` or the JAX package ``repro``;
  importing and running the port (a cross-match and the serving launcher)
  leaves both out of ``sys.modules``.
* The device picks the path: without ``device`` an entry point runs on
  ``cuda`` and raises where there is none; nothing falls back to the CPU
  (the kernel package has no ``try``).
* The port's catalog and trace generators give the reference's arrays,
  bit for bit.
"""
from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.crossmatch import make_catalog as j_make_catalog  # noqa: E402
from repro.crossmatch import make_trace as j_make_trace, TraceConfig as JTC  # noqa: E402
from repro_torch.crossmatch import CrossMatchEngine  # noqa: E402
from repro_torch.crossmatch import make_catalog as t_make_catalog  # noqa: E402
from repro_torch.crossmatch import make_trace as t_make_trace, TraceConfig as TTC  # noqa: E402
from repro_torch.kernels.crossmatch import kernel as tkernel  # noqa: E402
from repro_torch.kernels.crossmatch import ops as tops  # noqa: E402
from repro_torch.kernels import nvcc  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pkernel  # noqa: E402
from repro_torch.kernels.grouped_matmul import kernel as gkernel  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import registry as tmodels  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.serving import PagePool  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "k4_tune.py",
                                          ROOT / "cm_tune.py"]


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_kernel_package_has_no_fallback():
    """A CUDA build or launch that fails raises; no ``try`` catches it to
    carry on with the plain version."""
    for path in (PORT / "kernels").rglob("*.py"):
        tries = [n for n in ast.walk(ast.parse(path.read_text()))
                 if isinstance(n, ast.Try)]
        assert not tries, f"{path} has a try at line {tries[0].lineno}"


def test_running_the_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from repro_torch.crossmatch import CrossMatchEngine, TraceConfig, "
        "make_catalog, make_trace\n"
        "from repro_torch.launch import serve\n"
        "cat = make_catalog(n_objects=2000, objects_per_bucket=100, "
        "htm_level=6, seed=1)\n"
        "tr = make_trace(cat, TraceConfig(n_queries=4, objects_median=20, seed=2))\n"
        "eng = CrossMatchEngine(cat, match_radius_rad=4e-3, fuse_k=2, device='cpu')\n"
        "res = eng.run(tr)\n"
        "assert len(eng.wm.response_times()) == 4\n"
        "serve.main(['--arch', 'codeqwen1.5-7b', '--requests', '2', "
        "'--device', 'cpu'])\n"
        "serve.main(['--arch', 'moonshot-v1-16b-a3b', '--requests', '2', "
        "'--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_default_device_is_cuda_and_never_the_cpu():
    cat = t_make_catalog(n_objects=500, objects_per_bucket=100, htm_level=5, seed=1)
    pts = cat.positions[:4]
    if torch.cuda.is_available():
        assert tops.resolve_device(None).type == "cuda"
        assert PagePool(4, 4, 1, 8).k_pages.is_cuda
        assert CrossMatchEngine(cat).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA"):
        CrossMatchEngine(cat)
    cfg = smoke_config("codeqwen1.5-7b")
    moe = smoke_config("moonshot-v1-16b-a3b")
    for call in (
        lambda: tmodels.init_params(cfg),
        lambda: tmodels.make_cache(cfg, 2, 16),
        lambda: tmodels.init_params(moe),
        lambda: tserve.main(["--arch", moe.name, "--requests", "2"]),
        lambda: PagePool(4, 4, 1, 8),
        lambda: tserve.main(["--arch", cfg.name, "--requests", "2"]),
        lambda: tops.crossmatch(pts, pts, 0.9),
        lambda: tops.crossmatch_fused(pts, pts, np.zeros(4), np.zeros(4), 0.9),
        lambda: tops.crossmatch_shared(
            pts, pts, np.zeros(4), np.zeros(4), np.full(4, 0.9)
        ),
    ):
        with pytest.raises(RuntimeError, match="no CUDA"):
            call()


DRIVERS = ["benchmarks." + n for n in (
    "fig2_hybrid_join", "fig5_bucket_reuse", "fig6_workload_cdf",
    "fig7_schedulers", "fig8_tradeoff", "bench_scheduler", "bench_sharedplan",
    "bench_shard", "bench_obs", "bench_adaptive", "bench_prefetch",
    "serving_bench", "kernel_bench", "ft_bench")] + ["examples." + n for n in (
        "crossmatch_skyquery", "quickstart", "serve_multitenant")]


@pytest.mark.parametrize("name", DRIVERS)
def test_drivers_default_to_cuda_and_raise_without_one(name, tmp_path,
                                                       monkeypatch):
    """Every driver's entry point runs on ``cuda`` unless told otherwise:
    without a card it raises before it writes a report."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the drivers run on it")
    import importlib

    mod = importlib.import_module(f"repro_torch.{name}")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA"):
        mod.main(["--out", str(tmp_path / "report.json")])
    assert not list(tmp_path.iterdir())


def test_a_driver_run_as_a_script_without_a_card_fails():
    """``python -m repro_torch.benchmarks.fig2_hybrid_join`` with no
    ``--device`` exits non-zero on a machine with no card, and the harness
    counts every section failed."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the drivers run on it")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for cmd in (["repro_torch.benchmarks.fig2_hybrid_join"],
                ["repro_torch.benchmarks.run", "--out-dir", "build"]):
        out = subprocess.run([sys.executable, "-m", *cmd], env=env,
                             capture_output=True, text=True, timeout=300,
                             cwd=ROOT)
        assert out.returncode != 0
        assert "no CUDA" in out.stderr + out.stdout
    assert "failures=14" in out.stdout


@pytest.mark.parametrize("module", [tkernel, pkernel, gkernel],
                         ids=["crossmatch", "paged_attention", "grouped_matmul"])
def test_build_without_nvcc_raises(monkeypatch, tmp_path, module):
    """No toolkit: the build raises rather than leaving a stub behind."""
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(module.LIBRARY, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        module.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_both_kernel_modules_share_one_build_helper():
    """One nvcc/ctypes build path, one set of flags, for every source."""
    assert tkernel.LIBRARY.source == nvcc.CSRC / "crossmatch.cu"
    assert pkernel.LIBRARY.source == nvcc.CSRC / "paged_attention.cu"
    assert gkernel.LIBRARY.source == nvcc.CSRC / "grouped_matmul.cu"
    assert all(m.LIBRARY.source.exists() for m in (tkernel, pkernel, gkernel))
    assert sorted(p.name for p in nvcc.CSRC.glob("*.cu")) == [
        "crossmatch.cu", "grouped_matmul.cu", "paged_attention.cu"]
    assert nvcc.NVCC_FLAGS == (
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
    )


def test_launch_counts_lose_no_update_across_threads():
    """Shard drain threads count launches concurrently; the count is the
    one ``chip_smoke.py`` holds against the engines' device dispatches."""
    import threading

    n_threads, per_thread = 16, 2_000
    saved = dict(tkernel.LAUNCHES)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tkernel.reset_launches()
        threads = [
            threading.Thread(
                target=lambda: [tkernel._count("crossmatch") for _ in range(per_thread)]
            )
            for _ in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert tkernel.LAUNCHES["crossmatch"] == n_threads * per_thread
    finally:
        sys.setswitchinterval(old)
        tkernel.LAUNCHES.update(saved)


@pytest.mark.parametrize("seed", [3, 17])
def test_catalog_generator_matches_reference(seed):
    kw = dict(n_objects=3_000, objects_per_bucket=150, htm_level=7, seed=seed)
    j, t = j_make_catalog(**kw), t_make_catalog(**kw)
    for name in ("positions", "mags", "htm"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j.partitioner.order, t.partitioner.order)
    assert j.n_buckets == t.n_buckets and j.level == t.level


@pytest.mark.parametrize("seed", [4, 19])
def test_trace_generator_matches_reference(seed):
    kw = dict(n_objects=3_000, objects_per_bucket=150, htm_level=7, seed=3)
    cfg = dict(n_queries=12, arrival_rate=1.0, objects_median=50, seed=seed)
    jq = j_make_trace(j_make_catalog(**kw), JTC(**cfg))
    tq = t_make_trace(t_make_catalog(**kw), TTC(**cfg))
    assert len(jq) == len(tq)
    for a, b in zip(jq, tq):
        assert (a.query_id, a.arrival_time, a.meta) == (b.query_id, b.arrival_time, b.meta)
        np.testing.assert_array_equal(a.keys_lo, b.keys_lo)
        np.testing.assert_array_equal(a.keys_hi, b.keys_hi)
        np.testing.assert_array_equal(a.payload["positions"], b.payload["positions"])
