"""The port's ``dist`` (gradient compression, fault tolerance) and its
``ft_bench`` held against the JAX reference on the CPU.

* ``compress``: the same f32 inputs (numpy, seeded) through both
  packages give ``q``, ``scales``, the dequantized values, the
  error-feedback residuals and the top-k split equal bit for bit, over
  sizes on and off the 256-block boundary, an all-zero block, and ties
  at the top-k threshold.  The reference's own compression tests
  (``tests/test_substrate.py``: the hypothesis bound, error feedback,
  top-k) pass on the port.
* ``ft``: ``HeartbeatMonitor``, ``StragglerPolicy`` and
  ``simulate_training_with_failures`` equal the reference's field by
  field over a grid of rates, seeds and ``backup_tasks``; the
  reference's fault-tolerance tests pass on the port.
* ``ft_bench``: the port's rows equal the reference's field by field; the
  port's verbose run prints every scenario and the backup-task gain,
  where the reference's raises ``AttributeError`` (it reads
  ``FTResult.n_straggler_steps``, a field that does not exist).

Every comparison is exact (tolerance 0), except the reference's own
bound tests, which keep their tolerances.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the reference's ``benchmarks`` package

from benchmarks import ft_bench as j_ft_bench  # noqa: E402
from repro.dist import compress as jc  # noqa: E402
from repro.dist import ft as jft  # noqa: E402
from repro_torch import dist as tdist  # noqa: E402
from repro_torch.benchmarks import ft_bench as t_ft_bench  # noqa: E402
from repro_torch.dist import compress as tc  # noqa: E402
from repro_torch.dist import ft as tft  # noqa: E402


def _eq(got: torch.Tensor, want) -> None:
    """Equal dtype, shape and bits."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _inputs(n, kind, seed=0):
    rng = np.random.default_rng(seed + n)
    if kind == "normal":
        x = rng.normal(size=n).astype(np.float32)
    elif kind == "zero_block":  # the first block all zeros
        x = rng.normal(size=n).astype(np.float32)
        x[:256] = 0.0
    else:  # "ties": few distinct magnitudes, both signs
        x = (rng.integers(-3, 4, size=n) * 0.25).astype(np.float32)
    return x


CASES = [(n, kind) for n in (1, 255, 256, 257, 1000, 4099)
         for kind in ("normal", "ties")] + [(300, "zero_block"),
                                            (512, "zero_block")]


def test_the_package_exports_the_reference_names():
    from repro import dist as jdist

    assert tdist.__all__ == jdist.__all__


@pytest.mark.parametrize("n,kind", CASES)
def test_quantize_and_error_feedback_bit_equal(n, kind):
    x = _inputs(n, kind)
    r = _inputs(n, "normal", seed=1) * 1e-3
    for shape in ((n,), (1, n)):
        xs, rs = x.reshape(shape), r.reshape(shape)
        jq, js = jc.quantize_blockwise(jnp.asarray(xs))
        tq, ts = tc.quantize_blockwise(torch.from_numpy(xs))
        _eq(tq, jq)
        _eq(ts, js)
        _eq(tc.dequantize_blockwise(tq, ts, shape),
            jc.dequantize_blockwise(jq, js, shape))
        (jq2, js2), jres = jc.error_feedback_compress(jnp.asarray(xs),
                                                      jnp.asarray(rs))
        (tq2, ts2), tres = tc.error_feedback_compress(torch.from_numpy(xs),
                                                      torch.from_numpy(rs))
        _eq(tq2, jq2)
        _eq(ts2, js2)
        _eq(tres, jres)
    if kind == "zero_block":
        assert float(ts[0]) == 1.0 and not tq[0].any()


@pytest.mark.parametrize("block", [64, 128])
def test_quantize_other_blocks_bit_equal(block):
    x = _inputs(1000, "normal", seed=block)
    jq, js = jc.quantize_blockwise(jnp.asarray(x), block)
    tq, ts = tc.quantize_blockwise(torch.from_numpy(x), block)
    _eq(tq, jq)
    _eq(ts, js)


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.4, 0.5, 1.0])
@pytest.mark.parametrize("n,kind", [(5, "normal"), (1000, "normal"),
                                    (1000, "ties"), (257, "ties")])
def test_topk_bit_equal(n, kind, frac):
    x = _inputs(n, kind).reshape(-1, 1) if n % 2 else _inputs(n, kind)
    r = (_inputs(n, "ties", seed=3) * 0.5).reshape(x.shape)
    for res in (None, r):
        jk, jr = jc.topk_compress(jnp.asarray(x), frac,
                                  None if res is None else jnp.asarray(res))
        tk, tr = tc.topk_compress(torch.from_numpy(x), frac,
                                  None if res is None else torch.from_numpy(res))
        _eq(tk, jk)
        _eq(tr, jr)
    if kind == "ties" and frac < 1.0:  # every entry tied at the threshold kept
        kept = np.abs(tk.numpy()) > 0
        thresh = np.sort(np.abs(x + r).ravel())[n - max(1, round(frac * n))]
        assert np.array_equal(kept, np.abs(x + r) >= thresh)


# ------------------------------------------------------------------ the reference's tests
@given(st.integers(1, 5000))
@settings(max_examples=25, deadline=None)
def test_quantize_roundtrip_bounded(n):
    x = torch.from_numpy(np.random.default_rng(n).normal(size=n).astype(np.float32))
    q, s = tc.quantize_blockwise(x)
    y = tc.dequantize_blockwise(q, s, x.shape)
    blk_max = float(x.abs().max())
    assert float((x - y).abs().max()) <= blk_max / 127.0 + 1e-6


def test_error_feedback_converges():
    """Sum of dequantized payloads + final residual == sum of grads."""
    rng = np.random.default_rng(0)
    total = np.zeros(100, np.float32)
    recovered = np.zeros(100, np.float32)
    res = None
    for _ in range(20):
        g = torch.from_numpy(rng.normal(size=100).astype(np.float32))
        total += g.numpy()
        (q, s), res = tc.error_feedback_compress(g, res)
        recovered += tc.dequantize_blockwise(q, s, g.shape).numpy()
    np.testing.assert_allclose(recovered + res.numpy(), total, atol=1e-3)


def test_topk_keeps_largest():
    g = torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05], dtype=torch.float32)
    kept, res = tc.topk_compress(g, 0.4, None)
    assert float(kept[1]) == -5.0 and float(kept[3]) == 3.0
    assert float(kept[0]) == 0.0
    np.testing.assert_allclose((kept + res).numpy(), g.numpy(), atol=1e-7)


def test_heartbeat_detects_failure():
    hb = tft.HeartbeatMonitor([0, 1, 2], timeout=10.0)
    for t in (0.0, 5.0):
        hb.beat(0, t)
        hb.beat(1, t)
    hb.beat(2, 0.0)
    assert hb.check(12.0) == [2]
    assert set(hb.alive) == {0, 1}


def test_straggler_policy():
    p = tft.StragglerPolicy(factor=2.0)
    for _ in range(10):
        assert not p.observe(1.0)
    assert p.observe(5.0)
    assert p.backup_cutoff() == pytest.approx(2.0, rel=0.1)


def test_backup_tasks_reduce_walltime():
    kw = dict(n_steps=400, straggler_rate=0.1, straggler_slowdown=8.0,
              failure_rate=0.0, seed=1)
    with_b = tft.simulate_training_with_failures(backup_tasks=True, **kw)
    without = tft.simulate_training_with_failures(backup_tasks=False, **kw)
    assert with_b.wall_time < without.wall_time
    assert with_b.n_backup_dispatches > 0


def test_failures_roll_back_to_checkpoint():
    r = tft.simulate_training_with_failures(
        n_steps=300, failure_rate=3e-6, checkpoint_every=20, seed=2
    )
    assert r.steps_done == 300
    if r.n_failures:
        assert r.lost_steps <= r.n_failures * 20


# ------------------------------------------------------------------ ft against the reference
def test_heartbeat_and_straggler_equal_reference():
    rng = np.random.default_rng(7)
    hbs = [m.HeartbeatMonitor(range(6), timeout=3.0) for m in (jft, tft)]
    pols = [m.StragglerPolicy(factor=1.5) for m in (jft, tft)]
    for t in np.arange(0.0, 60.0, 0.5):
        for r in rng.choice(6, size=rng.integers(0, 6), replace=False):
            for hb in hbs:
                hb.beat(int(r), float(t))
        dead = [hb.check(float(t)) for hb in hbs]
        assert dead[0] == dead[1]
        assert hbs[0].alive == hbs[1].alive
        d = float(rng.lognormal(0.0, 0.5))
        assert pols[0].observe(d) == pols[1].observe(d)
        assert pols[0].backup_cutoff() == pols[1].backup_cutoff()


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("backup", [False, True])
@pytest.mark.parametrize("failure_rate,straggler_rate", [
    (0.0, 0.0), (3e-4, 0.0), (0.0, 0.1), (2e-4, 0.05), (1e-3, 0.3)])
def test_simulate_equals_reference(seed, backup, failure_rate, straggler_rate):
    kw = dict(n_steps=500, failure_rate=failure_rate,
              straggler_rate=straggler_rate, straggler_slowdown=5.0,
              checkpoint_every=25, backup_tasks=backup, n_workers=16,
              restart_cost=7.0, seed=seed)
    want = dataclasses.asdict(jft.simulate_training_with_failures(**kw))
    got = dataclasses.asdict(tft.simulate_training_with_failures(**kw))
    assert got == want


# ------------------------------------------------------------------ ft_bench
def test_ft_bench_rows_equal_reference():
    want = j_ft_bench.run(verbose=False)
    got = t_ft_bench.run(verbose=False, device="cpu", out_path=None)
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name][0]) == \
            dataclasses.asdict(want[name][0])
        assert got[name][1] == want[name][1]


def test_ft_bench_verbose_runs_where_the_reference_raises(capsys, tmp_path):
    with pytest.raises(AttributeError, match="n_straggler_steps"):
        j_ft_bench.run(verbose=True)
    capsys.readouterr()
    rows = t_ft_bench.main(["--device", "cpu",
                            "--out", str(tmp_path / "ft.json")])
    out = capsys.readouterr().out
    for name in rows:
        assert name in out
    gain = rows["stragglers_backup"][1] / rows["stragglers_nobackup"][1]
    assert f"ft_bench,0.00,backup_task_goodput_gain={gain:.2f}x" in out
    report = json.loads((tmp_path / "ft.json").read_text())
    assert report["device"] == "cpu"
    assert report["backup_task_goodput_gain"] == gain
    assert report["scenarios"]["both"]["n_stragglers"] == \
        rows["both"][0].n_stragglers

