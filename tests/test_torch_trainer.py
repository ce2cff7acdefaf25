"""The port's trainer held against the JAX reference's on the CPU, at
``tests/test_trainer_restart.py``'s tiny config (codeqwen-family, 1 layer,
d_model 32, vocab 128; 2 x 16 tokens, lr 1e-3, a checkpoint every 5
steps), over 10 steps.

* The port's ``Trainer``, given the reference ``Trainer``'s initial
  weights (through numpy, bit for bit) and a fresh ``opt.init``, gives
  the reference's losses within ``STEP_TOL`` = 1e-4 relative
  (``tests/test_torch_train.py``'s train-step tolerance: the two
  frameworks sum the gradients in other orders; measured within 3.0e-7).
* Crossing over: the port resumes from the checkpoint the reference
  ``Trainer`` wrote at step 5 and gives the reference's losses at steps
  6-10 within ``STEP_TOL``; the reference resumes from the port's and
  gives the port's.
* The port's own resume is exact: a new ``Trainer`` on the step-5
  checkpoint gives the uninterrupted run's losses, parameters and
  optimizer state bit for bit, in float32 and in bfloat16 (whose
  checkpoint carries ``"bfloat16"`` leaves).
* The history records the straggler flag of each step.
* ``launch.train`` and ``examples.train_lm`` run on ``cpu``, and without
  ``--device`` raise on a machine with no card.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.training.trainer import Trainer as JTrainer  # noqa: E402
from repro.training.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.dist import StragglerPolicy  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import trainer as trainer_mod  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402
from repro_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402

STEP_TOL = 1e-4
STEPS, EVERY = 10, 5
TINY = dict(n_layers=1, d_model=32, d_ff=64, n_heads=2, n_kv_heads=2,
            head_dim=16, vocab_size=128)
QUIET = dict(log_fn=lambda s: None)


def _tcfg(cls, steps, ckpt_dir):
    return cls(steps=steps, checkpoint_every=EVERY, log_every=1000,
               checkpoint_dir=str(ckpt_dir), lr=1e-3, global_batch=2,
               seq_len=16)


def _losses(history, after=0):
    return {h["step"]: h["loss"] for h in history if h["step"] > after}


def _at_step(src, step, dst):
    """A checkpoint directory holding only ``src``'s step ``step``."""
    name = f"step_{step:08d}"
    shutil.copytree(src / name, dst / name)
    return dst


def _assert_close(got: dict, want: dict):
    assert set(got) == set(want)
    for step in want:
        np.testing.assert_allclose(got[step], want[step], rtol=STEP_TOL)


def _assert_same_tree(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference ``Trainer``'s uninterrupted run: its initial weights
    (numpy), its losses and its checkpoint directory (steps 5 and 10)."""
    d = tmp_path_factory.mktemp("ref")
    cfg = dataclasses.replace(j_smoke("codeqwen1.5-7b"), **TINY)
    t = JTrainer(cfg, _tcfg(JTrainerConfig, STEPS, d), **QUIET)
    init = jax.tree_util.tree_map(np.asarray, t.params)
    return init, _losses(t.run()), d


@pytest.fixture(scope="module")
def port_run(ref_run, tmp_path_factory):
    """The port's ``Trainer`` from the reference's initial weights: the
    trainer after 10 steps, its losses and its checkpoint directory."""
    d = tmp_path_factory.mktemp("port")
    cfg = dataclasses.replace(t_smoke("codeqwen1.5-7b"), **TINY)
    t = Trainer(cfg, _tcfg(TrainerConfig, STEPS, d), device="cpu", **QUIET)
    t.params = params_from_numpy(cfg, ref_run[0], "cpu")
    t.opt_state = t.opt.init(t.params)
    return t, _losses(t.run()), d


def test_port_trainer_matches_reference_from_its_weights(ref_run, port_run):
    _assert_close(port_run[1], ref_run[1])
    assert len(port_run[1]) == STEPS


def test_port_resumes_reference_checkpoint(ref_run, tmp_path):
    d = _at_step(ref_run[2], EVERY, tmp_path)
    cfg = dataclasses.replace(t_smoke("codeqwen1.5-7b"), **TINY)
    t = Trainer(cfg, _tcfg(TrainerConfig, STEPS, d), device="cpu", **QUIET)
    assert t.start_step == EVERY
    _assert_close(_losses(t.run()), {s: v for s, v in ref_run[1].items()
                                     if s > EVERY})


def test_reference_resumes_port_checkpoint(port_run, tmp_path):
    d = _at_step(port_run[2], EVERY, tmp_path)
    cfg = dataclasses.replace(j_smoke("codeqwen1.5-7b"), **TINY)
    t = JTrainer(cfg, _tcfg(JTrainerConfig, STEPS, d), **QUIET)
    assert t.start_step == EVERY
    _assert_close(_losses(t.run()), {s: v for s, v in port_run[1].items()
                                     if s > EVERY})


def test_port_resume_is_exact(port_run, tmp_path):
    full, losses, d = port_run
    cfg = dataclasses.replace(t_smoke("codeqwen1.5-7b"), **TINY)
    t = Trainer(cfg, _tcfg(TrainerConfig, STEPS, _at_step(d, EVERY, tmp_path)),
                device="cpu", **QUIET)
    assert t.start_step == EVERY
    assert _losses(t.run()) == {s: v for s, v in losses.items() if s > EVERY}
    _assert_same_tree(t.params, full.params)
    _assert_same_tree(t.opt_state, full.opt_state)


def test_bf16_resume_is_exact(tmp_path):
    """Trainer A runs 5 steps and saves; trainer B resumes there: B's
    steps 6-10 equal an uninterrupted run's bit for bit."""
    cfg = dataclasses.replace(t_smoke("codeqwen1.5-7b"), dtype="bfloat16",
                              **TINY)
    full = Trainer(cfg, _tcfg(TrainerConfig, STEPS, tmp_path / "full"),
                   device="cpu", **QUIET)
    want = _losses(full.run(), EVERY)
    a = Trainer(cfg, _tcfg(TrainerConfig, EVERY, tmp_path / "r"),
                device="cpu", **QUIET)
    a.run()
    man = json.loads((tmp_path / "r" / f"step_{EVERY:08d}" /
                      "manifest.json").read_text())
    assert "bfloat16" in {leaf["dtype"] for leaf in man["leaves"]}
    b = Trainer(cfg, _tcfg(TrainerConfig, STEPS, tmp_path / "r"),
                device="cpu", **QUIET)
    assert b.start_step == EVERY
    assert b.params["embed"].dtype == torch.bfloat16
    _assert_same_tree(b.params, a.params)
    _assert_same_tree(b.opt_state, a.opt_state)
    assert _losses(b.run()) == want
    _assert_same_tree(b.params, full.params)
    _assert_same_tree(b.opt_state, full.opt_state)


def test_straggler_flag_recorded(tmp_path, monkeypatch):
    """Each record carries the policy's verdict on its step's duration."""
    durations = [1.0, 1.0, 1.0, 9.0, 1.0]
    clock = iter(np.cumsum([x for d in durations for x in (0.0, d)]))
    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(clock))))
    cfg = dataclasses.replace(t_smoke("codeqwen1.5-7b"), **TINY)
    hist = Trainer(cfg, _tcfg(TrainerConfig, len(durations), tmp_path / "s"),
                   device="cpu", **QUIET).run()
    policy = StragglerPolicy()
    assert [h["straggler"] for h in hist] == [policy.observe(d)
                                              for d in durations]
    assert [h["straggler"] for h in hist] == [False, False, False, True, False]
    assert [h["sec"] for h in hist] == durations
    assert all(set(h) == {"step", "loss", "sec", "straggler"} for h in hist)


def test_launch_train_on_cpu(capsys, tmp_path):
    launch_train.main(["--arch", "codeqwen1.5-7b", "--steps", "3",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[train] final loss ") and line.endswith(
        "after 3 steps")
    assert np.isfinite(float(line.split()[3]))


def test_train_lm_on_cpu(capsys, tmp_path):
    train_lm.main(["--steps", "20", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "(improved)" in out


@pytest.mark.parametrize("entry", [
    lambda d: launch_train.main(["--arch", "codeqwen1.5-7b", "--steps", "1",
                                 "--ckpt-dir", str(d)]),
    lambda d: train_lm.main(["--steps", "1", "--ckpt-dir", str(d)]),
], ids=["launch_train", "train_lm"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA"):
        entry(tmp_path / "ckpt")
    assert not (tmp_path / "ckpt").exists()
