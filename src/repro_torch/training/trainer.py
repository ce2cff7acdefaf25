"""Training loop: data pipeline -> train step -> async checkpoints, with
restart recovery and straggler tracking.  Arch-agnostic via the registry.

The port of ``repro.training.trainer``.  ``device`` follows
``resolve_device``: ``cuda`` unless the caller passes ``cpu``.  The
parameters are drawn from a generator seeded ``tcfg.seed`` on the device;
the step runs eagerly and updates the parameters and the optimizer state
in place (``jax.jit``'s donation has no counterpart).  Each step's loss is
read back as a float, so a step's ``sec`` holds its device work.  A
caller may set ``params`` and ``opt_state`` (e.g. the reference's weights
through ``models.convert.params_from_numpy`` and ``opt.init``) before
``run``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..configs.base import ModelConfig
from ..data import DataConfig, TokenPipeline
from ..device import resolve_device
from ..dist.ft import StragglerPolicy
from ..models import registry as R
from .optimizer import make_optimizer
from .train_step import make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    lr: float = 3e-4
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 log_fn: Callable[[str], None] = print, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.log = log_fn
        self.device = resolve_device(device)
        self.opt = make_optimizer(cfg.optimizer, lr=tcfg.lr)
        self.step_fn = make_train_step(cfg, self.opt)
        self.data = TokenPipeline(
            DataConfig(cfg.vocab_size, tcfg.seq_len, tcfg.global_batch,
                       seed=tcfg.seed)
        )
        self.params = R.init_params(
            cfg, torch.Generator(self.device).manual_seed(tcfg.seed))
        self.opt_state = self.opt.init(self.params)
        self.start_step = 0
        self.ckpt = AsyncCheckpointer(tcfg.checkpoint_dir) if tcfg.checkpoint_dir else None
        self.straggler = StragglerPolicy()
        self.history: list[dict] = []
        self._maybe_restore()

    def _maybe_restore(self) -> None:
        if not self.ckpt:
            return
        last = latest_step(self.tcfg.checkpoint_dir)
        if last is None:
            return
        state = {"params": self.params, "opt": self.opt_state}
        restored, step = restore_checkpoint(self.tcfg.checkpoint_dir, last, state)
        self.params, self.opt_state = restored["params"], restored["opt"]
        self.start_step = step
        self.data = TokenPipeline.restore(
            self.data.cfg, {"step": step, "seed": self.tcfg.seed}
        )
        self.log(f"[trainer] restored checkpoint at step {step}")

    def run(self) -> list[dict]:
        for step in range(self.start_step, self.tcfg.steps):
            batch = self.data.next_batch()
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch.items()}
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch
            )
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            slow = self.straggler.observe(dt)
            rec = {"step": step + 1, "loss": loss, "sec": dt, "straggler": slow}
            self.history.append(rec)
            if (step + 1) % self.tcfg.log_every == 0:
                self.log(f"[trainer] step {step+1} loss={loss:.4f} ({dt*1e3:.0f} ms)")
            if self.ckpt and (step + 1) % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(step + 1, {"params": self.params, "opt": self.opt_state})
        if self.ckpt:
            self.ckpt.wait()
        return self.history
