"""Fault tolerance: heartbeat failure detection, straggler policy with
backup-task dispatch, and a discrete-event training simulator that models
failures rolling back to the last checkpoint.

The port's copy of ``repro.dist.ft``: NumPy only, unchanged, so the same
seed gives the reference's ``FTResult`` field for field.  A slow
participant is an aged work unit (the paper's §6): once its duration
exceeds the policy cutoff, a backup task is dispatched so one straggler
cannot stretch the whole synchronous step.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

__all__ = [
    "HeartbeatMonitor",
    "StragglerPolicy",
    "FTResult",
    "simulate_training_with_failures",
]


class HeartbeatMonitor:
    """Tracks per-rank heartbeats; ``check(now)`` returns newly-dead ranks."""

    def __init__(self, ranks: Iterable[int], timeout: float = 30.0) -> None:
        self.timeout = float(timeout)
        self._last: dict[int, float] = {r: -np.inf for r in ranks}
        self._dead: set[int] = set()

    def beat(self, rank: int, t: float) -> None:
        self._last[rank] = max(self._last.get(rank, -np.inf), t)
        self._dead.discard(rank)

    def check(self, now: float) -> list[int]:
        dead = [
            r
            for r, t in self._last.items()
            if r not in self._dead and now - t > self.timeout
        ]
        self._dead.update(dead)
        return sorted(dead)

    @property
    def alive(self) -> list[int]:
        return sorted(r for r in self._last if r not in self._dead)


class StragglerPolicy:
    """Flags step durations exceeding ``factor`` x the running mean.

    Flagged durations do NOT update the running statistics (a straggler
    must not inflate its own cutoff).  ``backup_cutoff`` is the duration
    after which a backup task should be dispatched.
    """

    def __init__(self, factor: float = 2.0) -> None:
        self.factor = float(factor)
        self._n = 0
        self._mean = 0.0

    def observe(self, duration: float) -> bool:
        """Record a step duration; returns True iff it is a straggler."""
        if self._n and duration > self.factor * self._mean:
            return True
        self._n += 1
        self._mean += (duration - self._mean) / self._n
        return False

    def backup_cutoff(self) -> float:
        return self.factor * self._mean if self._n else float("inf")


@dataclasses.dataclass
class FTResult:
    steps_done: int
    wall_time: float
    n_failures: int
    lost_steps: int
    n_backup_dispatches: int
    n_stragglers: int


def simulate_training_with_failures(
    n_steps: int,
    failure_rate: float = 0.0,
    straggler_rate: float = 0.0,
    straggler_slowdown: float = 4.0,
    checkpoint_every: int = 20,
    backup_tasks: bool = False,
    n_workers: int = 8,
    step_time: float = 1.0,
    restart_cost: float = 5.0,
    seed: int = 0,
) -> FTResult:
    """Discrete-event model of synchronous training with failures.

    Each step takes ``step_time`` unless a worker straggles
    (probability ``straggler_rate`` per step): without backup tasks the
    step takes ``straggler_slowdown`` x longer; with them a backup is
    dispatched at the policy cutoff and the step completes at ~2x.
    Failures (probability ``failure_rate * n_workers`` per step) roll the
    run back to the last checkpoint and pay ``restart_cost``.
    """
    rng = np.random.default_rng(seed)
    step = 0
    wall = 0.0
    last_ckpt = 0
    failures = 0
    lost = 0
    backups = 0
    stragglers = 0
    while step < n_steps:
        straggles = rng.random() < straggler_rate
        if straggles:
            stragglers += 1
            if backup_tasks:
                backups += 1
                wall += 2.0 * step_time  # cutoff + backup's fresh attempt
            else:
                wall += straggler_slowdown * step_time
        else:
            wall += step_time
        step += 1
        if step % checkpoint_every == 0:
            last_ckpt = step
        if failure_rate and rng.random() < failure_rate * n_workers:
            failures += 1
            lost += step - last_ckpt
            wall += restart_cost
            step = last_ckpt
    return FTResult(
        steps_done=step,
        wall_time=wall,
        n_failures=failures,
        lost_steps=lost,
        n_backup_dispatches=backups,
        n_stragglers=stragglers,
    )
