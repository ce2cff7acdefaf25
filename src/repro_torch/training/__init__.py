"""Training and step assembly of the port: the optimizers, the train
step, the serving decode step, the prefill step and the trainer (data,
steps, async checkpoints, restart).  The mesh tools are not ported
yet."""
from .optimizer import (
    Optimizer,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    make_optimizer,
)
from .train_step import make_prefill_step, make_serve_step, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = [
    "Optimizer", "clip_by_global_norm", "cosine_schedule", "global_norm",
    "make_optimizer", "make_prefill_step", "make_serve_step",
    "make_train_step", "Trainer", "TrainerConfig",
]
