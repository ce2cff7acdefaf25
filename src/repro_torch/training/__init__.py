"""Training and step assembly of the port: the optimizers, the train
step, the serving decode step, the prefill step, the trainer (data,
steps, async checkpoints, restart) and ``tree_shardings``, the sharding
tree the dry-run and the elastic restore place leaves by."""
from .optimizer import (
    Optimizer,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    make_optimizer,
)
from .train_step import (
    make_prefill_step,
    make_serve_step,
    make_train_step,
    tree_shardings,
)
from .trainer import Trainer, TrainerConfig

__all__ = [
    "Optimizer", "clip_by_global_norm", "cosine_schedule", "global_norm",
    "make_optimizer", "make_prefill_step", "make_serve_step",
    "make_train_step", "tree_shardings", "Trainer", "TrainerConfig",
]
