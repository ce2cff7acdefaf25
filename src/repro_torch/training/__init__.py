"""Training and step assembly of the port: the optimizers, the train
step, the serving decode step and the prefill step.  The trainer, the
checkpointer and the mesh tools are not ported yet."""
from .optimizer import (
    Optimizer,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    make_optimizer,
)
from .train_step import make_prefill_step, make_serve_step, make_train_step

__all__ = [
    "Optimizer", "clip_by_global_norm", "cosine_schedule", "global_norm",
    "make_optimizer", "make_prefill_step", "make_serve_step",
    "make_train_step",
]
