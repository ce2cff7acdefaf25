"""Step assembly of the port: the serving decode step and the prefill step;
the training substrate is not ported yet."""
from .train_step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
