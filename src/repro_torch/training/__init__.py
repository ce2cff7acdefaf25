"""Step assembly of the port: the serving decode step only; the training
substrate is not ported yet."""
from .train_step import make_serve_step

__all__ = ["make_serve_step"]
