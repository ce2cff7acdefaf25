"""Checkpointing of the port (``repro.checkpoint``'s format) and the
elastic restore onto a ``DeviceMesh``."""
from .checkpointer import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from .elastic import elastic_restore

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint", "elastic_restore"]
