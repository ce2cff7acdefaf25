"""Checkpointing of the port (``repro.checkpoint``'s format); the elastic
restore onto a mesh comes with the mesh tools."""
from .checkpointer import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
