"""Elastic restore: load a checkpoint into a *different* mesh.

The port of ``repro.checkpoint.elastic``.  Checkpoints store logical
arrays (mesh-free), so rescaling = recomputing the sharding tree for the
new mesh and placing each rank's block.  Combined with the
divisibility-aware rules this supports growing 256 -> 512 ranks (add the
pod axis) or shrinking to whatever survives a failure -- the LifeRaft
answer to node loss: checkpoint/restart onto the remaining mesh.
"""
from __future__ import annotations

from typing import Any, Optional

from ..sharding.logical import ShardingRules
from ..training.train_step import tree_shardings
from .checkpointer import restore_checkpoint

__all__ = ["elastic_restore"]


def elastic_restore(
    directory,
    step: Optional[int],
    like: Any,
    axes_tree: Any,
    rules: ShardingRules,
    zero1: bool = False,
):
    """Restore ``like``-shaped tree, resharded for ``rules.mesh``."""
    shardings = tree_shardings(rules, axes_tree, like, zero1=zero1)
    return restore_checkpoint(directory, step, like, shardings)
