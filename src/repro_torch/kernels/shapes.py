"""Shapes-only kernel calls: what a kernel would do, recorded.

Each kernel wrapper given ``meta`` tensors (the multi-pod dry-run's local
shards) returns its output's shape without running anything, and reports
its own flops and bytes here -- the counts ``benchmarks/common.py::bound``
takes: each input read once, each output written once.  Counting is off
unless a caller is ``recording``.
"""
from __future__ import annotations

import threading
from typing import Callable

import torch

__all__ = ["meta_empty", "nbytes", "record", "recording"]

_STATE = threading.local()


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (``None`` counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def record(name: str, flops: float, moved: float) -> None:
    """Report one shapes-only kernel call to every active recorder."""
    for sink in getattr(_STATE, "sinks", ()):
        sink(name, flops, moved)


class recording:
    """Within: ``sink(name, flops, bytes)`` is called for each shapes-only
    kernel call on this thread."""

    def __init__(self, sink: Callable[[str, float, float], None]):
        self.sink = sink

    def __enter__(self):
        self.prev = getattr(_STATE, "sinks", ())
        _STATE.sinks = self.prev + (self.sink,)
        return self.sink

    def __exit__(self, *exc) -> None:
        _STATE.sinks = self.prev


def meta_empty(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype, device="meta")
