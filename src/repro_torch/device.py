"""Where the port runs.

Entry points take a ``device``; ``None`` means ``cuda``, which must exist.
There is no silent fall back to the CPU: the CPU runs only when the caller
asks for it (the tests do), and then every kernel wrapper takes its plain
PyTorch version.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch device; ``None`` means ``cuda``.  A ``cuda``
    device must exist -- there is no silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "version"
        )
    return dev
