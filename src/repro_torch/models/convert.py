"""Carry the JAX reference's parameters into the port, bit for bit.

``params_from_numpy`` takes the reference's parameter pytree with numpy
leaves (``jax.tree_util.tree_map(np.asarray, params)``) and returns the
port's nested dict of tensors.  bfloat16 leaves (numpy's ``bfloat16``
extension dtype) travel as their 16-bit patterns, so no value changes.
The tree must have exactly the keys, shapes and dtypes ``init_params``
gives for ``cfg``.

``state_to_numpy`` and ``state_from_numpy`` do the same for optimizer
state trees (``training.optimizer``: ``{"mu": ..., "step": ...}``), in
both directions, so a port state compares to the reference's
(``jax.tree_util.tree_map(np.asarray, state)``) leaf for leaf and a
checkpoint can carry one.  Their leaves are f32, int8 and int32.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import init_params

__all__ = ["params_from_numpy", "state_from_numpy", "state_to_numpy"]


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _convert(tree: dict, like: dict, device, path: str) -> dict:
    if set(tree) != set(like):
        raise ValueError(f"{path or 'params'}: keys {sorted(tree)} != "
                         f"{sorted(like)}")
    out = {}
    for k, ref in like.items():
        where = f"{path}.{k}" if path else k
        if isinstance(ref, dict):
            out[k] = _convert(tree[k], ref, device, where)
            continue
        t = _tensor(np.asarray(tree[k]))
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{where}: {t.dtype} {tuple(t.shape)}, expected "
                             f"{ref.dtype} {tuple(ref.shape)}")
        out[k] = t.to(device)
    return out


def params_from_numpy(cfg, tree: dict, device) -> dict:
    """The reference's parameter tree (numpy leaves) as the port's
    parameters on ``device``."""
    return _convert(tree, init_params(cfg, device="meta"), torch.device(device), "")


def state_to_numpy(state: dict) -> dict:
    """An optimizer state (nested dicts of tensors) with numpy leaves."""
    return {k: state_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy().copy() for k, v in state.items()}


def state_from_numpy(tree: dict, like: dict, device) -> dict:
    """A state tree with numpy leaves (the reference's or
    ``state_to_numpy``'s) as tensors on ``device``, checked against
    ``like`` (e.g. ``opt.init(params)``): the same keys, shapes and
    dtypes."""
    return _convert(tree, like, torch.device(device), "")
