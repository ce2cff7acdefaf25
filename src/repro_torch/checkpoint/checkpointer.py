"""Checkpointing: atomic, async, in the reference's on-disk format.

The port of ``repro.checkpoint.checkpointer``.  Layout:
<dir>/step_<N>/
    manifest.json      — step, leaf paths, shapes, dtypes, data files
    arrays_<k>.npz     — leaf arrays, chunked ~512 MB per file

The trees are nested dicts of tensors.  Leaves go in the reference's
flatten order (each dict's keys sorted) under its path strings
(``"['params']/['embed']"``), so for the same tree the port writes the
reference's ``manifest.json`` and the same arrays, bit for bit, and each
side restores the other's checkpoints.

bfloat16.  NumPy has no bfloat16 of its own: a bf16 leaf is written as
its 16-bit patterns viewed as ``V2`` (what ``np.savez`` makes of the
reference's ``ml_dtypes`` leaves) with ``"bfloat16"`` in the manifest, and
restore takes the dtype from the manifest and views such a leaf back as
``torch.bfloat16``.  (The reference's own restore returns those leaves as
raw ``V2`` void, which its step cannot take.)

Writes go to ``step_<N>.tmp`` then ``os.replace`` (atomic on POSIX), so a
preempted save never corrupts the latest checkpoint.  ``AsyncCheckpointer``
copies the tree to the host before ``save`` returns (the optimizer then
overwrites the parameters and moments in place), writes the files on a
thread and blocks the *next* save until the previous one lands (bounded
staleness of one).  Restore places each leaf, as a fresh tensor, on the
device of the matching leaf of ``like``; with ``shardings`` (a matching
tree of ``NamedSharding``, as ``elastic_restore`` builds), each leaf
becomes a DTensor on its sharding's mesh: every rank reads the leaf and
keeps its own block (``DTensor.from_local``, no scatter), on the mesh's
device type (the current CUDA device for ``cuda``).
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "AsyncCheckpointer"]

_CHUNK_BYTES = 512 << 20


def _child(prefix: str, key) -> str:
    """The path of ``key`` under ``prefix``, as jax prints a ``DictKey``."""
    return f"{prefix}/[{key!r}]" if prefix else f"[{key!r}]"


def _paths(tree, prefix: str = ""):
    """(path, leaf) of every leaf, each dict's keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], _child(prefix, k))
    else:
        yield prefix, tree


def _to_host(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as a numpy copy on the host, and its manifest dtype.  A CUDA
    tensor's copy is synchronous, so it is whole when this returns."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        a = x.view(torch.int16).to("cpu", copy=True).numpy().view("V2")
        return a, "bfloat16"
    a = x.to("cpu", copy=True).numpy()
    return a, str(a.dtype)


def _snapshot(tree) -> list:
    """[(path, host array, dtype name)] of every leaf, in save order."""
    return [(p, *_to_host(x)) for p, x in _paths(tree)]


def _write(directory: pathlib.Path, step: int, snapshot: list) -> pathlib.Path:
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "leaves": [], "files": []}
    fidx, cur, cur_bytes = 0, {}, 0
    for p, a, dtype in snapshot:
        key = f"a{len(manifest['leaves'])}"
        manifest["leaves"].append(
            {"path": p, "file": fidx, "key": key, "shape": list(a.shape),
             "dtype": dtype}
        )
        cur[key] = a
        cur_bytes += a.nbytes
        if cur_bytes >= _CHUNK_BYTES:
            np.savez(tmp / f"arrays_{fidx}.npz", **cur)
            manifest["files"].append(f"arrays_{fidx}.npz")
            fidx, cur, cur_bytes = fidx + 1, {}, 0
    if cur:
        np.savez(tmp / f"arrays_{fidx}.npz", **cur)
        manifest["files"].append(f"arrays_{fidx}.npz")
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    return final


def save_checkpoint(directory: str | os.PathLike, step: int, tree: Any) -> pathlib.Path:
    return _write(pathlib.Path(directory), step, _snapshot(tree))


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in directory.iterdir()
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
    ]
    return max(steps) if steps else None


def _leaf(a: np.ndarray, entry: dict, like: torch.Tensor,
          sharding=None) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s shape, dtype and device, or
    with ``sharding`` as a DTensor of this rank's block; ``AssertionError``
    (the reference's) on a mismatch."""
    path = entry["path"]
    if tuple(a.shape) != tuple(like.shape):
        raise AssertionError((path, a.shape, like.shape))
    if sharding is not None and a.ndim:
        a = a[sharding.local_slices(a.shape)]
    if entry["dtype"] == "bfloat16" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if t.dtype != like.dtype:
        raise AssertionError((path, t.dtype, like.dtype))
    if sharding is None:
        return t.to(like.device)
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    local = t.to(dev, copy=True).contiguous()
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False, shape=tuple(like.shape),
                              stride=_contiguous_strides(like.shape))


def _contiguous_strides(shape) -> tuple:
    strides, n = [], 1
    for s in reversed(tuple(shape)):
        strides.append(n)
        n *= s
    return tuple(reversed(strides))


def restore_checkpoint(
    directory: str | os.PathLike,
    step: Optional[int],
    like: Any,
    shardings: Any = None,
):
    """Restore into the structure of ``like`` (its keys in its own order);
    returns ``(tree, step)``.  Each leaf must have ``like``'s shape and
    dtype (``AssertionError`` otherwise).  ``shardings``: a matching tree
    of ``NamedSharding`` (None leaves stay plain), each leaf then a
    DTensor of this rank's block (elastic restore)."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
    with contextlib.ExitStack() as stack:
        files = [stack.enter_context(np.load(d / f)) for f in manifest["files"]]

        def build(node, prefix, sh):
            if isinstance(node, dict):
                return {k: build(v, _child(prefix, k),
                                 None if sh is None else sh[k])
                        for k, v in node.items()}
            entry = by_path[prefix]
            return _leaf(files[entry["file"]][entry["key"]], entry, node, sh)

        tree = build(like, "", shardings)
    return tree, manifest["step"]


class AsyncCheckpointer:
    """Background-thread writer with bounded staleness of one save."""

    def __init__(self, directory: str | os.PathLike):
        self.directory = pathlib.Path(directory)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        snapshot = _snapshot(tree)  # on the caller, before it returns

        def _run():
            try:
                _write(self.directory, step, snapshot)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
