"""CUDA ragged grouped matmul (K5): ctypes binding and launch wrapper.

``csrc/grouped_matmul.cu`` is the Hopper counterpart of the Pallas TPU
kernel ``grouped_matmul_pallas`` of the JAX reference
(``repro/kernels/grouped_matmul/kernel.py:48``): y[r] = x[r] @
w[tile_gid[r // bt]] with f32 sums.  In bfloat16 it runs a TMA ring and
``wgmma`` where TMA can describe the operands (``kernel_path`` says which
kernel a call takes), wmma with element loads where it cannot; in float32
CUDA-core FMA.  An optional ``tile_rows`` names the real leading rows of
each ``bt``-row tile: the other rows count as zero and are written as +0,
and a tile with none reads no weights.  At the MoE decode shapes K5 is
bound by the bytes of the experts' weights; see the source's note.

Training.  ``grouped_matmul_fn`` is K5 with a backward (an autograd
Function): dX is K5 itself on each group's transposed weights, which the
TMA kernel reads through a tensor map over w as it is (``w_transposed``:
no copy of w^T is made on that path), and dW the source's ``gmm_dw_*``
kernels (``grouped_matmul_dw_kernel``; ``dw_kernel_path`` says which),
which the reference has no counterpart of (XLA transposes its einsum).
With no input that requires grad it is the raw wrapper, so serving
launches and copies nothing more.  The raw ``grouped_matmul_kernel``
raises when grad mode is on and a CUDA input requires grad: its output
would carry no gradient.

A wrapper given CPU tensors runs the plain PyTorch version from ``ref``;
given CUDA tensors it launches the kernel on the current stream, or
raises; given ``meta`` tensors (the multi-pod dry-run) it returns the
output's shape and reports the kernel's flops and bytes to
``kernels.shapes`` (every row counted: a meta tensor holds no counts).  ``LAUNCHES`` counts kernel launches: ``grouped_matmul`` the
forward's, ``grouped_matmul_dx`` the backward's K5 on the transposed
weights (the element-load and f32 kernels take a contiguous copy of w^T,
off the main path), ``grouped_matmul_dw`` the weight gradient's.  The source is
compiled at first use (``nvcc.CudaLibrary``); nothing is built when this
module is imported.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .. import shapes
from ..nvcc import CudaLibrary
from .ref import grouped_matmul_dw_ref, grouped_matmul_tiles_ref

__all__ = [
    "LAUNCHES",
    "ROW_TILE",
    "reset_launches",
    "build",
    "build_info",
    "dw_kernel_path",
    "grouped_matmul_dw_kernel",
    "grouped_matmul_fn",
    "grouped_matmul_kernel",
    "kernel_path",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Rows of one block's tile (kBM / kFBM in the source): ``bt`` must be a
# multiple of it, so that a block's rows lie in one group.
ROW_TILE = {torch.float32: 64, torch.bfloat16: 128}
_MAX_GRID_Y = 65535
_INT32_MAX = 2**31 - 1

LAUNCHES = {"grouped_matmul": 0, "grouped_matmul_dx": 0,
            "grouped_matmul_dw": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_matmul_launch.argtypes = [p, p, p, p, p] + [i] * 8 + [p]
    lib.grouped_matmul_launch.restype = ctypes.c_int
    lib.grouped_matmul_dw_launch.argtypes = [p, p, p, p, p] + [i] * 7 + [p]
    lib.grouped_matmul_dw_launch.restype = ctypes.c_int
    lib.grouped_matmul_row_tile.argtypes = [i]
    lib.grouped_matmul_row_tile.restype = ctypes.c_int


LIBRARY = CudaLibrary("grouped_matmul", _bind)


def build() -> ctypes.CDLL:
    """Compile (if the source's hash is new) and load the kernel library."""
    return LIBRARY.load()


def build_info() -> dict:
    """Library path, whether this process compiled it, the build's wall
    seconds and nvcc's output (ptxas register/shared-memory report)."""
    return LIBRARY.info()


def _tma_path(a: torch.Tensor, b: torch.Tensor) -> str:
    """"f32" for float32 operands; for bf16 "tma" where TMA can describe
    both (inner widths multiples of 8, 16-byte aligned bases), else
    "elem"."""
    if a.dtype == torch.float32:
        return "f32"
    ok = all(t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0 for t in (a, b))
    return "tma" if ok else "elem"


def kernel_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel a CUDA call on these operands takes, by dtype and shape:
    "tma" (``gmm_bf16_tma``: bf16 with d and f multiples of 8 and 16-byte
    aligned bases, what TMA can describe; it also reads w transposed, for
    K5's dX), "elem" (``gmm_bf16_elem``, other bf16) or "f32"
    (``gmm_f32``).  The wrapper launches by it."""
    return _tma_path(x, w)


def dw_kernel_path(x: torch.Tensor, dy: torch.Tensor) -> str:
    """The kernel a CUDA ``grouped_matmul_dw_kernel`` call takes: "tma"
    (``gmm_dw_bf16_tma``: bf16 with d and f multiples of 8 and 16-byte
    aligned bases), "elem" (``gmm_dw_bf16``, other bf16) or "f32"
    (``gmm_dw_f32``).  The wrapper launches by it."""
    return _tma_path(x, dy)


def _check(x, tile_gid, w, bt, tile_rows, w_transposed=False) -> None:
    named = [("tile_gid", tile_gid), ("w", w)]
    if tile_rows is not None:
        named.append(("tile_rows", tile_rows))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a tensor, got {type(t)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != x.dtype:
        raise ValueError(f"x and w must share one dtype: {x.dtype}, {w.dtype}")
    depth = 2 if w_transposed else 1
    if x.dim() != 2 or w.dim() != 3 or w.shape[depth] != x.shape[1]:
        layout = "(G, f, d)" if w_transposed else "(G, d, f)"
        raise ValueError(f"expected x (T, d) and w {layout}; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    T = x.shape[0]
    tile = ROW_TILE[x.dtype]
    if bt <= 0 or bt % tile:
        raise ValueError(f"bt={bt} is not a multiple of the kernel's "
                         f"{tile}-row tile for {x.dtype}")
    if T % bt:
        raise ValueError(f"{T} rows are not a whole number of {bt}-row tiles")
    if tile_gid.dtype != torch.int32 or tile_gid.shape != (T // bt,):
        raise ValueError(f"tile_gid must be int32 ({T // bt},), got "
                         f"{tile_gid.dtype} {tuple(tile_gid.shape)}")
    if tile_rows is not None and (tile_rows.dtype != torch.int32
                                  or tile_rows.shape != (T // bt,)):
        raise ValueError(f"tile_rows must be int32 ({T // bt},), got "
                         f"{tile_rows.dtype} {tuple(tile_rows.shape)}")
    if T // tile > _MAX_GRID_Y or max(x.numel(), w.shape[0] * w.shape[depth],
                                      T * w.shape[3 - depth]) > _INT32_MAX:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}: too large "
                         f"for one launch")
    for name, t in [("x", x)] + named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def grouped_matmul_kernel(
    x: torch.Tensor,  # (T, d) f32 or bf16, T % bt == 0
    tile_gid: torch.Tensor,  # (T // bt,) int32, group of each row tile
    w: torch.Tensor,  # (G, d, f), x's dtype
    bt: int,
    tile_rows: torch.Tensor | None = None,  # (T // bt,) int32 real rows
) -> torch.Tensor:
    """Tile-mapped grouped matmul (K5): (T, f) in x's dtype.  With
    ``tile_rows``, the rows of each tile past its count are taken as zero
    and come out +0.  Has no backward: a CUDA call with grad mode on and
    an input that requires grad raises (use ``grouped_matmul_fn``)."""
    if (x.device.type == "cuda" and torch.is_grad_enabled()
            and (x.requires_grad or w.requires_grad)):
        raise RuntimeError("grouped_matmul_kernel has no backward and its "
                           "input requires grad: call grouped_matmul_fn")
    return _k5(x, tile_gid, w, bt, tile_rows, "grouped_matmul")


def _k5(x, tile_gid, w, bt, tile_rows, counter: str,
        w_transposed: bool = False) -> torch.Tensor:
    """K5 on CPU (the plain version) or CUDA tensors, the launch counted
    under ``counter``.  ``w_transposed``: w is (G, f, d) and the call
    multiplies by each group's w^T (K5's dX on the forward's weights)."""
    if x.device.type == "cpu":
        if w_transposed:
            w = w.transpose(1, 2).contiguous()
        return grouped_matmul_tiles_ref(x, tile_gid, w, bt, tile_rows)
    if x.device.type == "meta":
        T, d = x.shape
        out = shapes.meta_empty((T, w.shape[1 if w_transposed else 2]), x)
        shapes.record(counter, 2.0 * T * d * out.shape[1],
                      shapes.nbytes(x, tile_gid, w, tile_rows, out))
        return out
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, tile_gid, w, bt, tile_rows, w_transposed)
    path = kernel_path(x, w)
    if w_transposed and path != "tma":
        # The element-load and f32 kernels index w (G, d, f); only the TMA
        # kernel reads it transposed, so the other paths copy it.
        w, w_transposed = w.transpose(1, 2).contiguous(), False
    T, d = x.shape
    G, f = w.shape[0], w.shape[1 if w_transposed else 2]
    out = torch.empty((T, f), dtype=x.dtype, device=x.device)
    if T == 0 or f == 0:
        return out
    lib = build()
    with torch.cuda.device(x.device):
        code = lib.grouped_matmul_launch(
            x.data_ptr(), tile_gid.data_ptr(),
            None if tile_rows is None else tile_rows.data_ptr(),
            w.data_ptr(), out.data_ptr(), T, d, f, G, bt, _DTYPES[x.dtype],
            int(path == "tma"), int(w_transposed),
            torch.cuda.current_stream().cuda_stream,
        )
    LIBRARY.check(code, "grouped_matmul")
    _count(counter)
    return out


def grouped_matmul_dw_kernel(
    x: torch.Tensor,  # (T, d) f32 or bf16, T % bt == 0
    dy: torch.Tensor,  # (T, f), x's dtype
    tile_gid: torch.Tensor,  # (T // bt,) int32
    n_groups: int,
    bt: int,
    tile_rows: torch.Tensor | None = None,  # (T // bt,) int32 real rows
) -> torch.Tensor:
    """K5's weight gradient: dw (n_groups, d, f) in x's dtype, dw[g] the
    f32 sum of x[r]^T dy[r] over the real rows of g's tiles; +0 for a
    group with none."""
    if x.device.type == "cpu":
        return grouped_matmul_dw_ref(x, dy, tile_gid, n_groups, bt, tile_rows)
    if x.device.type == "meta":
        T, d = x.shape
        dw = shapes.meta_empty((n_groups, d, dy.shape[1]), x)
        shapes.record("grouped_matmul_dw", 2.0 * T * d * dy.shape[1],
                      shapes.nbytes(x, dy, tile_gid, tile_rows, dw))
        return dw
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_dw(x, dy, tile_gid, n_groups, bt, tile_rows)
    T, d = x.shape
    f = dy.shape[1]
    dw = torch.empty((n_groups, d, f), dtype=x.dtype, device=x.device)
    if dw.numel() == 0:
        return dw
    tma = dw_kernel_path(x, dy) == "tma"
    lib = build()
    with torch.cuda.device(x.device):
        code = lib.grouped_matmul_dw_launch(
            x.data_ptr(), dy.data_ptr(), tile_gid.data_ptr(),
            None if tile_rows is None else tile_rows.data_ptr(),
            dw.data_ptr(), T, d, f, n_groups, bt, _DTYPES[x.dtype], int(tma),
            torch.cuda.current_stream().cuda_stream,
        )
    LIBRARY.check(code, "grouped_matmul_dw")
    _count("grouped_matmul_dw")
    return dw


def _check_dw(x, dy, tile_gid, n_groups, bt, tile_rows) -> None:
    named = [("dy", dy), ("tile_gid", tile_gid)]
    if tile_rows is not None:
        named.append(("tile_rows", tile_rows))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise ValueError(f"x and dy must share float32 or bfloat16: "
                         f"{x.dtype}, {dy.dtype}")
    if x.dim() != 2 or dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"expected x (T, d) and dy (T, f); got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    T = x.shape[0]
    if bt <= 0 or T % bt:
        raise ValueError(f"{T} rows are not a whole number of {bt}-row tiles")
    for name, t in [("tile_gid", tile_gid), ("tile_rows", tile_rows)]:
        if t is not None and (t.dtype != torch.int32
                              or t.shape != (T // bt,)):
            raise ValueError(f"{name} must be int32 ({T // bt},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    d, f = x.shape[1], dy.shape[1]
    if not 0 < n_groups <= _MAX_GRID_Y or max(
            x.numel(), dy.numel(), n_groups * d * f) > _INT32_MAX:
        raise ValueError(f"x {tuple(x.shape)}, dy {tuple(dy.shape)}, "
                         f"{n_groups} groups: too large for one launch")
    for name, t in [("x", x)] + named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class _GroupedMatmul(torch.autograd.Function):
    """K5 with its backward: dx = K5(dy, w^T) on w as it is, dw = the dW
    kernel."""

    @staticmethod
    def forward(ctx, x, tile_gid, w, bt, tile_rows):
        ctx.save_for_backward(x, tile_gid, w, tile_rows)
        ctx.bt = bt
        return _k5(x, tile_gid, w, bt, tile_rows, "grouped_matmul")

    @staticmethod
    def backward(ctx, dy):
        x, tile_gid, w, tile_rows = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _k5(dy, tile_gid, w, ctx.bt, tile_rows, "grouped_matmul_dx",
                     w_transposed=True)
        if ctx.needs_input_grad[2]:
            dw = grouped_matmul_dw_kernel(x, dy, tile_gid, w.shape[0],
                                          ctx.bt, tile_rows)
        return dx, None, dw, None, None


def grouped_matmul_fn(x: torch.Tensor, tile_gid: torch.Tensor,
                      w: torch.Tensor, bt: int,
                      tile_rows: torch.Tensor | None = None) -> torch.Tensor:
    """K5 (``grouped_matmul_kernel``'s function) with a backward: where
    grad mode is on and x or w requires grad, through the autograd
    Function (on the CPU its forward and backward are the plain
    versions); else the raw wrapper, with no extra launch or copy."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(x, tile_gid, w, bt, tile_rows)
    return _k5(x, tile_gid, w, bt, tile_rows, "grouped_matmul")
