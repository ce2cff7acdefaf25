"""CUDA paged decode attention (K4): ctypes binding and launch wrapper.

``csrc/paged_attention.cu`` is the Hopper counterpart of the Pallas TPU
kernel ``paged_attention_pallas`` of the JAX reference
(``repro/kernels/paged_attention/kernel.py:102``), templated for float32
and bfloat16 with f32 arithmetic inside.  It is bound by the bytes of the
valid K/V slots; see the source's note for what its design does about it.

A wrapper given CPU tensors runs the plain PyTorch version from ``ref``;
given CUDA tensors it launches the kernel on the current stream, or
raises.  ``LAUNCHES["paged_attention"]`` counts kernel launches.  The
source is compiled at first use (``nvcc.CudaLibrary``); nothing is built
when this module is imported.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..nvcc import CudaLibrary
from .ref import paged_attention_ref

__all__ = [
    "LAUNCHES",
    "MAX_HEAD_DIM",
    "reset_launches",
    "build",
    "build_info",
    "paged_attention_kernel",
]

MAX_HEAD_DIM = 256  # kMaxPerLane * 32 in the source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"paged_attention": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES["paged_attention"] = 0


def _count() -> None:
    with _count_lock:
        LAUNCHES["paged_attention"] += 1


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.argtypes = [p, p, p, p, p, p] + [i] * 8 + [p]
    lib.paged_attention_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("paged_attention", _bind)


def build() -> ctypes.CDLL:
    """Compile (if the source's hash is new) and load the kernel library."""
    return LIBRARY.load()


def build_info() -> dict:
    """Library path, whether this process compiled it, the build's wall
    seconds and nvcc's output (ptxas register/shared-memory report)."""
    return LIBRARY.info()


def _check(q, k_pages, v_pages, page_table, seq_lens) -> None:
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("q, k_pages and v_pages must share one dtype")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"expected q (B,H,D) and equal pools (N,page,KV,D); got "
            f"{tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}"
        )
    B, H, D = q.shape
    _, _, KV, Dk = k_pages.shape
    if Dk != D or H % KV or D > MAX_HEAD_DIM:
        raise ValueError(
            f"need H % KV == 0, matching head_dim <= {MAX_HEAD_DIM}; got "
            f"H={H}, KV={KV}, D={D}/{Dk}"
        )
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != B:
        raise ValueError(f"page_table must be int32 ({B}, P)")
    if seq_lens.dtype != torch.int32 or seq_lens.shape != (B,):
        raise ValueError(f"seq_lens must be int32 ({B},)")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_attention_kernel(
    q: torch.Tensor,  # (B, H, D) f32 or bf16
    k_pages: torch.Tensor,  # (N, page, KV, D), q's dtype
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, P) int32, entries in [0, N)
    seq_lens: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    """Decode attention over paged KV (K4): (B, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_pages, v_pages, page_table, seq_lens)
    B, H, D = q.shape
    N, page, KV, _ = k_pages.shape
    lib = build()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, H, KV, D, page, page_table.shape[1], N, _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    LIBRARY.check(code, "paged_attention")
    _count()
    return out
