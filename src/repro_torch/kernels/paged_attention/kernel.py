"""CUDA paged decode attention (K4): ctypes binding and launch wrapper.

``csrc/paged_attention.cu`` is the Hopper counterpart of the Pallas TPU
kernel ``paged_attention_pallas`` of the JAX reference
(``repro/kernels/paged_attention/kernel.py:102``), templated for float32
and bfloat16 with f32 arithmetic inside.  It is bound by the bytes of the
valid K/V slots.  A long cache is split across blocks (``split_plan``) and
the splits' partial softmaxes are merged in the same launch, in split
order.  ``kernel_path`` names the instance a call takes: bf16 query-head
groups (G > 2) go through tensor cores, every row of a KV head in one
pass over the chunk; the rest through the pair instance, in 16-byte
copies where the row allows it.  See the source's note.

A wrapper given CPU tensors runs the plain PyTorch version from ``ref``;
given CUDA tensors it launches the kernel on the current stream, or
raises; given ``meta`` tensors (the multi-pod dry-run) it returns the
output's shape and reports the kernel's flops and bytes to
``kernels.shapes``, every slot of the table counted (a meta tensor holds
no lengths).  With ``partials=True`` it returns (out, m, l), the row's
max score and softmax sum beside the output, for a sequence-sharded
cache: the same launch with two more (B, H) f32 outputs.
``LAUNCHES["paged_attention"]`` counts kernel launches (one a call, the
merge included), and ``PATH_LAUNCHES`` the same launches by the path
each took.  The source is compiled at first use
(``nvcc.CudaLibrary``); nothing is built when this module is imported.
"""
from __future__ import annotations

import contextlib
import ctypes
import struct
import threading

import torch

from .. import shapes
from ..nvcc import CudaLibrary
from .ref import paged_attention_partials_ref, paged_attention_ref

__all__ = [
    "CHUNK",
    "LAUNCHES",
    "MAX_HEAD_DIM",
    "PATH_LAUNCHES",
    "reset_launches",
    "build",
    "build_info",
    "kernel_path",
    "split_plan",
    "workspace_bytes",
    "paged_attention_kernel",
]

MAX_HEAD_DIM = 256  # the source's limit
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"scalar": 0, "async": 1, "mma": 2}
# A row of 8, 16, 32 or 64 16-byte vectors takes the cp.async ring.
_VEC_ROWS = (8, 16, 32, 64)
# The head_dims of the tensor-core instance (bf16, G > 2).
_MMA_HEAD_DIMS = (64, 128, 192, 256)

# Slots a block takes when a sequence is split (``k4_tune.py``'s sweep on
# the card: 512 beat 128, 256 and 1024 at chip_smoke.py's (b), (c) and (e);
# see PERF.md).
CHUNK = 512
_MAX_SPLITS = 65535  # gridDim.z

LAUNCHES = {"paged_attention": 0}
PATH_LAUNCHES = dict.fromkeys(_PATHS, 0)
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES["paged_attention"] = 0
        PATH_LAUNCHES.update(dict.fromkeys(_PATHS, 0))


# The launch entry's one argument: PagedAttentionArgs in the source, 22
# int64 (pointers as integers, 0 for none).
_ARGS = struct.Struct("<22q")


def _bind(lib: ctypes.CDLL) -> None:
    lib.paged_attention_launch.argtypes = [ctypes.c_char_p]
    lib.paged_attention_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("paged_attention", _bind)
_launch = None  # the bound launch entry, once the library is loaded
# The current stream's handle without building a torch.cuda.Stream (a few
# µs a call); CUDA builds of torch have it.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
# No torch.cuda.device context (a few µs) when q's device is the current one.
_CURRENT_DEVICE = contextlib.nullcontext()
# (device, stream) -> (f32 workspace, int32 merge counters kept at 0),
# grown as needed: launches on one stream run in order, so they share them.
_scratch: dict = {}


def build() -> ctypes.CDLL:
    """Compile (if the source's hash is new) and load the kernel library."""
    return LIBRARY.load()


def build_info() -> dict:
    """Library path, whether this process compiled it, the build's wall
    seconds and nvcc's output (ptxas register/shared-memory report)."""
    return LIBRARY.info()


def kernel_path(q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor) -> str:
    """The instance a CUDA call takes, by dtype, shape and alignment (the
    pools' bases 16-byte aligned in the first two):

    * "mma": bf16 with G = H / KV > 2 query heads a KV head and D = 64,
      128, 192 or 256 -- jamba (G = 4), mixtral-8x22b (6), paligemma and
      qwen1.5-110b (8), mistral-large-123b and nemotron-4-340b (12, D =
      192).  Tensor cores (mma.sync) take the G rows, padded to 16, through
      the chunk in one pass; G > 16 runs the chunk once for each 16 rows.
    * "async": the pair instance through a cp.async ring, where a K/V row
      is 8, 16, 32 or 64 16-byte vectors: f32 at any G, bf16 at G <= 2.
      At G > 2 (f32 only) it runs the chunk once for each pair of rows.
    * "scalar": the pair instance with element loads, for any other row
      (D = 40 or 16; f32 at D = 192) or unaligned pools."""
    D = q.shape[-1]
    aligned = k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0
    if (aligned and q.dtype == torch.bfloat16 and D in _MMA_HEAD_DIMS
            and q.shape[1] > 2 * k_pages.shape[2]):
        return "mma"
    vecs, rest = divmod(D * q.element_size(), 16)
    if rest == 0 and vecs in _VEC_ROWS and aligned:
        return "async"
    return "scalar"


def split_plan(slots: int):
    """(splits, chunk): the table's ``slots`` = P * page cut across blocks
    in chunks of ``CHUNK``, from the shape alone (never from seq_lens, which
    live on the device); one split where the table holds at most a chunk."""
    splits = max(1, -(-slots // CHUNK))
    if splits > _MAX_SPLITS:
        raise ValueError(f"{slots} slots need {splits} splits of {CHUNK}; "
                         f"the grid takes {_MAX_SPLITS}")
    return splits, CHUNK


def workspace_bytes(B: int, H: int, KV: int, D: int, splits: int) -> int:
    """Bytes of the f32 workspace a call with ``splits`` > 1 needs: each
    split's acc (G, D), m and l (G) and fault flag."""
    if splits <= 1:
        return 0
    return 4 * B * KV * splits * ((H // KV) * (D + 2) + 1)


def _check(q, k_pages, v_pages, page_table, seq_lens) -> None:
    """Raise ValueError on what the kernel does not take.  One expression
    passes a good call; only a refused one walks the checks one by one."""
    dev, dt = q.device, q.dtype
    qs, ks = q.shape, k_pages.shape
    i32 = torch.int32
    if (len(qs) == 3 and len(ks) == 4 and v_pages.shape == ks
            and ks[3] == qs[2] <= MAX_HEAD_DIM and qs[1] % ks[2] == 0
            and dt in _DTYPES and k_pages.dtype == dt and v_pages.dtype == dt
            and page_table.dtype == i32 and page_table.dim() == 2
            and page_table.shape[0] == qs[0] and seq_lens.dtype == i32
            and seq_lens.shape == (qs[0],) and k_pages.device == dev
            and v_pages.device == dev and page_table.device == dev
            and seq_lens.device == dev and q.is_contiguous()
            and k_pages.is_contiguous() and v_pages.is_contiguous()
            and page_table.is_contiguous() and seq_lens.is_contiguous()):
        return
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if dt not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {dt}")
    if k_pages.dtype != dt or v_pages.dtype != dt:
        raise ValueError("q, k_pages and v_pages must share one dtype")
    if len(qs) != 3 or len(ks) != 4 or v_pages.shape != ks:
        raise ValueError(
            f"expected q (B,H,D) and equal pools (N,page,KV,D); got "
            f"{tuple(qs)}, {tuple(ks)}, {tuple(v_pages.shape)}"
        )
    B, H, D = qs
    _, _, KV, Dk = ks
    if Dk != D or H % KV or D > MAX_HEAD_DIM:
        raise ValueError(
            f"need H % KV == 0, matching head_dim <= {MAX_HEAD_DIM}; got "
            f"H={H}, KV={KV}, D={D}/{Dk}"
        )
    if page_table.dtype != i32 or page_table.dim() != 2 \
            or page_table.shape[0] != B:
        raise ValueError(f"page_table must be int32 ({B}, P)")
    if seq_lens.dtype != i32 or seq_lens.shape != (B,):
        raise ValueError(f"seq_lens must be int32 ({B},)")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    raise AssertionError("_check's fast path and its checks disagree")


def _split_scratch(device: torch.device, stream: int, floats: int,
                   counters: int):
    """The workspace (at least ``floats`` f32) and ``counters`` int32
    counters at 0 for the launches on ``stream``.  The merging block of
    each (b, kv) sets its counter back to 0, so counters are zeroed once,
    when made or grown; nothing is allocated on a call that fits."""
    key = (device, stream)
    ws, cnt = _scratch.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(max(counters, 1024), dtype=torch.int32,
                          device=device)
    _scratch[key] = (ws, cnt)
    return ws, cnt


def _meta_call(q, k_pages, page_table, seq_lens, partials: bool):
    """K4 on meta tensors: the output's shape (and the partials' m and
    l); the flops of QK^T and PV and the bytes of q, the table's K/V slots,
    the table, the lengths and the outputs, reported to
    ``kernels.shapes``."""
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    T = page_table.shape[1] * page
    outs = (shapes.meta_empty(q.shape, q),)
    if partials:
        outs += tuple(torch.empty((B, H), dtype=torch.float32, device="meta")
                      for _ in range(2))
    kv_bytes = 2 * B * T * KV * D * k_pages.element_size()
    shapes.record("paged_attention", 4.0 * B * H * T * D,
                  kv_bytes + shapes.nbytes(q, page_table, seq_lens, *outs))
    return outs if partials else outs[0]


def paged_attention_kernel(
    q: torch.Tensor,  # (B, H, D) f32 or bf16
    k_pages: torch.Tensor,  # (N, page, KV, D), q's dtype
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, P) int32, entries in [0, N)
    seq_lens: torch.Tensor,  # (B,) int32
    partials: bool = False,
):
    """Decode attention over paged KV (K4): (B, H, D) in q's dtype; with
    ``partials``, (out, m, l), m and l (B, H) f32 (the source's note)."""
    if q.device.type == "cpu":
        if partials:
            return paged_attention_partials_ref(q, k_pages, v_pages,
                                                page_table, seq_lens)
        return paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens)
    if q.device.type == "meta":
        return _meta_call(q, k_pages, page_table, seq_lens, partials)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_pages, v_pages, page_table, seq_lens)
    B, H, D = q.shape
    N, page, KV, _ = k_pages.shape
    P = page_table.shape[1]
    path = kernel_path(q, k_pages, v_pages)
    splits, chunk = split_plan(P * page)
    global _launch
    if _launch is None:
        _launch = build().paged_attention_launch
    out = torch.empty_like(q)
    m = l_ = None
    if partials:
        m, l_ = torch.empty((2, B, H), dtype=torch.float32, device=q.device)
    index = q.device.index
    with (_CURRENT_DEVICE if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        stream = (_raw_stream(index) if _raw_stream is not None
                  else torch.cuda.current_stream(q.device).cuda_stream)
        ws_ptr = counters = 0
        if splits > 1:
            ws, cnt = _split_scratch(q.device, stream,
                                     workspace_bytes(B, H, KV, D, splits) // 4,
                                     B * KV)
            ws_ptr, counters = ws.data_ptr(), cnt.data_ptr()
        code = _launch(_ARGS.pack(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), ws_ptr,
            counters, B, H, KV, D, page, P, N, splits, chunk,
            _DTYPES[q.dtype], _PATHS[path], stream,
            0 if m is None else m.data_ptr(), 0 if l_ is None else l_.data_ptr(),
        ))
    LIBRARY.check(code, "paged_attention")
    with _count_lock:
        LAUNCHES["paged_attention"] += 1
        PATH_LAUNCHES[path] += 1
    return (out, m, l_) if partials else out
