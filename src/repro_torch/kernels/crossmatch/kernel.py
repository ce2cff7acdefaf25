"""CUDA cross-match kernels: build, ctypes binding and launch wrappers.

``csrc/crossmatch.cu`` holds one kernel, the Hopper counterpart of the
three Pallas TPU kernels of the JAX reference
(``repro/kernels/crossmatch/kernel.py``), one instance a row-range policy:

  crossmatch_kernel         <- crossmatch_pallas        (:89)   K1
  crossmatch_fused_kernel   <- crossmatch_fused_pallas  (:248)  K2
  crossmatch_shared_kernel  <- crossmatch_shared_pallas (:206)  K3

Several probes a thread, one bucket row range a probe (K1: the bucket's
real rows, or its band's; K2/K3: its segment's), and, where the probe
blocks are too few to fill the card, each range split across blocks and
merged in the same launch (``split_plan``; see the source's note).

Inputs are what the Pallas kernels take: (N, COORD_PAD) bucket and
(M, COORD_PAD) probe rows, marked by ``ops``; on the card any M >= 1 (K1:
the first M rows of its padded probe grid).  A wrapper given CPU tensors
runs the plain PyTorch version from ``ref``; given CUDA tensors it
launches the kernel on the current stream, or raises.  ``LAUNCHES`` counts
kernel launches, one per launch, per wrapper.

The source is compiled at first use (``nvcc.CudaLibrary``: nvcc into a
shared library with a plain C interface, in ``build/kernels/``, rebuilt
when the source changes).  Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..nvcc import CudaLibrary
from .ref import crossmatch_fused_ref, crossmatch_ref, crossmatch_shared_ref

__all__ = [
    "COORD_PAD",
    "PAD_SEG",
    "LAUNCHES",
    "reset_launches",
    "build",
    "build_info",
    "split_plan",
    "bucket_rows_taken",
    "segment_layout",
    "segment_plan",
    "crossmatch_kernel",
    "crossmatch_fused_kernel",
    "crossmatch_shared_kernel",
]

COORD_PAD = 8  # zero-padded coordinate dimension
PAD_SEG = float(2**20)  # segment id of padded rows (sorts last, matches none)

LAUNCHES = {"crossmatch": 0, "crossmatch_fused": 0, "crossmatch_shared": 0}
_count_lock = threading.Lock()

# The kernel's split plan: split rows across blocks until the
# grid holds SPLIT_BLOCKS_PER_SM blocks an SM, but leave every split at
# least MIN_SPLIT_ROWS of the bucket's rows (``cm_tune.py`` sweeps both on
# the card; see PERF.md).
SPLIT_BLOCKS_PER_SM = 32
MIN_SPLIT_ROWS = 1024
_MAX_SPLITS = 65535  # gridDim.y


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.crossmatch_launch.argtypes = [
        p, p, f, i, i, i, i, i, i, i, i, p, p, p, p, p, p]
    lib.crossmatch_segment_launch.argtypes = [
        p, p, p, p, p, f, i, i, i, p, p, p, p, p, p]
    for fn in ("crossmatch_segment_thread_probes",
               "crossmatch_segment_block_probes"):
        getattr(lib, fn).argtypes = []
    for fn in ("crossmatch_launch", "crossmatch_segment_launch",
               "crossmatch_segment_thread_probes",
               "crossmatch_segment_block_probes"):
        getattr(lib, fn).restype = ctypes.c_int


LIBRARY = CudaLibrary("crossmatch", _bind)
# (device, stream) -> (workspace, int32 counters kept at 0), grown as
# needed: launches on one stream run in order, so they share them.
_scratch: dict = {}
_sm_count: dict = {}


def build() -> ctypes.CDLL:
    """Compile (if the source's hash is new) and load the kernel library."""
    return LIBRARY.load()


def build_info() -> dict:
    """Library path, whether this process compiled it, the build's wall
    seconds and nvcc's output (ptxas register/shared-memory report)."""
    return LIBRARY.info()


def split_plan(m: int, n: int, sms: int, block_probes: int):
    """(probe blocks, splits) of a launch, from shapes alone:
    ``block_probes`` probe rows a block; splits across the y axis until the
    grid holds ``SPLIT_BLOCKS_PER_SM * sms`` blocks, each split keeping at
    least ``MIN_SPLIT_ROWS`` of the ``n`` bucket rows a probe walks."""
    blocks = max(1, -(-m // block_probes))
    want = -(-SPLIT_BLOCKS_PER_SM * sms // blocks)
    return blocks, max(1, min(want, n // MIN_SPLIT_ROWS, _MAX_SPLITS))


def bucket_rows_taken(n: int, n_real: int, cos_thr: float) -> int:
    """The rows [0, rows) a K1 launch takes of an (N = ``n``, COORD_PAD)
    bucket whose rows from ``n_real`` on are marker rows: the real ones, or
    all ``n`` where ``cos_thr <= -2`` (the reference counts the marker rows
    there).  A probe walks at most these rows, with or without a band: the
    split plan's row count."""
    return n if cos_thr <= -2.0 else n_real


def segment_layout() -> tuple:
    """(probes a thread, probes a block) of the built kernel."""
    lib = build()
    return (lib.crossmatch_segment_thread_probes(),
            lib.crossmatch_segment_block_probes())


def _sms(dev: torch.device) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_count[index]


def segment_plan(m: int, n: int, dev: torch.device) -> tuple:
    """``split_plan`` of a launch of m probes, each walking n bucket rows
    at most, on card ``dev`` with the built kernel's block."""
    return split_plan(m, n, _sms(dev), segment_layout()[1])


def _split_scratch(dev: torch.device, stream: int, words: int, counters: int):
    """The workspace (at least ``words`` 4-byte words) and ``counters``
    int32 counters at 0 for the launches on ``stream``.  The merging block
    of each probe block sets its counter back to 0, so counters are zeroed
    once, when made or grown; nothing is allocated on a call that fits."""
    key = (dev, stream)
    ws, cnt = _scratch.get(key, (None, None))
    if ws is None or ws.numel() < words:
        ws = torch.empty(words, dtype=torch.float32, device=dev)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(max(counters, 1024), dtype=torch.int32, device=dev)
    _scratch[key] = (ws, cnt)
    return ws, cnt


def _check_rows(x: torch.Tensor, what: str, dev: torch.device) -> None:
    if x.device != dev:
        raise ValueError(f"{what} is on {x.device}, expected {dev}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != COORD_PAD:
        raise ValueError(
            f"{what} must be float32 (rows, {COORD_PAD}); got "
            f"{x.dtype} {tuple(x.shape)}"
        )
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")


def _check_vec(x: torch.Tensor, what: str, n: int, dev: torch.device) -> None:
    if x.device != dev or x.dtype != torch.float32 or x.shape != (n,):
        raise ValueError(
            f"{what} must be float32 ({n},) on {dev}; got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _outputs(m: int, dev: torch.device):
    return (
        torch.empty(m, dtype=torch.int32, device=dev),
        torch.empty(m, dtype=torch.float32, device=dev),
        torch.empty(m, dtype=torch.int32, device=dev),
    )


def _device_of(bucket: torch.Tensor) -> torch.device:
    dev = bucket.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch(name: str, dev: torch.device, m: int, walked: int, entry):
    """Plan a launch of ``m`` probe rows, each walking ``walked`` bucket
    rows at most, allocate its outputs and split scratch, and call
    ``entry(lib, splits, idx, dot, cnt, ws, counters, stream)``; returns
    (idx, dot, cnt)."""
    if m == 0:
        raise ValueError("the kernel needs at least one probe row")
    lib = build()
    blocks, splits = split_plan(m, walked, _sms(dev),
                                lib.crossmatch_segment_block_probes())
    idx, dot, cnt = _outputs(m, dev)
    with torch.cuda.device(dev):
        stream = _stream()
        ws_ptr, counters = None, None
        if splits > 1:
            ws, cnt_buf = _split_scratch(dev, stream, 3 * splits * m, blocks)
            ws_ptr, counters = ws.data_ptr(), cnt_buf.data_ptr()
        code = entry(lib, splits, idx.data_ptr(), dot.data_ptr(),
                     cnt.data_ptr(), ws_ptr, counters, stream)
    LIBRARY.check(code, name)
    _count(name)
    return idx, dot, cnt


def crossmatch_kernel(
    bucket: torch.Tensor,  # (N, COORD_PAD) f32, N % bn == 0
    probes: torch.Tensor,  # (M, COORD_PAD) f32, M <= m_grid
    cos_thr: float,
    bm: int = 128,
    bn: int = 512,
    band: Optional[int] = None,
    n_real: Optional[int] = None,
    m_grid: Optional[int] = None,
):
    """Single-bucket join (K1).  Returns (best_idx i32, best_dot f32,
    n_cand i32), each (M,).

    ``bucket``'s rows from ``n_real`` (default N) on are marker rows, which
    dot to -2 with every probe; ``probes`` are the first M rows of the
    reference's (``m_grid``, COORD_PAD) probe grid (default M: all of it),
    ``m_grid % bm == 0``.  ``bm``/``bn`` shape the band's tile grid over
    (m_grid, N).  On the card the kernel walks only the rows
    ``bucket_rows_taken`` gives, each probe those its band keeps."""
    dev = _device_of(bucket)
    m, n = probes.shape[0], bucket.shape[0]
    m_grid = m if m_grid is None else int(m_grid)
    n_real = n if n_real is None else int(n_real)
    if m_grid % bm or n % bn:
        raise ValueError(f"the grid ({m_grid}, {n}) must be multiples of "
                         f"({bm}, {bn})")
    if m > m_grid or not 0 <= n_real <= n:
        raise ValueError(f"{m} probe rows and {n_real} real bucket rows do "
                         f"not fit the ({m_grid}, {n}) grid")
    if band is not None and band < 0:
        raise ValueError(f"band must be >= 0, got {band}")
    if dev.type == "cpu":
        return crossmatch_ref(bucket, probes, cos_thr, band=band, bm=bm,
                              bn=bn, m_grid=m_grid)
    _check_rows(bucket, "bucket", dev)
    _check_rows(probes, "probes", dev)
    rows = bucket_rows_taken(n, n_real, cos_thr)
    return _launch(
        "crossmatch", dev, m, rows,
        lambda lib, *rest: lib.crossmatch_launch(
            bucket.data_ptr(), probes.data_ptr(), float(cos_thr), rows, m,
            -1 if band is None else int(band), bm, bn, m_grid // bm, n // bn,
            *rest),
    )


def _segment_launch(name, bucket, probes, bucket_seg, probe_seg, thr):
    """Launch the kernel's segment instance (K2 with a float ``thr``, K3
    with an (M,) tensor) after the shared checks; returns (idx, dot, cnt)."""
    dev = bucket.device
    m, n = probes.shape[0], bucket.shape[0]
    _check_rows(bucket, "bucket", dev)
    _check_rows(probes, "probes", dev)
    _check_vec(bucket_seg, "bucket_seg", n, dev)
    _check_vec(probe_seg, "probe_seg", m, dev)
    per_probe = torch.is_tensor(thr)
    if per_probe:
        _check_vec(thr, "probe_thr", m, dev)
    return _launch(
        name, dev, m, n,
        lambda lib, *rest: lib.crossmatch_segment_launch(
            bucket.data_ptr(), probes.data_ptr(), bucket_seg.data_ptr(),
            probe_seg.data_ptr(), thr.data_ptr() if per_probe else None,
            0.0 if per_probe else float(thr), n, m, *rest),
    )


def crossmatch_fused_kernel(
    bucket: torch.Tensor,  # (N, COORD_PAD) f32, segment-sorted
    probes: torch.Tensor,  # (M, COORD_PAD) f32
    bucket_seg: torch.Tensor,  # (N,) f32 ascending
    probe_seg: torch.Tensor,  # (M,) f32
    cos_thr: float,
):
    """Segment-masked multi-bucket join (K2); best_idx indexes the
    concatenated bucket."""
    dev = _device_of(bucket)
    if dev.type == "cpu":
        return crossmatch_fused_ref(bucket, probes, bucket_seg, probe_seg, cos_thr)
    return _segment_launch("crossmatch_fused", bucket, probes, bucket_seg,
                           probe_seg, float(cos_thr))


def crossmatch_shared_kernel(
    bucket: torch.Tensor,  # (N, COORD_PAD) f32, segment-sorted
    probes: torch.Tensor,  # (M, COORD_PAD) f32
    bucket_seg: torch.Tensor,  # (N,) f32 ascending
    probe_seg: torch.Tensor,  # (M,) f32
    probe_thr: torch.Tensor,  # (M,) f32, each in (-2, 1] (padded rows +2)
):
    """Shared-plan join (K3): the segment mask plus per-probe thresholds."""
    dev = _device_of(bucket)
    if dev.type == "cpu":
        return crossmatch_shared_ref(
            bucket, probes, bucket_seg, probe_seg, probe_thr
        )
    return _segment_launch("crossmatch_shared", bucket, probes, bucket_seg,
                           probe_seg, probe_thr)
