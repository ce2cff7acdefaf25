"""CUDA cross-match kernels: build, ctypes binding and launch wrappers.

``csrc/crossmatch.cu`` holds one kernel template with three
instantiations, each the Hopper counterpart of a Pallas TPU kernel of
the JAX reference (``repro/kernels/crossmatch/kernel.py``):

  crossmatch_kernel         <- crossmatch_pallas        (:89)
  crossmatch_fused_kernel   <- crossmatch_fused_pallas  (:248)
  crossmatch_shared_kernel  <- crossmatch_shared_pallas (:206)

Inputs are what the Pallas kernels take: (N, COORD_PAD) bucket and
(M, COORD_PAD) probe rows, already padded and marked by ``ops``.  A
wrapper given CPU tensors runs the plain PyTorch version from ``ref``;
given CUDA tensors it launches the kernel on the current stream, or
raises.  ``LAUNCHES`` counts kernel launches, one per launch, per kernel.

The source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface, in ``build/kernels/`` of the checkout (or
``$REPRO_TORCH_BUILD_DIR``), named by the hash of the source and flags so
an edited source rebuilds.  Nothing is built when this module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

from .ref import crossmatch_fused_ref, crossmatch_ref, crossmatch_shared_ref

__all__ = [
    "COORD_PAD",
    "PAD_SEG",
    "LAUNCHES",
    "reset_launches",
    "build",
    "build_info",
    "crossmatch_kernel",
    "crossmatch_fused_kernel",
    "crossmatch_shared_kernel",
]

COORD_PAD = 8  # zero-padded coordinate dimension
PAD_SEG = float(2**20)  # segment id of padded rows (sorts last, matches none)

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "csrc" / "crossmatch.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {"crossmatch": 0, "crossmatch_fused": 0, "crossmatch_shared": 0}
_count_lock = threading.Lock()
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_info: dict = {}


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[4] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> ctypes.CDLL:
    """Compile (if the source's hash is new) and load the kernel library."""
    global _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(
            SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        lib_path = out_dir / f"libcrossmatch_{digest}.so"
        t0 = time.perf_counter()
        compiled = False
        log = ""
        if not lib_path.exists():
            tmp = out_dir / f".{lib_path.name}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, lib_path)
            (out_dir / f"libcrossmatch_{digest}.log").write_text(log)
            compiled = True
        lib = ctypes.CDLL(str(lib_path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.crossmatch_launch.argtypes = [p, p, i, i, f, i, i, i, p, p, p, p]
        lib.crossmatch_fused_launch.argtypes = [p, p, p, p, i, i, f, p, p, p, p]
        lib.crossmatch_shared_launch.argtypes = [p, p, p, p, p, i, i, p, p, p, p]
        for fn in ("crossmatch_launch", "crossmatch_fused_launch",
                   "crossmatch_shared_launch"):
            getattr(lib, fn).restype = ctypes.c_int
        lib.crossmatch_error_string.argtypes = [ctypes.c_int]
        lib.crossmatch_error_string.restype = ctypes.c_char_p
        _build_info.update(
            path=str(lib_path), compiled=compiled,
            seconds=time.perf_counter() - t0, log=log,
        )
        _lib = lib
        return lib


def build_info() -> dict:
    """Library path, whether this process compiled it, the build's wall
    seconds and nvcc's output (ptxas register/shared-memory report)."""
    return dict(_build_info)


def _check_launch(lib: ctypes.CDLL, code: int, name: str) -> None:
    if code != 0:
        msg = lib.crossmatch_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


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


def crossmatch_kernel(
    bucket: torch.Tensor,  # (N, COORD_PAD) f32, N % bn == 0
    probes: torch.Tensor,  # (M, COORD_PAD) f32, M % bm == 0
    cos_thr: float,
    bm: int = 128,
    bn: int = 512,
    band: Optional[int] = None,
):
    """Single-bucket join (K1).  Returns (best_idx i32, best_dot f32,
    n_cand i32), each (M,).  ``bm``/``bn`` shape the band's tile grid."""
    dev = _device_of(bucket)
    m, n = probes.shape[0], bucket.shape[0]
    if m % bm or n % bn:
        raise ValueError(f"shapes ({m}, {n}) must be multiples of ({bm}, {bn})")
    if band is not None and band < 0:
        raise ValueError(f"band must be >= 0, got {band}")
    if dev.type == "cpu":
        return crossmatch_ref(bucket, probes, cos_thr, band=band, bm=bm, bn=bn)
    _check_rows(bucket, "bucket", dev)
    _check_rows(probes, "probes", dev)
    lib = build()
    idx, dot, cnt = _outputs(m, dev)
    with torch.cuda.device(dev):
        code = lib.crossmatch_launch(
            bucket.data_ptr(), probes.data_ptr(), n, m, float(cos_thr),
            -1 if band is None else int(band), bm, bn,
            idx.data_ptr(), dot.data_ptr(), cnt.data_ptr(), _stream(),
        )
    _check_launch(lib, code, "crossmatch")
    _count("crossmatch")
    return idx, dot, cnt


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
    m, n = probes.shape[0], bucket.shape[0]
    _check_rows(bucket, "bucket", dev)
    _check_rows(probes, "probes", dev)
    _check_vec(bucket_seg, "bucket_seg", n, dev)
    _check_vec(probe_seg, "probe_seg", m, dev)
    lib = build()
    idx, dot, cnt = _outputs(m, dev)
    with torch.cuda.device(dev):
        code = lib.crossmatch_fused_launch(
            bucket.data_ptr(), probes.data_ptr(), bucket_seg.data_ptr(),
            probe_seg.data_ptr(), n, m, float(cos_thr),
            idx.data_ptr(), dot.data_ptr(), cnt.data_ptr(), _stream(),
        )
    _check_launch(lib, code, "crossmatch_fused")
    _count("crossmatch_fused")
    return idx, dot, cnt


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
    m, n = probes.shape[0], bucket.shape[0]
    _check_rows(bucket, "bucket", dev)
    _check_rows(probes, "probes", dev)
    _check_vec(bucket_seg, "bucket_seg", n, dev)
    _check_vec(probe_seg, "probe_seg", m, dev)
    _check_vec(probe_thr, "probe_thr", m, dev)
    lib = build()
    idx, dot, cnt = _outputs(m, dev)
    with torch.cuda.device(dev):
        code = lib.crossmatch_shared_launch(
            bucket.data_ptr(), probes.data_ptr(), bucket_seg.data_ptr(),
            probe_seg.data_ptr(), probe_thr.data_ptr(), n, m,
            idx.data_ptr(), dot.data_ptr(), cnt.data_ptr(), _stream(),
        )
    _check_launch(lib, code, "crossmatch_shared")
    _count("crossmatch_shared")
    return idx, dot, cnt
