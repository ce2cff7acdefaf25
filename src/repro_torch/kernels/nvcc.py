"""Build a CUDA source of ``csrc/`` with nvcc and load it with ctypes.

Every kernel module of the port binds its source the same way: ``nvcc``
compiles it for sm_90a into a shared library with a plain C interface, in
``build/kernels/`` of the checkout (or ``$REPRO_TORCH_BUILD_DIR``), named by
the hash of the source and the flags so an edited source rebuilds; ctypes
loads it.  Nothing is built when a module is imported: ``CudaLibrary.load``
builds at first use.  Each source exports ``<name>_error_string(int)`` for
the codes its launch entries return (``cudaGetLastError()``).
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
from typing import Callable, Optional

__all__ = ["CSRC", "NVCC_FLAGS", "CudaLibrary"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


class CudaLibrary:
    """One ``csrc/<name>.cu``, compiled at first use and loaded once.

    ``bind(lib)`` declares the ``argtypes``/``restype`` of the source's
    launch entries; ``load`` is safe to call from several threads, and two
    libraries build concurrently (nvcc runs outside the interpreter lock).
    ``loads`` counts the times this object built or loaded its library
    (once a process, unless a caller resets ``_lib``)."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._info: dict = {}
        self.loads = 0

    def load(self) -> ctypes.CDLL:
        """Compile (if the source's hash is new) and load the library."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            digest = hashlib.sha256(
                self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
            ).hexdigest()[:16]
            out_dir = _build_dir()
            out_dir.mkdir(parents=True, exist_ok=True)
            lib_path = out_dir / f"lib{self.name}_{digest}.so"
            t0 = time.perf_counter()
            compiled = False
            log = ""
            if not lib_path.exists():
                # Unique per process and thread: two libraries of one
                # source may build at once.
                tmp = out_dir / (f".{lib_path.name}.{os.getpid()}."
                                 f"{threading.get_ident()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
                os.replace(tmp, lib_path)
                (out_dir / f"lib{self.name}_{digest}.log").write_text(log)
                compiled = True
            lib = ctypes.CDLL(str(lib_path))
            self._bind(lib)
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._info = dict(
                path=str(lib_path), compiled=compiled,
                seconds=time.perf_counter() - t0, log=log,
            )
            self._lib = lib
            self.loads += 1
            return lib

    def variant(self, edits, path) -> "CudaLibrary":
        """A library of this one's source with each ``(old, new)`` of
        ``edits`` replaced (``old`` must occur once), written to ``path``
        and built on its own: a copy with one change, for a tuning sweep."""
        text = self.source.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{old!r} is not in {self.source.name} once")
            text = text.replace(old, new)
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        lib = CudaLibrary(self.name, self._bind)
        lib.source = path
        return lib

    def info(self) -> dict:
        """Library path, whether this process compiled it, the build's wall
        seconds and nvcc's output (ptxas register/shared-memory report)."""
        return dict(self._info)

    def check(self, code: int, what: str) -> None:
        """Raise if a launch entry returned a CUDA error code."""
        if code != 0:
            msg = getattr(self._lib, f"{self.name}_error_string")(code).decode()
            raise RuntimeError(f"{what} kernel launch failed: {msg} ({code})")
