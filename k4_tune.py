"""Tuning measurements of the paged decode-attention kernel (K4) on one card.

Not part of the smoke run; run it when K4's chunk or its wrapper changes:

    python3 k4_tune.py
    python3 k4_tune.py --against OTHER.cu  # only section 3

1. chunk  -- K4's device time (``chip_smoke.many_ms``: 20 launches between
             one pair of CUDA events, over 20) at chip_smoke.py's phase-5
             shapes (b), (c) and (e), with ``kernel.CHUNK`` set to each of
             128, 256, 512 and 1024 slots in turn; each variant is first
             held to the plain version with phase 5's check.
2. host   -- host µs a call at shape (a), each part alone over 2,000
             calls: the whole wrapper call, the parts it still does, the
             parts it no longer does (a ``torch.cuda.device`` context, the
             public ``current_stream``, the library's lock) and the two
             table builds ``attn_decode`` no longer makes a layer.
3. source -- with ``--against OTHER.cu`` (an earlier
             ``csrc/paged_attention.cu``, e.g. ``git show
             <commit>:src/repro_torch/csrc/paged_attention.cu``): the
             normal decode call (no partials) built from OTHER and from
             this tree's source, at every phase-5 shape (a)-(h): the
             outputs bit-compared, and each kernel's own duration in one
             ``torch.profiler`` trace (``chip_smoke.profiled_runs``) and
             its 20-launch CUDA-event time, in turns other, this, this,
             other.  OTHER must take the same packed arguments (a source
             from before the partials reads 20 of the 22 int64 this
             wrapper packs and ignores the last two, their pointers).

Exits 2 without a CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

import torch

import chip_smoke as smoke
from chip_smoke import PK, paged_attention_ref

CHUNKS = (128, 256, 512, 1024)
SWEEP_SHAPES = ("b", "c", "e")
HOST_REPS = 2000


def sweep_chunks(dev) -> None:
    default = PK.CHUNK
    try:
        for key in SWEEP_SHAPES:
            args = smoke.paged_inputs(*smoke.PAGED_SHAPES[key], dev,
                                      seed=20 + ord(key))
            want = paged_attention_ref(*args)
            times = {}
            for chunk in CHUNKS:
                PK.CHUNK = chunk
                smoke.check_paged(f"K4 ({key}) chunk {chunk}",
                                  PK.paged_attention_kernel(*args), want)
                times[chunk] = smoke.many_ms(
                    lambda: PK.paged_attention_kernel(*args))
            print(f"[chunk] ({key}) ms over {smoke.MANY} launches: " + ", ".join(
                f"{c} {t:.4f}" for c, t in times.items()), flush=True)
    finally:
        PK.CHUNK = default


def host_costs(dev) -> None:
    args = smoke.paged_inputs(*smoke.PAGED_SHAPES["a"], dev, seed=20 + ord("a"))
    q, kp, vp, table, _ = args
    B, P = table.shape

    def per_call_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / HOST_REPS * 1e6

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    kept = {
        "whole call": lambda: PK.paged_attention_kernel(*args),
        "checks": lambda: PK._check(*args),
        "kernel_path": lambda: PK.kernel_path(q, kp, vp),
        "empty_like": lambda: torch.empty_like(q),
        "current_device": torch.cuda.current_device,
    }
    if PK._raw_stream is not None:
        kept["raw stream handle"] = lambda: PK._raw_stream(dev.index)
    dropped = {
        "torch.cuda.device context": device_ctx,
        "public current_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "library lock": PK.LIBRARY.load,
        "identity table (arange)": lambda: torch.arange(
            B * P, dtype=torch.int32, device=dev).view(B, P),
        "seq_lens (full)": lambda: torch.full((B,), 16, dtype=torch.int32,
                                              device=dev),
    }
    for name, parts in (("kept", kept), ("dropped", dropped)):
        print(f"[host] ({name}) µs a call at (a): " + ", ".join(
            f"{k} {per_call_us(fn):.3f}" for k, fn in parts.items()),
            flush=True)


def against(other: str, dev) -> None:
    from repro_torch.kernels.nvcc import CudaLibrary

    libs = {"this": PK.LIBRARY, "other": CudaLibrary("paged_attention",
                                                    PK._bind)}
    libs["other"].source = pathlib.Path(other).resolve()
    launch = {k: lib.load().paged_attention_launch for k, lib in libs.items()}
    order = ("other", "this", "this", "other")
    fns, event = {}, {}
    for key, shape in smoke.PAGED_SHAPES.items():
        args = smoke.paged_inputs(*shape, dev, seed=20 + ord(key))
        if key in smoke.PAGED_FULL:
            args[4].fill_(shape[6])

        def call(which, args=args):
            PK._launch = launch[which]
            return PK.paged_attention_kernel(*args)

        if not torch.equal(call("this").view(torch.uint8),
                           call("other").view(torch.uint8)):
            raise SystemExit(f"K4 ({key}): this source's output differs "
                             f"from {other}'s")
        fns[key] = [lambda w=w, c=call: c(w) for w in order]
        event[key] = [smoke.many_ms(fn) for fn in fns[key]]
    # one profiler session (each makes the later ones lose device events)
    prof = smoke.profiled_runs([f for key in fns for f in fns[key]],
                               "paged_attention")
    for i, key in enumerate(fns):
        mine = prof[4 * i:4 * i + 4]
        print(f"[source] ({key}) outputs bit-equal; profiled ms "
              + ", ".join(f"{w} {smoke.fmt_ms(ms)}"
                          for w, (ms, _) in zip(order, mine))
              + f"; {smoke.MANY}-launch ms "
              + ", ".join(f"{w} {ms:.4f}" for w, ms in zip(order, event[key])),
              flush=True)
    PK._launch = launch["this"]


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_tune: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    PK.build()
    if sys.argv[1:2] == ["--against"]:
        against(sys.argv[2], dev)
        return 0
    sweep_chunks(dev)
    host_costs(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
