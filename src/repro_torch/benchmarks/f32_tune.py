"""K5's float32 kernels on the card, and variants of their source.

Builds copies of ``csrc/grouped_matmul.cu`` with one change each
(``VARIANTS``) beside the source as it stands, and runs each call two
ways on every build: on the TMA kernels (``gmm_f32_tma``,
``gmm_dw_f32_tma``) and on the async ones (``gmm_f32_async``,
``gmm_dw_f32_async``, taken on copies of the same inputs 4 bytes past 16:
x and dy in 4-byte copies).  Every variant's forward, dX and dW, both
ways, must equal the build's async kernels bit for bit.  Each call's
kernel time from one torch.profiler trace (the kernel's own duration,
without the wrapper's host time) is printed beside the CUDA-event median
of one call (with it) and ``torch.bmm``'s, with the card's name and power
limit.  ``--against PATH`` also times an earlier ``grouped_matmul.cu``
whose float32 path TMA cannot describe ran the element-load kernels
(``gmm_f32``, ``gmm_dw_f32``) on the same misaligned inputs, held to the
same bits; its dX takes a contiguous copy of w^T, timed with the copy
and without.  The shapes are ``chip_smoke.py``'s: (b) kernel_bench's T =
4096, d = f = 1024 over groups of 512, 1024, 512 and 2048 rows (forward,
dX and dW), (e) moonshot's decode call (8 tokens top-6 over 64 experts of
256 rows, d = 2048, f = 1408), (t) the f32 cut's call (32 tokens;
forward, dX and dW) and (r) the ragged dW (4 experts of 256 rows, d =
192, f = 160).  Needs a card:

    git show <commit>:src/repro_torch/csrc/grouped_matmul.cu > build/OLD_gmm.cu
    PYTHONPATH=src python -m repro_torch.benchmarks.f32_tune \\
        --against build/OLD_gmm.cu
"""
from __future__ import annotations

import argparse
import pathlib
from concurrent.futures import ThreadPoolExecutor

import torch

from ..kernels.grouped_matmul import kernel as GK
from ..kernels.grouped_matmul.ops import tile_groups
from ..models.moe import EXPERT_BT, expert_tiles
from .async_tune import earlier_library, ptxas_lines
from .common import (
    device_record, misaligned, profiled_runs, same_bits, time_call,
)

__all__ = ["VARIANTS", "main"]

# name: [(the source's text, its replacement), ...].  The last four
# change the async kernels' producers: a forward producer of 2 warps (the
# bf16 async instances' setmaxnreg off with it, as the source's check
# asks), the forward handing registers to its consumers (setmaxnreg 96 /
# 200, as the bf16 async instances), a dW producer of 4 warps, and every
# copy through the zero fill's predicate and selects (``copy_rows``
# without its path for boxes wholly inside the matrix).
VARIANTS = {
    "forward, no narrow blocks": [("const bool narrow = rows <= 8;",
                                   "const bool narrow = false;")],
    "3 forward stages": [("constexpr int kF32Stages = 4;",
                          "constexpr int kF32Stages = 3;")],
    "dW one f-tile a block": [("constexpr int kDwF32MaxFTiles = 8;",
                               "constexpr int kDwF32MaxFTiles = 1;")],
    "dW 4 f-tiles a block at most": [("constexpr int kDwF32MaxFTiles = 8;",
                                      "constexpr int kDwF32MaxFTiles = 4;")],
    "forward producer 2 warps": [
        ("constexpr int kAsyncProducerWarps = 4;",
         "constexpr int kAsyncProducerWarps = 2;"),
        ("constexpr int kProducerRegs = 96;",
         "constexpr int kProducerRegs = 0;"),
        ("constexpr int kConsumerRegs = 200;",
         "constexpr int kConsumerRegs = 0;")],
    "forward setmaxnreg": [
        ("    loads.template load<kWKMajor>(tile, tid - kF32Warps * 32);",
         "    if constexpr (Loads::kAsync) set_max_regs<true>();\n"
         "    loads.template load<kWKMajor>(tile, tid - kF32Warps * 32);"),
        ("  if (warp >= nwarps) {\n    fill(row0 + 8 * warp",
         "  if constexpr (Loads::kAsync) set_max_regs<false>();\n"
         "  if (warp >= nwarps) {\n    fill(row0 + 8 * warp")],
    "dW producer 4 warps": [("constexpr int kDwF32AsyncProducers = 64;",
                             "constexpr int kDwF32AsyncProducers = 128;")],
    "every copy predicated": [
        ("    if ((kCopies - 1) * kRowStep < rows) {", "    if (false) {"),
        ("    if (all) {", "    if (false) {")],
}
REPS = 20
TRACED = 10  # launches of each call in the trace


def _dx(dy, gid, w, rows=None):
    """K5's dX on w as it is (read K-major)."""
    return lambda: GK._k5(dy, gid, w, EXPERT_BT, rows, "grouped_matmul_dx",
                          w_transposed=True)


def _earlier_dx(dy, gid, w, rows=None) -> dict:
    """The earlier source's f32 dX off TMA: K5 on a contiguous copy of
    w^T, made in the call and made once beforehand."""
    wt = w.transpose(1, 2).contiguous()
    return {
        "earlier + w^T copy": lambda: GK._k5(
            dy, gid, w.transpose(1, 2).contiguous(), EXPERT_BT, rows,
            "grouped_matmul_dx"),
        "earlier": lambda: GK._k5(dy, gid, wt, EXPERT_BT, rows,
                                  "grouped_matmul_dx"),
    }


def dense_cases(gen, dev) -> dict:
    """(b): kernel_bench's shape, forward, dX and dW."""
    T, d, f, sizes = 4096, 1024, 1024, [512, 1024, 512, 2048]
    x = torch.randn(T, d, device=dev, generator=gen)
    dy = torch.randn(T, f, device=dev, generator=gen)
    w = torch.randn(4, d, f, device=dev, generator=gen) * 0.02
    gid = tile_groups(torch.tensor(sizes, device=dev), T, EXPERT_BT, 4)
    xm, dym = misaligned(x), misaligned(dy)
    tiles, wg = x.view(T // EXPERT_BT, EXPERT_BT, d), w[gid.long()]
    dtiles = dy.view(T // EXPERT_BT, EXPERT_BT, f)
    fwd = (lambda a: lambda: GK.grouped_matmul_kernel(a, gid, w, EXPERT_BT))
    dwk = (lambda a, b: lambda: GK.grouped_matmul_dw_kernel(a, b, gid, 4,
                                                            EXPERT_BT))
    return {
        "(b) forward": (fwd(x), fwd(xm), lambda: torch.bmm(tiles, wg),
                        {"earlier": fwd(xm)}),
        "(b) dX": (_dx(dy, gid, w), _dx(dym, gid, w),
                   lambda: torch.bmm(dtiles, wg.transpose(1, 2)),
                   _earlier_dx(dym, gid, w)),
        "(b) dW": (dwk(x, dy), dwk(xm, dym), None,
                   {"earlier": dwk(xm, dym)}),
    }


def routed_cases(key, tokens, w, gen, dev) -> dict:
    """(e) / (t): ``tokens`` tokens routed top-6 over moonshot's 64 experts
    of 256 rows, x and dy zero past the counts; (t) with dX and dW."""
    E, C = w.shape[0], 256
    d, f = w.shape[1], w.shape[2]
    top = torch.rand(tokens, E, device=dev, generator=gen).argsort(
        dim=1)[:, :6]
    gid, rows = expert_tiles(top, E, C, EXPERT_BT)
    real = (torch.arange(EXPERT_BT, device=dev)
            < rows[:, None]).reshape(E * C, 1)
    x = torch.randn(E * C, d, device=dev, generator=gen) * real
    dy = torch.randn(E * C, f, device=dev, generator=gen) * real
    xm, dym = misaligned(x), misaligned(dy)
    fwd = (lambda a: lambda: GK.grouped_matmul_kernel(a, gid, w, EXPERT_BT,
                                                      rows))
    dwk = (lambda a, b: lambda: GK.grouped_matmul_dw_kernel(
        a, b, gid, E, EXPERT_BT, rows))
    out = {f"({key}) forward": (
        fwd(x), fwd(xm), lambda: torch.bmm(x.view(E, C, d), w),
        {"earlier": fwd(xm)})}
    if key == "t":
        out["(t) dX"] = (
            _dx(dy, gid, w, rows), _dx(dym, gid, w, rows),
            lambda: torch.bmm(dy.view(E, C, f), w.transpose(1, 2)),
            _earlier_dx(dym, gid, w, rows))
        out["(t) dW"] = (
            dwk(x, dy), dwk(xm, dym),
            lambda: torch.bmm(x.view(E, C, d).transpose(1, 2),
                              dy.view(E, C, f)),
            {"earlier": dwk(xm, dym)})
    return out


def ragged_case(gen, dev) -> dict:
    """(r): 4 experts of 256 rows, one empty, a partly filled tile."""
    gid = torch.arange(8, dtype=torch.int32, device=dev) // 2
    rows = torch.tensor([128, 128, 0, 0, 128, 77, 5, 0], dtype=torch.int32,
                        device=dev)
    real = (torch.arange(EXPERT_BT, device=dev)
            < rows[:, None]).reshape(-1, 1)
    x = torch.randn(1024, 192, device=dev, generator=gen) * real
    dy = torch.randn(1024, 160, device=dev, generator=gen) * real
    xm, dym = misaligned(x), misaligned(dy)
    dwk = (lambda a, b: lambda: GK.grouped_matmul_dw_kernel(
        a, b, gid, 4, EXPERT_BT, rows))
    return {"(r) dW": (
        dwk(x, dy), dwk(xm, dym),
        lambda: torch.bmm(x.view(4, 256, 192).transpose(1, 2),
                          dy.view(4, 256, 160)),
        {"earlier": dwk(xm, dym)})}


def cases(dev) -> dict:
    """name: (K5 on the TMA path, the same on the async path, one PyTorch
    call of the same function or None, the earlier source's calls by name
    on the async path's inputs: its element-load kernels)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(64, 2048, 1408, device=dev, generator=gen) * 2048 ** -0.5
    return {**dense_cases(gen, dev), **routed_cases("e", 8, w, gen, dev),
            **routed_cases("t", 32, w, gen, dev), **ragged_case(gen, dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build-dir", default="build/f32_tune")
    ap.add_argument("--against", default=None,
                    help="an earlier grouped_matmul.cu with the f32 "
                         "element-load kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("f32_tune needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    root = pathlib.Path(args.build_dir)
    main_lib = GK.LIBRARY
    libs = {"as built": main_lib,
            **{name: main_lib.variant(edits, root / name.replace(" ", "_")
                                      .replace(",", "") / "grouped_matmul.cu")
               for name, edits in VARIANTS.items()}}
    earlier = (earlier_library(args.against, root, GK._bind) if args.against
               else None)
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        for fut in [pool.submit(lib.load) for lib in
                    [*libs.values(), *([earlier] if earlier else [])]]:
            fut.result()
    for name, lib in libs.items():
        for line in ptxas_lines(lib.info()["log"], "f32"):
            print(f"[ptxas {name}] {line}")
    print(device_record(dev), flush=True)

    def on(lib, fn):
        def call():
            GK.LIBRARY = lib
            return fn()
        return call

    fns, rows = [], []
    try:
        for name, (tma, asy, library, olds) in cases(dev).items():
            GK.LIBRARY = main_lib
            want = asy()
            for tag, lib in libs.items():
                for kind, fn in (("TMA", tma), ("async", asy)):
                    GK.LIBRARY = lib
                    if not same_bits(fn(), want):
                        raise SystemExit(f"{name}, {tag}: the {kind} "
                                         f"kernel's bits differ from the "
                                         f"build's async kernel's")
                    fns.append(on(lib, fn))
                    rows.append((name, f"{tag}, {kind}", time_call(
                        fn, device="cuda", reps=REPS,
                        warmup=1).device_us / 1e3))
            olds = {"earlier, TMA": tma, **olds} if earlier else {}
            for tag, fn in olds.items():
                GK.LIBRARY = earlier
                if not same_bits(fn(), want):
                    raise SystemExit(f"{name}, {tag}: the earlier kernel's "
                                     f"bits differ from the async kernel's")
                fns.append(on(earlier, fn))
                rows.append((name, tag, time_call(
                    fn, device="cuda", reps=REPS, warmup=1).device_us / 1e3))
            GK.LIBRARY = main_lib
            if library is not None:
                lib_ms = time_call(library, device="cuda", reps=REPS,
                                   warmup=1).device_us / 1e3
                print(f"{name}: torch.bmm one call {lib_ms:.4f} ms",
                      flush=True)
        traced = [ms for ms, _ in profiled_runs(fns, "gmm_", TRACED)]
    finally:
        GK.LIBRARY = main_lib
    for (name, tag, one_ms), ms in zip(rows, traced):
        kernel = "not measured" if ms is None else f"{ms:.4f} ms"
        print(f"{name}, {tag}: kernel {kernel}, one call {one_ms:.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
