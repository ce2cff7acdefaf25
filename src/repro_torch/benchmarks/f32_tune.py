"""K5's float32 kernels on the card, and variants of their source.

Builds copies of ``csrc/grouped_matmul.cu`` with one change each
(``VARIANTS``) beside the source as it stands, holds every variant's
forward, dX and dW to the element-load kernels (``gmm_f32``,
``gmm_dw_f32``, taken on misaligned copies of the same inputs) bit for
bit, and prints each call's kernel time from one torch.profiler trace
(the kernel's own duration, without the wrapper's host time) beside the
CUDA-event median of one call (with it), ``torch.bmm``'s and the
element-load kernels', with the card's name and power limit.  The shapes
are ``chip_smoke.py``'s: (b) kernel_bench's T = 4096, d = f = 1024 over
groups of 512, 1024, 512 and 2048 rows (forward, dX and dW), (e) moonshot's
decode call (8 tokens top-6 over 64 experts of 256 rows, d = 2048, f =
1408), (t) the f32 cut's call (32 tokens; forward, dX and dW) and (r)
the ragged dW (4 experts of 256 rows, d = 192, f = 160).  Needs a card:

    PYTHONPATH=src python -m repro_torch.benchmarks.f32_tune
"""
from __future__ import annotations

import argparse
import pathlib
from concurrent.futures import ThreadPoolExecutor

import torch

from ..kernels.grouped_matmul import kernel as GK
from ..kernels.grouped_matmul.ops import tile_groups
from ..models.moe import EXPERT_BT, expert_tiles
from .common import (
    device_record, misaligned, profiled_runs, same_bits, time_call,
)

__all__ = ["VARIANTS", "main"]

# name: [(the source's text, its replacement), ...].
VARIANTS = {
    "forward, no narrow blocks": [("const bool narrow = rows <= 8;",
                                   "const bool narrow = false;")],
    "3 forward stages": [("constexpr int kF32Stages = 4;",
                          "constexpr int kF32Stages = 3;")],
    "dW one f-tile a block": [("constexpr int kDwF32MaxFTiles = 8;",
                               "constexpr int kDwF32MaxFTiles = 1;")],
    "dW 4 f-tiles a block at most": [("constexpr int kDwF32MaxFTiles = 8;",
                                      "constexpr int kDwF32MaxFTiles = 4;")],
}
REPS = 20
TRACED = 10  # launches of each call in the trace


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
    return {
        "(b) forward": (
            lambda: GK.grouped_matmul_kernel(x, gid, w, EXPERT_BT),
            lambda: GK.grouped_matmul_kernel(xm, gid, w, EXPERT_BT),
            lambda: torch.bmm(tiles, wg)),
        "(b) dX": (
            lambda: GK._k5(dy, gid, w, EXPERT_BT, None, "grouped_matmul_dx",
                           w_transposed=True),
            lambda: GK._k5(dym, gid, w, EXPERT_BT, None, "grouped_matmul_dx",
                           w_transposed=True),
            lambda: torch.bmm(dtiles, wg.transpose(1, 2))),
        "(b) dW": (
            lambda: GK.grouped_matmul_dw_kernel(x, dy, gid, 4, EXPERT_BT),
            lambda: GK.grouped_matmul_dw_kernel(xm, dym, gid, 4, EXPERT_BT),
            None),
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
    out = {f"({key}) forward": (
        lambda: GK.grouped_matmul_kernel(x, gid, w, EXPERT_BT, rows),
        lambda: GK.grouped_matmul_kernel(xm, gid, w, EXPERT_BT, rows),
        lambda: torch.bmm(x.view(E, C, d), w))}
    if key == "t":
        out["(t) dX"] = (
            lambda: GK._k5(dy, gid, w, EXPERT_BT, rows, "grouped_matmul_dx",
                           w_transposed=True),
            lambda: GK._k5(dym, gid, w, EXPERT_BT, rows, "grouped_matmul_dx",
                           w_transposed=True),
            lambda: torch.bmm(dy.view(E, C, f), w.transpose(1, 2)))
        out["(t) dW"] = (
            lambda: GK.grouped_matmul_dw_kernel(x, dy, gid, E, EXPERT_BT,
                                                rows),
            lambda: GK.grouped_matmul_dw_kernel(xm, dym, gid, E, EXPERT_BT,
                                                rows),
            lambda: torch.bmm(x.view(E, C, d).transpose(1, 2),
                              dy.view(E, C, f)))
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
    return {"(r) dW": (
        lambda: GK.grouped_matmul_dw_kernel(x, dy, gid, 4, EXPERT_BT, rows),
        lambda: GK.grouped_matmul_dw_kernel(xm, dym, gid, 4, EXPERT_BT, rows),
        lambda: torch.bmm(x.view(4, 256, 192).transpose(1, 2),
                          dy.view(4, 256, 160)))}


def cases(dev) -> dict:
    """name: (K5 on the TMA path, the same on the element-load path, one
    PyTorch call of the same function or None)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(64, 2048, 1408, device=dev, generator=gen) * 2048 ** -0.5
    return {**dense_cases(gen, dev), **routed_cases("e", 8, w, gen, dev),
            **routed_cases("t", 32, w, gen, dev), **ragged_case(gen, dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build-dir", default="build/f32_tune")
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
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.load) for lib in libs.values()]:
            fut.result()
    print(device_record(dev), flush=True)

    def on(lib, fn):
        def call():
            GK.LIBRARY = lib
            return fn()
        return call

    fns, rows = [], []
    try:
        for name, (tma, elem, library) in cases(dev).items():
            GK.LIBRARY = main_lib
            want = elem()
            for tag, lib in libs.items():
                GK.LIBRARY = lib
                if not same_bits(tma(), want):
                    raise SystemExit(f"{name}, {tag}: the TMA path's bits "
                                     f"differ from the element-load path's")
                fns.append(on(lib, tma))
                rows.append((name, tag, time_call(
                    tma, device="cuda", reps=REPS, warmup=1).device_us / 1e3))
            GK.LIBRARY = main_lib
            fns.append(on(main_lib, elem))
            rows.append((name, "element-load", time_call(
                elem, device="cuda", reps=REPS, warmup=1).device_us / 1e3))
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
