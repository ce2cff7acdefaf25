"""Sweep of the TMA dW kernel's schedule on the card.

Builds copies of ``csrc/grouped_matmul.cu`` with ``kDwFTiles`` (the
f-tiles of 256 columns a block walks in turn) and ``kDwStages`` (the
ring's depth) rewritten, holds each variant's dW to the plain version at
moonshot's training call (64 experts of C = 512 rows, 4,096 tokens routed
top-6 by ``moe.expert_tiles``, bf16, noise past each tile's count), and
prints each one's CUDA-event median beside ``torch.bmm``'s on the same
operands (zero past the counts) and the build as it stands, with the
card's name and power limit.  Needs a card:

    PYTHONPATH=src python -m repro_torch.benchmarks.dw_tune
"""
from __future__ import annotations

import argparse
import pathlib
from concurrent.futures import ThreadPoolExecutor

import torch

from ..kernels.grouped_matmul import kernel as GK
from ..kernels.grouped_matmul.ref import grouped_matmul_dw_ref
from ..kernels.nvcc import CudaLibrary
from ..models.moe import EXPERT_BT, expert_tiles
from .common import device_record, time_call

__all__ = ["VARIANTS", "main"]

# (f-tiles a block walks, ring stages) beside the source as it stands (6,
# 3).  Four stages of 48 KB and the 64 KB epilogue tile overrun the SM's
# 227 KB of shared memory, so the ring is 2 or 3 deep.
VARIANTS = [(1, 3), (2, 3), (3, 3), (3, 2), (6, 2)]
SHAPES = [(2048, 1408), (1408, 2048)]  # (d, f): gate/up, down
E, C, TOKENS, TOP_K = 64, 512, 4096, 6
REPS = 20
TOL = 1e-2  # of the largest value: one bf16 rounding of an f32 sum


def variant_library(ftiles: int, stages: int, root: pathlib.Path
                    ) -> CudaLibrary:
    """A ``CudaLibrary`` of the source with the two constants set."""
    text = GK.LIBRARY.source.read_text()
    edits = []
    for name, value in (("kDwFTiles", ftiles), ("kDwStages", stages)):
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(f"constexpr int {name} = ")]
        if len(lines) != 1:
            raise SystemExit(f"{name}: not set once in the source")
        edits.append((lines[0].split(";")[0],
                      f"constexpr int {name} = {value}"))
    return GK.LIBRARY.variant(
        edits, root / f"f{ftiles}_s{stages}" / "grouped_matmul.cu")


def median_ms(fn) -> float:
    """The CUDA-event median of ``fn`` over ``REPS`` calls, in ms."""
    return time_call(fn, device="cuda", reps=REPS, warmup=1).device_us / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build-dir", default="build/dw_tune")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dw_tune needs a CUDA card")
    dev = torch.device("cuda")
    root = pathlib.Path(args.build_dir)
    libs = {v: variant_library(*v, root) for v in VARIANTS}
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        for fut in [pool.submit(lib.load) for lib in libs.values()] + [
                pool.submit(GK.build)]:
            fut.result()
    gen = torch.Generator(device=dev).manual_seed(0)
    top = torch.rand(TOKENS, E, device=dev, generator=gen).argsort(
        dim=1)[:, :TOP_K]
    gid, rows = expert_tiles(top, E, C, EXPERT_BT)
    real = (torch.arange(EXPERT_BT, device=dev) < rows[:, None]).reshape(-1)
    T = E * C
    print(f"{device_record(dev)}; {int(rows.sum())} real rows of {T}, "
          f"{E} experts of {C}", flush=True)
    main_lib = GK.LIBRARY
    try:
        for d, f in SHAPES:
            x = torch.randn(T, d, device=dev, generator=gen).to(torch.bfloat16)
            dy = torch.randn(T, f, device=dev, generator=gen).to(
                torch.bfloat16)
            x0 = x.masked_fill(~real[:, None], 0)
            dy0 = dy.masked_fill(~real[:, None], 0)
            want = grouped_matmul_dw_ref(x, dy, gid, E, EXPERT_BT,
                                         rows).float()
            scale = float(want.abs().max())
            flops = 2.0 * int(rows.sum()) * d * f

            def bmm():
                return torch.bmm(x0.view(E, C, d).transpose(1, 2),
                                 dy0.view(E, C, f))

            def dw():
                return GK.grouped_matmul_dw_kernel(x, dy, gid, E, EXPERT_BT,
                                                   rows)

            bmm_ms = [median_ms(bmm)]
            for (ft, st), lib in [((None, None), main_lib),
                                  *libs.items()]:
                GK.LIBRARY = lib
                err = float((dw().float() - want).abs().max())
                ms = median_ms(dw)
                ok = err <= TOL * scale
                tag = "as built" if ft is None else f"kDwFTiles={ft} " \
                                                    f"kDwStages={st}"
                print(f"d={d} f={f} {tag}: {ms:.4f} ms "
                      f"({flops / ms / 1e9:.1f} TFLOP/s), max |diff| "
                      f"{err:.3e} of {scale:.3e} ({'ok' if ok else 'WRONG'})",
                      flush=True)
            GK.LIBRARY = main_lib
            bmm_ms.append(median_ms(bmm))
            print(f"d={d} f={f} torch.bmm: {bmm_ms[0]:.4f} ms before, "
                  f"{bmm_ms[1]:.4f} ms after", flush=True)
    finally:
        GK.LIBRARY = main_lib
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
