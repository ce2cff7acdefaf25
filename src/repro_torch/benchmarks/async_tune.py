"""K5's bf16 async kernels on the card, beside the earlier element-load
kernels and variants of its producer.

At the shapes TMA cannot describe -- (b elem) T = 4096, d = 1024, f =
1020 (x in 16-byte copies, w and y in 8-byte ones), (b odd) f = 1021 (w
and y at 2 bytes: 4-byte words realigned in shared memory), and dX with
an output width of 1020 (``--twins``: also (b) itself, on the TMA
kernels, and on inputs 8 bytes off, on the async ones) --
the forward, dX and dW of:

* "built": the source as it stands (``gmm_bf16_async`` /
  ``gmm_dw_bf16_async``, a warpgroup of producers, 96 registers a
  producer thread and 200 a consumer's through setmaxnreg);
* copies of the source with one change each (``VARIANTS``): a producer
  of 2 warps (320 threads, no setmaxnreg), no registers moved, 56 / 224,
  and every copy predicated (``copy_rows`` without its path for boxes
  wholly inside the matrix);
* "earlier" (``--against PATH``): an earlier ``grouped_matmul.cu`` whose
  bf16 path TMA cannot describe (now "async") ran the element-load wmma
  kernels (``gmm_bf16_elem``, ``gmm_dw_bf16``), bound by its own ctypes
  signature; its dX takes a
  contiguous copy of w^T, timed with the copy and without.

Each output is held to the plain version (5e-2 forward and dX, 1e-2 of
the largest value for dW), each variant's bits to the build's.
Times: CUDA-event medians of 20 calls in turns (built, the variants,
earlier, then the same in reverse), and each kernel's mean duration in
one ``torch.profiler`` trace of every call.  Prints the card's name and power
limit and writes the numbers to ``--out``.  Needs a card:

    git show <commit>:src/repro_torch/csrc/grouped_matmul.cu > build/OLD_gmm.cu
    PYTHONPATH=src python -m repro_torch.benchmarks.async_tune \\
        --against build/OLD_gmm.cu
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
from concurrent.futures import ThreadPoolExecutor

import torch

from ..kernels.grouped_matmul import kernel as GK
from ..kernels.grouped_matmul import ops as gmm_ops
from ..kernels.grouped_matmul.ref import (
    grouped_matmul_dw_ref, grouped_matmul_tiles_ref,
)
from ..kernels.nvcc import CudaLibrary
from .common import (
    device_record, misaligned, profiled_runs, same_bits, time_call,
)

__all__ = ["SHAPES", "VARIANTS", "main"]

T, SIZES, BT = 4096, [512, 1024, 512, 2048], 128
# (key, product, d, f, offset): the forward and dW take x (T, d), w (G, d,
# f), dy (T, f); dX takes dy (T, f) against the forward's w (G, d, f), out
# (T, d); x and dy lie `offset` bytes past 16.  (b bf16) is TMA's (the
# build's TMA kernels, the earlier source's element-load ones), and (b
# bf16 +8) the same on inputs 8 bytes off: the async twins.
SHAPES = [("b elem", "fwd", 1024, 1020, 0), ("b odd", "fwd", 1024, 1021, 0),
          ("b elem", "dw", 1024, 1020, 0), ("b odd", "dw", 1024, 1021, 0),
          ("b elem", "dx", 1024, 1020, 0), ("d1020", "dx", 1020, 1024, 0)]
TWINS = [(key, product, 1024, 1024, offset) for product in ("fwd", "dw", "dx")
         for key, offset in (("b bf16", 0), ("b bf16 +8", 8))]
REPS = 20
TOL = {"fwd": 5e-2, "dx": 5e-2, "dw": 1e-2}


def _bind_earlier(lib: ctypes.CDLL) -> None:
    """The ctypes signature of the sources before the async instances."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_matmul_launch.argtypes = [p, p, p, p, p] + [i] * 8 + [p]
    lib.grouped_matmul_launch.restype = ctypes.c_int
    lib.grouped_matmul_dw_launch.argtypes = [p, p, p, p, p] + [i] * 7 + [p]
    lib.grouped_matmul_dw_launch.restype = ctypes.c_int


# Copies of the source with one change each: a producer of 2 warps (no
# setmaxnreg then), no registers moved, 56 / 224 moved, and every copy
# through the zero fill's predicate and selects.
VARIANTS = {
    "2 warps": [("constexpr int kAsyncProducerWarps = 4;",
                 "constexpr int kAsyncProducerWarps = 2;"),
                ("constexpr int kProducerRegs = 96;",
                 "constexpr int kProducerRegs = 0;"),
                ("constexpr int kConsumerRegs = 200;",
                 "constexpr int kConsumerRegs = 0;")],
    "no setmaxnreg": [("constexpr int kProducerRegs = 96;",
                       "constexpr int kProducerRegs = 0;"),
                      ("constexpr int kConsumerRegs = 200;",
                       "constexpr int kConsumerRegs = 0;")],
    "regs 56/224": [("constexpr int kProducerRegs = 96;",
                     "constexpr int kProducerRegs = 56;"),
                    ("constexpr int kConsumerRegs = 200;",
                     "constexpr int kConsumerRegs = 224;")],
    "every copy predicated": [
        ("    if ((kCopies - 1) * kRowStep < rows) {", "    if (false) {"),
        ("    if (all) {", "    if (false) {")],
}


def variant_libraries(root: pathlib.Path) -> dict:
    return {name: GK.LIBRARY.variant(
        edits, root / name.replace(" ", "_").replace("/", "_")
        / "grouped_matmul.cu") for name, edits in VARIANTS.items()}


def earlier_library(path: str, root: pathlib.Path,
                    bind=_bind_earlier) -> CudaLibrary:
    """An earlier ``grouped_matmul.cu``, built beside the source and bound
    by ``bind`` (by default the signature before the async instances)."""
    lib = CudaLibrary("grouped_matmul", bind)
    copy = root / "earlier" / "grouped_matmul.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(pathlib.Path(path).read_text())
    lib.source = copy
    return lib


def _earlier_call(lib: CudaLibrary, product, x, w_or_dy, gid, out, d, f):
    """One launch of the earlier source's element-load kernel (tma = 0)."""
    cdll = lib.load()
    stream = torch.cuda.current_stream().cuda_stream
    if product == "dw":
        code = cdll.grouped_matmul_dw_launch(
            x.data_ptr(), w_or_dy.data_ptr(), gid.data_ptr(), None,
            out.data_ptr(), T, d, f, len(SIZES), BT, 1, 0, stream)
    else:
        code = cdll.grouped_matmul_launch(
            x.data_ptr(), gid.data_ptr(), None, w_or_dy.data_ptr(),
            out.data_ptr(), T, d, f, len(SIZES), BT, 1, 0, 0, stream)
    lib.check(code, "earlier grouped_matmul")
    return out


def case(key, product, d, f, offset, dev, gen, earlier):
    """(the build's fn, the earlier source's fns by name -- none without
    ``earlier``, its library -- and the plain result)."""
    G = len(SIZES)
    gid = gmm_ops.tile_groups(torch.tensor(SIZES, device=dev), T, BT, G)
    w = (torch.randn(G, d, f, device=dev, generator=gen) * 0.02).to(
        torch.bfloat16)
    x = torch.randn(T, d, device=dev, generator=gen).to(torch.bfloat16)
    dy = torch.randn(T, f, device=dev, generator=gen).to(torch.bfloat16)
    if offset:
        x, dy = misaligned(x, offset), misaligned(dy, offset)
    if product == "fwd":
        def new():
            return GK.grouped_matmul_kernel(x, gid, w, BT)
        want = grouped_matmul_tiles_ref(x, gid, w, BT)
        old = (lambda out: lambda: _earlier_call(
            earlier, "fwd", x, w, gid, out, d, f))(torch.empty_like(want))
        olds = {"earlier": old}
    elif product == "dw":
        def new():
            return GK.grouped_matmul_dw_kernel(x, dy, gid, G, BT)
        want = grouped_matmul_dw_ref(x, dy, gid, G, BT)
        old = (lambda out: lambda: _earlier_call(
            earlier, "dw", x, dy, gid, out, d, f))(torch.empty_like(want))
        olds = {"earlier": old}
    else:
        def new():
            return GK._k5(dy, gid, w, BT, None, "grouped_matmul_dx",
                          w_transposed=True)
        want = grouped_matmul_tiles_ref(dy, gid, w.transpose(1, 2), BT)
        wt = w.transpose(1, 2).contiguous()
        out = torch.empty_like(want)
        olds = {
            "earlier": lambda: _earlier_call(earlier, "dx", dy, wt, gid, out,
                                             f, d),
            "earlier + w^T copy": lambda: _earlier_call(
                earlier, "dx", dy, w.transpose(1, 2).contiguous(), gid, out,
                f, d),
        }
    if earlier is None:
        olds = {}
    return new, olds, want


def ptxas_lines(log: str, marker: str) -> list:
    """ptxas's lines for the entries whose name holds ``marker``: the
    "Compiling entry" line and its registers, shared memory and spills."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = marker in line
        if keep and any(k in line for k in ("Compiling entry", "Used",
                                            "spill")):
            out.append(line.strip())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None,
                    help="an earlier grouped_matmul.cu with the element-load "
                         "kernels")
    ap.add_argument("--build-dir", default="build/async_tune")
    ap.add_argument("--out", default="chiprun_out/async_tune.json")
    ap.add_argument("--twins", action="store_true",
                    help="also (b bf16) on TMA and on inputs 8 bytes off")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("async_tune needs a CUDA card")
    dev = torch.device("cuda")
    root = pathlib.Path(args.build_dir)
    built = GK.LIBRARY
    variants = {"built": built, **variant_libraries(root)}
    libs = list(variants.values())
    earlier = None
    if args.against:
        earlier = earlier_library(args.against, root)
        libs.append(earlier)
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.load) for lib in libs]:
            fut.result()
    for name, lib in variants.items():
        for line in ptxas_lines(lib.info()["log"], "async"):
            print(f"[ptxas {name}] {line}")
    card = device_record(dev)
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(30)
    report = {"card": card, "shapes": []}
    fns, names = [], []
    try:
        for key, product, d, f, offset in SHAPES + (TWINS if args.twins
                                                    else []):
            new, olds, want = case(key, product, d, f, offset, dev, gen,
                                   earlier)

            def on(lib, fn=new):
                def run():
                    GK.LIBRARY = lib
                    return fn()
                return run

            fns_by = {name: on(lib) for name, lib in variants.items()}
            fns_by.update(olds)
            scale = float(want.float().abs().max()) or 1.0
            errs = {}
            for name, fn in fns_by.items():
                got = fn().float()
                torch.cuda.synchronize()
                errs[name] = float((got - want.float()).abs().max())
                ok = (errs[name] <= TOL[product] * scale if product == "dw"
                      else torch.allclose(got, want.float(),
                                          rtol=TOL[product],
                                          atol=TOL[product]))
                if not (ok and bool(torch.isfinite(got).all())):
                    raise SystemExit(f"{key} {product} {name}: max |diff| "
                                     f"{errs[name]} against the plain "
                                     f"version")
            for name in variants:
                if not same_bits(fns_by["built"](), fns_by[name]()):
                    raise SystemExit(f"{key} {product}: {name}'s bits "
                                     f"differ from the build's")
            order = list(fns_by)
            turns = order + order[::-1]
            times = {name: [] for name in order}
            for name in turns:
                times[name].append(time_call(fns_by[name], device="cuda",
                                             reps=REPS, warmup=1
                                             ).device_us / 1e3)
            GK.LIBRARY = built
            rec = {"key": key, "product": product, "d": d, "f": f,
                   "offset": offset, "max_abs_err": errs, "ms": times}
            report["shapes"].append(rec)
            for name in order:
                fns.append(fns_by[name])
                names.append((len(report["shapes"]) - 1, name))
            print(f"[async_tune] ({key}) {product} d={d} f={f}: " + "; ".join(
                f"{name} {sum(t) / len(t):.4f} ms ({' / '.join(f'{v:.4f}' for v in t)})"
                for name, t in times.items()), flush=True)
        traced = profiled_runs(fns, "gmm_", REPS)
        for (i, name), (ms, n) in zip(names, traced):
            report["shapes"][i].setdefault("profiled_ms", {})[name] = ms
        for rec in report["shapes"]:
            print(f"[async_tune] ({rec['key']}) {rec['product']} profiled: "
                  + "; ".join(f"{k} {'not measured' if v is None else f'{v:.4f}'} ms"
                              for k, v in rec["profiled_ms"].items()),
                  flush=True)
    finally:
        GK.LIBRARY = built
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
