"""Kernel micro-benchmarks at the reference's shapes: the single-bucket
join K1 (10,000 x 1,024), the grouped matmul K5 (T = 4096, d = f = 1024,
groups [512, 1024, 512, 2048]; bf16 through the tensor-core kernel and
f32 through the f32 kernel) and paged decode attention K4 (B = 16, H =
16, KV = 8, D = 128, pages of 64 x 32, bf16).

The port of ``benchmarks/kernel_bench.py``, with the reference's inputs
(numpy seeds 0, 1, 2).  Each kernel's wrapper call is timed with
``common.time_call`` (host wall; on ``cuda`` also CUDA events).  On the
card each kernel alone is timed too (``device_ms``: 20 launches between
one pair of CUDA events, over 20: K1 through ``ops.prepared_crossmatch``,
without its host padding and copy; K5 its kernel's wrapper on the tile
map made once; where the wrapper's host time exceeds the kernel's, this
times the host), held against its plain version
on the CPU (``max_abs_err``), and set beside the H100 bound
(``common.bound``): K1 counts 4 FMAs a pair in FP32 (the cross-match
kernels run on CUDA cores), K5 2 T d f at its type's peak, K4 the bytes
of its K/V pages.  The reference's TPU estimates are not carried over.

    python -m repro_torch.benchmarks.kernel_bench [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.crossmatch import ops as cm_ops
from ..kernels.grouped_matmul.kernel import grouped_matmul_kernel
from ..kernels.grouped_matmul.ops import grouped_matmul, tile_groups
from ..kernels.paged_attention.ops import dense_to_pages, paged_attention
from .common import (
    PEAK_BF16_FLOPS,
    PEAK_FP32_FLOPS,
    bound,
    device_record,
    emit,
    time_call,
    write_report,
)

__all__ = ["GMM_SIZES", "PAGED_SHAPE", "crossmatch_inputs", "grouped_inputs",
           "paged_inputs", "crossmatch_bench", "grouped_matmul_bench",
           "paged_attention_bench", "run", "main"]

GMM_SIZES = [512, 1024, 512, 2048]
BT = 128  # K5's row tile
PAGED_SHAPE = dict(B=16, H=16, KV=8, D=128, page=64, P=32)
MANY = 20  # launches between one pair of CUDA events
# The plain version on the CPU against the kernel on the card: K1's dot
# within 2 ulp at 1.0, K5 and K4 at the reference's tolerances
# (tests/test_kernels.py:173, :235).
TOL = {"crossmatch": 2.0**-22, "grouped_matmul bfloat16": 5e-2,
       "grouped_matmul float32": 1e-5, "paged_attention": 5e-2}


def _device_ms(fn, dev) -> Optional[float]:
    if dev.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(MANY):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / MANY


def _record(name, shape, dtype, t, device_ms, err, nbytes, flops, peak):
    b_ms, b_by = bound(nbytes, flops, peak)
    return dict(name=name, shape=shape, dtype=dtype, wall_us=t.wall_us,
                event_us=t.device_us, device_ms=device_ms, max_abs_err=err,
                bytes=nbytes, flops=flops, bound_ms=b_ms, bound_by=b_by)


def crossmatch_inputs():
    rng = np.random.default_rng(0)
    N, M = 10_000, 1_024
    b = rng.normal(size=(N, 3)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    p = rng.normal(size=(M, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    return b, p, float(np.cos(0.01))


def crossmatch_bench(verbose=True, device=None) -> dict:
    dev = resolve_device(device)
    b, p, thr = crossmatch_inputs()
    N, M = len(b), len(p)
    t = time_call(lambda: cm_ops.crossmatch(b, p, thr, device=dev)[0],
                  device=dev)
    device_ms = err = None
    if dev.type == "cuda":
        device_ms = _device_ms(cm_ops.prepared_crossmatch(b, p, thr, dev), dev)
        got = cm_ops.crossmatch(b, p, thr, device=dev)[1].cpu()
        err = float((got - cm_ops.crossmatch(b, p, thr, device="cpu")[1])
                    .abs().max())
    n_pad = 1 << (N - 1).bit_length()  # the padded bucket the kernel reads
    nbytes = (n_pad + M) * cm_ops.COORD_PAD * 4 + 12 * M
    rec = _record("crossmatch", f"N={N} M={M}", "float32", t, device_ms, err,
                  nbytes, 8.0 * N * M, PEAK_FP32_FLOPS)
    if verbose:
        _print(rec)
    emit("kernel_crossmatch", t.wall_us, f"h100_bound_us={rec['bound_ms'] * 1e3:.2f}")
    return rec


def grouped_inputs():
    rng = np.random.default_rng(1)
    T, d, f = 4096, 1024, 1024
    x = rng.normal(size=(T, d)).astype(np.float32)
    w = (rng.normal(size=(4, d, f)) * 0.02).astype(np.float32)
    return x, w


def grouped_matmul_bench(verbose=True, device=None) -> list:
    dev = resolve_device(device)
    x32, w32 = grouped_inputs()
    T, d = x32.shape
    f = w32.shape[2]
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(x32).to(dtype).to(dev)
        w = torch.from_numpy(w32).to(dtype).to(dev)
        sizes = torch.tensor(GMM_SIZES, device=dev)
        name = str(dtype).replace("torch.", "")
        t = time_call(lambda: grouped_matmul(x, sizes, w), device=dev)
        device_ms = err = None
        if dev.type == "cuda":
            gid = tile_groups(sizes, T, BT, len(GMM_SIZES))
            device_ms = _device_ms(
                lambda: grouped_matmul_kernel(x, gid, w, BT), dev)
            want = grouped_matmul(x.cpu(), GMM_SIZES, w.cpu()).float()
            err = float((grouped_matmul(x, sizes, w).float().cpu() - want)
                        .abs().max())
        nbytes = (T * d + 4 * d * f + T * f) * x.element_size() + 4 * (T // BT)
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
        rec = _record("grouped_matmul", f"T={T} d={d} f={f} groups={GMM_SIZES}",
                      name, t, device_ms, err, nbytes, 2.0 * T * d * f, peak)
        recs.append(rec)
        if verbose:
            _print(rec)
        emit(f"kernel_grouped_matmul_{name}", t.wall_us,
             f"h100_bound_us={rec['bound_ms'] * 1e3:.2f}")
    return recs


def paged_inputs():
    rng = np.random.default_rng(2)
    s = PAGED_SHAPE
    B, H, KV, D, S = s["B"], s["H"], s["KV"], s["D"], s["page"] * s["P"]
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    return q, k, v


def paged_attention_bench(verbose=True, device=None) -> dict:
    dev = resolve_device(device)
    s = PAGED_SHAPE
    B, H, KV, D, S = s["B"], s["H"], s["KV"], s["D"], s["page"] * s["P"]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).to(dev)
               for a in paged_inputs())
    kp, vp, pt = dense_to_pages(k, v, s["page"])
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    t = time_call(lambda: paged_attention(q, kp, vp, pt, lens), device=dev)
    device_ms = err = None
    if dev.type == "cuda":
        device_ms = _device_ms(lambda: paged_attention(q, kp, vp, pt, lens),
                               dev)
        want = paged_attention(*(a.cpu() for a in (q, kp, vp, pt, lens)))
        err = float((paged_attention(q, kp, vp, pt, lens).float().cpu()
                     - want.float()).abs().max())
    nbytes = 2 * B * S * KV * D * 2 + 2 * q.numel() * 2 + pt.numel() * 4 + B * 4
    rec = _record("paged_attention",
                  f"B={B} H={H} KV={KV} D={D} pages={s['page']}x{s['P']}",
                  "bfloat16", t, device_ms, err, nbytes, 4.0 * B * H * S * D,
                  PEAK_BF16_FLOPS)
    if verbose:
        _print(rec)
    emit("kernel_paged_attention", t.wall_us,
         f"h100_bound_us={rec['bound_ms'] * 1e3:.2f}")
    return rec


def _print(r) -> None:
    dev = ("" if r["device_ms"] is None else
           f"  kernel {r['device_ms']:.4f} ms ({r['device_ms'] / r['bound_ms']:.2f}x"
           f" bound), max |diff| vs plain {r['max_abs_err']:.3e}")
    print(f"  {r['name']} {r['shape']} {r['dtype']}: wrapper "
          f"{r['wall_us']:.0f}us{dev}; H100 bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']})")


def check(report) -> list:
    """The records whose kernel disagrees with its plain version."""
    bad = []
    for r in report["kernels"]:
        key = r["name"] if r["name"] != "grouped_matmul" else \
            f"grouped_matmul {r['dtype']}"
        if r["max_abs_err"] is not None and not r["max_abs_err"] <= TOL[key]:
            bad.append(r)
    return bad


def run(verbose: bool = True, device=None,
        out_path: str | None = "BENCH_torch_kernel_bench.json") -> dict:
    dev = resolve_device(device)
    report = {
        "kernels": [crossmatch_bench(verbose, dev),
                    *grouped_matmul_bench(verbose, dev),
                    paged_attention_bench(verbose, dev)],
        "device": device_record(dev),
    }
    if out_path:
        write_report(out_path, report)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    ap.add_argument("--out", default="BENCH_torch_kernel_bench.json")
    args, _ = ap.parse_known_args(argv)
    report = run(device=args.device, out_path=args.out)
    bad = check(report)
    assert not bad, bad
    return report


if __name__ == "__main__":
    main()
