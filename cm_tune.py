"""Tuning measurements of the cross-match kernel (K1-K3) on one card.

Not part of the smoke run; run it when the kernel or its split plan
changes:

    python3 cm_tune.py

1. source -- probes a thread (``kProbes`` = 2, 4, 8) and the staging
             (plain loads between two barriers, as committed, or
             ``RING_PATCH``: a double-buffered ring of 16-byte cp.async
             copies, the next tile landing while this one is walked), each
             a copy of ``csrc/crossmatch.cu`` with that change, built at run
             time (all nvcc processes started together) and swapped in as
             ``kernel.LIBRARY``; each at ``SPLIT_BLOCKS_PER_SM`` 8, 16, 32.
   Beside them, at 2 probes a thread (``VARIANT_PATCHES``): the count as
   C++ writes it (FSETP, VIADD and a predicated IMAD.MOV a pair, against
   the committed compare and predicated add) or as the 0 / -1 of a PTX
   ``set`` (FSETP, SEL and half an IADD3); the row loop unrolled 4 times,
   not 8; and 3 probes a thread.
2. splits -- with the committed source, ``kernel.SPLIT_BLOCKS_PER_SM`` in
             0 (no split), 1, 2, 4, 8, 16, 32, 64 and ``MIN_SPLIT_ROWS`` in
             256, 1024, 4096.

3. k1     -- K1 (no band) at run A's batch sizes, M = 1,000, 4,000, 8,000
             and 54,471 real probe rows (run A's largest) on one bucket of
             10,000 rows: probes a thread 2 and 4, each at
             ``SPLIT_BLOCKS_PER_SM`` in 0 (no split) .. 64 and
             ``MIN_SPLIT_ROWS`` in 128 .. 4096.

Each variant's line also gives its walk loop's instructions by opcode
(``cuobjdump -sass`` of the built library: the innermost loop with
FFMAs of the segment instance, and of K1's in part 3) and the pairs one
pass of it takes.  Each variant is first held to the plain version with
chip_smoke.py's check, then timed: parts 1-2 at chip_smoke.py's phase-4
K3 case (four 10,000-row buckets, M = 101,545 real probe rows: runs B's
and C's largest batch) and at phase 2's K3 cases (M = 256, 4096, 32768 on
one bucket).  Times:
``device`` = 20 launches between one pair of CUDA events, over 20
(``chip_smoke.many_ms``); ``prof.`` = the kernel's mean duration in a
profiler trace (the kernel's own time where the launch is slower).

Exits 2 without a CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import os
import pathlib
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as smoke
from chip_smoke import K

PHASE4_M = 101_545  # runs B's and C's max_probe_batch (chip_smoke phase 3)
K1_M = (1000, 4000, 8000, 54_471)  # run A's batches; its largest last
K1_PROBES = (2, 4)
K1_MIN_ROWS = (128, 256, 512, 1024, 2048, 4096)
# The kernel's instances in ptxas's and cuobjdump's mangled names.
INSTANCE = {"segment": "RowsE0E", "bucket": "RowsE1E"}
PROBES = (2, 4, 8)
DEFAULT_PROBES = 2  # the committed kProbes
RINGS = (False, True)
BLOCKS_PER_SM = (0, 1, 2, 4, 8, 16, 32, 64)
SOURCE_BLOCKS_PER_SM = (8, 16, 32)
MIN_ROWS = (256, 1024, 4096)
R_LINE = "constexpr int kProbes = {};"
COUNT_LINE = "      add_if_at_least(cnt[r], d, thr[r]);"
# Other forms of the count and the walk's unroll: (line of the source,
# its replacement).
VARIANT_PATCHES = {
    "count as C++ writes it": ((COUNT_LINE,
                                "      cnt[r] += d >= thr[r] ? 1 : 0;"),),
    "count as a PTX set": ((COUNT_LINE, """\
      int ge;
      asm("set.ge.s32.f32 %0, %1, %2;" : "=r"(ge) : "f"(d), "f"(thr[r]));
      cnt[r] -= ge;"""),),
    "row loop unrolled 4 times": (
        ("#pragma unroll 8\n  for (int t = 0; t < len; ++t) {",
         "#pragma unroll 4\n  for (int t = 0; t < len; ++t) {"),),
}
# The staging as a cp.async ring: (line of the source, its replacement).
RING_PATCH = (
    ("  __shared__ float4 tile[kSegTile];",
     "  __shared__ __align__(16) float4 tile[2][kSegTile];"),
    ("// R dot chains over the staged rows", """\
__device__ __forceinline__ void stage_async(float4* dst, const float4* rows4,
                                            int base, int len) {
  for (int t = threadIdx.x; t < len; t += kSegThreads) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + t));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(d),
                 "l"(rows4 + static_cast<size_t>(base + t) * (kRowFloats / 4))
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
}

// R dot chains over the staged rows"""),
    ("""\
    for (int base = r0; base < r1; base += kSegTile) {
      const int n_rows = min(kSegTile, r1 - base);
      __syncthreads();  // the last tile is consumed
      stage(tile, rows4, base, n_rows);
      __syncthreads();
      if (any) visit(tile, n_rows, base);
    }
""", """\
    int buf = 0;
    if (r0 < r1) stage_async(tile[0], rows4, r0, min(kSegTile, r1 - r0));
    cp_async_commit();
    for (int base = r0; base < r1; base += kSegTile) {
      const int n_rows = min(kSegTile, r1 - base);
      const int next = base + kSegTile;
      if (next < r1)
        stage_async(tile[buf ^ 1], rows4, next, min(kSegTile, r1 - next));
      cp_async_commit();
      asm volatile("cp.async.wait_group 1;\\n" ::: "memory");
      __syncthreads();  // everyone's copies of tile[buf] landed
      if (any) visit(tile[buf], n_rows, base);
      __syncthreads();  // tile[buf] is consumed before it is refilled
      buf ^= 1;
    }
"""),
)


def source_variants() -> dict:
    """{(probes a thread, ring): CudaLibrary} for each variant's copy of
    the source, under ``build/cm_tune/``."""
    text = open(os.path.join(smoke.ROOT, smoke.SOURCE)).read()
    base_r = R_LINE.format(DEFAULT_PROBES)
    patches = [((base_r, None),), RING_PATCH, *VARIANT_PATCHES.values()]
    for old, _ in (pair for patch in patches for pair in patch):
        if text.count(old) != 1:
            raise SystemExit(f"cm_tune: a patched line moved: {old[:60]!r}")
    out = {}
    for r in PROBES:
        for ring in RINGS:
            variant = text.replace(base_r, R_LINE.format(r))
            for old, new in RING_PATCH if ring else ():
                variant = variant.replace(old, new)
            path = pathlib.Path(smoke.ROOT, "build", "cm_tune",
                                f"r{r}_{'ring' if ring else 'plain'}",
                                "crossmatch.cu")
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(variant)
            out[(r, ring)] = _library(path)
    others = dict(VARIANT_PATCHES, **{"kProbes 3": ((base_r, R_LINE.format(3)),)})
    for name, patch in others.items():
        path = pathlib.Path(smoke.ROOT, "build", "cm_tune",
                            name.replace(" ", "_"), "crossmatch.cu")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text.replace(*patch[0]))
        out[name] = _library(path)
    return out


def _library(path: pathlib.Path):
    lib = smoke.CudaLibrary("crossmatch", K._bind)
    lib.source = path
    return lib


def k1_cases(dev):
    """K1 at run A's batch sizes on one 10,000-row bucket, the real rows
    as the card path hands them."""
    cat = smoke.make_catalog(n_objects=1_000_000, objects_per_bucket=10_000,
                             htm_level=10, seed=3)
    bucket = smoke.largest_buckets(cat, 1)[0]
    rng = np.random.default_rng(12)
    thr = float(np.cos(5e-3))
    return [smoke.k1_case(bucket, smoke.near_probes(bucket, m, rng), thr,
                          None, f"K1 M={m}", dev) for m in K1_M]


def cases(dev):
    """The K3 cases timed: phase 4's real shape, then phase 2's."""
    cat = smoke.make_catalog(n_objects=1_000_000, objects_per_bucket=10_000,
                             htm_level=10, seed=3)
    buckets = smoke.largest_buckets(cat, 4)
    rng = np.random.default_rng(11)
    out = []
    for m in smoke.PROBE_COUNTS:
        out += [c for c in smoke.kernel_cases(buckets[0], m, rng, dev)
                if c["name"] == "crossmatch_shared"]
    phase4 = smoke.main_shape_cases(
        buckets, {"A": 256, "B": PHASE4_M, "C": PHASE4_M}, rng, dev)
    return [c for c in phase4 if c["name"] == "crossmatch_shared"] + out


def segment_registers(lib, instance: str = "segment") -> str:
    """ptxas's register line for one instance of the kernel in ``lib``'s
    build."""
    lines = lib.info()["log"].splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and INSTANCE[instance] in ln:
            regs = [x.strip() for x in lines[i + 1:i + 4] if "registers" in x]
            if regs:
                return regs[0]
    return "no ptxas report"


def walk_loop(lib, probes_a_thread: int, instance: str = "segment") -> str:
    """One instance's walk loop in ``lib``'s SASS (``cuobjdump``)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib.info()["path"]],
                          capture_output=True, text=True).stdout
    return loop_summary(sass, probes_a_thread, instance)


def loop_summary(sass: str, probes_a_thread: int,
                 instance: str = "segment") -> str:
    """The innermost loop (a backward BRA) of one instance of the kernel
    with the most FFMAs: its instructions by opcode, and per pair (4
    FFMAs)."""
    body = next((f for f in re.split(r"\n\s*Function : ", sass)
                 if INSTANCE[instance] in f.split("\n", 1)[0]), "")
    code = []
    for a, op, rest in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                                  r"([A-Z0-9_]+)([^;\n]*);", body):
        target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        code.append((int(a, 16), op, int(target.group(1), 16) if target else None))
    loops = [(t, a) for a, op, t in code if t is not None and t < a]
    best = None
    for t, a in loops:
        if any(t <= t2 and a2 < a or t < t2 and a2 <= a for t2, a2 in loops):
            continue  # not innermost
        ops = collections.Counter(o for x, o, _ in code if t <= x <= a)
        if best is None or ops["FFMA"] > best["FFMA"]:
            best = ops
    if best is None or not best["FFMA"]:
        return "walk loop not found"
    n, pairs = sum(best.values()), best["FFMA"] // 4
    top = ", ".join(f"{o} {c}" for o, c in best.most_common(8))
    return (f"walk loop {n} instructions for {pairs} pairs ({n / pairs:.2f} "
            f"a pair, {pairs // probes_a_thread} rows): {top}")


def timings(cs) -> str:
    parts = []
    for c in cs:
        want = c["plain"]()
        smoke.check_join(c["label"], c, c["kernel"](), want)
        dev_ms = smoke.many_ms(c["kernel"])
        prof = smoke.profiled_ms(c["kernel"], "crossmatch_segment")
        _, splits = K.segment_plan(c["p8"].shape[0],
                                   c.get("rows", c["b8"].shape[0]),
                                   c["p8"].device)
        parts.append(f"M={c['p8'].shape[0]} splits {splits}: device "
                     f"{dev_ms:.4f} prof. {smoke.fmt_ms(prof)}")
    return "; ".join(parts)


def sweep_segment(variants, dev) -> None:
    """Parts 1 and 2: K3's source variants, then its split constants."""
    cs = cases(dev)
    saved = K.LIBRARY, K.SPLIT_BLOCKS_PER_SM
    try:
        for key, lib in variants.items():
            K.LIBRARY = lib
            name = (key if isinstance(key, str) else
                    f"kProbes {key[0]}, ring {key[1]}")
            r = key[0] if isinstance(key, tuple) else (
                3 if key == "kProbes 3" else DEFAULT_PROBES)
            print(f"[sass] {name}: {walk_loop(lib, r)}", flush=True)
            for blocks in SOURCE_BLOCKS_PER_SM:
                K.SPLIT_BLOCKS_PER_SM = blocks
                print(f"[source] {name}, SPLIT_BLOCKS_PER_SM {blocks}: "
                      f"{timings(cs)} ({segment_registers(lib)})", flush=True)
    finally:
        K.LIBRARY, K.SPLIT_BLOCKS_PER_SM = saved

    defaults = K.SPLIT_BLOCKS_PER_SM, K.MIN_SPLIT_ROWS
    try:
        for blocks in BLOCKS_PER_SM:
            K.SPLIT_BLOCKS_PER_SM = blocks
            print(f"[splits] SPLIT_BLOCKS_PER_SM {blocks}: {timings(cs)}",
                  flush=True)
        K.SPLIT_BLOCKS_PER_SM = defaults[0]
        for rows in MIN_ROWS:
            K.MIN_SPLIT_ROWS = rows
            print(f"[splits] MIN_SPLIT_ROWS {rows}: {timings(cs[1:])}",
                  flush=True)
    finally:
        K.SPLIT_BLOCKS_PER_SM, K.MIN_SPLIT_ROWS = defaults


def sweep_k1(variants, dev) -> None:
    """Part 3: K1 at run A's batch sizes, probes a thread and the split
    constants."""
    cs = k1_cases(dev)
    saved = K.LIBRARY, K.SPLIT_BLOCKS_PER_SM, K.MIN_SPLIT_ROWS
    try:
        for r in K1_PROBES:
            lib = variants[(r, False)]
            K.LIBRARY = lib
            print(f"[k1 sass] kProbes {r}: {walk_loop(lib, r, 'bucket')} "
                  f"({segment_registers(lib, 'bucket')})", flush=True)
            K.MIN_SPLIT_ROWS = saved[2]
            for blocks in BLOCKS_PER_SM:
                K.SPLIT_BLOCKS_PER_SM = blocks
                print(f"[k1] kProbes {r}, SPLIT_BLOCKS_PER_SM {blocks}: "
                      f"{timings(cs)}", flush=True)
            K.SPLIT_BLOCKS_PER_SM = saved[1]
            for rows in K1_MIN_ROWS:
                K.MIN_SPLIT_ROWS = rows
                print(f"[k1] kProbes {r}, MIN_SPLIT_ROWS {rows}: "
                      f"{timings(cs)}", flush=True)
    finally:
        K.LIBRARY, K.SPLIT_BLOCKS_PER_SM, K.MIN_SPLIT_ROWS = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("cm_tune: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {smoke.card_name()}", flush=True)
    variants = source_variants()
    with ThreadPoolExecutor(len(variants) + 1) as pool:
        for fut in [pool.submit(K.build)] + [
                pool.submit(lib.load) for lib in variants.values()]:
            fut.result()
    dev = torch.device(smoke.DEVICE)
    sweep_segment(variants, dev)
    sweep_k1(variants, dev)
    print(f"nvidia-smi: {smoke.card_name()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
