#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's cross-match main path on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the last line is printed:

1. build   -- compile ``src/repro_torch/csrc/crossmatch.cu`` with nvcc (into
              ``build/kernels/``) and load it.
2. kernels -- each CUDA kernel (K1 single bucket, K2 fused, K3 shared plan)
              against its plain PyTorch version on the card, at the main
              path's shapes: a bucket of 10,000 rows padded to 16,384 and
              M in {256, 4096, 32768} probes.  Tolerance (the plain version
              takes its dots from cuBLAS, in another order than the kernel):
              best_dot within 2 ulp; best_idx equal or the float64 dots of
              both indices within 2 ulp; n_cand equal except on probes with a
              pair whose float64 dot lies within 2 ulp of the threshold.
              Kernel, plain and torch.mm dots-only times are CUDA-event
              medians of 20.
3. main    -- the SkyQuery cross-match at the paper's SDSS bucket width
              (10,000 objects a bucket), cut in depth to 100 buckets, 200
              queries; three engines on ``cuda``: A fuse_k=1 (K1), B fuse_k=4
              (K2), C shared plan with per-query radius and magnitude cut
              (K3, and K1 for indexed members).  Each run's kernel launches
              must be > 0 and add up to its device dispatches; its decision
              log and per-query results must match a ``device="cpu"`` run of
              the same engine on the first 50 queries (the plain fused join
              takes minutes on the host for the whole trace), under the
              tolerance above.  Each run's drain is run once more under
              ``torch.profiler`` for the device's busy share.
4. shapes  -- each kernel against its plain version again, at the shape the
              main path gave it: K1 on one 10,000-row bucket (N = 16,384)
              with run A's largest probe batch; K2 and K3 on four
              10,000-row buckets (N = 65,536) with the largest probe batch
              of run B and run C.  These cases make the kernels' record.

The last two lines are the kernels' JSON record and the device record.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import (  # noqa: E402
    CostModel, HybridCostModel, HybridPlanner, LifeRaftScheduler,
)
from repro_torch.crossmatch import (  # noqa: E402
    CrossMatchEngine, TraceConfig, make_catalog, make_trace,
    queries_from_records,
)
from repro_torch.kernels.crossmatch import kernel as K  # noqa: E402
from repro_torch.kernels.crossmatch import ops, ref  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
ULPS = 2
PROBE_COUNTS = (256, 4096, 32768)  # kernel-check probe counts (M)
REPS = 20  # CUDA-event timing repetitions (median)
CPU_QUERIES = 50  # the cpu run of each engine takes the first 50 queries
DEVICE = "cuda"  # the device the main path runs on

SOURCE = "src/repro_torch/csrc/crossmatch.cu"
REPLACES = {
    "crossmatch": "src/repro/kernels/crossmatch/kernel.py:89",
    "crossmatch_fused": "src/repro/kernels/crossmatch/kernel.py:248",
    "crossmatch_shared": "src/repro/kernels/crossmatch/kernel.py:206",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    K.build()
    info = K.build_info()
    print(f"[build] {info['path']} compiled={info['compiled']} "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"[build]   {line.strip()}")

    # -- data: the main path's catalog --------------------------------------
    t0 = time.perf_counter()
    cat = make_catalog(
        n_objects=1_000_000, objects_per_bucket=10_000, htm_level=10, seed=3
    )
    trace = make_trace(
        cat,
        TraceConfig(n_queries=200, arrival_rate=1.0,
                    objects_median=1000, seed=4),
    )
    print(f"[data] catalog {cat.n_objects} objects, {cat.n_buckets} buckets; "
          f"{len(trace)} queries, {sum(q.n_objects for q in trace)} probe "
          f"objects; {time.perf_counter() - t0:.2f}s", flush=True)

    # -- 2. kernels against their plain versions ----------------------------
    dev = torch.device(DEVICE)
    buckets = largest_buckets(cat, 4)
    rng = np.random.default_rng(11)
    for m in PROBE_COUNTS:
        for c in kernel_cases(buckets[0], m, rng, dev):
            measure(c)

    # -- 3. main path ---------------------------------------------------------
    by_run, batches = run_main_path(cat, trace)

    # -- 4. kernels at the main path's shapes --------------------------------
    records = []
    for c in main_shape_cases(buckets, batches, rng, dev):
        rec = measure(c)
        rec["launches_by_run"] = {
            run: counts[c["name"]] for run, counts in by_run.items()
        }
        rec["launches"] = sum(rec["launches_by_run"].values())
        records.append(rec)
    missing = [r["name"] for r in records if r["launches"] <= 0]
    if missing:
        raise SystemExit(f"main path never launched {missing}")
    for r in records:
        print(f"[summary] {r['name']} (M={r['m']}, N={r['n']}): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, dots-only "
              f"{r['dots_mm_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), main-path launches "
              f"{r['launches_by_run']}")

    kind = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind,
                   "count": torch.cuda.device_count()},
    }))
    return 0


# ---------------------------------------------------------------- timing
def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return float(times[len(times) // 2])


# ---------------------------------------------------------------- tolerance
def within_ulps(a, b, ulps=ULPS):
    """|a - b| <= ulps * spacing of the larger magnitude, in float32."""
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    mag = np.maximum(np.abs(a64), np.abs(b64)).astype(np.float32)
    return np.abs(a64 - b64) <= ulps * np.spacing(mag).astype(np.float64)


def check_join(label, case, got, want):
    """Hold a kernel's (idx, dot, cnt) against the plain version's.

    ``case`` has the padded f32 inputs ``b8``/``p8`` (CUDA tensors), the
    per-row threshold ``thr`` (numpy f32) and ``keep(rows)`` -> bool mask
    (len(rows), N) of the pairs that take part.  Returns max |dot diff|."""
    gi, gd, gc = (x.cpu().numpy() for x in got)
    wi, wd, wc = (x.cpu().numpy() for x in want)
    b64 = case["b8"].double()

    def dots64(rows):
        p = case["p8"][torch.as_tensor(rows, device=b64.device)].double()
        d = p @ b64.t()
        keep = case["keep"](rows)
        return torch.where(keep, d, torch.full_like(d, -2.0)).cpu().numpy()

    bad_dot = ~within_ulps(gd, wd)
    if bad_dot.any():
        r = int(np.nonzero(bad_dot)[0][0])
        raise SystemExit(f"{label}: best_dot differs beyond {ULPS} ulp at "
                         f"row {r}: {gd[r]!r} vs {wd[r]!r}")
    rows = np.nonzero(gi != wi)[0]
    if rows.size:
        d = dots64(rows)
        a = d[np.arange(rows.size), gi[rows]]
        b = d[np.arange(rows.size), wi[rows]]
        tie = within_ulps(a, b)
        if not tie.all():
            r = int(rows[~tie][0])
            raise SystemExit(f"{label}: best_idx differs at row {r} "
                             f"({gi[r]} vs {wi[r]}) without a {ULPS}-ulp tie")
    rows_c = np.nonzero(gc != wc)[0]
    if rows_c.size:
        d = dots64(rows_c)
        thr = case["thr"][rows_c].astype(np.float64)[:, None]
        near = within_ulps(d, np.broadcast_to(thr, d.shape)).any(axis=1)
        if not near.all():
            r = int(rows_c[~near][0])
            raise SystemExit(f"{label}: n_cand differs at row {r} "
                             f"({gc[r]} vs {wc[r]}) with no pair near the "
                             f"threshold")
    print(f"[kernels]   {label}: ok (idx ties {rows.size}, near-threshold "
          f"counts {rows_c.size})", flush=True)
    return float(np.max(np.abs(gd.astype(np.float64) - wd)))


def largest_buckets(cat, k: int) -> list:
    """Positions of the catalog's ``k`` largest buckets (10,000 rows each
    at the main path's partitioning)."""
    sizes = [cat.partitioner.object_slice(b).size for b in range(cat.n_buckets)]
    ids = np.argsort(sizes, kind="stable")[::-1][:k]
    return [cat.store.read(int(b))["positions"] for b in ids]


def near_probes(bucket_pos, m, rng):
    """``m`` unit vectors: three in four within ~2e-3 rad of a bucket row,
    the rest anywhere on the sky."""
    near = bucket_pos[rng.integers(0, len(bucket_pos), m)] + rng.normal(
        scale=2e-3, size=(m, 3)
    )
    probes = near / np.linalg.norm(near, axis=1, keepdims=True)
    sky = rng.normal(size=(m // 4, 3))
    probes[: m // 4] = sky / np.linalg.norm(sky, axis=1, keepdims=True)
    return probes


def k1_case(bucket_pos, probes, thr, band, label, dev):
    """A K1 case, padded as ``ops.crossmatch`` pads."""
    b8, p8, _, _ = ops._host_prepare(bucket_pos, probes, 128, 512)
    b8t, p8t = torch.from_numpy(b8).to(dev), torch.from_numpy(p8).to(dev)
    keep_fn = (
        ref.band_keep(p8.shape[0], b8.shape[0], 128, 512, band, dev)
        if band is not None else None
    )

    def keep(rows, n=b8.shape[0]):
        if keep_fn is None:
            return torch.ones(len(rows), n, dtype=torch.bool, device=dev)
        return torch.cat([keep_fn(int(r), int(r) + 1) for r in rows])

    return dict(
        name="crossmatch", label=label, b8=b8t, p8=p8t,
        thr=np.full(p8.shape[0], thr, np.float32), keep=keep,
        kernel=lambda: K.crossmatch_kernel(b8t, p8t, thr, bm=128, bn=512,
                                           band=band),
        plain=lambda: ref.crossmatch_ref(b8t, p8t, thr, band=band, bm=128,
                                         bn=512),
        pairs=(len(probes) * len(bucket_pos) if band is None
               else band_pairs(p8.shape[0], b8.shape[0], band)),
        in_bytes=(b8.size + p8.size) * 4,
    )


def seg_cases(bucket_pos, probes, bseg, pseg, thr_real, label, dev):
    """The K2 case (threshold cos 5e-3) and the K3 case (per-probe
    thresholds ``thr_real``) on one segmented input, padded as
    ``ops.crossmatch_fused``/``crossmatch_shared`` pad."""
    b8s, p8s, bs, ps, _, m = ops._segmented_inputs(
        bucket_pos, probes, bseg, pseg, 128, 512
    )
    b8t, p8t = torch.from_numpy(b8s).to(dev), torch.from_numpy(p8s).to(dev)
    bst, pst = torch.from_numpy(bs).to(dev), torch.from_numpy(ps).to(dev)
    thr_row = np.full(p8s.shape[0], 2.0, np.float32)
    thr_row[:m] = thr_real
    thr_t = torch.from_numpy(thr_row).to(dev)
    pairs = seg_pair_count(bs, ps)
    in_bytes = (b8s.size + p8s.size + bs.size + ps.size) * 4

    def keep(rows):
        r = torch.as_tensor(rows, device=dev)
        return pst[r][:, None] == bst[None, :]

    thr = float(np.cos(5e-3))
    return [
        dict(name="crossmatch_fused", label=f"K2 {label}", b8=b8t, p8=p8t,
             thr=np.full(p8s.shape[0], thr, np.float32), keep=keep,
             kernel=lambda: K.crossmatch_fused_kernel(b8t, p8t, bst, pst, thr),
             plain=lambda: ref.crossmatch_fused_ref(b8t, p8t, bst, pst, thr),
             pairs=pairs, in_bytes=in_bytes),
        dict(name="crossmatch_shared", label=f"K3 {label}", b8=b8t, p8=p8t,
             thr=thr_row, keep=keep,
             kernel=lambda: K.crossmatch_shared_kernel(b8t, p8t, bst, pst,
                                                       thr_t),
             plain=lambda: ref.crossmatch_shared_ref(b8t, p8t, bst, pst,
                                                     thr_t),
             pairs=pairs, in_bytes=in_bytes + thr_row.size * 4),
    ]


def kernel_cases(bucket_pos, m, rng, dev):
    """Phase 2's K1/K2/K3 cases at one probe count on one bucket of
    10,000 rows (N = 16,384)."""
    n_real = len(bucket_pos)
    probes = near_probes(bucket_pos, m, rng)
    cases = [
        k1_case(bucket_pos, probes, thr, band,
                f"K1 M={m} thr={thr:.6g} band={band}", dev)
        for thr, band in ((float(np.cos(5e-3)), None),
                          (float(np.cos(5e-3)), 2), (float(np.cos(2.0)), None))
    ]
    # K2 / K3: 4 segments, segment 2 has probes but no bucket rows.
    bseg = np.repeat([0, 1, 3], [3000, 3000, n_real - 6000])
    pseg = np.repeat([0, 1, 2, 3], m // 4)
    radii = np.array([1e-3, 2e-3, 2.5e-3, 5e-3, 1e-2, 2e-2, 0.1, 2.0])
    thr_real = np.cos(radii)[np.arange(m) % 8].astype(np.float32)
    k2, k3 = seg_cases(bucket_pos, probes, bseg, pseg, thr_real,
                       f"M={m} k=4 (one empty)", dev)
    k3["label"] += ", 8 thresholds"
    return cases + [k2, k3]


def main_shape_cases(buckets, batches, rng, dev):
    """Phase 4: each kernel at the shape the main path gave it.  K1 joins
    one bucket with run A's largest probe batch; K2 and K3 join four
    whole buckets (N = 65,536) with the largest probe batch of run B and
    run C (for C, the whole shared group before ``share_width`` chunks
    it: at most what one K3 call sees), the probes split evenly over the
    four segments.  K3's thresholds are run C's radii."""
    m1 = batches["A"]
    k1 = k1_case(buckets[0], near_probes(buckets[0], m1, rng),
                 float(np.cos(5e-3)), None, f"K1 main shape M={m1}", dev)
    bucket_cat = np.concatenate(buckets)
    bseg = np.repeat(np.arange(len(buckets)), [len(b) for b in buckets])
    out = [k1]
    for run, name in (("B", "crossmatch_fused"), ("C", "crossmatch_shared")):
        m = batches[run]
        parts = np.array_split(np.arange(m), len(buckets))
        probes = np.concatenate([
            near_probes(b, len(p), rng) for b, p in zip(buckets, parts)
        ])
        pseg = np.repeat(np.arange(len(buckets)), [len(p) for p in parts])
        radii = np.array([2.5e-3, 5e-3, 1e-2])
        thr_real = np.cos(radii)[np.arange(m) % 3].astype(np.float32)
        cases = seg_cases(bucket_cat, probes, bseg, pseg, thr_real,
                          f"main shape M={m} k={len(buckets)}", dev)
        out += [c for c in cases if c["name"] == name]
    return out


def band_pairs(m, n, band, bm=128, bn=512):
    """Pairs inside the kept band tiles of an (m, n) join."""
    n_i, n_j = m // bm, n // bn
    centers = (np.arange(n_i) * n_j) // max(n_i, 1)
    lo = np.maximum(centers - band, 0)
    hi = np.minimum(centers + band + 1, n_j)
    return int(((hi - lo) * bm * bn).sum())


def seg_pair_count(bseg, pseg):
    """Real pairs of equal segment: the work a segment-masked join must do
    (padded rows, of segment ``PAD_SEG``, need none)."""
    vals, nb = np.unique(bseg[bseg != K.PAD_SEG], return_counts=True)
    pv, npr = np.unique(pseg[pseg != K.PAD_SEG], return_counts=True)
    _, ib, ip = np.intersect1d(vals, pv, return_indices=True)
    return int((nb[ib].astype(np.int64) * npr[ip]).sum())


def measure(c) -> dict:
    """Hold one case's kernel against its plain version, time both and a
    dots-only ``torch.mm`` of the same operands; return its record."""
    err = check_join(c["label"], c, c["kernel"](), c["plain"]())
    k_ms = cuda_ms(c["kernel"], REPS)
    p_ms = cuda_ms(c["plain"], REPS)
    b8, p8 = c["b8"], c["p8"]
    mm_ms = cuda_ms(lambda: torch.mm(p8, b8.t()), REPS)
    m, n = p8.shape[0], b8.shape[0]
    flops = 8.0 * c["pairs"]  # 4 FMA per real pair
    nbytes = c["in_bytes"] + 12.0 * m
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    bound = max(t_ops, t_bytes) * 1e3
    print(f"[kernels]   {c['label']}: M={m} N={n} pairs={c['pairs']} kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, torch.mm dots-only "
          f"{mm_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})", flush=True)
    return dict(
        name=c["name"], route="cuda", source=SOURCE,
        replaces=REPLACES[c["name"]], launches=0, max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
        library_ms=None, dots_mm_ms=mm_ms, m=m, n=n,
    )


# ---------------------------------------------------------------- main path
def encode_round(outcome) -> tuple:
    """The decision-log fields of one round (bit-comparable)."""
    v = outcome.vector
    return (
        tuple((int(d.bucket_id), float(d.score), bool(d.in_cache),
               int(d.queue_size)) for d in outcome.decisions),
        float(outcome.cost),
        (float(v.alpha), int(v.fuse_k), bool(v.spill),
         int(getattr(v, "share_width", 0))),
        tuple(int(b) for b in outcome.spill_changed),
        float(getattr(outcome, "stall", 0.0)),
    )


def make_engine(cat, kind: str, device: str):
    cost = CostModel(T_b=1.2, T_m=0.13e-3)
    hybrid = HybridPlanner(
        HybridCostModel(T_b=1.2, T_m=0.13e-3, T_probe=4.13e-3),
        objects_per_bucket=10_000,
    )
    extra = {
        "A": dict(fuse_k=1),
        "B": dict(fuse_k=4),
        "C": dict(fuse_k=4, shared_plan=True, share_width=8),
    }[kind]
    return CrossMatchEngine(
        cat, scheduler=LifeRaftScheduler(cost, alpha=0.25), cost_model=cost,
        cache_capacity=20, match_radius_rad=5e-3, hybrid=hybrid,
        device=device, **extra,
    )


def queries_for(records, kind: str, n: int):
    """Fresh Query objects for one run; C gets per-query predicates."""
    qs = queries_from_records(records[:n])
    if kind == "C":
        rng = np.random.default_rng(5)
        for q in qs:
            q.meta["radius"] = float(rng.choice([2.5e-3, 5e-3, 1e-2]))
            q.meta["mag_cut"] = float(rng.choice([23.0, 24.0, 25.0]))
    return qs


def submit_all(eng, queries) -> float:
    """``CrossMatchEngine.run``'s intake half: admit the whole trace in
    arrival order; returns its wall seconds."""
    t0 = time.perf_counter()
    for q in sorted(queries, key=lambda q: q.arrival_time):
        eng.sim_clock = max(eng.sim_clock, q.arrival_time)
        eng.submit(q)
    return time.perf_counter() - t0


def drain(eng, device) -> float:
    """``CrossMatchEngine.run``'s drain half: service rounds until idle;
    returns its wall seconds, ending in a synchronise on the card."""
    t0 = time.perf_counter()
    while eng.step() is not None:
        pass
    eng.close()
    if device != "cpu":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def drive(cat, records, kind, device, n):
    """One run of the main path as ``engine.run`` does it, timed in its
    intake and drain halves."""
    eng = make_engine(cat, kind, device)
    log: list = []
    eng.loop.add_round_tap(lambda o: log.append(encode_round(o)))
    queries = queries_for(records, kind, n)
    t_in = submit_all(eng, queries)
    t_out = drain(eng, device)
    done = len(eng.wm.response_times())
    if done != len(queries):
        raise SystemExit(f"run {kind} on {device}: {done} of {len(queries)} "
                         f"queries completed")
    return eng, log, eng.results, queries, (t_in, t_out)


def profile_drain(cat, records, kind):
    """Device busy share of one run's drain, from a torch.profiler trace:
    the summed durations of the device's kernels and copies over the
    drain's wall time (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = make_engine(cat, kind, DEVICE)
    submit_all(eng, queries_for(records, kind, len(records)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = drain(eng, DEVICE)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"[profile] run {kind}: device time not measured (the profiler "
              f"saw no device events); drain {wall:.3f}s", flush=True)
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    kern = [e for e in dev if "crossmatch_kernel" in e.name]
    kern_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    copy_ms = sum(e.time_range.elapsed_us() for e in dev
                  if "memcpy" in e.name.lower()) / 1e3
    print(f"[profile] run {kind}: drain {wall:.3f}s under the profiler; device "
          f"busy {busy_ms:.3f} ms ({100 * busy_ms / 1e3 / wall:.3f}%): "
          f"crossmatch kernels {kern_ms:.3f} ms in {len(kern)} launches, "
          f"copies {copy_ms:.3f} ms, {len(dev)} device events", flush=True)


def result_rows(cat, results):
    """{(query, bucket, probe): (match_obj, best_dot, n_cand)}."""
    bucket_of = np.empty(cat.n_objects, np.int64)
    for b in range(cat.n_buckets):
        bucket_of[cat.partitioner.object_slice(b)] = b
    out = {}
    for qid, groups in results.items():
        for r in groups:
            for p, mo, d, c in zip(r.probe_idx, r.match_obj, r.best_dot,
                                   r.n_candidates):
                key = (int(qid), int(bucket_of[mo]), int(p))
                if key in out:
                    raise SystemExit(f"duplicate result row {key}")
                out[key] = (int(mo), np.float32(d), int(c))
    return out


def compare_results(cat, eng, queries, got, want, label):
    """Per-query results of a cuda run vs the cpu run, under the join
    tolerance: a differing row must be explained by a 2-ulp tie of its
    best index or a pair within 2 ulp of its threshold."""
    g, w = result_rows(cat, got), result_rows(cat, want)
    qmap = {q.query_id: q for q in queries}
    n_explained = 0
    for key in sorted(set(g) | set(w)):
        a, b = g.get(key), w.get(key)
        if a == b:
            continue
        if a is not None and b is not None and not within_ulps(a[1], b[1]):
            raise SystemExit(f"{label}: result row {key} best_dot differs "
                             f"beyond {ULPS} ulp: cuda {a} cpu {b}")
        qid, bucket, p = key
        pos = cat.store.read(bucket)["positions"].astype(np.float32)
        probe = qmap[qid].payload["positions"][p].astype(np.float32)
        d = pos.astype(np.float64) @ probe.astype(np.float64)
        thr, _ = eng._pred_of(qid)
        thr32 = np.float32(thr)
        near_thr = within_ulps(d, np.full_like(d, thr32)).any()
        top = d.max()
        tie = int(within_ulps(d, np.full_like(d, top)).sum()) > 1
        if a is not None and b is not None:
            ok = (a[0] == b[0] or tie) and (a[2] == b[2] or near_thr)
        else:  # matched on one side only: a threshold or mag-cut edge
            ok = near_thr or tie
        if not ok:
            raise SystemExit(f"{label}: result row {key} differs: cuda {a} "
                             f"cpu {b}")
        n_explained += 1
    return len(g), n_explained


def run_main_path(cat, trace):
    """Phase 3; returns each run's kernel launches and its largest probe
    batch (the engine's ``max_probe_batch``)."""
    records = [dataclasses.asdict(q) for q in trace]
    n_cpu = min(CPU_QUERIES, len(records))
    expect = {"A": "crossmatch", "B": "crossmatch_fused",
              "C": "crossmatch_shared"}
    by_run, batches = {}, {}
    for kind in ("A", "B", "C"):
        K.reset_launches()
        eng, log, res, queries, (t_in, t_out) = drive(
            cat, records, kind, DEVICE, len(records)
        )
        launches = dict(K.LAUNCHES)
        by_run[kind] = launches
        batches[kind] = int(eng.max_probe_batch)
        dd = eng.summary()["device_dispatches"]
        n_match = sum(len(r.probe_idx) for g in res.values() for r in g)
        print(f"[main] run {kind}: {len(queries)} queries in "
              f"{t_in + t_out:.3f}s wall (intake {t_in:.3f}s, drain "
              f"{t_out:.3f}s), "
              f"{eng.batches} buckets serviced in {eng.dispatches} rounds, "
              f"{dd} device dispatches, launches {launches}, "
              f"max_probe_batch {batches[kind]}, {n_match} matched probes",
              flush=True)
        if launches[expect[kind]] <= 0:
            raise SystemExit(f"run {kind} never launched {expect[kind]}")
        if sum(launches.values()) != dd:
            raise SystemExit(f"run {kind}: {sum(launches.values())} launches "
                             f"but {dd} device dispatches")
        if n_cpu < len(records):
            eng, log, res, queries, _ = drive(
                cat, records, kind, DEVICE, n_cpu
            )
        _, clog, cres, _, (c_in, c_out) = drive(
            cat, records, kind, "cpu", n_cpu
        )
        if log != clog:
            first = next((i for i, (a, b) in enumerate(zip(log, clog))
                          if a != b), min(len(log), len(clog)))
            raise SystemExit(f"run {kind}: decision log differs from the cpu "
                             f"run at round {first}")
        n_rows, n_expl = compare_results(cat, eng, queries, res, cres,
                                         f"run {kind}")
        print(f"[main] run {kind} vs cpu on the first {n_cpu} queries: "
              f"{len(log)} rounds identical, {n_rows} result rows, "
              f"{n_expl} differ within tolerance; cpu wall {c_in + c_out:.3f}s",
              flush=True)
    for kind in ("A", "B", "C"):
        profile_drain(cat, records, kind)
    return by_run, batches


if __name__ == "__main__":
    sys.exit(main())
