"""Tuning measurements of the paged decode-attention kernel (K4) on one card.

Not part of the smoke run; run it when K4's chunk or its wrapper changes:

    python3 k4_tune.py
    python3 k4_tune.py --against OTHER.cu  # only section 3
    python3 k4_tune.py --variants          # only section 4

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
             this tree's source, at every phase-5 shape (a)-(o).  Each
             library is handed the path code its own source knows: OTHER,
             from before the tensor-core instance, gets the pair
             instance's code where this tree takes "mma" (``old_path``).
             Where both take the same instance the outputs are
             bit-compared; elsewhere each is held to the plain version
             within phase 5's tolerance.  Then each kernel's own duration
             in one ``torch.profiler`` trace (``chip_smoke.profiled_runs``)
             and its 20-launch CUDA-event time, in turns other, this,
             this, other.  OTHER must take the same packed arguments (a
             source from before the partials reads 20 of the 22 int64
             this wrapper packs and ignores the last two, their
             pointers).
4. variants -- the tensor-core instance at (f), (i), (l) and (m)-(o)
             against copies of this tree's source with one change each,
             in turns: its ring at 2 stages for every D, at 3 for every
             D, the blocks of a (b, kv) pair's splits next to each other
             in launch order ("splits first"), K and V copied under L2's
             normal policy ("evict normal"), and two knock-outs timed only
             (their outputs are wrong by design): "no fold" (the tiles
             loaded, no mma) and "no merge" (the splits' partials left in
             the workspace); beside them the card's read-only rate over
             the same pools (one ``amax`` of K and one of V).  20-launch
             CUDA-event times, min/max of two turns, and each kernel's
             profiled duration.

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


this_path = PK.kernel_path


def old_path(q, k_pages, v_pages) -> str:
    """The instance a source from before the tensor-core one takes for a
    call: this tree's path where that is the pair instance's, else the
    pair instance's own rule (the ring for a row of 8-64 16-byte vectors,
    element loads else; such a source reads any code but 1 as 0)."""
    path = this_path(q, k_pages, v_pages)
    if path != "mma":
        return path
    vecs = q.shape[-1] * q.element_size() // 16
    return "async" if vecs in PK._VEC_ROWS else "scalar"


def against(other: str, dev) -> None:
    from repro_torch.kernels.nvcc import CudaLibrary

    libs = {"this": PK.LIBRARY, "other": CudaLibrary("paged_attention",
                                                    PK._bind)}
    libs["other"].source = pathlib.Path(other).resolve()
    launch = {k: lib.load().paged_attention_launch for k, lib in libs.items()}
    paths = {"this": this_path, "other": old_path}
    order = ("other", "this", "this", "other")
    fns, event, checked = {}, {}, {}
    for key, shape in smoke.PAGED_SHAPES.items():
        args = smoke.paged_inputs(*shape, dev, seed=20 + ord(key))
        if key in smoke.PAGED_FULL:
            args[4].fill_(shape[6])

        def call(which, args=args):
            PK._launch = launch[which]
            PK.kernel_path = paths[which]
            try:
                return PK.paged_attention_kernel(*args)
            finally:
                PK.kernel_path = this_path

        mine, theirs = call("this"), call("other")
        named = {w: p(*args[:3]) for w, p in paths.items()}
        if named["this"] == named["other"]:
            if not torch.equal(mine.view(torch.uint8),
                               theirs.view(torch.uint8)):
                raise SystemExit(f"K4 ({key}): this source's output differs "
                                 f"from {other}'s on the {named['this']} "
                                 f"instance")
            checked[key] = f"{named['this']} both, outputs bit-equal"
        else:
            want = paged_attention_ref(*args)
            errs = [smoke.check_paged(f"K4 ({key}) {w}", out, want)
                    for w, out in (("this", mine), ("other", theirs))]
            checked[key] = (f"this {named['this']}, other {named['other']}; "
                            f"max |diff| to plain {errs[0]:.3e} / "
                            f"{errs[1]:.3e}")
        fns[key] = [lambda w=w, c=call: c(w) for w in order]
        event[key] = [smoke.many_ms(fn) for fn in fns[key]]
    # one profiler session (each makes the later ones lose device events)
    prof = smoke.profiled_runs([f for key in fns for f in fns[key]],
                               "paged_attention")
    for i, key in enumerate(fns):
        mine = prof[4 * i:4 * i + 4]
        print(f"[source] ({key}) {checked[key]}; profiled ms "
              + ", ".join(f"{w} {smoke.fmt_ms(ms)}"
                          for w, (ms, _) in zip(order, mine))
              + f"; {smoke.MANY}-launch ms "
              + ", ".join(f"{w} {ms:.4f}" for w, ms in zip(order, event[key])),
              flush=True)
    PK._launch = launch["this"]


VARIANT_SHAPES = "filmno"
_STAGES = "  static constexpr int kStages = D <= 128 ? 3 : 2;\n"
_FOLD = ("        tc_fold<D>(sq, ks, ks + kTcTile * C::kPitch, t0, c.c1, "
         "qscale, m, l,\n                   o);\n")
_MERGE = ("  merge_splits(out, m_out, l_out, w, counters, b, kv, H, KV, D, len, "
          "chunk,\n               splits);\n}\n\n// ---------------------------"
          "------------------------------------------------\n// Launchers.")
_ORDER = ("  const int kv = blockIdx.x;\n  const int b = blockIdx.y;\n"
          "  const int split = blockIdx.z;\n  const int splits = gridDim.z;\n"
          "  const int B = gridDim.y;\n  const int G = H / KV;\n"
          "  const int warp = threadIdx.x >> 5;\n")
# The blocks of a (b, kv) pair's splits next to each other in launch order,
# so that pairs finish, and merge, while later pairs stream.
_SPLITS_FIRST = (
    "  const int splits = gridDim.z;\n  const int B = gridDim.y;\n"
    "  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + B * blockIdx.z);\n"
    "  const int split = lin % splits;\n  const int kv = lin / splits % KV;\n"
    "  const int b = lin / splits / KV;\n  const int G = H / KV;\n"
    "  const int warp = threadIdx.x >> 5;\n")
_POLICY = ("    cp_async16(dst, k + off + col, fill, policy);\n"
           "    cp_async16(dst + kTcTile * C::kPitch, v + off + col, fill, "
           "policy);\n")
# name -> (edits of the source, whether its output is held to plain)
VARIANTS = {
    "2 stages": ([(_STAGES, _STAGES.replace("? 3 : 2", "? 2 : 2"))], True),
    "3 stages": ([(_STAGES, _STAGES.replace("? 3 : 2", "? 3 : 3"))], True),
    "no fold": ([(_FOLD, "")], False),
    "no merge": ([(_MERGE, _MERGE.replace(_MERGE.split("}")[0], ""))], False),
    "splits first": ([(_ORDER, _SPLITS_FIRST)], True),
    "evict normal": ([(_POLICY, _POLICY.replace(", policy", ""))], True),
}


def variants(dev) -> None:
    from concurrent.futures import ThreadPoolExecutor

    out = pathlib.Path(__file__).resolve().parent / "build" / "k4_variants"
    libs = {"tree": PK.LIBRARY}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        libs[name] = PK.LIBRARY.variant(edits, out / str(i) / "paged_attention.cu")
    with ThreadPoolExecutor(len(libs)) as pool:
        launch = dict(zip(libs, pool.map(
            lambda lib: lib.load().paged_attention_launch, libs.values())))
    order = list(libs) + list(libs)[::-1]
    fns = []
    for key in VARIANT_SHAPES:
        shape = smoke.PAGED_SHAPES[key]
        args = smoke.paged_inputs(*shape, dev, seed=20 + ord(key))
        if key in smoke.PAGED_FULL:
            args[4].fill_(shape[6])
        assert PK.kernel_path(*args[:3]) == "mma"
        want = paged_attention_ref(*args)

        def call(name, args=args):
            PK._launch = launch[name]
            return PK.paged_attention_kernel(*args)

        for name in libs:
            if name == "tree" or VARIANTS[name][1]:
                smoke.check_paged(f"K4 ({key}) {name}", call(name), want)
        ms = {name: [] for name in libs}
        for name in order:
            ms[name].append(smoke.many_ms(lambda n=name, c=call: c(n)))
        kp, vp = args[1], args[2]
        read = smoke.many_ms(lambda: (kp.amax(), vp.amax()))
        print(f"[variants] ({key}) {smoke.MANY}-launch ms: " + ", ".join(
            f"{n} {min(v):.4f}/{max(v):.4f}" for n, v in ms.items())
            + f"; amax over K and V {read:.4f} "
            f"({(kp.numel() + vp.numel()) * kp.element_size() / 1e6:.1f} MB)",
            flush=True)
        fns += [(key, n, lambda n=n, c=call: c(n)) for n in libs]
    prof = smoke.profiled_runs([f for _, _, f in fns], "paged_attention")
    for key in VARIANT_SHAPES:
        print(f"[variants] ({key}) profiled ms: " + ", ".join(
            f"{n} {smoke.fmt_ms(p)}" for (k, n, _), (p, _) in zip(fns, prof)
            if k == key), flush=True)
    PK._launch = launch["tree"]


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
    if sys.argv[1:2] == ["--variants"]:
        variants(dev)
        return 0
    sweep_chunks(dev)
    host_costs(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
