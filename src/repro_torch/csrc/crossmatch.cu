// Cross-match joins on Hopper (sm_90a), bound to Python through the
// extern "C" entries below (built with nvcc into a shared library and
// loaded with ctypes).
//
// Two kernels replace the three Pallas TPU kernels of the JAX reference
// (src/repro/kernels/crossmatch/kernel.py):
//   crossmatch_kernel          <- crossmatch_pallas (:89)        K1
//   crossmatch_segment_kernel  <- crossmatch_fused_pallas (:248) K2, one
//                                 threshold for all probes
//                              <- crossmatch_shared_pallas (:206) K3, a
//                                 threshold a probe
//
// What they compute, for every probe row m of the (M, 8) probe array
// against the (N, 8) bucket array (rows: 3 coordinates, the marker column,
// zeros):
//   best_dot[m] = max_n dot(m, n)        (init -2)
//   best_idx[m] = lowest n attaining it  (init 0)
//   n_cand[m]   = #{n : dot(m, n) >= threshold}
// K2 and K3 take only the pairs of equal segment; the reference dots the
// others to -2, which never replaces the initial best and never passes a
// threshold in (-2, 1], so they are simply not visited.
//
// Common to both:
//   * Dot order: __fmaf_rn over columns 0..3 in order, from 0.  Columns
//     4..7 are zero.  This is the order jnp.dot takes on the CPU, so the
//     dots equal the reference's bit for bit; any other order moves
//     best_dot by an ulp and flips best_idx on near-ties.  The column-3
//     FMA also turns a -0 into +0, so no dot is -0.
//   * Tie rule: each thread scans its rows in ascending n and only a
//     strictly greater dot replaces the best, which yields the lowest
//     index, as the Pallas kernel's within-tile min-id plus across-tile
//     strict rule does.
//
// Bound on this card: instruction issue on the FP32 lanes.  A pair costs 4
// FMAs (the 67 TFLOP/s bound counts those) and about 5 more instructions
// on the same 128 lanes an SM: a compare and two selects for the best, a
// compare and an add for the count.  Bytes are small: 16 B a bucket row
// staged once a block, 32 B in and 12 B out a probe row.  TF32 tensor
// cores would round away thresholds as tight as cos(2e-3) = 0.999998, and
// the dot has K = 3.  Neither kernel synchronises with the host or
// allocates.
//
// K1 (crossmatch_kernel): one thread a probe row, kThreads probes a block;
// bucket rows staged through shared memory in tiles of kTile rows (a
// float4 a row), every thread reading the same staged row at once (a
// broadcast).  Band: the TPU kernel skips tile (i, j) of its (M/bm, N/bn)
// grid when |j - i*n_j/n_i| > band; here each row visits exactly the
// bucket rows of the tiles its logical tile row i keeps.
//
// K2/K3 (crossmatch_segment_kernel), built against the issue rate:
//   * kProbes probes a thread, kBlockProbes a block, contiguous.  Each
//     staged row is one broadcast shared load feeding kProbes dot chains.
//   * One segment range a probe.  The bucket is sorted by segment, so a
//     segment's rows are one range [lo, hi), which thread 0 finds once by
//     binary search for the block; the block walks the bucket segments
//     between the smallest and largest of its probes' segments (one or
//     two when the probes come sorted, as the engine sends them).  A
//     thread whose probes all belong to the segment walks its rows with
//     no per-row test; one whose probes straddle a segment edge walks
//     them too and keeps only its matching probes' results; one with no
//     probe there skips the walk.  Probes in any order stay right, only
//     slower.  A probe whose segment has no rows keeps (0, -2, 0).
//   * Splits.  Where the probe blocks alone are too few to fill the card,
//     the grid's y axis cuts every segment's rows into `splits` parts:
//     split s walks rows [lo + len*s/splits, lo + len*(s+1)/splits).
//     Each split leaves (best, idx, count) in a workspace; the block that
//     counts last on its probe block's counter (after __threadfence)
//     merges them in split order with a strict > and sums the counts, so
//     the result is the lowest index on ties and the same bits every run,
//     and resets the counter for the next call on the stream.  With one
//     split the block writes the outputs itself.
//   * No padded pairs: the card path hands the kernel only the real probe
//     rows (any M); the bucket's padded rows (segment PAD_SEG) lie past
//     every real segment.  Padded probes, if given, are joined like any
//     other segment, as the reference does.
//   * Issue count.  A pair costs 4 FFMA, a compare and two selects for
//     the best, and a compare and a predicated add for the count (C++'s
//     `cnt += d >= t` compiles to an add and a predicated move back, one
//     more).  The row loop is unrolled 8 times.  cm_tune.py keeps the
//     other forms as variants: C++'s count, a count by a `set` (one
//     instruction fewer than C++'s but with a select on the half-rate ALU
//     pipe; slower), an unroll of 4.
//   * Staging: tiles of kSegTile rows, loaded between two barriers.  A
//     double-buffered cp.async ring measured no faster (cm_tune.py keeps
//     it as a variant): a block's part of a segment is about one tile at
//     the main path's shapes, and several blocks share an SM.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRowFloats = 8;  // COORD_PAD

// ------------------------------------------------------------------ K1
constexpr int kThreads = 128;  // probe rows per block
constexpr int kTile = 1024;    // bucket rows staged per pass (16 KiB)

// Bucket rows [*a, *b) of the band tiles that logical tile row i keeps.
__device__ void band_rows(int row, int bm, int bn, int n_i, int n_j,
                          int band, int* a, int* b) {
  const int i = row / bm;
  const int center = (i * n_j) / max(n_i, 1);
  *a = max(center - band, 0) * bn;
  *b = min(center + band + 1, n_j) * bn;
}

__global__ void __launch_bounds__(kThreads)
crossmatch_kernel(const float* __restrict__ bucket,
                  const float* __restrict__ probes, int n, int m,
                  float cos_thr, int band, int bm, int bn,
                  int* __restrict__ out_idx, float* __restrict__ out_dot,
                  int* __restrict__ out_cnt) {
  __shared__ float4 tile[kTile];

  const int row0 = blockIdx.x * kThreads;
  const int last = min(row0 + kThreads, m) - 1;
  const int row = row0 + threadIdx.x;
  const bool live = row < m;

  const float4* probes4 = reinterpret_cast<const float4*>(probes);
  const float4 p = live ? probes4[static_cast<size_t>(row) * (kRowFloats / 4)]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  const float thr = cos_thr;

  // Bucket rows this block visits, and the ones this thread visits.
  int lo = 0, hi = n, my_lo = 0, my_hi = n;
  if (band >= 0) {
    const int n_i = m / bm, n_j = n / bn;
    int unused;
    band_rows(row0, bm, bn, n_i, n_j, band, &lo, &unused);
    band_rows(last, bm, bn, n_i, n_j, band, &unused, &hi);
    band_rows(live ? row : last, bm, bn, n_i, n_j, band, &my_lo, &my_hi);
  }

  float best = -2.f;
  int best_i = 0;
  int count = 0;
  const float4* rows4 = reinterpret_cast<const float4*>(bucket);
  for (int base = lo; base < hi; base += kTile) {
    const int len = min(kTile, hi - base);
    __syncthreads();  // the previous tile is consumed
    for (int t = threadIdx.x; t < len; t += kThreads) {
      tile[t] = rows4[static_cast<size_t>(base + t) * (kRowFloats / 4)];
    }
    __syncthreads();
    if (!live) continue;
    const int t0 = max(my_lo - base, 0);
    const int t1 = min(my_hi - base, len);
    for (int t = t0; t < t1; ++t) {
      const float4 b = tile[t];
      float d = __fmaf_rn(p.x, b.x, 0.f);
      d = __fmaf_rn(p.y, b.y, d);
      d = __fmaf_rn(p.z, b.z, d);
      d = __fmaf_rn(p.w, b.w, d);
      if (d > best) {
        best = d;
        best_i = base + t;
      }
      count += d >= thr ? 1 : 0;
    }
  }
  if (live) {
    out_idx[row] = best_i;
    out_dot[row] = best;
    out_cnt[row] = count;
  }
}

// ------------------------------------------------------------------ K2/K3
constexpr int kSegThreads = 128;
constexpr int kProbes = 2;  // probes a thread (cm_tune.py sweeps it)
constexpr int kBlockProbes = kSegThreads * kProbes;
constexpr int kSegTile = 1024;  // bucket rows a stage (16 KiB)

struct SegmentArgs {
  const float* bucket;  // (n, 8), rows sorted by segment
  const float* probes;  // (m, 8)
  const float* bseg;    // (n,) ascending
  const float* pseg;    // (m,)
  const float* pthr;    // (m,) per-probe thresholds, or null: cos_thr
  int* idx;             // (m,) outputs
  float* dot;
  int* cnt;
  float* ws_dot;  // (splits, m) partials, used when splits > 1
  int* ws_idx;
  int* ws_cnt;
  int* counters;  // (gridDim.x,) at 0; the merging block resets its own
  float cos_thr;
  int n, m, splits;
};

// First index in sorted seg[lo, hi) whose value is > v (upper) or >= v.
__device__ int search(const float* seg, int lo, int hi, float v, bool upper) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float s = seg[mid];
    if (upper ? (s <= v) : (s < v)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Bucket rows [base, base + len) into dst: 16 bytes (columns 0..3) a row.
__device__ __forceinline__ void stage(float4* dst, const float4* rows4,
                                      int base, int len) {
  for (int t = threadIdx.x; t < len; t += kSegThreads)
    dst[t] = rows4[static_cast<size_t>(base + t) * (kRowFloats / 4)];
}

// cnt += 1 where d >= t (ordered): a compare and a predicated add.
__device__ __forceinline__ void add_if_at_least(int& cnt, float d, float t) {
  asm("{ .reg .pred p; setp.ge.f32 p, %1, %2; @p add.s32 %0, %0, 1; }"
      : "+r"(cnt)
      : "f"(d), "f"(t));
}

// R dot chains over the staged rows [0, len), the first of which is bucket
// row base: ascending rows, strict > for the best, >= for the count.
template <int R>
__device__ __forceinline__ void walk(const float4* tile, int len, int base,
                                     const float4 (&p)[R],
                                     const float (&thr)[R], float (&best)[R],
                                     int (&arg)[R], int (&cnt)[R]) {
#pragma unroll 8
  for (int t = 0; t < len; ++t) {
    const float4 b = tile[t];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float d = __fmaf_rn(p[r].x, b.x, 0.f);
      d = __fmaf_rn(p[r].y, b.y, d);
      d = __fmaf_rn(p[r].z, b.z, d);
      d = __fmaf_rn(p[r].w, b.w, d);
      if (d > best[r]) {
        best[r] = d;
        arg[r] = base + t;
      }
      add_if_at_least(cnt[r], d, thr[r]);
    }
  }
}

__global__ void __launch_bounds__(kSegThreads)
crossmatch_segment_kernel(const SegmentArgs a) {
  __shared__ float4 tile[kSegTile];
  __shared__ float warp_seg[2][kSegThreads / 32];
  __shared__ float sm_seg_hi, sm_cur;
  __shared__ int sm_next, sm_lo, sm_hi, sm_last;

  const int first = blockIdx.x * kBlockProbes + threadIdx.x * kProbes;
  const int split = blockIdx.y;
  const float4* probes4 = reinterpret_cast<const float4*>(a.probes);
  const float4* rows4 = reinterpret_cast<const float4*>(a.bucket);

  float4 p[kProbes];
  float thr[kProbes], seg[kProbes], best[kProbes];
  int arg[kProbes], cnt[kProbes];
  float seg_lo = CUDART_INF_F, seg_hi = -CUDART_INF_F;
#pragma unroll
  for (int r = 0; r < kProbes; ++r) {
    const int row = first + r;
    const bool live = row < a.m;
    p[r] = live ? probes4[static_cast<size_t>(row) * (kRowFloats / 4)]
                : make_float4(0.f, 0.f, 0.f, 0.f);
    thr[r] = (live && a.pthr != nullptr) ? a.pthr[row] : a.cos_thr;
    seg[r] = live ? a.pseg[row] : CUDART_NAN_F;  // NaN equals no segment
    if (live) {
      seg_lo = fminf(seg_lo, seg[r]);
      seg_hi = fmaxf(seg_hi, seg[r]);
    }
    best[r] = -2.f;
    arg[r] = 0;
    cnt[r] = 0;
  }

  // [min, max] of the block's probe segments; the first bucket row of a
  // segment at or above the min.
  for (int off = 16; off > 0; off >>= 1) {
    seg_lo = fminf(seg_lo, __shfl_xor_sync(0xffffffffu, seg_lo, off));
    seg_hi = fmaxf(seg_hi, __shfl_xor_sync(0xffffffffu, seg_hi, off));
  }
  if ((threadIdx.x & 31) == 0) {
    warp_seg[0][threadIdx.x >> 5] = seg_lo;
    warp_seg[1][threadIdx.x >> 5] = seg_hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSegThreads / 32; ++w) {
      seg_lo = fminf(seg_lo, warp_seg[0][w]);
      seg_hi = fmaxf(seg_hi, warp_seg[1][w]);
    }
    sm_seg_hi = seg_hi;
    sm_next = search(a.bseg, 0, a.n, seg_lo, false);
  }

  // One bucket segment at a time, in ascending order.
  for (;;) {
    __syncthreads();  // the last segment's range is read and its tiles used
    if (threadIdx.x == 0) {
      const int lo = sm_next;
      int hi = -1;
      if (lo < a.n && a.bseg[lo] <= sm_seg_hi) {
        sm_cur = a.bseg[lo];
        hi = search(a.bseg, lo, a.n, sm_cur, true);
        sm_next = hi;
      }
      sm_lo = lo;
      sm_hi = hi;
    }
    __syncthreads();
    const int lo = sm_lo;
    const int seg_end = sm_hi;
    if (seg_end < 0) break;
    const float cur = sm_cur;
    const long long len = seg_end - lo;
    const int r0 = lo + static_cast<int>(len * split / a.splits);
    const int r1 = lo + static_cast<int>(len * (split + 1) / a.splits);

    bool match[kProbes];
    bool any = false, all = true;
#pragma unroll
    for (int r = 0; r < kProbes; ++r) {
      match[r] = seg[r] == cur;
      any = any || match[r];
      all = all && match[r];
    }
    // A thread straddling a segment edge walks all its chains and keeps
    // the matching probes' results only.
    float keep_best[kProbes];
    int keep_arg[kProbes], keep_cnt[kProbes];
#pragma unroll
    for (int r = 0; r < kProbes; ++r) {
      keep_best[r] = best[r];
      keep_arg[r] = arg[r];
      keep_cnt[r] = cnt[r];
    }

    for (int base = r0; base < r1; base += kSegTile) {
      const int n_rows = min(kSegTile, r1 - base);
      __syncthreads();  // the last tile is consumed
      stage(tile, rows4, base, n_rows);
      __syncthreads();
      if (any) walk(tile, n_rows, base, p, thr, best, arg, cnt);
    }

    if (!all) {
#pragma unroll
      for (int r = 0; r < kProbes; ++r) {
        if (!match[r]) {
          best[r] = keep_best[r];
          arg[r] = keep_arg[r];
          cnt[r] = keep_cnt[r];
        }
      }
    }
  }

  if (a.splits == 1) {
#pragma unroll
    for (int r = 0; r < kProbes; ++r) {
      const int row = first + r;
      if (row < a.m) {
        a.idx[row] = arg[r];
        a.dot[row] = best[r];
        a.cnt[row] = cnt[r];
      }
    }
    return;
  }

  // Leave this split's partials; the last split of the probe block merges.
#pragma unroll
  for (int r = 0; r < kProbes; ++r) {
    const int row = first + r;
    if (row < a.m) {
      const size_t k = static_cast<size_t>(split) * a.m + row;
      a.ws_dot[k] = best[r];
      a.ws_idx[k] = arg[r];
      a.ws_cnt[k] = cnt[r];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sm_last = atomicAdd(a.counters + blockIdx.x, 1) == a.splits - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  // The splits in order, each thread its own probes; a split's loads for
  // all of them are in flight together.
  const int n_live = min(kProbes, a.m - first);
#pragma unroll
  for (int r = 0; r < kProbes; ++r) {
    best[r] = -2.f;
    arg[r] = 0;
    cnt[r] = 0;
  }
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s) {
#pragma unroll
    for (int r = 0; r < kProbes; ++r) {
      if (r >= n_live) continue;
      const size_t k = static_cast<size_t>(s) * a.m + first + r;
      const float split_best = __ldcg(a.ws_dot + k);
      const int split_arg = __ldcg(a.ws_idx + k);
      if (split_best > best[r]) {
        best[r] = split_best;
        arg[r] = split_arg;
      }
      cnt[r] += __ldcg(a.ws_cnt + k);
    }
  }
#pragma unroll
  for (int r = 0; r < kProbes; ++r) {
    if (r >= n_live) continue;
    a.idx[first + r] = arg[r];
    a.dot[first + r] = best[r];
    a.cnt[first + r] = cnt[r];
  }
  if (threadIdx.x == 0) a.counters[blockIdx.x] = 0;  // ready for the next call
}

}  // namespace

extern "C" {

// band < 0: no band.  bm, bn shape the band's logical tile grid only.
int crossmatch_launch(const float* bucket, const float* probes, int n, int m,
                      float cos_thr, int band, int bm, int bn, int* idx,
                      float* dot, int* cnt, void* stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  crossmatch_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bucket, probes, n, m, cos_thr, band, bm, bn, idx, dot, cnt);
  return static_cast<int>(cudaGetLastError());
}

// Probe rows a thread and a block of the segment kernel take (the
// wrapper's plan).
int crossmatch_segment_thread_probes() { return kProbes; }
int crossmatch_segment_block_probes() { return kBlockProbes; }

// K2 (pthr null: cos_thr for every probe) and K3.  ws: 3 * splits * m
// words when splits > 1 (f32 dots, then int32 indices and counts);
// counters: ceil(m / block probes) int32 at 0.
int crossmatch_segment_launch(const float* bucket, const float* probes,
                              const float* bseg, const float* pseg,
                              const float* pthr, float cos_thr, int n, int m,
                              int splits, int* idx, float* dot, int* cnt,
                              void* ws, int* counters, void* stream) {
  SegmentArgs a;
  a.bucket = bucket;
  a.probes = probes;
  a.bseg = bseg;
  a.pseg = pseg;
  a.pthr = pthr;
  a.idx = idx;
  a.dot = dot;
  a.cnt = cnt;
  const size_t plane = static_cast<size_t>(splits) * m;
  a.ws_dot = static_cast<float*>(ws);
  a.ws_idx = ws == nullptr ? nullptr : reinterpret_cast<int*>(a.ws_dot + plane);
  a.ws_cnt = ws == nullptr ? nullptr : a.ws_idx + plane;
  a.counters = counters;
  a.cos_thr = cos_thr;
  a.n = n;
  a.m = m;
  a.splits = splits;
  const dim3 grid((m + kBlockProbes - 1) / kBlockProbes, splits);
  crossmatch_segment_kernel<<<grid, kSegThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* crossmatch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
