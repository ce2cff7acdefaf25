// Cross-match joins on Hopper (sm_90a), bound to Python through the
// extern "C" entries below (built with nvcc into a shared library and
// loaded with ctypes).
//
// One kernel, crossmatch_segment_kernel, replaces the three Pallas TPU
// kernels of the JAX reference (src/repro/kernels/crossmatch/kernel.py),
// one instance a row-range policy (`Rows`):
//   kBucket, kBand <- crossmatch_pallas (:89)         K1, without and with
//                                                      its band
//   kSegment       <- crossmatch_fused_pallas (:248)  K2, one threshold for
//                                                      all probes
//                  <- crossmatch_shared_pallas (:206) K3, a threshold a probe
//
// What it computes, for every probe row m of the (M, 8) probe array
// against the (N, 8) bucket array (rows: 3 coordinates, the marker column,
// zeros):
//   best_dot[m] = max_n dot(m, n)        (init -2)
//   best_idx[m] = lowest n attaining it  (init 0)
//   n_cand[m]   = #{n : dot(m, n) >= threshold}
// over the bucket rows probe m takes part with: K1 the bucket's real rows
// (with a band, those of the tiles its tile row keeps); K2 and K3 the rows
// of its own segment.  The reference dots the other pairs to -2 (marker
// rows, other segments) or skips them (the band's tiles), which never
// replaces the initial best and never passes a threshold in (-2, 1], so
// they are simply not visited.
//
// Dot order: __fmaf_rn over columns 0..3 in order, from 0.  Columns 4..7
// are zero.  This is the order jnp.dot takes on the CPU, so the dots equal
// the reference's bit for bit; any other order moves best_dot by an ulp
// and flips best_idx on near-ties.  The column-3 FMA also turns a -0 into
// +0, so no dot is -0.
// Tie rule: each thread scans its rows in ascending n and only a strictly
// greater dot replaces the best, which yields the lowest index, as the
// Pallas kernel's within-tile min-id plus across-tile strict rule does.
//
// Bound on this card: instruction issue on the FP32 lanes.  A pair costs 4
// FMAs (the 67 TFLOP/s bound counts those) and about 5 more instructions
// on the same 128 lanes an SM: a compare and two selects for the best, a
// compare and an add for the count.  Bytes are small: 16 B a bucket row
// staged once a block, 32 B in and 12 B out a probe row.  TF32 tensor
// cores would round away thresholds as tight as cos(2e-3) = 0.999998, and
// the dot has K = 3.  The kernel neither synchronises with the host nor
// allocates.
//
// Design, built against the issue rate:
//   * kProbes probes a thread, kBlockProbes a block, contiguous.  Each
//     staged row is one broadcast shared load feeding kProbes dot chains.
//   * One row range a probe, which thread 0 resolves for the block:
//     - kSegment: the bucket is sorted by segment, so a segment's rows are
//       one range [lo, hi), found once by binary search; the block walks
//       the bucket segments between the smallest and largest of its
//       probes' segments (one or two when the probes come sorted, as the
//       engine sends them).  A thread whose probes all belong to the
//       segment walks its rows with no per-row test; one whose probes
//       straddle a segment edge walks them too and keeps only its matching
//       probes' results; one with no probe there skips the walk.  Probes
//       in any order stay right, only slower.  A probe whose segment has
//       no rows keeps (0, -2, 0).
//     - kBucket: the bucket's rows [0, rows): the real rows, past which
//       the marker rows dot to exactly -2 (the wrapper passes every row
//       where the threshold is <= -2, since the reference counts them
//       there).  No search and no per-row test.
//     - kBand: probe row r keeps the tiles (i, j) of its tile row i = r /
//       bm with |j - i * n_j / n_i| <= band, on the reference's grid of
//       (bm, bn) tiles over the padded shapes, clipped to [0, rows): one
//       range, growing with r.  The block walks the union of its probes'
//       ranges; a thread whose probes share a range (every thread where
//       bm is a multiple of kProbes) walks its part of each staged tile
//       with no per-row test, one whose probes straddle two tile rows
//       tests every row against each probe's range.
//   * Splits.  Where the probe blocks alone are too few to fill the card,
//     the grid's y axis cuts each range the block walks into `splits`
//     parts: split s walks rows [lo + len*s/splits, lo + len*(s+1)/splits).
//     Each split leaves (best, idx, count) in a workspace; the block that
//     counts last on its probe block's counter (after __threadfence)
//     merges them in split order with a strict > and sums the counts, so
//     the result is the lowest index on ties and the same bits every run,
//     and resets the counter for the next call on the stream.  With one
//     split the block writes the outputs itself.
//   * No padded pairs: the card path hands the kernel only the real probe
//     rows (any M); the bucket's padded rows lie past `rows` (K1) or in
//     segment PAD_SEG past every real segment (K2/K3).  Padded probes, if
//     given, are joined like any other probe, as the reference does.
//   * Issue count.  A pair costs 4 FFMA, a compare and two selects for
//     the best, and a compare and a predicated add for the count (C++'s
//     `cnt += d >= t` compiles to an add and a predicated move back, one
//     more).  The row loop is unrolled 8 times.  cm_tune.py keeps the
//     other forms as variants: C++'s count, a count by a `set` (one
//     instruction fewer than C++'s but with a select on the half-rate ALU
//     pipe; slower), an unroll of 4.
//   * Staging: tiles of kSegTile rows, loaded between two barriers.  A
//     double-buffered cp.async ring measured no faster (cm_tune.py keeps
//     it as a variant): a block's part of a range is about one tile at
//     the main path's shapes, and several blocks share an SM.
//   * Counting build.  Compiled with CROSSMATCH_COUNT_PAIRS defined, the
//     kernel also counts, on the card, the pairs its threads dot (one a
//     dot chain a row, dead chains included) and the largest split count
//     launched; crossmatch_count_read returns and resets both.  chip_smoke.py
//     builds that copy to measure the pairs each join walks.  Without the
//     define the count compiles to nothing.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRowFloats = 8;  // COORD_PAD
constexpr int kSegThreads = 128;
constexpr int kProbes = 2;  // probes a thread (cm_tune.py sweeps it)
constexpr int kBlockProbes = kSegThreads * kProbes;
constexpr int kSegTile = 1024;  // bucket rows a stage (16 KiB)

#ifdef CROSSMATCH_COUNT_PAIRS
__device__ unsigned long long g_pairs_walked;
__device__ unsigned int g_splits_launched;
#define COUNT_PAIR(n) (++(n))
#else
#define COUNT_PAIR(n) ((void)0)
#endif

// The bucket rows a probe takes part with: its segment's (K2/K3), the
// bucket's (K1), or its band's (K1 with band).
enum class Rows { kSegment, kBucket, kBand };

struct SegmentArgs {
  const float* bucket;  // (n, 8); kSegment: rows sorted by segment
  const float* probes;  // (m, 8)
  const float* bseg;    // kSegment: (n,) ascending
  const float* pseg;    // kSegment: (m,)
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
  // K1: bucket rows [0, rows) take part; kBand keeps those of the tiles
  // (i, j) of the (n_i, n_j) grid of (bm, bn) tiles with
  // |j - i * n_j / n_i| <= band.
  int rows, band, bm, bn, n_i, n_j;
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

// K1: the bucket rows [lo, hi) that probe row `row` takes part with.
template <Rows kRows>
__device__ __forceinline__ void probe_rows(const SegmentArgs& a, int row,
                                           int& lo, int& hi) {
  if (kRows != Rows::kBand) {
    lo = 0;
    hi = a.rows;
    return;
  }
  const int center = static_cast<int>(static_cast<long long>(row / a.bm) *
                                      a.n_j / max(a.n_i, 1));
  const int tile_hi = min(center + a.band + 1, a.n_j);
  lo = min(max(center - a.band, 0) * a.bn, a.rows);
  hi = min(tile_hi * a.bn, a.rows);
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
// row base: ascending rows, strict > for the best, >= for the count.  With
// kBounded, chain r takes only the rows in [lo[r], hi[r]).  `pairs` counts
// the dots in a counting build.
template <int R, bool kBounded>
__device__ __forceinline__ void walk(const float4* tile, int len, int base,
                                     const float4 (&p)[R],
                                     const float (&thr)[R], const int (&lo)[R],
                                     const int (&hi)[R], float (&best)[R],
                                     int (&arg)[R], int (&cnt)[R], int& pairs) {
#pragma unroll 8
  for (int t = 0; t < len; ++t) {
    const float4 b = tile[t];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (kBounded && (base + t < lo[r] || base + t >= hi[r])) continue;
      COUNT_PAIR(pairs);
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

template <Rows kRows>
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
  int arg[kProbes], cnt[kProbes], lo_r[kProbes], hi_r[kProbes];
  int pairs = 0;  // dots of this thread, in a counting build
  float seg_lo = CUDART_INF_F, seg_hi = -CUDART_INF_F;
#pragma unroll
  for (int r = 0; r < kProbes; ++r) {
    const int row = first + r;
    const bool live = row < a.m;
    p[r] = live ? probes4[static_cast<size_t>(row) * (kRowFloats / 4)]
                : make_float4(0.f, 0.f, 0.f, 0.f);
    thr[r] = (live && a.pthr != nullptr) ? a.pthr[row] : a.cos_thr;
    seg[r] = CUDART_NAN_F;  // NaN equals no segment
    lo_r[r] = hi_r[r] = 0;
    if (kRows == Rows::kSegment) {
      if (live) {
        seg[r] = a.pseg[row];
        seg_lo = fminf(seg_lo, seg[r]);
        seg_hi = fmaxf(seg_hi, seg[r]);
      }
    } else {
      // A probe past the last takes the first's range.
      probe_rows<kRows>(a, live ? row : first, lo_r[r], hi_r[r]);
    }
    best[r] = -2.f;
    arg[r] = 0;
    cnt[r] = 0;
  }
  // K1: whether this thread's probes share one range.
  bool same = true;
#pragma unroll
  for (int r = 1; r < kProbes; ++r)
    same = same && lo_r[r] == lo_r[0] && hi_r[r] == hi_r[0];

  if (kRows == Rows::kSegment) {
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
  } else if (threadIdx.x == 0) {
    sm_next = 0;
  }

  // The block's ranges one at a time: K2/K3 the bucket segments in
  // ascending order, K1 one.
  for (;;) {
    __syncthreads();  // the last range is read and its tiles used
    if (threadIdx.x == 0) {
      int lo = 0, hi = -1;  // hi < 0: no range left
      if (kRows == Rows::kSegment) {
        lo = sm_next;
        if (lo < a.n && a.bseg[lo] <= sm_seg_hi) {
          sm_cur = a.bseg[lo];
          hi = search(a.bseg, lo, a.n, sm_cur, true);
          sm_next = hi;
        }
      } else if (sm_next == 0) {
        // The union of the block's probes' ranges, which grow with the row.
        const int b0 = blockIdx.x * kBlockProbes;
        int unused;
        probe_rows<kRows>(a, b0, lo, unused);
        probe_rows<kRows>(a, min(b0 + kBlockProbes, a.m) - 1, unused, hi);
        sm_next = 1;
      }
      sm_lo = lo;
      sm_hi = hi;
    }
    __syncthreads();
    const int lo = sm_lo;
    const int seg_end = sm_hi;
    if (seg_end < 0) break;
    const long long len = seg_end - lo;
    const int r0 = lo + static_cast<int>(len * split / a.splits);
    const int r1 = lo + static_cast<int>(len * (split + 1) / a.splits);

    // The chains that take part: K1 every live probe, each over its own
    // rows; K2/K3 the probes of this segment.  A thread straddling a
    // segment edge walks all its chains and keeps the matching probes'
    // results only.
    bool match[kProbes];
    bool any = first < a.m, all = true;
    if (kRows == Rows::kSegment) {
      const float cur = sm_cur;
      any = false;
#pragma unroll
      for (int r = 0; r < kProbes; ++r) {
        match[r] = seg[r] == cur;
        any = any || match[r];
        all = all && match[r];
      }
    }
    float keep_best[kProbes];
    int keep_arg[kProbes], keep_cnt[kProbes];
#pragma unroll
    for (int r = 0; r < kProbes; ++r) {
      keep_best[r] = best[r];
      keep_arg[r] = arg[r];
      keep_cnt[r] = cnt[r];
    }

    // This thread's part of the staged rows [base, base + n_rows).
    auto visit = [&](const float4* staged, int n_rows, int base) {
      if (kRows == Rows::kBand && !same) {
        walk<kProbes, true>(staged, n_rows, base, p, thr, lo_r, hi_r, best,
                            arg, cnt, pairs);
        return;
      }
      const bool k1 = kRows != Rows::kSegment;
      const int t0 = k1 ? max(lo_r[0] - base, 0) : 0;
      const int t1 = k1 ? min(hi_r[0] - base, n_rows) : n_rows;
      if (t0 < t1)
        walk<kProbes, false>(staged + t0, t1 - t0, base + t0, p, thr, lo_r,
                             hi_r, best, arg, cnt, pairs);
    };
    for (int base = r0; base < r1; base += kSegTile) {
      const int n_rows = min(kSegTile, r1 - base);
      __syncthreads();  // the last tile is consumed
      stage(tile, rows4, base, n_rows);
      __syncthreads();
      if (any) visit(tile, n_rows, base);
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
#ifdef CROSSMATCH_COUNT_PAIRS
  if (pairs > 0)
    atomicAdd(&g_pairs_walked, static_cast<unsigned long long>(pairs));
  if (threadIdx.x == 0) atomicMax(&g_splits_launched, gridDim.y);
#endif

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

// The arguments every launch sets.  ws: 3 * splits * m words when splits >
// 1 (f32 dots, then int32 indices and counts); counters: ceil(m / block
// probes) int32 at 0.
SegmentArgs launch_args(const float* bucket, const float* probes,
                        float cos_thr, int m, int splits, int* idx, float* dot,
                        int* cnt, void* ws, int* counters) {
  SegmentArgs a{};
  a.bucket = bucket;
  a.probes = probes;
  a.idx = idx;
  a.dot = dot;
  a.cnt = cnt;
  const size_t plane = static_cast<size_t>(splits) * m;
  a.ws_dot = static_cast<float*>(ws);
  a.ws_idx = ws == nullptr ? nullptr : reinterpret_cast<int*>(a.ws_dot + plane);
  a.ws_cnt = ws == nullptr ? nullptr : a.ws_idx + plane;
  a.counters = counters;
  a.cos_thr = cos_thr;
  a.m = m;
  a.splits = splits;
  return a;
}

template <Rows kRows>
int launch(const SegmentArgs& a, void* stream) {
  const dim3 grid((a.m + kBlockProbes - 1) / kBlockProbes, a.splits);
  crossmatch_segment_kernel<kRows>
      <<<grid, kSegThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Probe rows a thread and a block of the kernel take (the wrapper's plan).
int crossmatch_segment_thread_probes() { return kProbes; }
int crossmatch_segment_block_probes() { return kBlockProbes; }

// K1: bucket rows [0, rows) against every probe; band < 0: no band, else
// (bm, bn) tiles of an (n_i, n_j) grid.  ws and counters as above.
int crossmatch_launch(const float* bucket, const float* probes, float cos_thr,
                      int rows, int m, int band, int bm, int bn, int n_i,
                      int n_j, int splits, int* idx, float* dot, int* cnt,
                      void* ws, int* counters, void* stream) {
  SegmentArgs a = launch_args(bucket, probes, cos_thr, m, splits, idx, dot,
                              cnt, ws, counters);
  a.n = a.rows = rows;
  a.band = band;
  a.bm = bm;
  a.bn = bn;
  a.n_i = n_i;
  a.n_j = n_j;
  return band < 0 ? launch<Rows::kBucket>(a, stream)
                  : launch<Rows::kBand>(a, stream);
}

// K2 (pthr null: cos_thr for every probe) and K3.  ws and counters as
// above.
int crossmatch_segment_launch(const float* bucket, const float* probes,
                              const float* bseg, const float* pseg,
                              const float* pthr, float cos_thr, int n, int m,
                              int splits, int* idx, float* dot, int* cnt,
                              void* ws, int* counters, void* stream) {
  SegmentArgs a = launch_args(bucket, probes, cos_thr, m, splits, idx, dot,
                              cnt, ws, counters);
  a.bseg = bseg;
  a.pseg = pseg;
  a.pthr = pthr;
  a.n = n;
  return launch<Rows::kSegment>(a, stream);
}

#ifdef CROSSMATCH_COUNT_PAIRS
// The counting build's pairs dotted and largest split count since the last
// read; waits for the card, then sets both back to 0.
int crossmatch_count_read(unsigned long long* pairs, unsigned int* splits) {
  const unsigned long long zero = 0;
  const unsigned int zero32 = 0;
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(pairs, g_pairs_walked, sizeof(*pairs));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(splits, g_splits_launched, sizeof(*splits));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_pairs_walked, &zero, sizeof(zero));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_splits_launched, &zero32, sizeof(zero32));
  return static_cast<int>(e);
}
#endif

const char* crossmatch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
