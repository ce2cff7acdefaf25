// Cross-match joins on Hopper (sm_90a): one kernel template, three
// instantiations, bound to Python through the extern "C" entries below
// (built with nvcc into a shared library and loaded with ctypes).
//
// Each instantiation replaces one Pallas TPU kernel of the JAX reference
// (src/repro/kernels/crossmatch/kernel.py):
//   kPlain  <- crossmatch_pallas        (static cos_thr, optional band skip)
//   kFused  <- crossmatch_fused_pallas  (segment mask, static cos_thr)
//   kShared <- crossmatch_shared_pallas (segment mask, per-probe threshold)
//
// What it computes, for every probe row m of the (M, 8) probe array against
// the (N, 8) bucket array (rows: 3 coordinates, the marker column, zeros):
//   best_dot[m] = max_n dot(m, n)        (init -2)
//   best_idx[m] = lowest n attaining it  (init 0)
//   n_cand[m]   = #{n : dot(m, n) >= threshold}
// Pairs of different segments (kFused, kShared) dot to -2 in the reference;
// -2 never replaces the initial best and never passes a threshold in
// (-2, 1], so such pairs are simply not visited.
//
// Design.  One thread per probe row, kThreads probes a block.  The bucket
// rows the block needs are staged through shared memory in tiles of kTile
// rows (the first four floats of each row as one float4, plus the segment
// id); every thread reads the same staged row at once (a broadcast), and
// keeps its running best, index and count in registers.  The TPU's
// sequential grid axis over bucket tiles becomes this in-block loop.
//   * Dot order: __fmaf_rn over columns 0..3 in order, from 0.  Columns
//     4..7 are zero.  This is the order jnp.dot takes on the CPU, so the
//     dots equal the reference's bit for bit; any other order moves
//     best_dot by an ulp and flips best_idx on near-ties.
//   * Tie rule: rows are scanned in ascending n and only a strictly
//     greater dot replaces the best, which yields the lowest index, as the
//     Pallas kernel's within-tile min-id plus across-tile strict rule does.
//   * Band (kPlain): the TPU kernel skips tile (i, j) of its (M/bm, N/bn)
//     grid when |j - i*n_j/n_i| > band.  Here each row visits exactly the
//     bucket rows of the tiles its logical tile row i keeps.
//   * Segments (kFused, kShared): the bucket is sorted by segment; each
//     block reduces the [min, max] of its own probes' segments and
//     binary-searches the bucket rows whose segment lies in it (the CSR
//     range of that segment span); only those are staged.
//
// Bound on this card: CUDA-core FP32 FMA throughput, 4 FMA per probe x
// visited bucket row (TF32 tensor cores would round away thresholds as
// tight as cos(2e-3) = 0.999998).  Bytes are small: 16 B per bucket row
// staged once per block, 32 B in and 12 B out per probe row.  The kernel
// does no synchronisation with the host and allocates nothing.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;  // probe rows per block
constexpr int kTile = 1024;    // bucket rows staged per pass (16 KiB + 4 KiB)
constexpr int kRowFloats = 8;  // COORD_PAD
constexpr int kWarps = kThreads / 32;

enum Mode { kPlain = 0, kFused = 1, kShared = 2 };

// First index in sorted seg[0, n) whose value is >= v (upper: > v).
__device__ int lower_bound(const float* seg, int n, float v, bool upper) {
  int lo = 0, hi = n;
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

// Bucket rows [*a, *b) of the band tiles that logical tile row i keeps.
__device__ void band_rows(int row, int bm, int bn, int n_i, int n_j,
                          int band, int* a, int* b) {
  const int i = row / bm;
  const int center = (i * n_j) / max(n_i, 1);
  *a = max(center - band, 0) * bn;
  *b = min(center + band + 1, n_j) * bn;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
crossmatch_kernel(const float* __restrict__ bucket,
                  const float* __restrict__ probes,
                  const float* __restrict__ bseg,
                  const float* __restrict__ pseg,
                  const float* __restrict__ pthr, int n, int m, float cos_thr,
                  int band, int bm, int bn, int* __restrict__ out_idx,
                  float* __restrict__ out_dot, int* __restrict__ out_cnt) {
  __shared__ float4 tile[kTile];
  __shared__ float tile_seg[MODE == kPlain ? 1 : kTile];
  __shared__ float warp_lo[kWarps], warp_hi[kWarps];
  __shared__ int block_rows[2];

  const int row0 = blockIdx.x * kThreads;
  const int last = min(row0 + kThreads, m) - 1;
  const int row = row0 + threadIdx.x;
  const bool live = row < m;

  const float4* probes4 = reinterpret_cast<const float4*>(probes);
  const float4 p = live ? probes4[static_cast<size_t>(row) * (kRowFloats / 4)]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  const float thr = MODE == kShared ? (live ? pthr[row] : 2.f) : cos_thr;
  const float my_seg = (MODE != kPlain && live) ? pseg[row] : 0.f;

  // Bucket rows this block visits, and the ones this thread visits.
  int lo = 0, hi = n, my_lo = 0, my_hi = n;
  if (MODE == kPlain) {
    if (band >= 0) {
      const int n_i = m / bm, n_j = n / bn;
      int unused;
      band_rows(row0, bm, bn, n_i, n_j, band, &lo, &unused);
      band_rows(last, bm, bn, n_i, n_j, band, &unused, &hi);
      band_rows(live ? row : last, bm, bn, n_i, n_j, band, &my_lo, &my_hi);
    }
  } else {
    // [min, max] of the block's probe segments, then its bucket-row range.
    float seg_lo = live ? my_seg : CUDART_INF_F;
    float seg_hi = live ? my_seg : -CUDART_INF_F;
    for (int off = 16; off > 0; off >>= 1) {
      seg_lo = fminf(seg_lo, __shfl_xor_sync(0xffffffffu, seg_lo, off));
      seg_hi = fmaxf(seg_hi, __shfl_xor_sync(0xffffffffu, seg_hi, off));
    }
    if ((threadIdx.x & 31) == 0) {
      warp_lo[threadIdx.x >> 5] = seg_lo;
      warp_hi[threadIdx.x >> 5] = seg_hi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        seg_lo = fminf(seg_lo, warp_lo[w]);
        seg_hi = fmaxf(seg_hi, warp_hi[w]);
      }
      block_rows[0] = lower_bound(bseg, n, seg_lo, false);
      block_rows[1] = lower_bound(bseg, n, seg_hi, true);
    }
    __syncthreads();
    lo = block_rows[0];
    hi = block_rows[1];
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
      if (MODE != kPlain) tile_seg[t] = bseg[base + t];
    }
    __syncthreads();
    if (!live) continue;
    const int t0 = max(my_lo - base, 0);
    const int t1 = min(my_hi - base, len);
    for (int t = t0; t < t1; ++t) {
      if (MODE != kPlain && tile_seg[t] != my_seg) continue;
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

template <int MODE>
int launch(const float* bucket, const float* probes, const float* bseg,
           const float* pseg, const float* pthr, int n, int m, float cos_thr,
           int band, int bm, int bn, int* idx, float* dot, int* cnt,
           void* stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  crossmatch_kernel<MODE>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          bucket, probes, bseg, pseg, pthr, n, m, cos_thr, band, bm, bn, idx,
          dot, cnt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// band < 0: no band.  bm, bn shape the band's logical tile grid only.
int crossmatch_launch(const float* bucket, const float* probes, int n, int m,
                      float cos_thr, int band, int bm, int bn, int* idx,
                      float* dot, int* cnt, void* stream) {
  return launch<kPlain>(bucket, probes, nullptr, nullptr, nullptr, n, m,
                        cos_thr, band, bm, bn, idx, dot, cnt, stream);
}

int crossmatch_fused_launch(const float* bucket, const float* probes,
                            const float* bseg, const float* pseg, int n, int m,
                            float cos_thr, int* idx, float* dot, int* cnt,
                            void* stream) {
  return launch<kFused>(bucket, probes, bseg, pseg, nullptr, n, m, cos_thr,
                        -1, 1, 1, idx, dot, cnt, stream);
}

int crossmatch_shared_launch(const float* bucket, const float* probes,
                             const float* bseg, const float* pseg,
                             const float* pthr, int n, int m, int* idx,
                             float* dot, int* cnt, void* stream) {
  return launch<kShared>(bucket, probes, bseg, pseg, pthr, n, m, 0.f, -1, 1,
                         1, idx, dot, cnt, stream);
}

const char* crossmatch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
