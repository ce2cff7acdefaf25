// Ragged grouped matmul on Hopper (sm_90a), bound to Python through the
// extern "C" entries below (built with nvcc into a shared library and
// loaded with ctypes).
//
// Replaces the Pallas TPU kernel grouped_matmul_pallas of the JAX reference
// (src/repro/kernels/grouped_matmul/kernel.py:48, body _kernel :26).  What
// it computes, for x (T, d) with T a whole number of bt-row tiles, the
// per-tile group ids tile_gid (T / bt,) and the group weights w (G, d, f):
//   y[r] = x[r] @ w[tile_gid[r / bt]]
// with the sum over d in f32 and y cast to x's type once, at the end
// (kernel.py:40-41).  Rows arrive group-sorted with tile-aligned group
// boundaries (the MoE capacity layout), so every row tile has one group.
//
// Design.  One block computes one (row tile, column tile) of y.  Its row
// tile divides bt, so the block reads its group id once from tile_gid in
// device memory (the TPU's scalar prefetch) and uses that one weight
// matrix.  The depth d is a loop inside the block (the sequential grid
// axis of the Pallas kernel) and the sums stay in registers.  The ragged
// edges of d and f are loaded as zeros, so no padded copy of x or w is
// made (the reference pads w to its block widths on every call).  Blocks
// run column tiles fastest, so the blocks of one row tile, which share its
// x slice, and those of one group, which share its w, are resident
// together and meet in the 50 MB L2 rather than in device memory.
//
//  * bfloat16: tensor cores through nvcuda::wmma, 16x16x16 bf16 fragments
//    into f32 accumulators.  A block of 8 warps owns a 128 x 128 output
//    tile (each warp 64 x 32, 4 x 2 fragments) and stages x's 128 x 32 and
//    w's 32 x 128 slices through shared memory, double-buffered: the next
//    slice is loaded into registers while the tensor cores work on this
//    one.  16-byte loads where d and f are multiples of 8, else one
//    element at a time.
//  * float32: CUDA-core FMA, no TF32 (the reference checks f32 to 1e-5).
//    A block of 256 threads owns a 64 x 64 output tile, 4 x 4 a thread,
//    through 16-deep shared-memory slices.
//
// Bound on this card.  At the MoE decode shapes (T = 16,384 capacity rows
// of 64 experts, d = 2048, f = 1408, bf16) a call does 94.5 GFLOP on
// 482 MB: 0.096 ms of bf16 tensor-core work and 0.144 ms of memory, so it
// is bound by bytes, nearly all of them the experts' weights.  This first
// version keeps every weight byte read from device memory once (the L2
// order above) but does not keep enough loads in flight to reach that:
// no cp.async/TMA ring and no wgmma, which a later change adds.  A group
// id outside [0, G) makes the block write NaN to its tile instead of
// reading out of bounds.  The kernels do no synchronisation with the host
// and allocate nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

// ---------------------------------------------------------------- bf16
constexpr int kBM = 128;  // rows of a block's tile (divides bt)
constexpr int kBN = 128;  // columns
constexpr int kBK = 32;   // depth of a shared-memory slice
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = kWarpsM * kWarpsN * 32;
constexpr int kWM = kBM / kWarpsM;  // 64 rows a warp
constexpr int kWN = kBN / kWarpsN;  // 32 columns a warp
constexpr int kFM = kWM / 16;
constexpr int kFN = kWN / 16;
constexpr int kALd = kBK + 8;  // row pitch (elements) of the x slice
constexpr int kBLd = kBN + 8;  // of the w slice
constexpr int kAVecs = kBM * kBK / 8 / kThreads;  // 16-byte loads a thread
constexpr int kBVecs = kBK * kBN / 8 / kThreads;

// bf16 bit patterns; wmma reads them as __nv_bfloat16.
struct __align__(128) BfTiles {
  uint16_t a[2][kBM * kALd];
  uint16_t b[2][kBK * kBLd];
  float stage[kThreads / 32][16 * 16];  // one accumulator tile a warp
};

__device__ __forceinline__ const __nv_bfloat16* as_bf16(const uint16_t* p) {
  return reinterpret_cast<const __nv_bfloat16*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Eight consecutive bf16 of p, of which the first `valid` are read and the
// rest are zero.  With kVec, valid is 0 or >= 8 and p is 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ uint4 load8(const uint16_t* p, int valid) {
  if (kVec) {
    return valid >= 8 ? *reinterpret_cast<const uint4*>(p)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
  uint16_t h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = e < valid ? p[e] : uint16_t(0);
  return make_uint4(h[0] | (uint32_t(h[1]) << 16), h[2] | (uint32_t(h[3]) << 16),
                    h[4] | (uint32_t(h[5]) << 16), h[6] | (uint32_t(h[7]) << 16));
}

// Two blocks an SM: registers capped at 128 a thread (ptxas gives 132
// uncapped, which leaves one block an SM; the cap was faster at the MoE
// shapes, with identical results).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    gmm_bf16(const uint16_t* __restrict__ x, const int* __restrict__ tile_gid,
             const uint16_t* __restrict__ w, __nv_bfloat16* __restrict__ y,
             int d, int f, int G, int bt) {
  __shared__ BfTiles s;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int n0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBM;
  const int g = tile_gid[row0 / bt];
  if (g < 0 || g >= G) {
    for (int e = tid; e < kBM * kBN; e += kThreads) {
      const int c = n0 + (e % kBN);
      if (c < f) y[size_t(row0 + e / kBN) * f + c] = __float2bfloat16(CUDART_NAN_F);
    }
    return;
  }
  const uint16_t* wg = w + size_t(g) * d * f;

  uint4 ra[kAVecs], rb[kBVecs];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
      ra[i] = load8<kVec>(x + size_t(row0 + r) * d + k0 + c, d - (k0 + c));
    }
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kBN / 8), c = (v % (kBN / 8)) * 8;
      const int valid = k0 + r < d ? f - (n0 + c) : 0;
      rb[i] = load8<kVec>(wg + size_t(k0 + r) * f + n0 + c, valid);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(&s.a[buf][r * kALd + c]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kBN / 8), c = (v % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(&s.b[buf][r * kBLd + c]) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (d + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          af[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          bf[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(
            af[i], as_bf16(&s.a[cur][(wm * kWM + i * 16) * kALd + kk]), kALd);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(
            bf[j], as_bf16(&s.b[cur][kk * kBLd + wn * kWN + j * 16]), kBLd);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier.
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  // Epilogue: each accumulator tile through the warp's staging tile, cast
  // to bf16 once, eight columns a lane.
  float* st = s.stage[warp];
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = row0 + wm * kWM + i * 16 + r;
      const int col = n0 + wn * kWN + j * 16 + c;
      __nv_bfloat16* out = y + size_t(row) * f + col;
      const float* v = st + r * 16 + c;
      if (kVec && col < f) {
        *reinterpret_cast<uint4*>(out) =
            make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                       pack2(v[4], v[5]), pack2(v[6], v[7]));
      } else if (!kVec) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < f) out[e] = __float2bfloat16(v[e]);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------- f32
constexpr int kFBM = 64;
constexpr int kFBN = 64;
constexpr int kFBK = 16;
constexpr int kFThreads = 256;  // 16 x 16, each 4 x 4 outputs

__global__ void __launch_bounds__(kFThreads)
    gmm_f32(const float* __restrict__ x, const int* __restrict__ tile_gid,
            const float* __restrict__ w, float* __restrict__ y, int d, int f,
            int G, int bt) {
  __shared__ float as[kFBK][kFBM + 4];  // x slice, depth-major
  __shared__ float bs[kFBK][kFBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kFBN;
  const int row0 = blockIdx.y * kFBM;
  const int g = tile_gid[row0 / bt];
  if (g < 0 || g >= G) {
    for (int e = tid; e < kFBM * kFBN; e += kFThreads) {
      const int c = n0 + (e % kFBN);
      if (c < f) y[size_t(row0 + e / kFBN) * f + c] = CUDART_NAN_F;
    }
    return;
  }
  const float* wg = w + size_t(g) * d * f;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += kFBK) {
#pragma unroll
    for (int i = 0; i < kFBM * kFBK / kFThreads; ++i) {
      const int e = tid + i * kFThreads;
      const int ar = e / kFBK, ac = e % kFBK;
      as[ac][ar] = k0 + ac < d ? x[size_t(row0 + ar) * d + k0 + ac] : 0.0f;
      const int br = e / kFBN, bc = e % kFBN;
      bs[br][bc] = (k0 + br < d && n0 + bc < f)
                       ? wg[size_t(k0 + br) * f + n0 + bc]
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < f) y[size_t(row0 + ty + 16 * i) * f + col] = acc[i][j];
    }
}

}  // namespace

extern "C" {

// Rows of a block's tile, by dtype: bt must be a multiple of it.
int grouped_matmul_row_tile(int dtype) { return dtype == 1 ? kBM : kFBM; }

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it).  vec: d and f
// are multiples of 8 and x, w, y are 16-byte aligned (bf16 only).
// T must be a positive multiple of bt, and bt of the row tile.
int grouped_matmul_launch(const void* x, const int* tile_gid, const void* w,
                          void* y, int T, int d, int f, int G, int bt,
                          int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((f + kBN - 1) / kBN, T / kBM);
    const auto* xb = static_cast<const uint16_t*>(x);
    const auto* wb = static_cast<const uint16_t*>(w);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    if (vec) {
      gmm_bf16<true><<<grid, kThreads, 0, st>>>(xb, tile_gid, wb, yb, d, f, G, bt);
    } else {
      gmm_bf16<false><<<grid, kThreads, 0, st>>>(xb, tile_gid, wb, yb, d, f, G, bt);
    }
  } else {
    const dim3 grid((f + kFBN - 1) / kFBN, T / kFBM);
    gmm_f32<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(x), tile_gid, static_cast<const float*>(w),
        static_cast<float*>(y), d, f, G, bt);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* grouped_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
