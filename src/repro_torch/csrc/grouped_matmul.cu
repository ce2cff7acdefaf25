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
// Rows taken as zero.  An optional tile_rows (T / bt,) says how many
// leading rows of each bt-row tile are real: the result is that of the
// call on x with the other rows set to zero, and those rows of y are
// written as +0.  A block whose rows all lie past the count reads nothing
// and writes zeros, so a tile with no real row never reads its group's
// weights; inside a computed block the rows past the count are zeroed in
// the epilogue.  At the MoE decode, 8 tokens x top-6 fill at most 48 of the
// 16,384 capacity rows, and most experts get no token at all.
//
// Design.  One block computes one (row tile, column tile) of y.  Its row
// tile divides bt, so the block reads its group id once from tile_gid in
// device memory (the TPU's scalar prefetch) and uses that one weight
// matrix.  The depth d is a loop inside the block (the sequential grid
// axis of the Pallas kernel) and the sums stay in registers.  Blocks run
// column tiles fastest, so the blocks of one row tile, which share its x
// slice, and those of one group, which share its w, are resident together
// and meet in the 50 MB L2 rather than in device memory.
//
//  * bfloat16, d and f multiples of 8 (gmm_bf16_tma): a 128 x 128 output
//    tile, warp-specialised.  One producer warp keeps a ring of kStages
//    stages in dynamic shared memory filled by TMA (x as 64-row x 64-deep
//    boxes, w as 64-deep x 64-column boxes, both 128-byte swizzled; the
//    tensor maps' zero fill covers the ragged edges of d and f), each
//    stage completing on an mbarrier.  Two consumer warpgroups, 64 rows
//    each, issue wgmma.mma_async m64n128k16 (bf16 into f32 accumulators in
//    registers; w is N-contiguous, so B's descriptor takes the MN-major
//    128-byte-swizzled layout with the transpose bit set) and release a
//    stage once the next stage's products are issued.  The sums run over d
//    in ascending 16-deep steps; a block with at most 64 real rows runs
//    one warpgroup (and loads 64 rows of x), the other writes zeros.  K5's
//    dX (dy times each group's w^T) is the instance with kWKMajor: it
//    reads the forward's w through a tensor map over the same memory,
//    boxes 64 deep x 64 columns along w's contiguous f, as a K-major B
//    (transpose bit clear), so no transposed copy of the weights is made.
//  * bfloat16 that TMA cannot describe (d or f not a multiple of 8, or an
//    unaligned base; gmm_bf16_elem): tensor cores through nvcuda::wmma,
//    16x16x16 fragments, 8 warps on a 128 x 128 tile, element loads with
//    the ragged edges zeroed, double-buffered shared-memory slices.
//  * float32 (gmm_f32): CUDA-core FMA, no TF32 (the reference checks f32 to
//    1e-5).  A block of 256 threads owns a 64 x 64 output tile, 4 x 4 a
//    thread, through 16-deep shared-memory slices.
//  The wrapper picks the kernel by dtype and shape (kernel_path), never
//  because a build or launch failed.
//
// Bound on this card.  At the MoE expert shapes with every row real (T =
// 16,384 capacity rows of 64 experts, d = 2048, f = 1408, bf16) a call
// does 94.5 GFLOP on 482 MB: 0.096 ms of bf16 tensor-core work and 0.144
// ms of memory, so it is bound by bytes, nearly all of them the experts'
// weights.  The ring keeps up to kStages x 32 KB in flight a block.  What
// holds that call back is the weight stream: each 64 x 64 box of w is
// fetched by the blocks of both row tiles of its group (they meet in L2)
// in 128-byte rows, and the stream runs below the memory's rate; a
// persistent grid and a block over both row tiles (w fetched once) were
// tried and were slower at the decode call below (PERF.md).  At decode,
// with tile_rows, the bytes it must move are the weights of the experts
// that got a token, their used row tiles of x and y written whole; there
// the kernel streams near the rate a plain copy reaches.  A group id outside
// [0, G) makes the block write NaN to its tile (whatever its row count)
// instead of reading out of bounds.  The kernels do no synchronisation
// with the host and allocate nothing.
#include <cuda.h>  // CUtensorMap and the driver's types; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>
#include <stdio.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 128;  // rows of a bf16 block's tile (divides bt)
constexpr int kBN = 128;  // its columns (one wgmma's n in gmm_bf16_tma)

// Real rows of the block's kBM-row slice starting at row0 of its bt-row
// tile t: the tile's count minus the rows of the tile before row0.
__device__ __forceinline__ int block_rows(const int* tile_rows, int t,
                                          int row0, int bt, int rows) {
  if (tile_rows == nullptr) return rows;
  return min(max(tile_rows[t] - (row0 - t * bt), 0), rows);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Rows [r0, r1) x columns [n0, n0 + kBN) of a bf16 y set to `bits` (a bf16
// bit pattern), columns past f left alone.  kVec: f % 8 == 0 and y is
// 16-byte aligned, so eight columns go in one store.
template <bool kVec>
__device__ __forceinline__ void fill_bf16(__nv_bfloat16* y, int r0, int r1,
                                          int n0, int f, uint16_t bits,
                                          int tid, int nthreads) {
  if (kVec) {
    const uint32_t b2 = bits | (uint32_t(bits) << 16);
    const uint4 v = make_uint4(b2, b2, b2, b2);
    for (int e = tid; e < (r1 - r0) * (kBN / 8); e += nthreads) {
      const int c = n0 + (e % (kBN / 8)) * 8;
      if (c < f)
        *reinterpret_cast<uint4*>(y + size_t(r0 + e / (kBN / 8)) * f + c) = v;
    }
  } else {
    const __nv_bfloat16 v = __ushort_as_bfloat16(bits);
    for (int e = tid; e < (r1 - r0) * kBN; e += nthreads) {
      const int c = n0 + (e % kBN);
      if (c < f) y[size_t(r0 + e / kBN) * f + c] = v;
    }
  }
}

constexpr uint16_t kBf16Nan = 0x7FC0;

// ------------------------------------------------------- bf16: TMA + wgmma
constexpr int kBK = 64;        // depth of a stage: 128 bytes of bf16
constexpr int kStages = 6;     // ring depth: 192 KB of the SM's 227 KB
constexpr int kConsumers = 2;  // warpgroups, 64 rows each
constexpr int kTmaThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kXBox = 64 * kBK * 2;  // one 64-row x box: 8 KB
constexpr int kWBox = kBK * 64 * 2;  // one 64-column w box: 8 KB
constexpr int kStageBytes = kConsumers * kXBox + (kBN / 64) * kWBox;
constexpr int kTmaSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

// x (A, 64 rows x 16 deep): K-major, each row 128 bytes of depth, 8-row
// swizzle atoms 1024 bytes apart; a 16-deep step moves 32 bytes along the
// row.  w (B, 16 deep x 128 columns): MN-major, each depth row 128 bytes
// (64 columns) of one box, 8-row atoms 1024 bytes apart (SBO), the second
// 64 columns one box (8 KB) on (LBO); a 16-deep step is 16 rows, 2 KB.
constexpr uint32_t kALbo = 16, kASbo = 1024;
constexpr uint32_t kBLbo = kWBox, kBSbo = 1024;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16, bf16) * B (16 x 128, bf16).  kTransA /
// kTransB are wgmma's transpose immediates: 0 reads the operand K-major
// (its depth contiguous), 1 MN-major (its rows or columns contiguous).
// K5's forward reads x K-major and w MN-major (0, 1); its dX instance
// reads w K-major (0, 0); the dW kernel reads both MN-major (1, 1).
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(kTransA), "n"(kTransB));
}

// tmx: x as (T rows, d) with 64 x 64 boxes; tmw: w with 1 x 64 x 64 boxes;
// both 128-byte swizzled with zero fill past the edges.  kWKMajor false:
// w is (G, d, f), a box 64 deep x 64 columns, read MN-major (the forward).
// kWKMajor true: w is stored (G, f, d), the transpose of the weights this
// call multiplies by (dX = dy w^T reads the forward's w untransposed), a
// box 64 columns (rows of the stored w) x 64 deep, read K-major: the same
// products in the same order, so the result equals the call on a
// contiguous copy of w^T bit for bit.
template <bool kWKMajor>
__global__ void __launch_bounds__(kTmaThreads, 1)
    gmm_bf16_tma(const __grid_constant__ CUtensorMap tmx,
                 const __grid_constant__ CUtensorMap tmw,
                 const int* __restrict__ tile_gid,
                 const int* __restrict__ tile_rows,
                 __nv_bfloat16* __restrict__ y, int d, int f, int G, int bt) {
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBM;
  const int t = row0 / bt;
  const int g = tile_gid[t];
  if (g < 0 || g >= G) {
    fill_bf16<true>(y, row0, row0 + kBM, n0, f, kBf16Nan, tid, kTmaThreads);
    return;
  }
  const int rows = block_rows(tile_rows, t, row0, bt, kBM);
  if (rows == 0) {
    fill_bf16<true>(y, row0, row0 + kBM, n0, f, 0, tid, kTmaThreads);
    return;
  }
  const int nwg = rows > 64 ? 2 : 1;  // consumer warpgroups with real rows

  // Stages on 1024-byte boundaries (the 128-byte swizzle's atom), then
  // the full and empty barriers of each stage.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t bars = ring + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  auto xbox = [&](int s, int h) { return ring + s * kStageBytes + h * kXBox; };
  auto wbox = [&](int s, int j) {
    return ring + s * kStageBytes + kConsumers * kXBox + j * kWBox;
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), nwg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nk = (d + kBK - 1) / kBK;
  const int wg = tid / 128;
  if (wg == kConsumers) {
    // Producer warp: one lane keeps the ring full.
    if (tid == kConsumers * 128) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tmx))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tmw))
                   : "memory");
      const int bytes = nwg * kXBox + (kBN / 64) * kWBox;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), bytes);
        for (int h = 0; h < nwg; ++h)
          tma_load_2d(xbox(s, h), &tmx, kt * kBK, row0 + 64 * h, full(s));
        for (int j = 0; j < kBN / 64; ++j) {
          if (kWKMajor)
            tma_load_3d(wbox(s, j), &tmw, kt * kBK, n0 + 64 * j, g, full(s));
          else
            tma_load_3d(wbox(s, j), &tmw, n0 + 64 * j, kt * kBK, g, full(s));
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the tile.
  const int lane = tid & 31, warp = (tid & 127) >> 5;
  const int r_lo = 64 * wg + 16 * warp + (lane >> 2);  // and r_lo + 8
  if (wg >= nwg) {
    fill_bf16<true>(y, row0 + 64 * wg, row0 + 64 * wg + 64, n0, f, 0,
                    tid & 127, 128);
    return;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  acc_fence(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full(s), (kt / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t a = gmma_desc(xbox(s, wg) + 32 * kk, kALbo, kASbo);
      // K-major w: each of the 128 columns one 128-byte line of depth, as
      // x's rows (the two boxes adjoin, so 8-column atoms stay 1 KB apart)
      if (kWKMajor)
        wgmma_m64n128k16<0, 0>(acc, a,
                               gmma_desc(wbox(s, 0) + 32 * kk, kALbo, kASbo));
      else
        wgmma_m64n128k16<0, 1>(acc, a,
                               gmma_desc(wbox(s, 0) + 2048 * kk, kBLbo, kBSbo));
    }
    wgmma_commit();
    acc_fence(acc);
    // The previous stage's products are done: hand its buffers back.
    wgmma_wait<1>();
    acc_fence(acc);
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(empty((kt - 1) % kStages));
  }
  wgmma_wait<0>();
  acc_fence(acc);

  // Epilogue: accumulator 4 i + {0, 1} of lane l holds row r_lo, columns
  // 8 i + 2 (l % 4) + {0, 1}; 4 i + {2, 3} row r_lo + 8.  Rows past the
  // count are written as +0; one cast to bf16.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    const bool real = r < rows;
    __nv_bfloat16* out = y + size_t(row0 + r) * f;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * (lane & 3);
      if (col < f) {
        const float a = real ? acc[4 * i + 2 * half] : 0.0f;
        const float b = real ? acc[4 * i + 2 * half + 1] : 0.0f;
        *reinterpret_cast<uint32_t*>(out + col) = pack2(a, b);
      }
    }
  }
}

// ------------------------------------------------ bf16: element loads
constexpr int kEK = 32;  // depth of a shared-memory slice
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = kWarpsM * kWarpsN * 32;
constexpr int kWM = kBM / kWarpsM;  // 64 rows a warp
constexpr int kWN = kBN / kWarpsN;  // 32 columns a warp
constexpr int kFM = kWM / 16;
constexpr int kFN = kWN / 16;
constexpr int kALd = kEK + 8;  // row pitch (elements) of the x slice
constexpr int kBLd = kBN + 8;  // of the w slice
constexpr int kAVecs = kBM * kEK / 8 / kThreads;  // 8-element groups a thread
constexpr int kBVecs = kEK * kBN / 8 / kThreads;

// bf16 bit patterns; wmma reads them as __nv_bfloat16.
struct __align__(128) BfTiles {
  uint16_t a[2][kBM * kALd];
  uint16_t b[2][kEK * kBLd];
  float stage[kThreads / 32][16 * 16];  // one accumulator tile a warp
};

__device__ __forceinline__ const __nv_bfloat16* as_bf16(const uint16_t* p) {
  return reinterpret_cast<const __nv_bfloat16*>(p);
}

// Eight consecutive bf16 of p, of which the first `valid` are read and the
// rest are zero.
__device__ __forceinline__ uint4 load8(const uint16_t* p, int valid) {
  uint16_t h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = e < valid ? p[e] : uint16_t(0);
  return make_uint4(h[0] | (uint32_t(h[1]) << 16), h[2] | (uint32_t(h[3]) << 16),
                    h[4] | (uint32_t(h[5]) << 16), h[6] | (uint32_t(h[7]) << 16));
}

__global__ void __launch_bounds__(kThreads, 2)
    gmm_bf16_elem(const uint16_t* __restrict__ x,
                  const int* __restrict__ tile_gid,
                  const int* __restrict__ tile_rows,
                  const uint16_t* __restrict__ w,
                  __nv_bfloat16* __restrict__ y, int d, int f, int G, int bt) {
  __shared__ BfTiles s;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int n0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBM;
  const int t = row0 / bt;
  const int g = tile_gid[t];
  if (g < 0 || g >= G) {
    fill_bf16<false>(y, row0, row0 + kBM, n0, f, kBf16Nan, tid, kThreads);
    return;
  }
  const int rows = block_rows(tile_rows, t, row0, bt, kBM);
  if (rows == 0) {
    fill_bf16<false>(y, row0, row0 + kBM, n0, f, 0, tid, kThreads);
    return;
  }
  const uint16_t* wg = w + size_t(g) * d * f;

  uint4 ra[kAVecs], rb[kBVecs];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kEK / 8), c = (v % (kEK / 8)) * 8;
      ra[i] = load8(x + size_t(row0 + r) * d + k0 + c, d - (k0 + c));
    }
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kBN / 8), c = (v % (kBN / 8)) * 8;
      const int valid = k0 + r < d ? f - (n0 + c) : 0;
      rb[i] = load8(wg + size_t(k0 + r) * f + n0 + c, valid);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kEK / 8), c = (v % (kEK / 8)) * 8;
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

  const int nk = (d + kEK - 1) / kEK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kEK);
#pragma unroll
    for (int kk = 0; kk < kEK; kk += 16) {
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
  // to bf16 once, eight columns a lane; rows past the count get +0.
  float* st = s.stage[warp];
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rr = wm * kWM + i * 16 + r;
      const int col = n0 + wn * kWN + j * 16 + c;
      __nv_bfloat16* out = y + size_t(row0 + rr) * f + col;
      const float* v = st + r * 16 + c;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col + e < f) out[e] = __float2bfloat16(rr < rows ? v[e] : 0.0f);
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
            const int* __restrict__ tile_rows, const float* __restrict__ w,
            float* __restrict__ y, int d, int f, int G, int bt) {
  __shared__ float as[kFBK][kFBM + 4];  // x slice, depth-major
  __shared__ float bs[kFBK][kFBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kFBN;
  const int row0 = blockIdx.y * kFBM;
  const int t = row0 / bt;
  const int g = tile_gid[t];
  const int rows = block_rows(tile_rows, t, row0, bt, kFBM);
  if (g < 0 || g >= G || rows == 0) {
    const float v = (g < 0 || g >= G) ? CUDART_NAN_F : 0.0f;
    for (int e = tid; e < kFBM * kFBN; e += kFThreads) {
      const int c = n0 + (e % kFBN);
      if (c < f) y[size_t(row0 + e / kFBN) * f + c] = v;
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
      const int rr = ty + 16 * i;
      if (col < f) y[size_t(row0 + rr) * f + col] = rr < rows ? acc[i][j] : 0.0f;
    }
}

// ------------------------------------------ the weights' gradient (dW)
// The backward of K5 with respect to w.  The Pallas kernel has none: the
// reference's MoE is an einsum that XLA transposes.  The port runs the
// expert products through K5, so it owes their gradient:
//   dw[g] = sum over tiles t with tile_gid[t] == g, over the tile's real
//           rows r < tile_rows[t] (all bt without tile_rows), of
//           x[t bt + r]^T dy[t bt + r]
// with f32 sums and dw cast to w's type once.  A group that owns no real
// row gets +0 (the einsum's gradient of an expert with no token); a tile
// whose id lies outside [0, G) belongs to no group.  One block computes a
// (d-tile, f-tile) of one group's dw: it walks the tile list itself
// (tile_gid is small: 256 ids at moonshot's training call), and the depth
// of its product is the group's real rows in ascending order, so padding
// rows past a tile's count cost nothing and every output element is the
// sum of one block, the same bits run to run (no atomics).
//
// Bound.  At moonshot's training call (64 experts of C = 512 rows, 24,576
// real rows, d = 2048, f = 1408, bf16) a call does 2 x 24,576 x 2048 x
// 1408 = 142 GFLOP on ~539 MB (x's and dy's real rows read once, dw's 369
// MB written once): 0.143 ms of bf16 tensor-core work against 0.161 ms of
// bytes, so both limits are near and the kernel has to keep the tensor
// cores fed and the writes streaming at once.
//
//  * bfloat16 that TMA can describe (d and f multiples of 8, 16-byte
//    aligned bases; gmm_dw_bf16_tma): K5's forward design turned over.
//    The reduction runs over rows, so both operands are MN-major in shared
//    memory: A = x^T from 64-row x 64-d-column boxes, B = dy from 64-row x
//    64-f-column boxes, both 128-byte swizzled, wgmma m64n256k16 with both
//    transpose immediates set.  A block owns a 128 (d) x 256 (f) tile of
//    one group's dw (the operands cross L2 once per 128 x 256 outputs:
//    ~1.7 GB at moonshot's call against ~2.2 GB for 128 x 128) and walks
//    kDwFTiles f-tiles in turn: the producer fills the ring with the next
//    f-tile's boxes while the consumers stage the last one's bf16 tile in
//    shared memory, and TMA stores it while they run the next one's
//    products (dw's writes are 68% of the bound's bytes).  One producer
//    warp walks the group's tiles, testing 32 tile ids a step (a lane
//    that walks from tile 0 spends ~ntiles dependent loads a block), and
//    issues 64-row boxes while the box starts below the tile's count,
//    telling the consumers each stage's real rows in a word beside the
//    ring; two consumer warpgroups take 64 d-rows each.  A box that
//    straddles the count still carries the rows past it (noise, or NaN),
//    so the consumers zero those rows in all six boxes of the stage (zero
//    both operands: 0 x NaN is NaN) before any wgmma reads it: a row of a
//    64-column bf16 box is one 128-byte line (the swizzle only permutes
//    its 16-byte chunks), then fence.proxy.async and a named barrier make
//    the generic-proxy writes visible to wgmma; 16-row steps wholly past
//    the count are skipped.  Blocks run d-tiles fastest, then groups, so
//    the resident blocks cover a few groups, whose x and dy rows meet in
//    L2.  TMA's zero fill covers the ragged d and f edges on the loads,
//    and the stores clip there.  What is left between this kernel and
//    its bound is not broken down (PERF.md).
//  * other bfloat16 (gmm_dw_bf16): wmma 16x16x16 fragments from
//    double-buffered shared-memory slices with element-wise masked loads.
//  * float32 (gmm_dw_f32): CUDA-core FMA from 16-row slices.
constexpr int kDEK = 32;  // rows of a bf16 dW slice
constexpr int kDALd = kBM + 8;  // pitch of the x slice (d columns)
constexpr int kDBLd = kBN + 8;  // of the dy slice (f columns)
constexpr int kDVecs = kDEK * kBM / 8 / kThreads;  // 8-element groups a thread

struct __align__(128) DwTiles {
  uint16_t a[2][kDEK * kDALd];
  uint16_t b[2][kDEK * kDBLd];
  float stage[kThreads / 32][16 * 16];
};

// Real rows of tile t for group g: 0 unless the tile is g's.
__device__ __forceinline__ int dw_rows(const int* tile_gid,
                                       const int* tile_rows, int t, int g,
                                       int bt) {
  if (tile_gid[t] != g) return 0;
  return tile_rows == nullptr ? bt : min(max(tile_rows[t], 0), bt);
}

// Steps (t, k0) to the next slice of group g's real rows: k0 advances by
// `step` inside tile t, else to the next tile of g with a real row.
// `rt` is tile t's real rows.  False once the tiles are walked.
__device__ __forceinline__ bool dw_next(const int* tile_gid,
                                        const int* tile_rows, int ntiles,
                                        int g, int bt, int step, int& t,
                                        int& k0, int& rt) {
  k0 += step;
  while (t < ntiles && k0 >= rt) {
    ++t;
    k0 = 0;
    rt = t < ntiles ? dw_rows(tile_gid, tile_rows, t, g, bt) : 0;
  }
  return t < ntiles;
}

__global__ void __launch_bounds__(kThreads, 2)
    gmm_dw_bf16(const uint16_t* __restrict__ x, const uint16_t* __restrict__ dy,
                const int* __restrict__ tile_gid,
                const int* __restrict__ tile_rows,
                __nv_bfloat16* __restrict__ dw, int d, int f, int ntiles,
                int bt) {
  __shared__ DwTiles s;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int n0 = blockIdx.x * kBN;  // f columns
  const int m0 = blockIdx.y * kBM;  // d rows of dw
  const int g = blockIdx.z;
  __nv_bfloat16* out = dw + size_t(g) * d * f;

  int t = -1, k0 = 0, rt = 0;
  if (!dw_next(tile_gid, tile_rows, ntiles, g, bt, kDEK, t, k0, rt)) {
    for (int e = tid; e < kBM * kBN; e += kThreads) {
      const int r = m0 + e / kBN, c = n0 + e % kBN;
      if (r < d && c < f) out[size_t(r) * f + c] = __float2bfloat16(0.0f);
    }
    return;
  }

  uint4 ra[kDVecs], rb[kDVecs];
  // Slice rows [t bt + k0, + kDEK): those at or past rt are zero.
  auto load = [&](int tt, int kk0, int rtt) {
#pragma unroll
    for (int i = 0; i < kDVecs; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kBM / 8), c = (v % (kBM / 8)) * 8;
      const bool real = kk0 + r < rtt;
      const size_t row = size_t(tt) * bt + kk0 + r;
      ra[i] = load8(x + row * d + m0 + c, real ? d - (m0 + c) : 0);
      rb[i] = load8(dy + row * f + n0 + c, real ? f - (n0 + c) : 0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kDVecs; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kBM / 8), c = (v % (kBM / 8)) * 8;
      *reinterpret_cast<uint4*>(&s.a[buf][r * kDALd + c]) = ra[i];
      *reinterpret_cast<uint4*>(&s.b[buf][r * kDBLd + c]) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load(t, k0, rt);
  store(0);
  __syncthreads();
  for (int cur = 0;; cur ^= 1) {
    int nt = t, nk0 = k0, nrt = rt;
    const bool more =
        dw_next(tile_gid, tile_rows, ntiles, g, bt, kDEK, nt, nk0, nrt);
    if (more) load(nt, nk0, nrt);
#pragma unroll
    for (int kk = 0; kk < kDEK; kk += 16) {
      // A = x^T: the slice holds x's rows, so A is column-major in it.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>
          af[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          bf[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(
            af[i], as_bf16(&s.a[cur][kk * kDALd + wm * kWM + i * 16]), kDALd);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(
            bf[j], as_bf16(&s.b[cur][kk * kDBLd + wn * kWN + j * 16]), kDBLd);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier.
    if (more) store(cur ^ 1);
    __syncthreads();
    if (!more) break;
    t = nt;
    k0 = nk0;
    rt = nrt;
  }

  // Epilogue: each accumulator tile through the warp's staging tile, cast
  // to bf16 once.
  float* st = s.stage[warp];
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rr = m0 + wm * kWM + i * 16 + r;
      const int col = n0 + wn * kWN + j * 16 + c;
      if (rr < d) {
        const float* v = st + r * 16 + c;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < f)
            out[size_t(rr) * f + col + e] = __float2bfloat16(v[e]);
      }
      __syncwarp();
    }
  }
}

// -------------------------------------------------- dW: TMA + wgmma
constexpr int kDwBN = 256;     // f columns of a dW tile: one m64n256 wgmma
constexpr int kDwStages = 3;   // ring depth: 144 KB of the SM's 227 KB
constexpr int kDwFTiles = 6;   // f-tiles a block walks in turn
constexpr int kDwStageBytes = (kConsumers + kDwBN / 64) * kXBox;  // 48 KB
// The epilogue's bf16 tile, 64 KB: each warpgroup's 64 rows as four 64 x
// 64 boxes, 128-byte swizzled, which TMA stores while the next f-tile's
// products run.
constexpr int kDwOutBytes = kConsumers * (kDwBN / 64) * kXBox;
constexpr int kDwSmem = kDwStages * kDwStageBytes + kDwOutBytes + 1024 +
                        2 * kDwStages * 8 + kDwStages * 4;
// A stage's info word (written by the producer before its TMA, read by the
// consumers once the stage is full): the real rows of its boxes, and
// whether it is the last box of its f-tile and of the block.
constexpr int kDwTileEnd = 1 << 8;
constexpr int kDwLast = 1 << 9;

// d (64 x 256, f32) += A (64 x 16, bf16) * B (16 x 256, bf16), both read
// MN-major (transpose immediates set): the dW kernel's x^T and dy.
__device__ __forceinline__ void wgmma_m64n256k16_tt(float (&d)[128],
                                                    uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void acc_fence(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void st_shared_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(addr), "r"(0)
               : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The first tile at or after t whose id is g and which has a real row, or
// ntiles: the whole warp tests 32 tiles a step (tile_gid is small and the
// walk from tile 0 to a group's tiles would otherwise be ~ntiles
// dependent loads).
__device__ __forceinline__ int warp_next_tile(const int* tile_gid,
                                              const int* tile_rows,
                                              int ntiles, int g, int t,
                                              int lane) {
  for (; t < ntiles; t += 32) {
    const int u = t + lane;
    const bool hit = u < ntiles && tile_gid[u] == g &&
                     (tile_rows == nullptr || tile_rows[u] > 0);
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (m) return t + __ffs(m) - 1;
  }
  return ntiles;
}

// x^T (A, 64 d-rows x 16 rows deep) and dy (B, 16 rows deep x 256 f
// columns) are both MN-major, as w is in the forward: each box row (one
// row of x or dy) is 128 bytes, 8-row atoms 1 KB apart (SBO), dy's next
// 64 columns one box on (LBO); a 16-row step is 2 KB.  A's M = 64 is one
// box, so its LBO is never used.
//
// tmx: x as (T rows, d), tmdy: dy as (T rows, f), tmdw: dw as (G, d, f),
// 64 x 64 boxes, 128-byte swizzled, zero fill past the edges (a store
// clips there).  Grid (d-tiles of 128, groups, chunks of kDwFTiles f-tiles
// of 256): a block computes its d-tile of one group's dw for each f-tile
// of its chunk in turn, so the producer loads the next f-tile's boxes
// while the consumers stage the last one, and TMA stores it while the
// consumers run the next one's products.
__global__ void __launch_bounds__(kTmaThreads, 1)
    gmm_dw_bf16_tma(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmdy,
                    const __grid_constant__ CUtensorMap tmdw,
                    const int* __restrict__ tile_gid,
                    const int* __restrict__ tile_rows,
                    __nv_bfloat16* __restrict__ dw, int d, int f, int ntiles,
                    int bt) {
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * kBM;  // d rows of dw
  const int g = blockIdx.y;
  const int n_lo = blockIdx.z * kDwFTiles * kDwBN;  // the chunk's f columns
  const int n_hi = min(n_lo + kDwFTiles * kDwBN, f);
  __nv_bfloat16* out = dw + size_t(g) * d * f;

  // Every warp finds the group's first tile with a real row itself.
  const int first =
      warp_next_tile(tile_gid, tile_rows, ntiles, g, 0, lane);
  if (first >= ntiles) {
    const int m1 = min(m0 + kBM, d), w8 = (n_hi - n_lo) / 8;
    for (int e = tid; e < (m1 - m0) * w8; e += kTmaThreads)
      *reinterpret_cast<uint4*>(out + size_t(m0 + e / w8) * f + n_lo +
                                (e % w8) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }

  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t staging = ring + kDwStages * kDwStageBytes;
  const uint32_t bars = staging + kDwOutBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kDwStages + s); };
  volatile int* info = reinterpret_cast<volatile int*>(
      smem_raw + (bars + 16 * kDwStages - raw));
  // A stage: x's boxes (d columns m0, m0 + 64), then dy's (f columns n0 +
  // 64 j), 8 KB each and adjoining.
  auto box = [&](int s, int b) {
    return ring + s * kDwStageBytes + b * kXBox;
  };
  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto rows_of = [&](int t) {
    return tile_rows == nullptr ? bt : min(max(tile_rows[t], 0), bt);
  };
  const int wg = tid / 128;
  if (wg == kConsumers) {
    // Producer warp: walks the group's real rows once for each f-tile, a
    // 64-row box at a time; lane 0 issues the loads.
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tmx))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tmdy))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tmdw))
                   : "memory");
    }
    int n0 = n_lo, t = first, k0 = 0, rt = rows_of(first);
    for (int it = 0;; ++it) {
      const int s = it % kDwStages;
      const int valid = min(rt - k0, kBK);
      int nt = t, nk0 = k0 + kBK;
      if (nk0 >= rt) {
        nt = warp_next_tile(tile_gid, tile_rows, ntiles, g, t + 1, lane);
        nk0 = 0;
      }
      const bool tile_end = nt >= ntiles;
      const bool last = tile_end && n0 + kDwBN >= n_hi;
      if (lane == 0) {
        mbar_wait(empty(s), ((it / kDwStages) & 1) ^ 1);
        info[s] = valid | (tile_end ? kDwTileEnd : 0) | (last ? kDwLast : 0);
        mbar_expect_tx(full(s), kDwStageBytes);
        const int row = t * bt + k0;
        for (int h = 0; h < kConsumers; ++h)
          tma_load_2d(box(s, h), &tmx, m0 + 64 * h, row, full(s));
        for (int j = 0; j < kDwBN / 64; ++j)
          tma_load_2d(box(s, kConsumers + j), &tmdy, n0 + 64 * j, row,
                      full(s));
      }
      __syncwarp();
      if (last) break;
      if (tile_end) {
        n0 += kDwBN;
        t = first;
        k0 = 0;
        rt = rows_of(first);
      } else {
        if (nt != t) rt = rows_of(nt);
        t = nt;
        k0 = nk0;
      }
    }
    return;
  }

  // Consumer warpgroup wg: dw rows [m0 + 64 wg, + 64) of the tile.
  const int warp = (tid & 127) >> 5;
  const bool leader = (tid & 127) == 0;  // issues the warpgroup's stores
  const uint32_t out_wg = staging + wg * (kDwBN / 64) * kXBox;
  float acc[128];
  int it = 0, prev = -1;
  for (int n0 = n_lo;; n0 += kDwBN) {
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    acc_fence(acc);
    int flags;
    do {
      const int s = it % kDwStages;
      mbar_wait(full(s), (it / kDwStages) & 1);
      flags = info[s];
      const int valid = flags & 0xFF;
      const bool straddles = valid < kBK;
      if (straddles) {
        // Rows [valid, 64) of the stage's six boxes to +0: 8 16-byte
        // chunks a row.
        const int chunks = (kBK - valid) * 8;
        constexpr int kBoxes = kConsumers + kDwBN / 64;
        for (int e = tid; e < kBoxes * chunks; e += kConsumers * 128)
          st_shared_zero16(box(s, e / chunks) + valid * 128 +
                           (e % chunks) * 16);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 128) : "memory");
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if (16 * kk < valid)
          wgmma_m64n256k16_tt(
              acc, gmma_desc(box(s, wg) + 2048 * kk, kBLbo, kBSbo),
              gmma_desc(box(s, kConsumers) + 2048 * kk, kBLbo, kBSbo));
      }
      wgmma_commit();
      acc_fence(acc);
      // The previous stage's products are done: hand its buffers back.
      wgmma_wait<1>();
      acc_fence(acc);
      if (prev >= 0 && leader) mbar_arrive(empty(prev));
      prev = s;
      ++it;
    } while (!(flags & kDwTileEnd));
    wgmma_wait<0>();
    acc_fence(acc);
    if (leader) mbar_arrive(empty(prev));
    prev = -1;

    // Epilogue: accumulator 4 i + {0, 1} of lane l holds the warpgroup's
    // row 16 warp + l / 4, columns 8 i + 2 (l % 4) + {0, 1}; 4 i + {2, 3}
    // the row 8 below.  Cast to bf16 once into the staging boxes (box i /
    // 8, 16-byte chunk i % 8 of the row, swizzled by the row's index mod 8
    // as TMA reads it back), once the previous f-tile's stores have read
    // them; then one lane stores the boxes that lie below d and n_hi (TMA
    // clips the ragged d and f edges).
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + (lane >> 2) + 8 * half;
#pragma unroll
      for (int i = 0; i < kDwBN / 8; ++i) {
        const uint32_t addr = out_wg + (i / 8) * kXBox + r * 128 +
                              (((i % 8) ^ (r & 7)) << 4) + 4 * (lane & 3);
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                     "r"(pack2(acc[4 * i + 2 * half],
                               acc[4 * i + 2 * half + 1]))
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
    if (leader && m0 + 64 * wg < d) {
      for (int j = 0; j < kDwBN / 64; ++j)
        if (n0 + 64 * j < n_hi)
          tma_store_3d(&tmdw, out_wg + j * kXBox, n0 + 64 * j, m0 + 64 * wg,
                       g);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (flags & kDwLast) break;
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

constexpr int kDFK = 16;  // rows of an f32 dW slice

__global__ void __launch_bounds__(kFThreads)
    gmm_dw_f32(const float* __restrict__ x, const float* __restrict__ dy,
               const int* __restrict__ tile_gid,
               const int* __restrict__ tile_rows, float* __restrict__ dw,
               int d, int f, int ntiles, int bt) {
  __shared__ float as[kDFK][kFBM + 4];  // x slice: rows x d columns
  __shared__ float bs[kDFK][kFBN + 4];  // dy slice: rows x f columns
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kFBN;
  const int m0 = blockIdx.y * kFBM;
  const int g = blockIdx.z;
  float acc[4][4] = {};
  int t = -1, k0 = 0, rt = 0;
  while (dw_next(tile_gid, tile_rows, ntiles, g, bt, kDFK, t, k0, rt)) {
#pragma unroll
    for (int i = 0; i < kDFK * kFBM / kFThreads; ++i) {
      const int e = tid + i * kFThreads;
      const int r = e / kFBM, c = e % kFBM;
      const bool real = k0 + r < rt;
      const size_t row = size_t(t) * bt + k0 + r;
      as[r][c] = real && m0 + c < d ? x[row * d + m0 + c] : 0.0f;
      bs[r][c] = real && n0 + c < f ? dy[row * f + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDFK; ++k) {
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
  float* out = dw + size_t(g) * d * f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (rr < d && col < f) out[size_t(rr) * f + col] = acc[i][j];
    }
}

// ------------------------------------------------------- host: tensor maps
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no -lcuda); null if the driver does not have it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The CUDA driver's result code for the last tensor map it refused.
int g_refused = 0;

// A bf16 tensor map of `rank` dims (innermost first) with 64-element
// boxes in the two inner dims, 128-byte swizzle and zero fill.
CUresult encode_bf16(EncodeTiled enc, CUtensorMap* map, const void* base,
                     int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides) {
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                           const_cast<void*>(base), dims, strides, box, elem,
                           CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) g_refused = static_cast<int>(res);
  return res;
}

// cuTensorMapEncodeTiled, a CUDA driver call, needs a context current on
// the calling thread.  Autograd runs a backward on a thread of its own,
// where the runtime may not have been touched yet (K5's dX, or a
// recomputed forward, is then the thread's first CUDA call), so make the
// device's primary context current there: once a thread and device.
cudaError_t bind_context() {
  thread_local int bound = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev == bound) return err;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) bound = dev;
  return err;
}

// A 2-D bf16 tensor map of `rows` rows of `cols` contiguous elements.
CUresult encode_rows(EncodeTiled enc, CUtensorMap* map, const void* base,
                     int rows, int cols) {
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  return encode_bf16(enc, map, base, 2, dims, strides);
}

// Lets a TMA kernel take `bytes` of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Codes the launch entry returns beside cudaGetLastError()'s.
constexpr int kNoEncoder = -1;
constexpr int kEncodeFailed = -2;

}  // namespace

extern "C" {

// Rows of a block's tile, by dtype: bt must be a multiple of it.
int grouped_matmul_row_tile(int dtype) { return dtype == 1 ? kBM : kFBM; }

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it).  tma (bf16
// only): d and f are multiples of 8 and x, w are 16-byte aligned, so the
// TMA kernel runs; else the element-load one.  w_kmajor (TMA only): w is
// stored (G, f, d), the transpose of the (G, d, f) weights the call
// multiplies by, and is read K-major through its tensor map (K5's dX on
// the forward's w, with no copy); else w is (G, d, f).  tile_rows may be
// null (every row real).  T must be a positive multiple of bt, and bt of
// the row tile.
int grouped_matmul_launch(const void* x, const int* tile_gid,
                          const int* tile_rows, const void* w, void* y, int T,
                          int d, int f, int G, int bt, int dtype, int tma,
                          int w_kmajor, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && tma) {
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return kNoEncoder;
    const cudaError_t ctx = bind_context();
    if (ctx != cudaSuccess) return static_cast<int>(ctx);
    CUtensorMap tmx, tmw;
    // w's inner dim is f (the forward) or d (stored transposed)
    const cuuint64_t inner = w_kmajor ? d : f, outer = w_kmajor ? f : d;
    const cuuint64_t wdims[3] = {inner, outer, cuuint64_t(G)};
    const cuuint64_t wstrides[2] = {inner * 2, inner * outer * 2};
    if (encode_rows(enc, &tmx, x, T, d) != CUDA_SUCCESS ||
        encode_bf16(enc, &tmw, w, 3, wdims, wstrides) != CUDA_SUCCESS)
      return kEncodeFailed;
    const auto kernel = w_kmajor ? gmm_bf16_tma<true> : gmm_bf16_tma<false>;
    const cudaError_t attr = allow_smem(kernel, kTmaSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((f + kBN - 1) / kBN, T / kBM);
    kernel<<<grid, kTmaThreads, kTmaSmem, st>>>(
        tmx, tmw, tile_gid, tile_rows, static_cast<__nv_bfloat16*>(y), d, f,
        G, bt);
  } else if (w_kmajor) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (dtype == 1) {
    const dim3 grid((f + kBN - 1) / kBN, T / kBM);
    gmm_bf16_elem<<<grid, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(x), tile_gid, tile_rows,
        static_cast<const uint16_t*>(w), static_cast<__nv_bfloat16*>(y), d, f,
        G, bt);
  } else {
    const dim3 grid((f + kFBN - 1) / kFBN, T / kFBM);
    gmm_f32<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(x), tile_gid, tile_rows,
        static_cast<const float*>(w), static_cast<float*>(y), d, f, G, bt);
  }
  return static_cast<int>(cudaGetLastError());
}

// dw (G, d, f) = the gradient of K5 with respect to w, from x (T, d) and
// dy (T, f) of one dtype (0 = float32, 1 = bfloat16), over T / bt tiles.
// tma (bf16 only): d and f are multiples of 8 and x, dy 16-byte aligned,
// so the TMA kernel runs; else the element-load one.  tile_rows may be
// null.
int grouped_matmul_dw_launch(const void* x, const void* dy,
                             const int* tile_gid, const int* tile_rows,
                             void* dw, int T, int d, int f, int G, int bt,
                             int dtype, int tma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = T / bt;
  if (dtype == 1 && tma) {
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return kNoEncoder;
    const cudaError_t ctx = bind_context();
    if (ctx != cudaSuccess) return static_cast<int>(ctx);
    CUtensorMap tmx, tmdy, tmdw;
    const cuuint64_t wdims[3] = {cuuint64_t(f), cuuint64_t(d), cuuint64_t(G)};
    const cuuint64_t wstrides[2] = {cuuint64_t(f) * 2,
                                    cuuint64_t(f) * cuuint64_t(d) * 2};
    if (encode_rows(enc, &tmx, x, T, d) != CUDA_SUCCESS ||
        encode_rows(enc, &tmdy, dy, T, f) != CUDA_SUCCESS ||
        encode_bf16(enc, &tmdw, dw, 3, wdims, wstrides) != CUDA_SUCCESS)
      return kEncodeFailed;
    const cudaError_t attr = allow_smem(gmm_dw_bf16_tma, kDwSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int chunks = ((f + kDwBN - 1) / kDwBN + kDwFTiles - 1) / kDwFTiles;
    const dim3 grid((d + kBM - 1) / kBM, G, chunks);
    gmm_dw_bf16_tma<<<grid, kTmaThreads, kDwSmem, st>>>(
        tmx, tmdy, tmdw, tile_gid, tile_rows,
        static_cast<__nv_bfloat16*>(dw), d, f, ntiles, bt);
  } else if (dtype == 1) {
    const dim3 grid((f + kBN - 1) / kBN, (d + kBM - 1) / kBM, G);
    gmm_dw_bf16<<<grid, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy),
        tile_gid, tile_rows, static_cast<__nv_bfloat16*>(dw), d, f, ntiles,
        bt);
  } else {
    const dim3 grid((f + kFBN - 1) / kFBN, (d + kFBM - 1) / kFBM, G);
    gmm_dw_f32<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), tile_gid,
        tile_rows, static_cast<float*>(dw), d, f, ntiles, bt);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* grouped_matmul_error_string(int code) {
  if (code == kNoEncoder)
    return "the driver has no cuTensorMapEncodeTiled";
  if (code == kEncodeFailed) {
    static char msg[96];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
             g_refused);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
