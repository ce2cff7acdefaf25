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
//  * bfloat16 that TMA cannot describe (d or f not a multiple of 8, or a
//    base off 16 bytes; gmm_bf16_async): the same consumers, the same
//    products in the same order, on a ring filled by a warpgroup of
//    producer threads through cp.async in the exact bytes TMA's boxes
//    would hold (each operand at the widest copy of 16, 8 or 4 bytes that
//    divides its row pitch and base; at 2 bytes, the aligned 16-byte
//    chunks that hold a row, realigned in shared memory a stage behind;
//    zeros past the edges and past the tile's real rows), so its results
//    equal gmm_bf16_tma's bit for bit wherever both can run.  The
//    producers hand registers to the consumers (setmaxnreg), and the
//    consumers fence the generic proxy's writes from wgmma's reads after
//    each stage's barrier.  Its dX instance reads the forward's w K-major
//    in place at any width, so no call copies w^T in bf16.  Bound at (b)
//    with f = 1020 (T = 4096, d = 1024): 8.6 GFLOP, 0.0087 ms of
//    tensor-core work against 0.0075 ms of bytes; what the copies add is
//    producer instructions, which bound the ring's rate (on copies 8
//    bytes off, the async forward at (b) took 1.3x the TMA kernel's time,
//    1.7x while every copy went through the zero fill's selects;
//    PERF.md).
//  * float32 that TMA can describe (d and f multiples of 4, 16-byte aligned
//    bases; gmm_f32_tma): CUDA-core FMA, no TF32 and no split of the depth
//    (the reference checks f32 to 1e-5, and this is the path that proves
//    the port exact on the card).  Each output is one fmaf chain over d in
//    ascending order from +0 (a zero term past d adds +0), as in
//    gmm_f32_async below.  Bound: at kernel_bench's
//    shape (T = 4096, d = f = 1024) 8.6 GFLOP is 0.128 ms at the 67
//    TFLOP/s FP32 peak, so it is bound by operations, and what limits an
//    FMA loop is how many shared-memory reads feed each FMA.  Design: a
//    64 x 256 tile, 8 consumer warps of 8 rows x 256 columns, each thread
//    8 x 8 outputs in registers; a depth step of a thread reads its 8 rows
//    of x as 128-bit loads along d (one address across the warp: a
//    broadcast) and its 8 columns of w as two 128-bit loads, 16 values for
//    64 FMAs.  One producer warp keeps a ring of kF32Stages 32-deep stages
//    filled by TMA (x as a 64-row x 32-deep box, w as 32 deep x 256
//    columns; zero fill on the ragged d and f edges), each stage completing
//    on an mbarrier and handed back once its warps have read it.  With
//    tile_rows, a warp whose 8 rows all lie past the count writes zeros and
//    computes nothing; a block whose real rows fit in 8 (the decode calls:
//    a few tokens an expert) splits its 256 columns over the 8 warps
//    instead, one a lane, so that every warp computes and the call is
//    bound by the active experts' weights.  dX (kWKMajor) reads the
//    forward's w (G, d, f) through a tensor map as 32-deep x 256-row boxes
//    with the 128-byte swizzle, a thread's columns 32 apart so that the 8
//    lanes of each quarter-warp read 8 rows whose 16-byte chunks land in
//    distinct banks: no copy of w^T is made.  (Warps of 16 x 128 rows and
//    columns read 40% fewer shared-memory wavefronts a FMA and were not
//    faster on an H100, nor were 128-row blocks, whose 16 warps leave 96
//    registers a thread: the loop is bound by issuing FMAs, not by shared
//    memory.)
//  * float32 that TMA cannot describe (d or f not a multiple of 4, or a
//    base off 16 bytes; gmm_f32_async): the same FMA consumers on the same
//    ring, filled by a warpgroup of producer threads through cp.async in
//    the bytes TMA's boxes would hold (each operand at the widest copy of
//    16, 8 or 4 bytes that divides its row pitch and base, y stored at its
//    own), so its results equal gmm_f32_tma's bit for bit wherever both
//    can run; its dX instance reads the forward's w K-major in place, so no
//    f32 call copies w^T either.
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
#include <stdint.h>
#include <stdio.h>

#include <algorithm>

namespace {

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

// The unsigned type of kBytes (16, 8, 4 or 2): one copy or store.
template <int kBytes>
struct Bits;
template <>
struct Bits<16> {
  using T = uint4;
  static __device__ __forceinline__ T of(uint32_t b2) {
    return make_uint4(b2, b2, b2, b2);
  }
};
template <>
struct Bits<8> {
  using T = uint2;
  static __device__ __forceinline__ T of(uint32_t b2) {
    return make_uint2(b2, b2);
  }
};
template <>
struct Bits<4> {
  using T = uint32_t;
  static __device__ __forceinline__ T of(uint32_t b2) { return b2; }
};
template <>
struct Bits<2> {
  using T = uint16_t;
  static __device__ __forceinline__ T of(uint32_t b2) {
    return static_cast<uint16_t>(b2);
  }
};

template <int N>
struct Width {
  static constexpr int value = N;
};

// Calls fn(Width<b>{}) for b = `bytes`, one of 16, 8, 4 and (where kLeast
// is 2) 2, picked on the host: each width is an instance of its own of
// whatever loop fn runs, so no loop branches on it.  float32 operands
// take kLeast 4: a copy or store of one element is their narrowest.
template <int kLeast = 2, class Fn>
__device__ __forceinline__ void with_width(int bytes, Fn&& fn) {
  static_assert(kLeast == 2 || kLeast == 4, "widths of 2 or 4 bytes up");
  switch (bytes) {
    case 16: fn(Width<16>{}); break;
    case 8: fn(Width<8>{}); break;
    default:
      if constexpr (kLeast == 4)
        fn(Width<4>{});
      else if (bytes == 4)
        fn(Width<4>{});
      else
        fn(Width<2>{});
      break;
  }
}

// Rows [r0, r1) x columns [n0, n0 + kBN) of a bf16 y set to `bits` (a bf16
// bit pattern), columns past f left alone, kBytes a store: kBytes divides
// y's row pitch (2 f) and base, so a store lies wholly on one side of f.
template <int kBytes>
__device__ __forceinline__ void fill_bf16(__nv_bfloat16* y, int r0, int r1,
                                          int n0, int f, uint16_t bits,
                                          int tid, int nthreads) {
  constexpr int kPer = kBN * 2 / kBytes;  // stores a row of the tile
  const auto v = Bits<kBytes>::of(bits | (uint32_t(bits) << 16));
  for (int e = tid; e < (r1 - r0) * kPer; e += nthreads) {
    const int c = n0 + (e % kPer) * (kBytes / 2);
    if (c < f)
      *reinterpret_cast<typename Bits<kBytes>::T*>(
          y + size_t(r0 + e / kPer) * f + c) = v;
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

// ------------------------------------ bf16: the producers of the ring
// The wgmma kernels (forward, dX and dW) read their operands from a ring
// of stages in dynamic shared memory, each operand as 64-row boxes of 128
// bytes a row in the layout of TMA's SWIZZLE_128B: row r of a box at r x
// 128 bytes, its 16-byte chunk c at (c ^ (r & 7)) x 16 (the box on a
// 1024-byte boundary), which the consumers' descriptors (gmma_desc)
// assume.  Two producers fill it.  TMA, where it can describe the
// operands (rows of a whole number of 16 bytes on 16-byte aligned bases):
// one lane issues the boxes and each stage completes on its full barrier
// by the bytes written.  cp.async elsewhere (the "async" instances): a
// warpgroup of producer threads writes the same bytes to the same
// addresses, each operand in copies of its own width, the widest of 16, 8,
// 4 or 2 bytes that divides its row pitch and its base (picked on the
// host, an instance of the copy loop each).  Edges and rows past a count
// are zeros (cp.async's src-size 0); a copy never straddles an edge, since
// its width divides the pitch.  cp.async takes no 2-byte copy, so a
// 2-byte operand moves in the aligned 16-byte chunks that hold its rows
// and is realigned in shared memory (copy_chunks, realign_chunks).  So the
// consumers run the same products on the same bytes in the same order,
// and the async instances give the TMA instances' bits.  The producers
// write through the generic proxy and wgmma reads through the async one,
// so a consumer runs fence.proxy.async after each full barrier's wait.
// The float32 kernels' rings (unswizzled boxes, and the 128-byte swizzle
// of dX's w) are filled the same way (copy_rows), but their FMA consumers
// read them with ordinary loads, in the producers' own proxy: the full
// barrier's wait is all they need, and they run no fence.
constexpr int kAsyncProducerWarps = 4;  // a warpgroup
constexpr int kAsyncProducers = kAsyncProducerWarps * 32;
constexpr int kAsyncThreads = kConsumers * 128 + kAsyncProducers;
// Registers a producer thread keeps through setmaxnreg, the consumers
// taking the rest (0: none moved): a block of 384 threads has 168 a
// thread at launch, and 128 x 96 + 256 x 200 fit in them.  The consumers
// need no more than 168, as the TMA kernels' do; producers held to 96 ran
// as fast as with none moved, or faster (the 2-byte dW), and to 56
// spilled (benchmarks/async_tune.py).
constexpr int kProducerRegs = 96;
constexpr int kConsumerRegs = 200;
static_assert(kProducerRegs == 0 ||
                  (kAsyncProducerWarps == 4 &&
                   128 * kProducerRegs + kConsumers * 128 * kConsumerRegs <=
                       kAsyncThreads * ((65536 / kAsyncThreads) & ~7)),
              "setmaxnreg asks for more registers than the block holds");

template <bool kDec>
__device__ __forceinline__ void set_max_regs() {
  if constexpr (kProducerRegs > 0) {
    if (kDec)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One copy of kBytes (16, 8 or 4) from global src to shared dst, whose
// first n bytes (kBytes or 0) are read and the rest written as zeros.
template <int kBytes>
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src,
                                           int n) {
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
                 "l"(src), "n"(kBytes), "r"(n)
                 : "memory");
}

// The same with every byte read: no source size, no select.
template <int kBytes>
__device__ __forceinline__ void copy_async_all(uint32_t dst, const void* src) {
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst),
                 "l"(src), "n"(kBytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_u32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

// Ends a producer thread's part of a stage of direct copies.  The first
// arrive waits for the thread's cp.async copies without counting as one
// of the barrier's arrivals (the pending count goes up now and down when
// they land); the second is an ordinary arrive, whose release covers what
// the thread wrote with st.shared (dW's info word).  The barrier counts
// one arrival a producer thread.
__device__ __forceinline__ void stage_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(bar)
               : "memory");
  mbar_arrive(bar);
}

// One box's source: rows [r0, r0 + the box's rows) x columns [c0, c0 + the
// box's columns) of the row-major matrix of E (bf16 bits or float) at
// `base`, `pitch` elements a row; rows at or past nrows and columns at or
// past ncols are zeros.
template <class E>
struct Src {
  const E* base;
  int pitch, r0, nrows, c0, ncols;

  // A 16-byte aligned address the copies of zeros name (they read none).
  __device__ __forceinline__ const char* dummy() const {
    return reinterpret_cast<const char*>(
        reinterpret_cast<uintptr_t>(base) & ~uintptr_t(15));
  }
};
using BoxSrc = Src<uint16_t>;  // a bf16 box: 64 rows x 64 columns

// A box of kRows rows of kRowBytes bytes at `dst`, as TMA lays it out, in
// kBytes (16, 8 or 4) copies by kThreads producer threads: thread p makes
// copies p, p + kThreads, ... of the box's in row order (neighbouring
// threads on neighbouring bytes of a row).  kSwizzle: rows of 128 bytes,
// 16-byte chunk c of row r at (c ^ (r % 8)) x 16 (SWIZZLE_128B, the box on
// a 1024-byte boundary); else row r at r x kRowBytes, unswizzled.  Every
// trip count is a compile-time constant, and a thread whose copies all
// lie inside the matrix (every box but the edges') makes them without
// the predicate and selects of the zero fill: the producers' instructions
// are what an async instance adds to the TMA one's work.
template <int kBytes, int kRows, int kRowBytes, bool kSwizzle, int kThreads,
          class E>
__device__ __forceinline__ void copy_rows(uint32_t dst, const Src<E>& b,
                                          int p) {
  constexpr int kPer = kRowBytes / kBytes;  // copies a box row
  constexpr int kElems = kBytes / int(sizeof(E));  // elements a copy
  static_assert(kElems >= 1 && kRowBytes % kBytes == 0, "whole copies");
  static_assert(!kSwizzle || (kRowBytes == 128 && kThreads % kPer == 0),
                "the swizzle's rows are 128 bytes");
  static_assert(kThreads % kPer == 0 || kPer % kThreads == 0,
                "producers cover whole rows");
  static_assert(kRows * kPer % kThreads == 0, "every thread copies alike");
  const size_t pitch = size_t(b.pitch) * sizeof(E);  // bytes
  if constexpr (kThreads % kPer == 0) {
    // A column q of kBytes, every kRowStep-th row from p / kPer.
    constexpr int kRowStep = kThreads / kPer;  // rows between a thread's
    const int q = p % kPer, r_first = p / kPer;
    const int col = b.c0 + q * kElems;
    // this thread's copy i is real while i x kRowStep < rows
    const int rows = col < b.ncols ? b.nrows - b.r0 - r_first : 0;
    const char* src = reinterpret_cast<const char*>(
        b.base + (size_t(b.r0 + r_first) * b.pitch + col));
    const size_t step = kRowStep * pitch;
    const int byte = q * kBytes;
    const uint32_t at =
        dst + r_first * kRowBytes + (kSwizzle ? (byte & 15) : byte);
    constexpr int kCopies = kRows / kRowStep;
    auto to = [&](int i) {  // copy i's shared address
      const int swz = kRowStep % 8 == 0 ? r_first & 7
                                        : (r_first + i * kRowStep) & 7;
      return at + i * kRowStep * kRowBytes +
             (kSwizzle ? (((byte >> 4) ^ swz) << 4) : 0);
    };
    if ((kCopies - 1) * kRowStep < rows) {
#pragma unroll
      for (int i = 0; i < kCopies; ++i)
        copy_async_all<kBytes>(to(i), src + i * step);
    } else {
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const bool in = i * kRowStep < rows;
        copy_async<kBytes>(to(i), in ? src + i * step : b.dummy(),
                           in ? kBytes : 0);
      }
    }
  } else {
    // Rows wider than the producers' copies: kCols columns of every row,
    // p, p + kThreads, ...
    constexpr int kCols = kPer / kThreads;
    const int rows = b.nrows - b.r0;
    const char* src = reinterpret_cast<const char*>(
        b.base + (size_t(b.r0) * b.pitch + b.c0 + p * kElems));
    bool col_in[kCols];
    bool all = rows >= kRows;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      col_in[j] = b.c0 + (p + j * kThreads) * kElems < b.ncols;
      all = all && col_in[j];
    }
    const uint32_t at = dst + p * kBytes;
    if (all) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          copy_async_all<kBytes>(at + r * kRowBytes + j * kThreads * kBytes,
                                 src + r * pitch + j * kThreads * kBytes);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const bool in = col_in[j] && r < rows;
          const int off = j * kThreads * kBytes;
          copy_async<kBytes>(at + r * kRowBytes + off,
                             in ? src + r * pitch + off : b.dummy(),
                             in ? kBytes : 0);
        }
      }
    }
  }
}

// The 2-byte tier, a warp for rows warp, warp + kAsyncProducerWarps, ...
// of a box, in two passes.  A row's 64 elements (128 bytes) start s = 0,
// 2, ..., 14 bytes into an aligned 16-byte chunk, so they lie in its 8
// aligned chunks from there (9 where s > 0).  copy_chunks: the warp copies
// four rows at a time, lane l chunk l % 8 of the (l / 8)-th row, through
// cp.async to the box row, unswizzled, and chunk 8 of each row to the
// row's 16 bytes in `side`; a chunk with no element below ncols, and a row
// at or past nrows, is zeros.
constexpr int kWordRows = 64 / kAsyncProducerWarps;  // a warp's rows a box
static_assert(kWordRows % 4 == 0, "a warp copies four rows at a time");

// The byte address of element c0 of the warp's first row.
__device__ __forceinline__ const char* row_start(const BoxSrc& b, int warp) {
  return reinterpret_cast<const char*>(
      b.base + (size_t(b.r0 + warp) * b.pitch + b.c0));
}

__device__ __forceinline__ void copy_chunks(uint32_t dst, uint32_t side,
                                            const BoxSrc& b, int p) {
  const int warp = p >> 5, lane = p & 31;
  const int c = lane & 7, sub = lane >> 3;  // chunk, row of the four
  const char* a0 = row_start(b, warp);
  const size_t step = size_t(kAsyncProducerWarps) * b.pitch * 2;
  const int rows = b.nrows - b.r0 - warp;  // row i is real while i kW < rows
#pragma unroll
  for (int i4 = 0; i4 < kWordRows; i4 += 4) {
    const int i = i4 + sub;
    const int r = warp + i * kAsyncProducerWarps;
    const char* a = a0 + i * step;
    const int s = reinterpret_cast<uintptr_t>(a) & 15;
    const char* ch = a - s;  // the row's first aligned chunk
    const bool row = i * kAsyncProducerWarps < rows;
    // chunk c holds the row's elements from (16 c - s) / 2 on
    const bool in = row && b.c0 + max((16 * c - s) / 2, 0) < b.ncols;
    copy_async<16>(dst + r * 128 + 16 * c, in ? ch + 16 * c : b.dummy(),
                   in ? 16 : 0);
    if (c == 0) {
      const bool end = row && s != 0 && b.c0 + (128 - s) / 2 < b.ncols;
      copy_async<16>(side + 16 * r, end ? ch + 128 : b.dummy(),
                     end ? 16 : 0);
    }
  }
}

// realign_chunks, once the warp's copy_chunks have landed: lane t takes
// the row's bytes [s + 4 t, s + 4 t + 4) -- words q = (s + 4 t) / 4 and q
// + 1 of the 144 copied (words 32-35 in `side`), funnel-shifted by 8 (s %
// 4) bits: the pair of elements 2 t, 2 t + 1 -- and zeroes those at or
// past ncols; once the warp has read all its rows, it stores each pair
// where TMA's box has it (16-byte chunk t / 4, swizzled, 4 bytes (t % 4)
// in).
__device__ __forceinline__ void realign_chunks(uint32_t dst, uint32_t side,
                                               const BoxSrc& b, int p) {
  const int warp = p >> 5, lane = p & 31;
  const int e = b.c0 + 2 * lane;  // the pair's first element
  const char* a0 = row_start(b, warp);
  const size_t step = size_t(kAsyncProducerWarps) * b.pitch * 2;
  __syncwarp();  // the other lanes' copies, landed, are seen
  uint32_t lo[kWordRows], hi[kWordRows];
  int shift[kWordRows];
#pragma unroll
  for (int i = 0; i < kWordRows; ++i) {
    const int r = warp + i * kAsyncProducerWarps;
    const int s = reinterpret_cast<uintptr_t>(a0 + i * step) & 15;
    const int q = (s >> 2) + lane;
    auto word = [&](int k) {
      return k < 32 ? dst + r * 128 + 4 * k : side + 16 * r + 4 * (k - 32);
    };
    lo[i] = ld_shared_u32(word(q));
    hi[i] = ld_shared_u32(word(q + 1));
    shift[i] = 8 * (s & 3);
  }
  uint32_t out[kWordRows];
#pragma unroll
  for (int i = 0; i < kWordRows; ++i) {
    out[i] = __funnelshift_r(lo[i], hi[i], shift[i]);
    if (e + 1 >= b.ncols) out[i] = e < b.ncols ? out[i] & 0xFFFFu : 0u;
  }
  __syncwarp();  // every lane has read the rows it overwrites
#pragma unroll
  for (int i = 0; i < kWordRows; ++i) {
    const int r = warp + i * kAsyncProducerWarps;
    st_shared_u32(dst + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) +
                      4 * (lane & 3),
                  out[i]);
  }
}

// A box's copies at kBytes (2: the first pass), and its second pass.
template <int kBytes>
__device__ __forceinline__ void load_box(uint32_t dst, uint32_t side,
                                         const BoxSrc& b, int p) {
  if constexpr (kBytes == 2)
    copy_chunks(dst, side, b, p);
  else
    copy_rows<kBytes, 64, 128, true, kAsyncProducers>(dst, b, p);
}
template <int kBytes>
__device__ __forceinline__ void finish_box(uint32_t dst, uint32_t side,
                                           const BoxSrc& b, int p) {
  if constexpr (kBytes == 2) realign_chunks(dst, side, b, p);
}

// The forward's ring: stage s holds kConsumers x boxes (64 rows x 64 deep)
// and kBN / 64 w boxes (64 deep x 64 columns, or 64 columns x 64 deep
// read K-major), then the full and empty barriers of each stage, then
// (async) each box's ninth chunks of its rows for the 2-byte tier.
constexpr int kFwdBoxes = kConsumers + kBN / 64;
constexpr int kSideBytes = 64 * 16;  // a box's 64 rows' ninth chunks
constexpr int kBarBytes = 128;      // a ring's barriers (and info words)
constexpr int kAsyncSmem =
    kStages * kStageBytes + 1024 + kBarBytes + kStages * kFwdBoxes * kSideBytes;
static_assert(2 * kStages * 8 <= kBarBytes, "the barriers fit");
__device__ __forceinline__ uint32_t fwd_xbox(uint32_t ring, int s, int h) {
  return ring + s * kStageBytes + h * kXBox;
}
__device__ __forceinline__ uint32_t fwd_wbox(uint32_t ring, int s, int j) {
  return ring + s * kStageBytes + kConsumers * kXBox + j * kWBox;
}
__device__ __forceinline__ uint32_t fwd_full(uint32_t ring, int s) {
  return ring + kStages * kStageBytes + 8u * s;
}
__device__ __forceinline__ uint32_t fwd_empty(uint32_t ring, int s) {
  return ring + kStages * kStageBytes + 8u * (kStages + s);
}
__device__ __forceinline__ uint32_t fwd_side(uint32_t ring, int s, int box) {
  return ring + kStages * kStageBytes + kBarBytes +
         (s * kFwdBoxes + box) * kSideBytes;
}

// A forward block's loads: its tile's group g, real rows `rows` from row0
// (x boxes for the nwg warpgroups with real rows), columns from n0, nk
// stages of kBK deep.
struct FwdTile {
  uint32_t ring;
  int nk, nwg, rows, row0, n0, g, d, f;
};

// TMA: x as (T rows, d) with 64 x 64 boxes, w with 1 x 64 x 64 boxes, zero
// fill past the edges.  One lane of the producer warp keeps the ring full.
struct TmaFwd {
  static constexpr int kThreads = 32, kArrivals = 1;
  static constexpr bool kAsync = false;
  const CUtensorMap* tmx;
  const CUtensorMap* tmw;

  template <bool kWKMajor>
  __device__ __forceinline__ void load(const FwdTile& b, int p) const {
    if (p != 0) return;
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(tmx))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(tmw))
                 : "memory");
    const int bytes = b.nwg * kXBox + (kBN / 64) * kWBox;
    for (int kt = 0; kt < b.nk; ++kt) {
      const int s = kt % kStages;
      const uint32_t full = fwd_full(b.ring, s);
      mbar_wait(fwd_empty(b.ring, s), ((kt / kStages) & 1) ^ 1);
      mbar_expect_tx(full, bytes);
      for (int h = 0; h < b.nwg; ++h)
        tma_load_2d(fwd_xbox(b.ring, s, h), tmx, kt * kBK, b.row0 + 64 * h,
                    full);
      for (int j = 0; j < kBN / 64; ++j) {
        if (kWKMajor)
          tma_load_3d(fwd_wbox(b.ring, s, j), tmw, kt * kBK, b.n0 + 64 * j,
                      b.g, full);
        else
          tma_load_3d(fwd_wbox(b.ring, s, j), tmw, b.n0 + 64 * j, kt * kBK,
                      b.g, full);
      }
    }
  }
};

// cp.async: x (T, d) and w, (G, d, f) or, read K-major, stored (G, f, d);
// xbytes and wbytes their copy widths.  The rows of x past the block's
// real rows are zeros: they feed only output rows the epilogue writes as
// +0, so TMA's noise there and these zeros give the same bits.  With a
// 2-byte operand a stage's copies are one cp.async group, and the stage is
// realigned and handed over kFwdLag stages later, its copies landing
// while the next ones are issued.  The consumers hand a stage back once
// they hold the next, so the producers, waiting for a free stage, have
// handed over every stage but the last kStages - 2 before they wait: the
// lag cannot stall the ring.
constexpr int kFwdLag = kStages - 2;
struct AsyncFwd {
  static constexpr int kThreads = kAsyncProducers, kArrivals = kAsyncProducers;
  static constexpr bool kAsync = true;
  const uint16_t* x;
  const uint16_t* w;
  int xbytes, wbytes;

  template <bool kWKMajor>
  __device__ __forceinline__ void load(const FwdTile& b, int p) const {
    with_width(xbytes, [&](auto xw) {
      with_width(wbytes, [&](auto ww) {
        this->template stages<kWKMajor, decltype(xw)::value,
                              decltype(ww)::value>(b, p);
      });
    });
    cp_async_wait<0>();
  }

  template <bool kWKMajor, int kX, int kW>
  __device__ __forceinline__ void stages(const FwdTile& b, int p) const {
    constexpr bool kRealign = kX == 2 || kW == 2;
    const uint16_t* wg = w + size_t(b.g) * b.d * b.f;
    auto xsrc = [&](int kt, int h) {
      return BoxSrc{x, b.d, b.row0 + 64 * h, b.row0 + b.rows, kt * kBK, b.d};
    };
    auto wsrc = [&](int kt, int j) {
      // K-major: rows are w's f (the output), columns its d
      return kWKMajor ? BoxSrc{wg, b.d, b.n0 + 64 * j, b.f, kt * kBK, b.d}
                      : BoxSrc{wg, b.f, kt * kBK, b.d, b.n0 + 64 * j, b.f};
    };
    constexpr int kLag = kRealign ? kFwdLag : 0;
    for (int kt = 0; kt < b.nk + kLag; ++kt) {
      if (kt < b.nk) {
        const int s = kt % kStages;
        mbar_wait(fwd_empty(b.ring, s), ((kt / kStages) & 1) ^ 1);
        for (int h = 0; h < b.nwg; ++h)
          load_box<kX>(fwd_xbox(b.ring, s, h), fwd_side(b.ring, s, h),
                       xsrc(kt, h), p);
        for (int j = 0; j < kBN / 64; ++j)
          load_box<kW>(fwd_wbox(b.ring, s, j),
                       fwd_side(b.ring, s, kConsumers + j), wsrc(kt, j), p);
        if constexpr (kRealign)
          cp_async_commit();
        else
          stage_arrive(fwd_full(b.ring, s));
      }
      const int kf = kt - kLag;  // the stage to realign and hand over
      if (kRealign && kf >= 0) {
        const int s = kf % kStages;
        if (kt < b.nk)
          cp_async_wait<kLag>();
        else
          cp_async_wait<0>();
        for (int h = 0; h < b.nwg; ++h)
          finish_box<kX>(fwd_xbox(b.ring, s, h), fwd_side(b.ring, s, h),
                         xsrc(kf, h), p);
        for (int j = 0; j < kBN / 64; ++j)
          finish_box<kW>(fwd_wbox(b.ring, s, j),
                         fwd_side(b.ring, s, kConsumers + j), wsrc(kf, j),
                         p);
        mbar_arrive(fwd_full(b.ring, s));
      }
    }
  }
};

// The forward and dX: one block a 128 x 128 tile of y, the ring filled by
// `loads` (TmaFwd or AsyncFwd), two consumer warpgroups.  kWKMajor false:
// w is (G, d, f), a box 64 deep x 64 columns, read MN-major (the forward).
// kWKMajor true: w is stored (G, f, d), the transpose of the weights this
// call multiplies by (dX = dy w^T reads the forward's w untransposed), a
// box 64 columns (rows of the stored w) x 64 deep, read K-major: the same
// products in the same order, so the result equals the call on a
// contiguous copy of w^T bit for bit.  ybytes: y's store width (16 with
// TMA; the async instances store two columns at a time where y's width is
// 4 bytes or more, else one).
template <bool kWKMajor, class Loads>
__device__ __forceinline__ void gmm_bf16_wgmma(
    const Loads& loads, const int* __restrict__ tile_gid,
    const int* __restrict__ tile_rows, __nv_bfloat16* __restrict__ y, int d,
    int f, int G, int bt, int ybytes) {
  constexpr int kThreadsAll = kConsumers * 128 + Loads::kThreads;
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBM;
  const int t = row0 / bt;
  const int g = tile_gid[t];
  auto fill = [&](int r0, int r1, uint16_t bits, int i, int n) {
    if constexpr (!Loads::kAsync)
      fill_bf16<16>(y, r0, r1, n0, f, bits, i, n);
    else
      with_width(ybytes, [&](auto yw) {
        fill_bf16<decltype(yw)::value>(y, r0, r1, n0, f, bits, i, n);
      });
  };
  if (g < 0 || g >= G) {
    fill(row0, row0 + kBM, kBf16Nan, tid, kThreadsAll);
    return;
  }
  const int rows = block_rows(tile_rows, t, row0, bt, kBM);
  if (rows == 0) {
    fill(row0, row0 + kBM, 0, tid, kThreadsAll);
    return;
  }
  const int nwg = rows > 64 ? 2 : 1;  // consumer warpgroups with real rows

  // Stages on 1024-byte boundaries (the 128-byte swizzle's atom), then
  // the full and empty barriers of each stage.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(fwd_full(ring, s), Loads::kArrivals);
      mbar_init(fwd_empty(ring, s), nwg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nk = (d + kBK - 1) / kBK;
  const int wg = tid / 128;
  if (wg == kConsumers) {
    if constexpr (Loads::kAsync) set_max_regs<true>();
    loads.template load<kWKMajor>(
        FwdTile{ring, nk, nwg, rows, row0, n0, g, d, f}, tid - kConsumers * 128);
    return;
  }
  if constexpr (Loads::kAsync) set_max_regs<false>();

  // Consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the tile.
  const int lane = tid & 31, warp = (tid & 127) >> 5;
  const int r_lo = 64 * wg + 16 * warp + (lane >> 2);  // and r_lo + 8
  if (wg >= nwg) {
    fill(row0 + 64 * wg, row0 + 64 * wg + 64, 0, tid & 127, 128);
    return;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  acc_fence(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(fwd_full(ring, s), (kt / kStages) & 1);
    if constexpr (Loads::kAsync) fence_proxy_async();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t a = gmma_desc(fwd_xbox(ring, s, wg) + 32 * kk, kALbo, kASbo);
      // K-major w: each of the 128 columns one 128-byte line of depth, as
      // x's rows (the two boxes adjoin, so 8-column atoms stay 1 KB apart)
      if (kWKMajor)
        wgmma_m64n128k16<0, 0>(
            acc, a, gmma_desc(fwd_wbox(ring, s, 0) + 32 * kk, kALbo, kASbo));
      else
        wgmma_m64n128k16<0, 1>(
            acc, a, gmma_desc(fwd_wbox(ring, s, 0) + 2048 * kk, kBLbo, kBSbo));
    }
    wgmma_commit();
    acc_fence(acc);
    // The previous stage's products are done: hand its buffers back.
    wgmma_wait<1>();
    acc_fence(acc);
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(fwd_empty(ring, (kt - 1) % kStages));
  }
  wgmma_wait<0>();
  acc_fence(acc);

  // Epilogue: accumulator 4 i + {0, 1} of lane l holds row r_lo, columns
  // 8 i + 2 (l % 4) + {0, 1}; 4 i + {2, 3} row r_lo + 8.  Rows past the
  // count are written as +0; one cast to bf16.  A pair of columns goes in
  // one 4-byte store where y's width allows (f even: a pair lies wholly
  // on one side of f), else one column a store.
  const bool pairs = !Loads::kAsync || ybytes >= 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    const bool real = r < rows;
    __nv_bfloat16* out = y + size_t(row0 + r) * f;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * (lane & 3);
      const float a = real ? acc[4 * i + 2 * half] : 0.0f;
      const float b = real ? acc[4 * i + 2 * half + 1] : 0.0f;
      if (pairs) {
        if (col < f) *reinterpret_cast<uint32_t*>(out + col) = pack2(a, b);
      } else {
        if (col < f) out[col] = __float2bfloat16(a);
        if (col + 1 < f) out[col + 1] = __float2bfloat16(b);
      }
    }
  }
}

// bf16 that TMA can describe: the ring filled by TMA (see gmm_bf16_wgmma).
template <bool kWKMajor>
__global__ void __launch_bounds__(kTmaThreads, 1)
    gmm_bf16_tma(const __grid_constant__ CUtensorMap tmx,
                 const __grid_constant__ CUtensorMap tmw,
                 const int* __restrict__ tile_gid,
                 const int* __restrict__ tile_rows,
                 __nv_bfloat16* __restrict__ y, int d, int f, int G, int bt) {
  gmm_bf16_wgmma<kWKMajor>(TmaFwd{&tmx, &tmw}, tile_gid, tile_rows, y, d, f,
                           G, bt, 16);
}

// bf16 that TMA cannot describe (a width not a multiple of 8, a base off
// 16 bytes): the same consumers, the ring filled through cp.async at each
// operand's own width.
template <bool kWKMajor>
__global__ void __launch_bounds__(kAsyncThreads, 1)
    gmm_bf16_async(const uint16_t* __restrict__ x,
                   const uint16_t* __restrict__ w,
                   const int* __restrict__ tile_gid,
                   const int* __restrict__ tile_rows,
                   __nv_bfloat16* __restrict__ y, int d, int f, int G, int bt,
                   int xbytes, int wbytes, int ybytes) {
  gmm_bf16_wgmma<kWKMajor>(AsyncFwd{x, w, xbytes, wbytes}, tile_gid,
                           tile_rows, y, d, f, G, bt, ybytes);
}

// ------------------------------------------------------ f32: TMA + FMA
constexpr int kFBM = 64;       // rows of an f32 block's tile (divides bt)
constexpr int kF32BN = 256;    // columns of a block's tile: 32 lanes x 8
constexpr int kF32BK = 32;     // depth of a stage: one 128-byte f32 line
constexpr int kF32Stages = 4;  // ring depth: 160 KB of the SM's 227 KB
constexpr int kF32Warps = kFBM / 8;                // consumers, 8 rows each
constexpr int kF32Threads = kF32Warps * 32 + 32;  // + one producer warp
constexpr int kF32WBytes = kF32BK * kF32BN * 4;   // w's box: 32 KB
constexpr int kF32XBytes = kFBM * kF32BK * 4;     // x's box: 8 KB
constexpr int kF32StageBytes = kF32WBytes + kF32XBytes;
constexpr int kF32Smem =
    kF32Stages * kF32StageBytes + 1024 + 2 * kF32Stages * 8;
// The async instance's consumers are two warpgroups, as the bf16 ones,
// and keep the launch's 168 registers a thread: with setmaxnreg 96 / 200,
// as in bf16, its producers spilled (656 bytes in the dX instance) and no
// f32 call ran faster (0-1% slower; 2-7% while every copy was predicated;
// benchmarks/f32_tune.py).
static_assert(kF32Warps * 32 == kConsumers * 128, "the consumer warpgroups");

// Rows [r0, r1) x columns [n0, n0 + kF32BN) of an f32 y set to v, columns
// past f left alone, kBytes (16, 8 or 4) a store: kBytes divides y's row
// pitch (4 f) and base, so a store lies wholly on one side of f.
template <int kBytes>
__device__ __forceinline__ void fill_f32(float* y, int r0, int r1, int n0,
                                         int f, float v, int tid,
                                         int nthreads) {
  constexpr int kPer = kF32BN * 4 / kBytes;  // stores a row of the tile
  const auto bits = Bits<kBytes>::of(__float_as_uint(v));
  for (int e = tid; e < (r1 - r0) * kPer; e += nthreads) {
    const int c = n0 + (e % kPer) * (kBytes / 4);
    if (c < f)
      *reinterpret_cast<typename Bits<kBytes>::T*>(
          y + size_t(r0 + e / kPer) * f + c) = bits;
  }
}

// v at columns [col, col + 4) of an f32 row, those below `end`, kBytes (16,
// 8 or 4) a store: kBytes divides the row's pitch and base and `end` is a
// multiple of kBytes / 4, so a store lies wholly on one side of it.
template <int kBytes>
__device__ __forceinline__ void store4_f32(float* row, int col, int end,
                                           const float4& v) {
  if constexpr (kBytes == 16) {
    if (col < end) *reinterpret_cast<float4*>(row + col) = v;
  } else if constexpr (kBytes == 8) {
    if (col < end)
      *reinterpret_cast<float2*>(row + col) = make_float2(v.x, v.y);
    if (col + 2 < end)
      *reinterpret_cast<float2*>(row + col + 2) = make_float2(v.z, v.w);
  } else {
    if (col < end) row[col] = v.x;
    if (col + 1 < end) row[col + 1] = v.y;
    if (col + 2 < end) row[col + 2] = v.z;
    if (col + 3 < end) row[col + 3] = v.w;
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// gmm_f32_fma's epilogue for consumer warp `warp`: its rows [8 warp, 8
// warp + 8) of the tile, rows past the count written as +0.  The forward
// stores a lane's four adjoining columns in stores of kY bytes (y's
// width); dX (kWKMajor) one column a store.
template <bool kWKMajor, int kY>
__device__ __forceinline__ void f32_epilogue(const float (&acc)[8][8],
                                             float* y, int row0, int rows,
                                             int n0, int f, int warp,
                                             int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * warp + i;
    const bool real = r < rows;
    float* out = y + size_t(row0 + r) * f;
    if (kWKMajor) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + lane + 32 * j;
        if (col < f) out[col] = real ? acc[i][j] : 0.0f;
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4_f32<kY>(out, n0 + 128 * h + 4 * lane, f,
                       real ? make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                          acc[i][4 * h + 2],
                                          acc[i][4 * h + 3])
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    }
  }
}

// A forward f32 block's loads: its tile's group g, real rows `rows` from
// row0, columns from n0, nk stages of kF32BK deep.  Stage s holds w's box,
// then x's, on a 1024-byte boundary; `bars` the full and empty barriers.
struct F32Tile {
  uint32_t ring, bars;
  int nk, rows, row0, n0, g, d, f;

  __device__ __forceinline__ uint32_t stage(int s) const {
    return ring + s * kF32StageBytes;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return bars + 8u * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8u * (kF32Stages + s);
  }
};

// TMA: x as (T rows, d) with 32-deep x 64-row boxes, w with boxes of one
// group (see gmm_f32_fma); zero fill past the edges.  One lane of the
// producer warp keeps the ring full.
struct TmaF32Fwd {
  static constexpr int kThreads = 32, kArrivals = 1;
  static constexpr bool kAsync = false;
  const CUtensorMap* tmx;
  const CUtensorMap* tmw;

  template <bool kWKMajor>
  __device__ __forceinline__ void load(const F32Tile& b, int p) const {
    if (p != 0) return;
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(tmx))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(tmw))
                 : "memory");
    for (int kt = 0; kt < b.nk; ++kt) {
      const int s = kt % kF32Stages;
      mbar_wait(b.empty(s), ((kt / kF32Stages) & 1) ^ 1);
      mbar_expect_tx(b.full(s), kF32StageBytes);
      tma_load_2d(b.stage(s) + kF32WBytes, tmx, kt * kF32BK, b.row0,
                  b.full(s));
      if (kWKMajor)
        tma_load_3d(b.stage(s), tmw, kt * kF32BK, b.n0, b.g, b.full(s));
      else
        tma_load_3d(b.stage(s), tmw, b.n0, kt * kF32BK, b.g, b.full(s));
    }
  }
};

// cp.async: x (T, d) and w, (G, d, f) or, read K-major, stored (G, f, d),
// at copy widths xbytes and wbytes (16, 8 or 4), a warpgroup of producer
// threads writing each stage's boxes in TMA's bytes (copy_rows).  The rows
// of x past the block's real rows are zeros: they feed only output rows
// the epilogue writes as +0, so TMA's noise there and these zeros give
// the same bits.
struct AsyncF32Fwd {
  static constexpr int kThreads = kAsyncProducers, kArrivals = kAsyncProducers;
  static constexpr bool kAsync = true;
  const float* x;
  const float* w;
  int xbytes, wbytes;

  template <bool kWKMajor>
  __device__ __forceinline__ void load(const F32Tile& b, int p) const {
    with_width<4>(xbytes, [&](auto xw) {
      with_width<4>(wbytes, [&](auto ww) {
        this->template stages<kWKMajor, decltype(xw)::value,
                              decltype(ww)::value>(b, p);
      });
    });
    cp_async_wait<0>();
  }

  template <bool kWKMajor, int kX, int kW>
  __device__ __forceinline__ void stages(const F32Tile& b, int p) const {
    const float* wg = w + size_t(b.g) * b.d * b.f;
    for (int kt = 0; kt < b.nk; ++kt) {
      const int s = kt % kF32Stages, k0 = kt * kF32BK;
      mbar_wait(b.empty(s), ((kt / kF32Stages) & 1) ^ 1);
      copy_rows<kX, kFBM, kF32BK * 4, false, kThreads>(
          b.stage(s) + kF32WBytes,
          Src<float>{x, b.d, b.row0, b.row0 + b.rows, k0, b.d}, p);
      if constexpr (kWKMajor)  // rows are w's f (the output), columns its d
        copy_rows<kW, kF32BN, kF32BK * 4, true, kThreads>(
            b.stage(s), Src<float>{wg, b.d, b.n0, b.f, k0, b.d}, p);
      else
        copy_rows<kW, kF32BK, kF32BN * 4, false, kThreads>(
            b.stage(s), Src<float>{wg, b.f, k0, b.d, b.n0, b.f}, p);
      stage_arrive(b.full(s));
    }
  }
};

// The f32 forward and dX: one block a 64 x 256 tile of y, the ring filled
// by `loads` (TmaF32Fwd or AsyncF32Fwd).  x's box is 64 rows x 32 deep.
// kWKMajor false: w is (G, d, f), a box 32 deep x 256 columns, unswizzled:
// a depth row of the box is 1 KB, and lane l reads columns 4 l .. 4 l + 3
// and 128 + 4 l .. of it.  kWKMajor true: w is stored (G, f, d), the
// transpose of the weights this call multiplies by (dX on the forward's
// w), a box 256 columns (rows of the stored w) x 32 deep with the 128-byte
// swizzle: column n is one 128-byte line whose 16-byte chunk c sits at c ^
// (n % 8); lane l reads columns l + 32 j.  Either way each output is the
// same fmaf chain, so the result equals the call on a contiguous copy of
// w^T bit for bit.  ybytes: y's store width (16 with TMA; the async
// instance stores at y's copy width, where f is not a multiple of 4 or y
// lies off 16 bytes).
template <bool kWKMajor, class Loads>
__device__ __forceinline__ void gmm_f32_fma(const Loads& loads,
                                            const int* __restrict__ tile_gid,
                                            const int* __restrict__ tile_rows,
                                            float* __restrict__ y, int d,
                                            int f, int G, int bt,
                                            int ybytes) {
  constexpr int kThreadsAll = kF32Warps * 32 + Loads::kThreads;
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kF32BN;
  const int row0 = blockIdx.y * kFBM;
  const int t = row0 / bt;
  const int g = tile_gid[t];
  auto fill = [&](int r0, int r1, float v, int i, int n) {
    if constexpr (!Loads::kAsync)
      fill_f32<16>(y, r0, r1, n0, f, v, i, n);
    else
      with_width<4>(ybytes, [&](auto yw) {
        fill_f32<decltype(yw)::value>(y, r0, r1, n0, f, v, i, n);
      });
  };
  if (g < 0 || g >= G) {
    fill(row0, row0 + kFBM, CUDART_NAN_F, tid, kThreadsAll);
    return;
  }
  const int rows = block_rows(tile_rows, t, row0, bt, kFBM);
  if (rows == 0) {
    fill(row0, row0 + kFBM, 0.0f, tid, kThreadsAll);
    return;
  }
  // A block whose real rows fit in 8 (the decode calls) splits its 256
  // columns over the 8 warps instead, one a lane: every warp computes.
  const bool narrow = rows <= 8;
  const int nwarps = narrow ? kF32Warps : (rows + 7) / 8;  // computing

  // Stages on 1024-byte boundaries (the swizzle's atom), w's box first;
  // then the full and empty barriers of each stage.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int nk = (d + kF32BK - 1) / kF32BK;
  const F32Tile tile{ring, ring + kF32Stages * kF32StageBytes, nk, rows,
                     row0, n0, g, d, f};
  if (tid == 0) {
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(tile.full(s), Loads::kArrivals);
      mbar_init(tile.empty(s), nwarps * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kF32Warps) {
    loads.template load<kWKMajor>(tile, tid - kF32Warps * 32);
    return;
  }
  if (warp >= nwarps) {
    fill(row0 + 8 * warp, row0 + 8 * warp + 8, 0.0f, lane, 32);
    return;
  }
  const float* ring_f = reinterpret_cast<const float*>(smem_raw + (ring - raw));
  if (narrow) {
    // Rows 0..7 of the tile, column 32 warp + lane: each depth step reads
    // the 8 rows (one address a warp) and one value of w a lane, for 8
    // FMAs; the rows past 8 are zeros.
    fill(row0 + 8, row0 + kFBM, 0.0f, tid, kF32Warps * 32);
    const int n = 32 * warp + lane;
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kF32Stages;
      mbar_wait(tile.full(s), (kt / kF32Stages) & 1);
      const float* ws = ring_f + s * (kF32StageBytes / 4);
      const float* xs = ws + kF32WBytes / 4;
#pragma unroll 2
      for (int kc = 0; kc < kF32BK / 4; ++kc) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(xs + i * kF32BK + 4 * kc);
        float4 b;
        if (kWKMajor)
          b = *reinterpret_cast<const float4*>(ws + n * kF32BK +
                                               4 * (kc ^ (lane & 7)));
        else
          b = make_float4(ws[(4 * kc) * kF32BN + n],
                          ws[(4 * kc + 1) * kF32BN + n],
                          ws[(4 * kc + 2) * kF32BN + n],
                          ws[(4 * kc + 3) * kF32BN + n]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[i] = fmaf(lane_of(a[i], kk), lane_of(b, kk), acc[i]);
      }
      mbar_arrive(tile.empty(s));
    }
    const int col = n0 + n;
    if (col < f) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        y[size_t(row0 + i) * f + col] = i < rows ? acc[i] : 0.0f;
    }
    return;
  }

  // Consumer warp: rows [8 warp, 8 warp + 8) of the tile, 8 columns a lane.
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kF32Stages;
    mbar_wait(tile.full(s), (kt / kF32Stages) & 1);
    const float* ws = ring_f + s * (kF32StageBytes / 4);
    const float* xs = ws + kF32WBytes / 4 + 8 * warp * kF32BK;
#pragma unroll 2
    for (int kc = 0; kc < kF32BK / 4; ++kc) {
      // x: rows 8 warp + i, depths 4 kc .. 4 kc + 3 (one address a warp).
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(xs + i * kF32BK + 4 * kc);
      if (kWKMajor) {
        // w^T: column lane + 32 j, the same four depths, one load each.
        float4 b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = *reinterpret_cast<const float4*>(
              ws + (lane + 32 * j) * kF32BK + 4 * (kc ^ (lane & 7)));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(lane_of(a[i], kk), lane_of(b[j], kk),
                               acc[i][j]);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* wrow = ws + (4 * kc + kk) * kF32BN + 4 * lane;
          const float4 b0 = *reinterpret_cast<const float4*>(wrow);
          const float4 b1 = *reinterpret_cast<const float4*>(wrow + 128);
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(lane_of(a[i], kk), b[j], acc[i][j]);
        }
      }
    }
    // Every lane's reads of the stage are done: hand it back.
    mbar_arrive(tile.empty(s));
  }

  // Epilogue: at y's store width where the forward's stores need one.
  if (!Loads::kAsync || kWKMajor || ybytes == 16)
    f32_epilogue<kWKMajor, 16>(acc, y, row0, rows, n0, f, warp, lane);
  else if (ybytes == 8)
    f32_epilogue<kWKMajor, 8>(acc, y, row0, rows, n0, f, warp, lane);
  else
    f32_epilogue<kWKMajor, 4>(acc, y, row0, rows, n0, f, warp, lane);
}

// f32 that TMA can describe: the ring filled by TMA (see gmm_f32_fma).
template <bool kWKMajor>
__global__ void __launch_bounds__(kF32Threads, 1)
    gmm_f32_tma(const __grid_constant__ CUtensorMap tmx,
                const __grid_constant__ CUtensorMap tmw,
                const int* __restrict__ tile_gid,
                const int* __restrict__ tile_rows, float* __restrict__ y,
                int d, int f, int G, int bt) {
  gmm_f32_fma<kWKMajor>(TmaF32Fwd{&tmx, &tmw}, tile_gid, tile_rows, y, d, f,
                        G, bt, 16);
}

// f32 that TMA cannot describe (a width not a multiple of 4, a base off 16
// bytes): the same consumers, the ring filled through cp.async at each
// operand's own width by a producer warpgroup.
template <bool kWKMajor>
__global__ void __launch_bounds__(kAsyncThreads, 1)
    gmm_f32_async(const float* __restrict__ x, const float* __restrict__ w,
                  const int* __restrict__ tile_gid,
                  const int* __restrict__ tile_rows, float* __restrict__ y,
                  int d, int f, int G, int bt, int xbytes, int wbytes,
                  int ybytes) {
  gmm_f32_fma<kWKMajor>(AsyncF32Fwd{x, w, xbytes, wbytes}, tile_gid,
                        tile_rows, y, d, f, G, bt, ybytes);
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
//  * other bfloat16 (gmm_dw_bf16_async): the same consumers on a ring
//    filled through cp.async at x's and dy's own widths (see
//    gmm_bf16_async), the rows past a tile's count zero-filled as they are
//    copied (so the consumers' zeroing step is skipped); each f-tile is
//    stored from registers at dw's width, so the 64 KB staging tile gives
//    the ring a fourth stage, and a block takes as many f-tiles as the
//    grid's size allows (one at small grids, where kDwFTiles would leave
//    most SMs idle: at (b), 32 blocks).  Its results equal
//    gmm_dw_bf16_tma's bit for bit.
//  * float32 that TMA can describe (d and f multiples of 4, 16-byte
//    aligned bases; gmm_dw_f32_tma): the forward's FMA microkernel turned
//    over.  Each output is one fmaf chain over the group's real rows in
//    ascending (tile, row) order from +0.  A block owns a 64 (d) x 128
//    (f) tile of one group's dw, 4 consumer warps, 8 x 8 outputs a thread,
//    and walks one or more f-tiles in turn as gmm_dw_bf16_tma does (one
//    where the grid of single f-tiles would leave the card short of
//    blocks, up to kDwF32MaxFTiles where it is large, so that each block's
//    walk and first loads are paid once for several f-tiles): one producer
//    warp walks the group's tiles 32 ids a step and fills a ring of
//    32-row stages by TMA (x as 32 rows x 64 d-columns, dy as 32 rows x
//    128 f-columns, both unswizzled: a row step of a thread reads 8 d and
//    8 f values as four 128-bit loads along the rows, neighbouring lanes
//    on neighbouring chunks), telling the consumers each stage's real
//    rows.  The consumers sum only those rows: the rows of a box past the
//    count (noise, or NaN) are never read.  Each f-tile is stored from
//    registers with 16-byte stores while the next one's stages arrive.
//    Bound: at the f32 cut's call (32 tokens top-6, E = 64, C = 256, d =
//    2048, f = 1408) the 192 real rows are 1.1 GFLOP against dw's 738 MB
//    written once, 0.22 ms of bytes, so the kernel has to keep the writes
//    streaming; at the ragged case (4 groups, d = 192, f = 160) it is
//    operations and latency.
//  * other float32 (gmm_dw_f32_async): the same consumers on a ring two
//    producer warps fill through cp.async at x's and dy's widths
//    (copy_rows: TMA's bytes, zeros past d, f and the real rows), each
//    f-tile stored at dw's own width; its results equal gmm_dw_f32_tma's
//    bit for bit.

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
constexpr int kDwBoxes = kConsumers + kDwBN / 64;  // a stage's boxes
static_assert(2 * kDwStages * 8 + kDwStages * 4 <= kBarBytes,
              "the barriers and info words fit");
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

// A dW block's walk: d-tile m0 of group g's dw, the f columns [n_lo,
// n_hi) of its chunk, the group's first tile with a real row.  Stage s of
// the ring holds x's kConsumers boxes (d columns m0 + 64 h) and dy's kDwBN
// / 64 (f columns n0 + 64 j), 8 KB each and adjoining; `bars` the full and
// empty barriers of the kStages stages, then their info words, then (the
// async instance) each box's ninth row chunks for the 2-byte tier.
template <int kRing>
struct DwTile {
  static constexpr int kStages = kRing;
  uint32_t ring, bars;
  volatile int* info;
  const int* tile_gid;
  const int* tile_rows;
  int ntiles, bt, g, m0, n_lo, n_hi, first, d, f;

  __device__ __forceinline__ int rows_of(int t) const {
    return tile_rows == nullptr ? bt : min(max(tile_rows[t], 0), bt);
  }
  __device__ __forceinline__ uint32_t box(int s, int b) const {
    return ring + s * kDwStageBytes + b * kXBox;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return bars + 8u * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8u * (kStages + s);
  }
  __device__ __forceinline__ uint32_t side(int s, int b) const {
    return bars + kBarBytes + (s * kDwBoxes + b) * kSideBytes;
  }
};

// The producer's walk, the same in every producer warp: the group's real
// rows once for each f-tile of kFTile columns, kStep rows a stage.
// stage(s, it, row, valid, n0, word) fills ring stage s (the it-th) with
// rows [row, row + kStep) of x and dy, of which `valid` are real, for the
// f-tile at n0, and publishes `word` (the stage's info) with it.  Tile:
// DwTile (bf16, 64-row stages of 256 f columns) or DwF32Tile (f32, 32
// rows of 128).
template <int kStep, int kFTile, class Tile, class Stage>
__device__ __forceinline__ void dw_walk(const Tile& b, int lane,
                                        Stage&& stage) {
  int n0 = b.n_lo, t = b.first, k0 = 0, rt = b.rows_of(b.first);
  for (int it = 0;; ++it) {
    const int s = it % Tile::kStages;
    const int valid = min(rt - k0, kStep);
    int nt = t, nk0 = k0 + kStep;
    if (nk0 >= rt) {
      nt = warp_next_tile(b.tile_gid, b.tile_rows, b.ntiles, b.g, t + 1,
                          lane);
      nk0 = 0;
    }
    const bool tile_end = nt >= b.ntiles;
    const bool last = tile_end && n0 + kFTile >= b.n_hi;
    stage(s, it, t * b.bt + k0, valid, n0,
          valid | (tile_end ? kDwTileEnd : 0) | (last ? kDwLast : 0));
    if (last) break;
    if (tile_end) {
      n0 += kFTile;
      t = b.first;
      k0 = 0;
      rt = b.rows_of(b.first);
    } else {
      if (nt != t) rt = b.rows_of(nt);
      t = nt;
      k0 = nk0;
    }
  }
}

// TMA: x as (T rows, d), dy as (T rows, f), dw as (G, d, f), 64 x 64
// boxes, 128-byte swizzled, zero fill past the edges (a store clips
// there).  The producer warp walks; lane 0 issues the loads of whole
// 64-row boxes, whose rows past a tile's count the consumers zero.  Each
// f-tile is staged in shared memory and stored by TMA.
struct TmaDw {
  static constexpr int kThreads = 32, kArrivals = 1, kStages = kDwStages;
  static constexpr bool kAsync = false;
  const CUtensorMap* tmx;
  const CUtensorMap* tmdy;
  const CUtensorMap* tmdw;

  __device__ __forceinline__ void load(const DwTile<kStages>& b,
                                       int p) const {
    if (p == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(tmx))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(tmdy))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(tmdw))
                   : "memory");
    }
    dw_walk<kBK, kDwBN>(b, p, [&](int s, int it, int row, int, int n0,
                                  int word) {
      if (p == 0) {
        mbar_wait(b.empty(s), ((it / kStages) & 1) ^ 1);
        b.info[s] = word;
        mbar_expect_tx(b.full(s), kDwStageBytes);
        for (int h = 0; h < kConsumers; ++h)
          tma_load_2d(b.box(s, h), tmx, b.m0 + 64 * h, row, b.full(s));
        for (int j = 0; j < kDwBN / 64; ++j)
          tma_load_2d(b.box(s, kConsumers + j), tmdy, n0 + 64 * j, row,
                      b.full(s));
      }
      __syncwarp();
    });
  }
};

// cp.async: x (T, d) and dy (T, f) at copy widths xbytes and dybytes; the
// rows of a box past its `valid` real rows are zeros, as the TMA kernel's
// consumers make them, so the consumers here skip that step.  With no
// staging tile (the consumers store from registers) the ring holds
// kAsyncDwStages stages, and with a 2-byte operand a stage is realigned
// and handed over kDwLag stages behind its copies (as AsyncFwd).
constexpr int kAsyncDwStages = 4;  // 192 KB of the SM's 227 KB
constexpr int kDwAsyncWaves = 2;   // blocks of the grid an SM, at least
constexpr int kDwLag = kAsyncDwStages - 2;
constexpr int kAsyncDwSmem = kAsyncDwStages * kDwStageBytes + 1024 +
                             kBarBytes +
                             kAsyncDwStages * kDwBoxes * kSideBytes;
static_assert(2 * kAsyncDwStages * 8 + kAsyncDwStages * 4 <= kBarBytes,
              "the barriers and info words fit");

struct AsyncDw {
  static constexpr int kThreads = kAsyncProducers, kArrivals = kAsyncProducers;
  static constexpr int kStages = kAsyncDwStages;
  static constexpr bool kAsync = true;
  const uint16_t* x;
  const uint16_t* dy;
  int xbytes, dybytes;

  __device__ __forceinline__ void load(const DwTile<kStages>& b,
                                       int p) const {
    with_width(xbytes, [&](auto xw) {
      with_width(dybytes, [&](auto yw) {
        this->template stages<decltype(xw)::value, decltype(yw)::value>(b,
                                                                       p);
      });
    });
    cp_async_wait<0>();
  }

  template <int kX, int kY>
  __device__ __forceinline__ void stages(const DwTile<kStages>& b,
                                         int p) const {
    constexpr bool kRealign = kX == 2 || kY == 2;
    auto xsrc = [&](int row, int valid, int h) {
      return BoxSrc{x, b.d, row, row + valid, b.m0 + 64 * h, b.d};
    };
    auto ysrc = [&](int row, int valid, int n0, int j) {
      return BoxSrc{dy, b.f, row, row + valid, n0 + 64 * j, b.f};
    };
    // The stages copied and not yet handed over, oldest first.
    int pend = 0, ps[kDwLag + 1], prow[kDwLag + 1], pvalid[kDwLag + 1],
        pn0[kDwLag + 1];
    auto finish_oldest = [&]() {
      for (int h = 0; h < kConsumers; ++h)
        finish_box<kX>(b.box(ps[0], h), b.side(ps[0], h),
                       xsrc(prow[0], pvalid[0], h), p);
      for (int j = 0; j < kDwBN / 64; ++j)
        finish_box<kY>(b.box(ps[0], kConsumers + j),
                       b.side(ps[0], kConsumers + j),
                       ysrc(prow[0], pvalid[0], pn0[0], j), p);
      mbar_arrive(b.full(ps[0]));
#pragma unroll
      for (int i = 0; i < kDwLag; ++i) {
        ps[i] = ps[i + 1];
        prow[i] = prow[i + 1];
        pvalid[i] = pvalid[i + 1];
        pn0[i] = pn0[i + 1];
      }
      --pend;
    };
    dw_walk<kBK, kDwBN>(b, p & 31, [&](int s, int it, int row, int valid,
                                       int n0, int word) {
      mbar_wait(b.empty(s), ((it / kStages) & 1) ^ 1);
      if (p == 0) b.info[s] = word;
      for (int h = 0; h < kConsumers; ++h)
        load_box<kX>(b.box(s, h), b.side(s, h), xsrc(row, valid, h), p);
      for (int j = 0; j < kDwBN / 64; ++j)
        load_box<kY>(b.box(s, kConsumers + j), b.side(s, kConsumers + j),
                     ysrc(row, valid, n0, j), p);
      if constexpr (kRealign) {
        cp_async_commit();
#pragma unroll
        for (int i = 0; i <= kDwLag; ++i)
          if (i == pend) {
            ps[i] = s;
            prow[i] = row;
            pvalid[i] = valid;
            pn0[i] = n0;
          }
        if (++pend > kDwLag) {
          cp_async_wait<kDwLag>();
          finish_oldest();
        }
      } else {
        stage_arrive(b.full(s));
      }
    });
    if constexpr (kRealign) {
      cp_async_wait<0>();
      while (pend > 0) finish_oldest();
    }
  }
};

// Rows [r0, r1) x columns [c0, c1) of a bf16 or f32 matrix with `pitch`
// elements a row set to +0, kBytes a store (kBytes divides the pitch's
// bytes and the base, and c1 - c0 is a whole number of stores).
template <int kBytes, class E>
__device__ __forceinline__ void zero_rows(E* out, int pitch, int r0, int r1,
                                          int c0, int c1, int tid,
                                          int nthreads) {
  constexpr int kElems = kBytes / int(sizeof(E));
  const int per = (c1 - c0) / kElems;
  const auto z = Bits<kBytes>::of(0);
  for (int e = tid; e < (r1 - r0) * per; e += nthreads)
    *reinterpret_cast<typename Bits<kBytes>::T*>(
        out + size_t(r0 + e / per) * pitch + c0 + (e % per) * kElems) = z;
}

// x^T (A, 64 d-rows x 16 rows deep) and dy (B, 16 rows deep x 256 f
// columns) are both MN-major, as w is in the forward: each box row (one
// row of x or dy) is 128 bytes, 8-row atoms 1 KB apart (SBO), dy's next
// 64 columns one box on (LBO); a 16-row step is 2 KB.  A's M = 64 is one
// box, so its LBO is never used.
//
// Grid (d-tiles of 128, groups, chunks of `ftiles` f-tiles of 256): a
// block computes its d-tile of one group's dw for each f-tile of its
// chunk in turn, so the producers load the next f-tile's boxes while the
// consumers store the last one.  The TMA instance stages each f-tile in
// shared memory and TMA stores it while the consumers run the next one's
// products; the async instance stores from registers, at dw's width
// (dwbytes: two columns a store where it is 4 bytes or more, else one).
template <class Loads>
__device__ __forceinline__ void gmm_dw_bf16_wgmma(
    const Loads& loads, const int* __restrict__ tile_gid,
    const int* __restrict__ tile_rows, __nv_bfloat16* __restrict__ dw, int d,
    int f, int ntiles, int bt, int ftiles, int dwbytes,
    const CUtensorMap* tmdw) {
  constexpr int kThreadsAll = kConsumers * 128 + Loads::kThreads;
  constexpr int kStages = Loads::kStages;
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * kBM;  // d rows of dw
  const int g = blockIdx.y;
  const int n_lo = blockIdx.z * ftiles * kDwBN;  // the chunk's f columns
  const int n_hi = min(n_lo + ftiles * kDwBN, f);
  __nv_bfloat16* out = dw + size_t(g) * d * f;

  // Every warp finds the group's first tile with a real row itself.
  const int first =
      warp_next_tile(tile_gid, tile_rows, ntiles, g, 0, lane);
  if (first >= ntiles) {
    const int m1 = min(m0 + kBM, d);
    if constexpr (!Loads::kAsync) {
      const int w8 = (n_hi - n_lo) / 8;
      for (int e = tid; e < (m1 - m0) * w8; e += kThreadsAll)
        *reinterpret_cast<uint4*>(out + size_t(m0 + e / w8) * f + n_lo +
                                  (e % w8) * 8) = make_uint4(0, 0, 0, 0);
    } else {
      with_width(dwbytes, [&](auto ww) {
        zero_rows<decltype(ww)::value>(out, f, m0, m1, n_lo, n_hi, tid,
                                       kThreadsAll);
      });
    }
    return;
  }

  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t staging = ring + kStages * kDwStageBytes;
  const uint32_t bars = staging + (Loads::kAsync ? 0 : kDwOutBytes);
  const DwTile<kStages> b{ring, bars,
                          reinterpret_cast<volatile int*>(
                              smem_raw + (bars + 16 * kStages - raw)),
                          tile_gid, tile_rows, ntiles, bt, g, m0, n_lo,
                          n_hi, first, d, f};
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(b.full(s), Loads::kArrivals);
      mbar_init(b.empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kConsumers) {
    if constexpr (Loads::kAsync) set_max_regs<true>();
    loads.load(b, tid - kConsumers * 128);
    return;
  }
  if constexpr (Loads::kAsync) set_max_regs<false>();

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
      const int s = it % kStages;
      mbar_wait(b.full(s), (it / kStages) & 1);
      flags = b.info[s];
      const int valid = flags & 0xFF;
      const bool straddles = valid < kBK;
      if constexpr (Loads::kAsync) {
        fence_proxy_async();  // the producers zeroed the rows past valid
      } else if (straddles) {
        // Rows [valid, 64) of the stage's six boxes to +0: 8 16-byte
        // chunks a row.
        const int chunks = (kBK - valid) * 8;
        for (int e = tid; e < kDwBoxes * chunks; e += kConsumers * 128)
          st_shared_zero16(b.box(s, e / chunks) + valid * 128 +
                           (e % chunks) * 16);
        fence_proxy_async();
        asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 128) : "memory");
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if (16 * kk < valid)
          wgmma_m64n256k16_tt(
              acc, gmma_desc(b.box(s, wg) + 2048 * kk, kBLbo, kBSbo),
              gmma_desc(b.box(s, kConsumers) + 2048 * kk, kBLbo, kBSbo));
      }
      wgmma_commit();
      acc_fence(acc);
      // The previous stage's products are done: hand its buffers back.
      wgmma_wait<1>();
      acc_fence(acc);
      if (prev >= 0 && leader) mbar_arrive(b.empty(prev));
      prev = s;
      ++it;
    } while (!(flags & kDwTileEnd));
    wgmma_wait<0>();
    acc_fence(acc);
    if (leader) mbar_arrive(b.empty(prev));
    prev = -1;

    // Epilogue: accumulator 4 i + {0, 1} of lane l holds the warpgroup's
    // row 16 warp + l / 4, columns 8 i + 2 (l % 4) + {0, 1}; 4 i + {2, 3}
    // the row 8 below; one cast to bf16.  TMA: into the staging boxes
    // (box i / 8, 16-byte chunk i % 8 of the row, swizzled by the row's
    // index mod 8 as TMA reads it back), once the previous f-tile's
    // stores have read them; then one lane stores the boxes that lie below
    // d and n_hi (TMA clips the ragged d and f edges).  Async: straight to
    // dw, the rows below d and the columns below n_hi.
    if constexpr (!Loads::kAsync) {
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
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
      if (leader && m0 + 64 * wg < d) {
        for (int j = 0; j < kDwBN / 64; ++j)
          if (n0 + 64 * j < n_hi)
            tma_store_3d(tmdw, out_wg + j * kXBox, n0 + 64 * j,
                         m0 + 64 * wg, g);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    } else {
      const bool pairs = dwbytes >= 4;  // f even: a pair is all in or out
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * half;
        __nv_bfloat16* row = out + size_t(r) * f;
#pragma unroll
        for (int i = 0; i < kDwBN / 8; ++i) {
          const int col = n0 + 8 * i + 2 * (lane & 3);
          const float v0 = acc[4 * i + 2 * half];
          const float v1 = acc[4 * i + 2 * half + 1];
          if (r < d && col < n_hi) {
            if (pairs)
              *reinterpret_cast<uint32_t*>(row + col) = pack2(v0, v1);
            else
              row[col] = __float2bfloat16(v0);
          }
          if (!pairs && r < d && col + 1 < n_hi)
            row[col + 1] = __float2bfloat16(v1);
        }
      }
    }
    if (flags & kDwLast) break;
  }
  if constexpr (!Loads::kAsync)
    if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// bf16 that TMA can describe: the ring filled by TMA, f-tiles stored by
// TMA from the staging boxes.
__global__ void __launch_bounds__(kTmaThreads, 1)
    gmm_dw_bf16_tma(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmdy,
                    const __grid_constant__ CUtensorMap tmdw,
                    const int* __restrict__ tile_gid,
                    const int* __restrict__ tile_rows,
                    __nv_bfloat16* __restrict__ dw, int d, int f, int ntiles,
                    int bt) {
  gmm_dw_bf16_wgmma(TmaDw{&tmx, &tmdy, &tmdw}, tile_gid, tile_rows, dw, d, f,
                    ntiles, bt, kDwFTiles, 16, &tmdw);
}

// bf16 that TMA cannot describe: the same consumers, the ring filled
// through cp.async at x's and dy's widths, dw stored at its own; ftiles
// f-tiles a block.
__global__ void __launch_bounds__(kAsyncThreads, 1)
    gmm_dw_bf16_async(const uint16_t* __restrict__ x,
                      const uint16_t* __restrict__ dy,
                      const int* __restrict__ tile_gid,
                      const int* __restrict__ tile_rows,
                      __nv_bfloat16* __restrict__ dw, int d, int f,
                      int ntiles, int bt, int ftiles, int xbytes, int dybytes,
                      int dwbytes) {
  gmm_dw_bf16_wgmma(AsyncDw{x, dy, xbytes, dybytes}, tile_gid, tile_rows, dw,
                    d, f, ntiles, bt, ftiles, dwbytes, nullptr);
}

// ------------------------------------------------- dW f32: TMA + FMA
constexpr int kDwF32BM = 64;      // d rows of a block's dw tile
constexpr int kDwF32BN = 128;     // f columns of it
constexpr int kDwF32BK = 32;      // rows of x and dy a stage
constexpr int kDwF32Stages = 4;   // ring depth: 96 KB, two blocks an SM
constexpr int kDwF32MaxFTiles = 8;  // most f-tiles a block walks in turn
constexpr int kDwF32Waves = 8;    // blocks of the grid an SM, at least
constexpr int kDwF32Warps = 4;    // consumers: 8 x 8 outputs a thread
constexpr int kDwF32Threads = kDwF32Warps * 32 + 32;  // + one producer
// The async instance's producer threads: two warps.  A warpgroup was as
// fast at (b) and 3% slower at the f32 cut's call (t), and its 256 threads
// a block, two blocks an SM, held a thread to 128 registers, where the
// consumers spilled (benchmarks/f32_tune.py).
constexpr int kDwF32AsyncProducers = 64;
constexpr int kDwF32AsyncThreads = kDwF32Warps * 32 + kDwF32AsyncProducers;
constexpr int kDwF32XBytes = kDwF32BK * kDwF32BM * 4;  // 8 KB
constexpr int kDwF32StageBytes = kDwF32XBytes + kDwF32BK * kDwF32BN * 4;
constexpr int kDwF32Smem = kDwF32Stages * kDwF32StageBytes + 1024 +
                           2 * kDwF32Stages * 8 + kDwF32Stages * 4;

// An f32 dW block's walk (see dw_walk): d-tile m0 of group g's dw, the f
// columns [n_lo, n_hi) of its chunk, the group's first tile with a real
// row.  Stage s holds x's box (32 rows x 64 d columns), then dy's (32 rows
// x 128 f columns), unswizzled; `bars` the full and empty barriers, then
// the stages' info words (`info`).
struct DwF32Tile {
  static constexpr int kStages = kDwF32Stages;
  uint32_t ring, bars;
  volatile int* info;
  const int* tile_gid;
  const int* tile_rows;
  int ntiles, bt, g, m0, n_lo, n_hi, first, d, f;

  __device__ __forceinline__ int rows_of(int t) const {
    return tile_rows == nullptr ? bt : min(max(tile_rows[t], 0), bt);
  }
  __device__ __forceinline__ uint32_t stage(int s) const {
    return ring + s * kDwF32StageBytes;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return bars + 8u * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8u * (kStages + s);
  }
};

// TMA: x as (T rows, d) with 64-column x 32-row boxes, dy as (T rows, f)
// with 128-column x 32-row boxes, unswizzled, zero fill past the edges.
// The producer warp walks; lane 0 issues the loads of whole 32-row boxes,
// whose rows past a tile's count the consumers never read.
struct TmaF32Dw {
  static constexpr int kThreads = 32, kArrivals = 1;
  static constexpr bool kAsync = false;
  const CUtensorMap* tmx;
  const CUtensorMap* tmdy;

  __device__ __forceinline__ void load(const DwF32Tile& b, int p) const {
    if (p == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(tmx))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(tmdy))
                   : "memory");
    }
    dw_walk<kDwF32BK, kDwF32BN>(b, p, [&](int s, int it, int row, int,
                                          int n0, int word) {
      if (p == 0) {
        mbar_wait(b.empty(s), ((it / kDwF32Stages) & 1) ^ 1);
        b.info[s] = word;
        mbar_expect_tx(b.full(s), kDwF32StageBytes);
        tma_load_2d(b.stage(s), tmx, b.m0, row, b.full(s));
        tma_load_2d(b.stage(s) + kDwF32XBytes, tmdy, n0, row, b.full(s));
      }
      __syncwarp();
    });
  }
};

// cp.async: x (T, d) and dy (T, f) at copy widths xbytes and dybytes (16,
// 8 or 4), every producer warp walking the group's rows; the rows of a box
// past its `valid` real rows are zeros (the consumers do not read them).
struct AsyncF32Dw {
  static constexpr int kThreads = kDwF32AsyncProducers;
  static constexpr int kArrivals = kDwF32AsyncProducers;
  static constexpr bool kAsync = true;
  const float* x;
  const float* dy;
  int xbytes, dybytes;

  __device__ __forceinline__ void load(const DwF32Tile& b, int p) const {
    with_width<4>(xbytes, [&](auto xw) {
      with_width<4>(dybytes, [&](auto yw) {
        this->template stages<decltype(xw)::value, decltype(yw)::value>(b,
                                                                       p);
      });
    });
    cp_async_wait<0>();
  }

  template <int kX, int kY>
  __device__ __forceinline__ void stages(const DwF32Tile& b, int p) const {
    dw_walk<kDwF32BK, kDwF32BN>(b, p & 31, [&](int s, int it, int row,
                                               int valid, int n0, int word) {
      mbar_wait(b.empty(s), ((it / kDwF32Stages) & 1) ^ 1);
      if (p == 0) b.info[s] = word;
      copy_rows<kX, kDwF32BK, kDwF32BM * 4, false, kThreads>(
          b.stage(s), Src<float>{x, b.d, row, row + valid, b.m0, b.d}, p);
      copy_rows<kY, kDwF32BK, kDwF32BN * 4, false, kThreads>(
          b.stage(s) + kDwF32XBytes,
          Src<float>{dy, b.f, row, row + valid, n0, b.f}, p);
      stage_arrive(b.full(s));
    });
  }
};

// gmm_dw_f32_fma's epilogue for consumer thread (tm, tn): its rows of the
// f-tile at n0 below d, its columns below n_hi, four adjoining columns in
// stores of kY bytes (dw's width).
template <int kY>
__device__ __forceinline__ void dw_f32_epilogue(const float (&acc)[8][8],
                                                float* out, int m0, int n0,
                                                int n_hi, int d, int f,
                                                int tm, int tn) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * tm + i : 32 + 4 * tm + i - 4);
    if (m < d) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4_f32<kY>(out + size_t(m) * f, n0 + 64 * h + 4 * tn, n_hi,
                       make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                   acc[i][4 * h + 2], acc[i][4 * h + 3]));
    }
  }
}

// The f32 dW: grid (d-tiles of 64, groups, chunks of `ftiles` f-tiles of
// 128), the ring filled by `loads` (TmaF32Dw or AsyncF32Dw).  Thread (tm,
// tn) of the 8 x 16 consumer threads owns dw rows m0 + 4 tm + {0..3} and
// m0 + 32 + 4 tm + {0..3}, columns n0 + 4 tn + {0..3} and n0 + 64 + 4 tn +
// {0..3}: a row step reads them as two 128-bit loads from x's row and two
// from dy's.  dwbytes: dw's store width (16 with TMA).
template <class Loads>
__device__ __forceinline__ void gmm_dw_f32_fma(
    const Loads& loads, const int* __restrict__ tile_gid,
    const int* __restrict__ tile_rows, float* __restrict__ dw, int d, int f,
    int ntiles, int bt, int ftiles, int dwbytes) {
  constexpr int kThreadsAll = kDwF32Warps * 32 + Loads::kThreads;
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kDwF32BM;
  const int g = blockIdx.y;
  const int n_lo = blockIdx.z * ftiles * kDwF32BN;
  const int n_hi = min(n_lo + ftiles * kDwF32BN, f);
  float* out = dw + size_t(g) * d * f;

  // Every warp finds the group's first tile with a real row itself.
  const int first = warp_next_tile(tile_gid, tile_rows, ntiles, g, 0, lane);
  if (first >= ntiles) {
    const int m1 = min(m0 + kDwF32BM, d);
    with_width<4>(dwbytes, [&](auto ww) {
      zero_rows<decltype(ww)::value>(out, f, m0, m1, n_lo, n_hi, tid,
                                     kThreadsAll);
    });
    return;
  }

  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t bars = ring + kDwF32Stages * kDwF32StageBytes;
  const DwF32Tile b{ring, bars,
                    reinterpret_cast<volatile int*>(
                        smem_raw + (bars + 16 * kDwF32Stages - raw)),
                    tile_gid, tile_rows, ntiles, bt, g, m0, n_lo, n_hi,
                    first, d, f};
  if (tid == 0) {
    for (int s = 0; s < kDwF32Stages; ++s) {
      mbar_init(b.full(s), Loads::kArrivals);
      mbar_init(b.empty(s), kDwF32Warps * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kDwF32Warps) {
    loads.load(b, tid - kDwF32Warps * 32);
    return;
  }

  // Consumer thread (tm, tn).
  const int tm = 2 * warp + (lane >> 4), tn = lane & 15;
  const float* ring_f = reinterpret_cast<const float*>(smem_raw + (ring - raw));
  float acc[8][8];
  int it = 0;
  for (int n0 = n_lo;; n0 += kDwF32BN) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    int flags;
    do {
      const int s = it % kDwF32Stages;
      mbar_wait(b.full(s), (it / kDwF32Stages) & 1);
      flags = b.info[s];
      const int valid = flags & 0xFF;
      const float* xs = ring_f + s * (kDwF32StageBytes / 4) + 4 * tm;
      const float* dys =
          ring_f + s * (kDwF32StageBytes / 4) + kDwF32XBytes / 4 + 4 * tn;
      // Row r of the stage: x's d values and dy's f values; the rows at
      // or past `valid` belong to no real row and are not read.
      auto step = [&](int r) {
        const float4 a0 = *reinterpret_cast<const float4*>(xs + r * kDwF32BM);
        const float4 a1 =
            *reinterpret_cast<const float4*>(xs + r * kDwF32BM + 32);
        const float4 b0 =
            *reinterpret_cast<const float4*>(dys + r * kDwF32BN);
        const float4 b1 =
            *reinterpret_cast<const float4*>(dys + r * kDwF32BN + 64);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      };
      if (valid == kDwF32BK) {
#pragma unroll 4
        for (int r = 0; r < kDwF32BK; ++r) step(r);
      } else {
        for (int r = 0; r < valid; ++r) step(r);
      }
      mbar_arrive(b.empty(s));
      ++it;
    } while (!(flags & kDwTileEnd));

    // Epilogue: the rows below d and columns below n_hi, at dw's width.
    if (dwbytes == 16)
      dw_f32_epilogue<16>(acc, out, m0, n0, n_hi, d, f, tm, tn);
    else if (dwbytes == 8)
      dw_f32_epilogue<8>(acc, out, m0, n0, n_hi, d, f, tm, tn);
    else
      dw_f32_epilogue<4>(acc, out, m0, n0, n_hi, d, f, tm, tn);
    if (flags & kDwLast) break;
  }
}

// f32 that TMA can describe: the ring filled by TMA (see gmm_dw_f32_fma).
__global__ void __launch_bounds__(kDwF32Threads)
    gmm_dw_f32_tma(const __grid_constant__ CUtensorMap tmx,
                   const __grid_constant__ CUtensorMap tmdy,
                   const int* __restrict__ tile_gid,
                   const int* __restrict__ tile_rows, float* __restrict__ dw,
                   int d, int f, int ntiles, int bt, int ftiles) {
  gmm_dw_f32_fma(TmaF32Dw{&tmx, &tmdy}, tile_gid, tile_rows, dw, d, f,
                 ntiles, bt, ftiles, 16);
}

// f32 that TMA cannot describe: the same consumers, the ring filled
// through cp.async at x's and dy's widths, dw stored at its own; two
// blocks an SM, as the TMA kernel's ring allows (192 threads a block
// leave a thread 168 registers; the consumers use fewer than 128).
__global__ void __launch_bounds__(kDwF32AsyncThreads, 2)
    gmm_dw_f32_async(const float* __restrict__ x,
                     const float* __restrict__ dy,
                     const int* __restrict__ tile_gid,
                     const int* __restrict__ tile_rows,
                     float* __restrict__ dw, int d, int f, int ntiles,
                     int bt, int ftiles, int xbytes, int dybytes,
                     int dwbytes) {
  gmm_dw_f32_fma(AsyncF32Dw{x, dy, xbytes, dybytes}, tile_gid, tile_rows,
                 dw, d, f, ntiles, bt, ftiles, dwbytes);
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

// The device's SM count, read once a thread and device.
int sm_count() {
  thread_local int cached_dev = -1, sms = 1;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev == cached_dev) return sms;
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
      cudaSuccess) {
    sms = n > 0 ? n : 1;
    cached_dev = dev;
  }
  return sms;
}

// An f32 tensor map of `rank` dims (innermost first) with boxes `box`,
// unswizzled or with the 128-byte swizzle, and zero fill.
CUresult encode_f32(EncodeTiled enc, CUtensorMap* map, const void* base,
                    int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box,
                    bool swizzle) {
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) g_refused = static_cast<int>(res);
  return res;
}

// A 2-D f32 tensor map of `rows` rows of `cols` contiguous floats, with
// unswizzled boxes of box_rows x box_cols.
CUresult encode_rows_f32(EncodeTiled enc, CUtensorMap* map, const void* base,
                         int rows, int cols, int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 4};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  return encode_f32(enc, map, base, 2, dims, strides, box, false);
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

// Whether `bytes` (16, 8, 4, or 2 with 2-byte elements) divides the row
// pitch of a matrix `cols` elements of `esize` bytes wide and its base
// `p`: a copy width an async instance can take.
bool copy_width_ok(int bytes, const void* p, long long cols, int esize) {
  return (bytes == 16 || bytes == 8 || bytes == 4 ||
          (bytes == 2 && esize == 2)) &&
         cols * esize % bytes == 0 &&
         reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The f-tiles a block of an f32 dW walks: one where the grid of single
// f-tiles is small (the card needs every block it can hold), up to
// kDwF32MaxFTiles where it is large (a block's walk of the group's tiles
// and its first loads are then paid once for several f-tiles).
int dw_f32_ftiles(int dtiles, int G, int nft) {
  const long long single = 1LL * dtiles * G * nft;
  return static_cast<int>(std::min<long long>(
      std::max<long long>(single / (kDwF32Waves * sm_count()), 1),
      kDwF32MaxFTiles));
}

// Codes the launch entry returns beside cudaGetLastError()'s.
constexpr int kNoEncoder = -1;
constexpr int kEncodeFailed = -2;

}  // namespace

extern "C" {

// Rows of a block's tile, by dtype: bt must be a multiple of it.
int grouped_matmul_row_tile(int dtype) { return dtype == 1 ? kBM : kFBM; }

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it).  tma: TMA can
// describe x and w (bf16: d and f multiples of 8; f32: of 4; 16-byte
// aligned bases), so the TMA kernel of the dtype runs; else the dtype's
// async instance (the ring filled through cp.async, x, w and y at the copy
// widths xbytes, wbytes and ybytes: 16, 8, 4 or, in bf16, 2, each
// dividing its operand's row pitch and base).  w_kmajor: w is stored (G,
// f, d), the transpose of the (G, d, f) weights the call multiplies by,
// and is read K-major (K5's dX on the forward's w, with no copy); else w
// is (G, d, f).  The
// TMA kernels fill and store y 16 bytes at a time, so with tma the output
// width f must be a multiple of 8 (bf16) or 4 (f32) too.  tile_rows may
// be null (every row real).  T must be a positive multiple of bt, and bt
// of the row tile.
int grouped_matmul_launch(const void* x, const int* tile_gid,
                          const int* tile_rows, const void* w, void* y, int T,
                          int d, int f, int G, int bt, int dtype, int tma,
                          int w_kmajor, int xbytes, int wbytes, int ybytes,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tma && f % (dtype == 1 ? 8 : 4) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
  } else if (tma) {
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return kNoEncoder;
    const cudaError_t ctx = bind_context();
    if (ctx != cudaSuccess) return static_cast<int>(ctx);
    CUtensorMap tmx, tmw;
    const cuuint64_t inner = w_kmajor ? d : f, outer = w_kmajor ? f : d;
    const cuuint64_t wdims[3] = {inner, outer, cuuint64_t(G)};
    const cuuint64_t wstrides[2] = {inner * 4, inner * outer * 4};
    const cuuint32_t wbox[3] = {
        cuuint32_t(w_kmajor ? kF32BK : kF32BN),
        cuuint32_t(w_kmajor ? kF32BN : kF32BK), 1};
    if (encode_rows_f32(enc, &tmx, x, T, d, kFBM, kF32BK) != CUDA_SUCCESS ||
        encode_f32(enc, &tmw, w, 3, wdims, wstrides, wbox, w_kmajor) !=
            CUDA_SUCCESS)
      return kEncodeFailed;
    const auto kernel = w_kmajor ? gmm_f32_tma<true> : gmm_f32_tma<false>;
    const cudaError_t attr = allow_smem(kernel, kF32Smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((f + kF32BN - 1) / kF32BN, T / kFBM);
    kernel<<<grid, kF32Threads, kF32Smem, st>>>(
        tmx, tmw, tile_gid, tile_rows, static_cast<float*>(y), d, f, G, bt);
  } else if (dtype == 1) {
    // w's rows are f wide (the forward) or d (stored transposed)
    if (!copy_width_ok(xbytes, x, d, 2) ||
        !copy_width_ok(wbytes, w, w_kmajor ? d : f, 2) ||
        !copy_width_ok(ybytes, y, f, 2))
      return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel =
        w_kmajor ? gmm_bf16_async<true> : gmm_bf16_async<false>;
    const cudaError_t attr = allow_smem(kernel, kAsyncSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((f + kBN - 1) / kBN, T / kBM);
    kernel<<<grid, kAsyncThreads, kAsyncSmem, st>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
        tile_gid, tile_rows, static_cast<__nv_bfloat16*>(y), d, f, G, bt,
        xbytes, wbytes, ybytes);
  } else {
    if (!copy_width_ok(xbytes, x, d, 4) ||
        !copy_width_ok(wbytes, w, w_kmajor ? d : f, 4) ||
        !copy_width_ok(ybytes, y, f, 4))
      return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = w_kmajor ? gmm_f32_async<true> : gmm_f32_async<false>;
    const cudaError_t attr = allow_smem(kernel, kF32Smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((f + kF32BN - 1) / kF32BN, T / kFBM);
    kernel<<<grid, kAsyncThreads, kF32Smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), tile_gid,
        tile_rows, static_cast<float*>(y), d, f, G, bt, xbytes, wbytes,
        ybytes);
  }
  return static_cast<int>(cudaGetLastError());
}

// dw (G, d, f) = the gradient of K5 with respect to w, from x (T, d) and
// dy (T, f) of one dtype (0 = float32, 1 = bfloat16), over T / bt tiles.
// tma: d and f are multiples of 8 (bf16) or 4 (f32) and x, dy 16-byte
// aligned, so the TMA kernel of the dtype runs; else its async instance
// (x, dy and dw at the copy widths xbytes, dybytes and dwbytes).
// tile_rows may be null.
int grouped_matmul_dw_launch(const void* x, const void* dy,
                             const int* tile_gid, const int* tile_rows,
                             void* dw, int T, int d, int f, int G, int bt,
                             int dtype, int tma, int xbytes, int dybytes,
                             int dwbytes, void* stream) {
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
  } else if (tma) {
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return kNoEncoder;
    const cudaError_t ctx = bind_context();
    if (ctx != cudaSuccess) return static_cast<int>(ctx);
    CUtensorMap tmx, tmdy;
    if (encode_rows_f32(enc, &tmx, x, T, d, kDwF32BK, kDwF32BM) !=
            CUDA_SUCCESS ||
        encode_rows_f32(enc, &tmdy, dy, T, f, kDwF32BK, kDwF32BN) !=
            CUDA_SUCCESS)
      return kEncodeFailed;
    const cudaError_t attr = allow_smem(gmm_dw_f32_tma, kDwF32Smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int dtiles = (d + kDwF32BM - 1) / kDwF32BM;
    const int nft = (f + kDwF32BN - 1) / kDwF32BN;
    const int ftiles = dw_f32_ftiles(dtiles, G, nft);
    const dim3 grid(dtiles, G, (nft + ftiles - 1) / ftiles);
    gmm_dw_f32_tma<<<grid, kDwF32Threads, kDwF32Smem, st>>>(
        tmx, tmdy, tile_gid, tile_rows, static_cast<float*>(dw), d, f,
        ntiles, bt, ftiles);
  } else if (dtype == 1) {
    if (!copy_width_ok(xbytes, x, d, 2) ||
        !copy_width_ok(dybytes, dy, f, 2) ||
        !copy_width_ok(dwbytes, dw, f, 2))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t attr = allow_smem(gmm_dw_bf16_async, kAsyncDwSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    // f-tiles a block walks: one where the grid of single f-tiles leaves
    // the card short of blocks (the producers' copies then run on every
    // SM), up to kDwFTiles where it is large (the walk paid once for
    // several).  Each output is still one block's sum in row order.
    const int dtiles = (d + kBM - 1) / kBM, nft = (f + kDwBN - 1) / kDwBN;
    const long long single = 1LL * dtiles * G * nft;
    const int ftiles = static_cast<int>(std::min<long long>(
        std::max<long long>(single / (kDwAsyncWaves * sm_count()), 1),
        kDwFTiles));
    const dim3 grid(dtiles, G, (nft + ftiles - 1) / ftiles);
    gmm_dw_bf16_async<<<grid, kAsyncThreads, kAsyncDwSmem, st>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy),
        tile_gid, tile_rows, static_cast<__nv_bfloat16*>(dw), d, f, ntiles,
        bt, ftiles, xbytes, dybytes, dwbytes);
  } else {
    if (!copy_width_ok(xbytes, x, d, 4) || !copy_width_ok(dybytes, dy, f, 4) ||
        !copy_width_ok(dwbytes, dw, f, 4))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t attr = allow_smem(gmm_dw_f32_async, kDwF32Smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int dtiles = (d + kDwF32BM - 1) / kDwF32BM;
    const int nft = (f + kDwF32BN - 1) / kDwF32BN;
    const int ftiles = dw_f32_ftiles(dtiles, G, nft);
    const dim3 grid(dtiles, G, (nft + ftiles - 1) / ftiles);
    gmm_dw_f32_async<<<grid, kDwF32AsyncThreads, kDwF32Smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), tile_gid,
        tile_rows, static_cast<float*>(dw), d, f, ntiles, bt, ftiles, xbytes,
        dybytes, dwbytes);
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
