// Paged decode attention on Hopper (sm_90a), bound to Python through the
// extern "C" entries below (built with nvcc into a shared library and
// loaded with ctypes).
//
// Replaces the Pallas TPU kernel paged_attention_pallas of the JAX
// reference (src/repro/kernels/paged_attention/kernel.py:102, body _kernel
// :27).  What it computes, for every sequence b and query head h of
// q (B, H, D), with G = H / KV query heads sharing KV head kv = h / G:
//   s[t]   = dot(q[b, h], k[b, t, kv]) / sqrt(D)  in f32, for t < seq_lens[b]
//   out    = sum_t p[t] * v[b, t, kv] / sum_t p[t],  p = exp(s - max s)
// where slot t of sequence b is row t % page of page page_table[b][t / page]
// of the (N, page, KV, D) pools.  As in the Pallas body: scores and the
// running max m and denominator l are f32; the unnormalised probabilities
// are cast to v's type before the PV product (kernel.py:85); the
// accumulator is f32; the output is acc / max(l, 1e-30) cast to q's type,
// so seq_len 0 gives 0.
//
// Bound on this card: memory.  Each valid slot is 2 D elements of K and V
// read once for the G queries of its KV head, 4 G D flops: G / esize flops
// a byte, at most 6 in bf16 on every shape the repo runs (G = 1 for
// CodeQwen, moonshot and seamless, 2 for kernel_bench, 4 for jamba, 6 for
// mixtral-8x22b, 8 for paligemma and qwen1.5-110b, 12 for
// mistral-large-123b and nemotron-4-340b).  An H100 turns compute-bound
// only near 295 flops a byte in bf16 on its tensor cores.  So what sets
// the time is how many bytes are in flight, how many SMs take part, and
// that each byte of the chunk is read once, whatever G is.
//
// Design, both instances.
//  * Split across blocks (flash-decoding).  The grid is (KV, B, splits);
//    a block takes the G query rows of one (b, kv) and the slots
//    [split * chunk, (split + 1) * chunk) below seq_lens[b].  The wrapper
//    picks splits from shapes alone (split_plan: the table's P * page
//    slots in chunks of 512); it never reads seq_lens, which live on the
//    device.  A block whose chunk starts at or past seq_lens[b] loads
//    nothing.  With one split (every shape of the decode path: 64 slots)
//    the block writes the output itself, with no workspace and no merge.
//  * The merge, in the same launch (merge_splits).  With splits > 1 each
//    block leaves its f32 partials (m_s, l_s, acc_s[G][D]) and a fault
//    flag in a workspace the wrapper provides, then counts itself done on
//    an atomic counter of its (b, kv) after __threadfence().  The block
//    that counts last merges: m = max m_s, c_s = exp(m_s - m), l = sum c_s
//    l_s, out = sum c_s acc_s / max(l, 1e-30), over the splits in split
//    order, so the result does not depend on which block came last and is
//    the same bits from run to run.  Splits at or past seq_lens[b] are not
//    read (their weight would be exp(-1e30 - m) = 0).  The merging block
//    then resets its counter to 0 for the next call on the stream.  One
//    launch a call.  The merge is the launch's tail (the last blocks of
//    every pair finish together), so a thread merges a run of 8 elements
//    of a row with their loads in flight together.
//  * K and V rows come through a ring of shared-memory stages filled by
//    cp.async.cg 16-byte copies of each page row, gathered through the
//    page table and zero-filled past the chunk's valid slots, tiles ahead
//    of the one being used.  Scores and the softmax are in
//    base 2 (log2(e) / sqrt(D) folded into one scale), so each
//    probability is one exp2f; each probability is rounded to v's type
//    against the running max of the part of the chunk that holds it (the
//    only place where the split changes the arithmetic).  At the end of a
//    chunk the block merges its parts' states through shared memory in a
//    fixed order.
//
// The tensor-core instance (path 2, paged_attention_tc_kernel): bf16, G >
// 2 and D = 64, 128, 192 or 256 -- jamba (G = 4), mixtral-8x22b (6),
// paligemma and qwen1.5-110b (8), mistral-large-123b and nemotron-4-340b
// (12, D = 192).  The G query rows of the KV head go through the chunk in
// one pass, as the Pallas body puts all H rows of a page through one MXU
// product (kernel.py:58-63, :84-89):
//  * The rows, padded to 16 with zeros and kept in bf16 and unscaled, sit
//    in shared memory and are the A operand of mma.sync m16n8k16 (bf16 in,
//    f32 sums), loaded with ldmatrix; the staged K rows (a slot's D
//    elements contiguous) are its B operand as they lie.  One mma's 16
//    rows hold every G <= 16, so the chunk is read once; G > 16 (no config
//    of the repo) runs the chunk once for each 16 rows.
//  * The scores leave the mma in f32 fragments and are scaled there, as
//    the reference scales after its dot (kernel.py:68).  Slots at or past
//    seq_lens[b] are masked; each row's max and sum are reduced over the
//    4 lanes of the fragment's quad with shuffles.
//  * p is rounded to bf16 (kernel.py:85) and feeds the PV mma straight
//    from the score fragments' registers as its A operand; V comes in with
//    ldmatrix.trans; O stays in f32 fragments (D / 2 registers a lane).
//  * A tile is 64 slots, 16 for each of the 4 warps; each warp keeps its
//    own (m, l, O) for its 16 query rows over its slots, and at the
//    chunk's end the warps are merged through shared memory in warp order.
//    Splitting D of the PV product across the warps instead would share P
//    through shared memory and a barrier at every tile; the registers
//    allow the first (D = 256: 128 of O, ptxas's report in build_info()).
//  * Staged rows are D + 8 elements apart, so the 8 rows an ldmatrix reads
//    fall in 8 different 16-byte bank groups.  3 stages at D <= 128 (108.8
//    KB with q at D = 128: 2 blocks an SM), 2 at D = 192 and 256; a tile's
//    stage is refilled as soon as every warp is done with it, before the
//    next tile is waited for, so kStages tiles are in flight.  K and V are
//    copied under an L2 evict-first policy: read once, they leave the
//    splits' workspace in L2 for the merge.
//  * What holds it (k4_tune.py --variants, PERF.md): over a 4,096-slot
//    cache the loads alone run near the card's own read rate; the mma
//    work costs little; the split merge at the launch's tail is most of
//    the rest.
//  * mma.sync, not wgmma: at G = 12 the work is ~6 flops a byte, so 3.35
//    TB/s needs ~20 TFLOP/s of the tensor cores, and a wgmma's 64 rows
//    would be 52-61 rows of zeros.
//
// The pair instance (paths 0 and 1, paged_attention_kernel): f32, bf16 at
// G <= 2, and head_dims the tensor-core instance does not take.
//  * A slot's K row is split over a group of LPS lanes, PER = 2 16-byte
//    vectors each (for D = 128 in bf16: 8 lanes, 32 bytes each), so a warp
//    takes 32 / LPS slots at once and four warps take a "pass"; a tile is
//    kPasses passes (32 slots at D = 128 in bf16), through the ring
//    (ASYNC).  The wrapper takes the ring when a K/V row is 8, 16, 32 or
//    64 vectors (128 to 1024 bytes) and the pools are 16-byte aligned.
//    Any other D (D = 40 or 16; D = 192 in f32 or at G <= 2) takes the
//    scalar instance of the same template: VEC = 1, 32 lanes a slot, element
//    loads into registers (!ASYNC), a lane's elements at or past D held at
//    zero (load_regs' and the q load's e < D) and never written.
//  * Each lane group keeps its own online softmax (m, l, acc for its part
//    of D) over the slots it takes; a dot is f32 FMAs ending in a shuffle
//    tree over the group's lanes, with q scaled by log2(e) / sqrt(D) once
//    (the f32 cuts hold the card to the CPU at 2e-5, which TF32 products
//    would round away).
//  * GR = 1 (G = 1) or 2 query rows are held in registers at a time; a
//    larger G (f32 only on the repo's configs) runs the chunk once for
//    each pair of rows, G / 2 passes, each with its own online softmax,
//    ring and merge.
// The kernel does no synchronisation with the host and allocates nothing.
// A page index outside [0, n_pages) met below seq_lens[b] makes the rows of
// that (b, kv) NaN instead of a read out of bounds, whichever split meets
// it: the flag travels through the merge.
//
// Partials (a sequence-sharded cache; the counterpart of the reference's
// paged_attention_partials_ref, which the JAX package runs as jnp under
// XLA's partitioner).  Given non-null m and l, (B, H) f32, the exit that
// writes a row of out (the one-split write or the merge) also writes its
// max score m and its sum l = sum exp(s - m) over the valid slots, so the
// shards of a sequence can be merged by the caller: m in natural units
// (the base-2 max times ln 2), -1e30 exactly where no slot is valid (l =
// 0, out = 0 there), and NaN in all three where a bad page was met.  The
// normal decode passes null pointers and writes only out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstddef>

// One call's arguments, packed by the wrapper as 22 int64 in this order
// (a ctypes call with one pointer argument costs the host a fraction of one
// with twenty).  dtype: 0 = float32, 1 = bfloat16 (q, the pools and out
// share it).  path: 0 = scalar loads, 1 = 16-byte cp.async ring (the pair
// instance), 2 = the tensor-core instance (bf16, D = 64, 128, 192, 256).
// ws: f32 workspace of B*KV*splits*(G*(D + 2) + 1) floats and counters:
// B*KV ints that are 0, both used only when splits > 1.  m, l: the
// partials' outputs, or 0.
struct PagedAttentionArgs {
  long long q, k_pages, v_pages, page_table, seq_lens, out, ws, counters;
  long long B, H, KV, D, page, P, n_pages, splits, chunk, dtype, path;
  long long stream;
  long long m, l;  // optional (B, H) f32 partials, 0 for none
};

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;  // cp.async ring depth, in tiles
constexpr int kPasses = 2;  // slots a lane group takes from each tile
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// A row's partials: the base-2 max ``mx`` in natural units (kNegInf kept
// as it is where no slot was valid) and the sum ``ll``; NaN for a fault.
__device__ __forceinline__ void write_partials(float* m_out, float* l_out,
                                               size_t row, float mx, float ll,
                                               bool ok) {
  m_out[row] = ok ? (mx > kNegInf ? mx * kLn2 : kNegInf) : CUDART_NAN_F;
  l_out[row] = ok ? ll : CUDART_NAN_F;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements of T loaded and stored as one access (16 bytes when VEC *
// sizeof(T) == 16).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T x[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> zero_vec() {
  Vec<T, VEC> z;
#pragma unroll
  for (int i = 0; i < VEC; ++i) z.x[i] = from_f<T>(0.f);
  return z;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = fill ? 16 : 0;  // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n)
               : "memory");
}
// The same under an L2 cache policy (``evict_first_policy``).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill,
                                           unsigned long long policy) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = fill ? 16 : 0;
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::
          "r"(dst),
      "l"(gmem), "r"(n), "l"(policy)
      : "memory");
}
// K and V are read once: evicted from L2 first, so the split merge at the
// launch's end finds the workspace there.
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Compile-time shape of one instance.  A slot's row of D elements is held
// by LPS lanes, PER vectors of VEC elements each (lane sl holds elements
// (j * LPS + sl) * VEC + x); kD = LPS * PER * VEC >= D.
template <typename T, int VEC, int LPS, int PER, int GR, bool ASYNC>
struct Cfg {
  static constexpr int kD = LPS * PER * VEC;
  static constexpr int kElems = PER * VEC;        // elements a lane holds
  static constexpr int kGroupsPerWarp = 32 / LPS;  // slots a warp at once
  static constexpr int kGroups = kWarps * kGroupsPerWarp;  // a pass
  static constexpr int kTile = kPasses * kGroups;          // slots a tile
  static_assert(!ASYNC || (kTile * LPS * PER) % kThreads == 0, "copies");
  static_assert(!ASYNC || VEC * sizeof(T) == 16, "cp.async moves 16 bytes");
  static_assert(LPS >= 1 && LPS <= 32 && (32 % LPS) == 0, "lane groups");

  // Dynamic shared memory: the ring (ASYNC) and, reusing it once the
  // chunk is done, the lane groups' states for the block's merge.
  __host__ __device__ static size_t ring_bytes() {
    return ASYNC ? size_t(kStages) * 2 * kTile * kD * sizeof(T) : 0;
  }
  __host__ __device__ static size_t merge_bytes(int D) {
    return size_t(kGroups) * GR * (D + 2) * sizeof(float);
  }
  __host__ __device__ static size_t smem_bytes(int D) {
    const size_t r = ring_bytes(), m = merge_bytes(D);
    return r > m ? r : m;
  }
};

// One lane group's K and V vectors of kPasses slots of a tile.
template <typename T, int VEC, int PER>
struct TileRegs {
  Vec<T, VEC> k[kPasses][PER];
  Vec<T, VEC> v[kPasses][PER];
  bool valid[kPasses];
};

struct Chunk {
  const int* table;  // the sequence's row of page_table
  int c0, c1;        // slots [c0, c1) of the chunk below seq_len
  int kv, KV, D, page, n_pages;
  int page_shift;    // log2(page) when page is a power of two, else -1
};

// Global offset of slot t's row for head kv, or -1 for a bad page.
__device__ __forceinline__ long long slot_offset(const Chunk& c, int t) {
  int i, row;
  if (c.page_shift >= 0) {
    i = t >> c.page_shift;
    row = t & (c.page - 1);
  } else {
    i = t / c.page;
    row = t - i * c.page;
  }
  const int pg = __ldg(c.table + i);
  if (pg < 0 || pg >= c.n_pages) return -1;
  return (static_cast<long long>(pg) * c.page + row) * (c.KV * c.D) +
         c.kv * c.D;
}

// Fold one tile's slots into a lane group's online softmax (m, l, acc) for
// its GR query rows.  ``qf`` holds the lane's elements of the rows scaled
// by log2(e) / sqrt(D), so scores and m are in base 2 and p = exp2(s - m)
// is the reference's exp(score - max).
template <typename T, int VEC, int LPS, int PER, int GR>
__device__ __forceinline__ void fold(const TileRegs<T, VEC, PER>& r,
                                     const float (&qf)[GR][PER * VEC],
                                     float (&m)[GR], float (&l)[GR],
                                     float (&acc)[GR][PER * VEC]) {
  float s[kPasses][GR];
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
#pragma unroll
    for (int g = 0; g < GR; ++g) s[u][g] = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
#pragma unroll
      for (int x = 0; x < VEC; ++x) {
        const float kx = to_f(r.k[u][j].x[x]);
#pragma unroll
        for (int g = 0; g < GR; ++g)
          s[u][g] = fmaf(qf[g][j * VEC + x], kx, s[u][g]);
      }
    }
  }
#pragma unroll
  for (int o = LPS / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
#pragma unroll
      for (int g = 0; g < GR; ++g)
        s[u][g] += __shfl_xor_sync(~0u, s[u][g], o);
    }
  }
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    float m_new = m[g];
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      s[u][g] = r.valid[u] ? s[u][g] : kNegInf;
      m_new = fmaxf(m_new, s[u][g]);
    }
    const float alpha = exp2f(m[g] - m_new);
    float p[kPasses];
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      p[u] = r.valid[u] ? exp2f(s[u][g] - m_new) : 0.f;
      psum += p[u];
      p[u] = to_f(from_f<T>(p[u]));  // probabilities in v's type
    }
    l[g] = l[g] * alpha + psum;
    m[g] = m_new;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
#pragma unroll
      for (int x = 0; x < VEC; ++x) {
        float a = acc[g][j * VEC + x] * alpha;
#pragma unroll
        for (int u = 0; u < kPasses; ++u)
          a = fmaf(p[u], to_f(r.v[u][j].x[x]), a);
        acc[g][j * VEC + x] = a;
      }
    }
  }
}

// Registers straight from device memory (!ASYNC, the scalar instance): the
// lane group's kPasses slots of tile ``i``.
template <typename T, int VEC, int LPS, int PER>
__device__ __forceinline__ void load_regs(TileRegs<T, VEC, PER>& r,
                                          const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          const Chunk& c, int i, int group,
                                          int sl, int groups, int* bad) {
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    const int t = c.c0 + i * kPasses * groups + u * groups + group;
    long long off = -1;
    if (t < c.c1) {
      off = slot_offset(c, t);
      if (off < 0) *bad = 1;
    }
    r.valid[u] = t < c.c1;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = (j * LPS + sl) * VEC;
      if (off >= 0 && e < c.D) {
        r.k[u][j] = *reinterpret_cast<const Vec<T, VEC>*>(k + off + e);
        r.v[u][j] = *reinterpret_cast<const Vec<T, VEC>*>(v + off + e);
      } else {
        r.k[u][j] = zero_vec<T, VEC>();
        r.v[u][j] = zero_vec<T, VEC>();
      }
    }
  }
}

// ASYNC: issue tile ``i``'s K and V rows into ring stage ``stage`` with
// 16-byte cp.async copies.  A thread copies the same vectors of K and V
// (one offset for both); consecutive threads take consecutive vectors of
// a row, so a warp's copies are contiguous.
template <typename T, int VEC, int LPS, int PER, int GR>
__device__ __forceinline__ void issue_tile(T* stage, const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           const Chunk& c, int i, int* bad) {
  using C = Cfg<T, VEC, LPS, PER, GR, true>;
  constexpr int kRowVecs = LPS * PER;
  constexpr int kVecs = C::kTile * kRowVecs;
  static_assert(kVecs % kThreads == 0, "whole copies a thread");
  const int t0 = c.c0 + i * C::kTile;
#pragma unroll
  for (int n = 0; n < kVecs / kThreads; ++n) {
    const int idx = n * kThreads + threadIdx.x;
    const int row = idx / kRowVecs;
    const int col = (idx - row * kRowVecs) * VEC;
    const int t = t0 + row;
    long long off = 0;
    bool fill = false;
    if (t < c.c1) {
      off = slot_offset(c, t);
      fill = off >= 0;
      if (!fill) {
        *bad = 1;
        off = 0;
      }
    }
    T* dst = stage + row * C::kD + col;
    cp_async16(dst, k + off + col, fill);
    cp_async16(dst + C::kTile * C::kD, v + off + col, fill);
  }
}

template <typename T, int VEC, int LPS, int PER>
__device__ __forceinline__ void read_stage(TileRegs<T, VEC, PER>& r,
                                           const T* stage, const Chunk& c,
                                           int i, int group, int sl,
                                           int groups, int tile, int kD) {
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    const int row = u * groups + group;
    r.valid[u] = c.c0 + i * tile + row < c.c1;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = (j * LPS + sl) * VEC;
      r.k[u][j] = *reinterpret_cast<const Vec<T, VEC>*>(stage + row * kD + e);
      r.v[u][j] = *reinterpret_cast<const Vec<T, VEC>*>(
          stage + (tile + row) * kD + e);
    }
  }
}

// The workspace of a call with splits > 1: acc [B*KV][splits][G][D], m
// and l [B*KV][splits][G], ok [B*KV][splits] (``parts`` = B*KV*splits*G).
struct Workspace {
  float *acc, *m, *l, *ok;
  __device__ Workspace(float* ws, size_t parts, int D)
      : acc(ws),
        m(ws + parts * D),
        l(ws + parts * D + parts),
        ok(ws + parts * D + 2 * parts) {}
};

// Element e of query row g (of G) of block (b, kv, split), its chunk
// folded: the row's base-2 max mx, its sum ll and its accumulator a.  One
// split: the output (and the partials); else the workspace, for the merge.
template <typename T>
__device__ __forceinline__ void leave_row(T* out, float* m_out, float* l_out,
                                          const Workspace& w, int b, int kv,
                                          int H, int KV, int g, int D, int e,
                                          int split, int splits, float mx,
                                          float ll, float a, bool ok) {
  const int G = H / KV;
  if (splits == 1) {
    const size_t row = static_cast<size_t>(b) * H + kv * G + g;
    out[row * D + e] = from_f<T>(ok ? a / fmaxf(ll, 1e-30f) : CUDART_NAN_F);
    if (m_out && e == 0) write_partials(m_out, l_out, row, mx, ll, ok);
  } else {
    const size_t row =
        ((static_cast<size_t>(b) * KV + kv) * splits + split) * G + g;
    w.acc[row * D + e] = a;
    if (e == 0) {
      w.m[row] = mx;
      w.l[row] = ll;
    }
  }
}

// With splits > 1, once a block has left its rows and its fault flag: the
// last block of this (b, kv) to finish merges the splits below seq_len in
// split order and resets the counter for the next call on the stream.
template <typename T>
__device__ void merge_splits(T* out, float* m_out, float* l_out,
                             const Workspace& w, int* counters, int b, int kv,
                             int H, int KV, int D, int len, int chunk,
                             int splits) {
  __shared__ int sm_last;
  const int G = H / KV;
  const size_t bkv = static_cast<size_t>(b) * KV + kv;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sm_last = atomicAdd(counters + bkv, 1) == splits - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  const int n_active = (len + chunk - 1) / chunk;  // splits below seq_len
  bool ok = true;
  for (int s = 0; s < n_active; ++s)
    ok &= __ldcg(w.ok + bkv * splits + s) != 0.f;
  // A thread merges a run of kRun elements of one row: the row's max and
  // each split's weight once for the run, and the run's loads in flight
  // together (the merge is the launch's tail: one element a thread, each
  // load waiting on the last, made it half again as long).  Each element
  // is still one fmaf chain over the splits in order.
  constexpr int kRun = 8;
  const int runs = (D + kRun - 1) / kRun;  // a row's
  for (int task = threadIdx.x; task < G * runs; task += kThreads) {
    const int g = task / runs;
    const int e0 = (task - g * runs) * kRun;
    const size_t row0 = bkv * splits * G + g;  // split s's row: + s * G
    float mx = kNegInf;
#pragma unroll 4
    for (int s = 0; s < n_active; ++s)
      mx = fmaxf(mx, __ldcg(w.m + row0 + static_cast<size_t>(s) * G));
    float ll = 0.f, a[kRun] = {};
#pragma unroll 4
    for (int s = 0; s < n_active; ++s) {
      const size_t row = row0 + static_cast<size_t>(s) * G;
      const float wt = exp2f(__ldcg(w.m + row) - mx);
      ll = fmaf(__ldcg(w.l + row), wt, ll);
#pragma unroll
      for (int x = 0; x < kRun; ++x)
        if (e0 + x < D) a[x] = fmaf(__ldcg(w.acc + row * D + e0 + x), wt, a[x]);
    }
    const size_t row = static_cast<size_t>(b) * H + kv * G + g;
#pragma unroll
    for (int x = 0; x < kRun; ++x)
      if (e0 + x < D)
        out[row * D + e0 + x] =
            from_f<T>(ok ? a[x] / fmaxf(ll, 1e-30f) : CUDART_NAN_F);
    if (m_out && e0 == 0) write_partials(m_out, l_out, row, mx, ll, ok);
  }
  if (threadIdx.x == 0) counters[bkv] = 0;  // ready for the next call
}

// One block: KV head blockIdx.x of sequence blockIdx.y, chunk blockIdx.z.
template <typename T, int VEC, int LPS, int PER, int GR, bool ASYNC>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ page_table, const int* __restrict__ seq_lens,
    T* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
    float* __restrict__ m_out, float* __restrict__ l_out, int H, int KV,
    int D, int page, int P, int n_pages, int chunk) {
  using C = Cfg<T, VEC, LPS, PER, GR, ASYNC>;
  constexpr int kE = C::kElems;
  extern __shared__ float4 smem4[];
  __shared__ int sm_bad;
  T* ring = reinterpret_cast<T*>(smem4);
  float* sm_acc = reinterpret_cast<float*>(smem4);  // [kGroups][GR][D]
  float* sm_m = sm_acc + C::kGroups * GR * D;       // [kGroups][GR]
  float* sm_l = sm_m + C::kGroups * GR;

  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int B = gridDim.y;
  const int G = H / KV;
  const int lane = threadIdx.x & 31;
  const int group = (threadIdx.x >> 5) * C::kGroupsPerWarp + lane / LPS;
  const int sl = lane % LPS;
  const int len = min(max(seq_lens[b], 0), P * page);
  Chunk c;
  c.table = page_table + static_cast<size_t>(b) * P;
  c.c0 = split * chunk;
  c.c1 = min(c.c0 + chunk, len);
  c.kv = kv;
  c.KV = KV;
  c.D = D;
  c.page = page;
  c.n_pages = n_pages;
  c.page_shift = (page & (page - 1)) == 0 ? __ffs(page) - 1 : -1;
  const int n_tiles = c.c1 > c.c0 ? (c.c1 - c.c0 + C::kTile - 1) / C::kTile : 0;
  // log2(e) / sqrt(D): scores in base 2 (fold's note).
  const float qscale = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const size_t bkv = static_cast<size_t>(b) * KV + kv;
  const Workspace w(ws, static_cast<size_t>(B) * KV * splits * G, D);

  if (threadIdx.x == 0) sm_bad = 0;
  if (splits == 1 || c.c0 < len) {
    for (int g0 = 0; g0 < G; g0 += GR) {
      float qf[GR][kE], acc[GR][kE], m[GR], l[GR];
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        m[g] = kNegInf;
        l[g] = 0.f;
        const size_t qrow = (static_cast<size_t>(b) * H + kv * G + g0 + g) * D;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
#pragma unroll
          for (int x = 0; x < VEC; ++x) {
            const int e = (j * LPS + sl) * VEC + x;
            acc[g][j * VEC + x] = 0.f;
            qf[g][j * VEC + x] =
                (g0 + g < G && e < D) ? to_f(q[qrow + e]) * qscale : 0.f;
          }
        }
      }
      __syncthreads();  // sm_bad set; the last row group's merge reads done

      TileRegs<T, VEC, PER> r;
      if constexpr (ASYNC) {
#pragma unroll
        for (int s = 0; s < kStages - 1; ++s) {
          if (s < n_tiles)
            issue_tile<T, VEC, LPS, PER, GR>(
                ring + static_cast<size_t>(s) * 2 * C::kTile * C::kD, k, v, c,
                s, &sm_bad);
          cp_async_commit();
        }
        for (int i = 0; i < n_tiles; ++i) {
          cp_async_wait<kStages - 2>();
          __syncthreads();  // tile i landed; everyone is done with tile i - 1
          const int nxt = i + kStages - 1;
          if (nxt < n_tiles)
            issue_tile<T, VEC, LPS, PER, GR>(
                ring + static_cast<size_t>(nxt % kStages) * 2 * C::kTile *
                           C::kD,
                k, v, c, nxt, &sm_bad);
          cp_async_commit();
          read_stage<T, VEC, LPS, PER>(
              r, ring + static_cast<size_t>(i % kStages) * 2 * C::kTile * C::kD,
              c, i, group, sl, C::kGroups, C::kTile, C::kD);
          fold<T, VEC, LPS, PER, GR>(r, qf, m, l, acc);
        }
        cp_async_wait<0>();
      } else {
        if (n_tiles > 0)
          load_regs<T, VEC, LPS, PER>(r, k, v, c, 0, group, sl, C::kGroups,
                                      &sm_bad);
        for (int i = 0; i < n_tiles; ++i) {
          TileRegs<T, VEC, PER> nx = r;
          if (i + 1 < n_tiles)
            load_regs<T, VEC, LPS, PER>(nx, k, v, c, i + 1, group, sl,
                                        C::kGroups, &sm_bad);
          fold<T, VEC, LPS, PER, GR>(r, qf, m, l, acc);
          r = nx;
        }
      }
      __syncthreads();  // the ring is free: lane groups' states go there

#pragma unroll
      for (int g = 0; g < GR; ++g) {
        if (sl == 0) {
          sm_m[group * GR + g] = m[g];
          sm_l[group * GR + g] = l[g];
        }
#pragma unroll
        for (int j = 0; j < PER; ++j) {
#pragma unroll
          for (int x = 0; x < VEC; ++x) {
            const int e = (j * LPS + sl) * VEC + x;
            if (e < D) sm_acc[(group * GR + g) * D + e] = acc[g][j * VEC + x];
          }
        }
      }
      __syncthreads();
      const bool ok = sm_bad == 0;
      for (int i = threadIdx.x; i < GR * D; i += kThreads) {
        const int g = i / D;
        const int e = i - g * D;
        if (g0 + g >= G) continue;
        float mx = kNegInf;
        for (int s = 0; s < C::kGroups; ++s) mx = fmaxf(mx, sm_m[s * GR + g]);
        float ll = 0.f, a = 0.f;
        for (int s = 0; s < C::kGroups; ++s) {
          const float wt = exp2f(sm_m[s * GR + g] - mx);
          ll = fmaf(sm_l[s * GR + g], wt, ll);
          a = fmaf(sm_acc[(s * GR + g) * D + e], wt, a);
        }
        leave_row(out, m_out, l_out, w, b, kv, H, KV, g0 + g, D, e, split,
                  splits, mx, ll, a, ok);
      }
    }
    __syncthreads();
    if (splits > 1 && threadIdx.x == 0)
      w.ok[bkv * splits + split] = sm_bad == 0 ? 1.f : 0.f;
  }
  if (splits == 1) return;
  merge_splits(out, m_out, l_out, w, counters, b, kv, H, KV, D, len, chunk,
               splits);
}

// ---------------------------------------------------------------------------
// The tensor-core instance (the note's second part): bf16, D = 64, 128, 192
// or 256, every query row of a KV head (up to 16) in one pass.

constexpr int kTcRows = 16;                     // an mma's rows: G, padded
constexpr int kWarpSlots = 16;                  // slots a warp takes a tile
constexpr int kTcTile = kWarps * kWarpSlots;    // 64 slots a tile
using bf16 = __nv_bfloat16;

template <int D>
struct TcCfg {
  static_assert(D % 16 == 0 && D <= 256, "whole k-steps of 16");
  static constexpr int kPitch = D + 8;  // a staged row: 16 bytes past D
  static constexpr int kStages = D <= 128 ? 3 : 2;
  static constexpr int kVecs = D / 8;   // 16-byte copies a row
  static constexpr int kKSteps = D / 16;  // QK^T's k-steps
  static constexpr int kNBlocks = D / 8;  // PV's n-blocks of 8 columns
  static constexpr size_t kStageElems = size_t(2) * kTcTile * kPitch;  // K, V
  static constexpr size_t kQBytes = size_t(kTcRows) * kPitch * sizeof(bf16);
  static constexpr size_t kRingBytes = kStages * kStageElems * sizeof(bf16);
  // The warps' (O, m, l) at the chunk's end, in the ring's place.
  static constexpr size_t kMergeBytes =
      size_t(kWarps) * kTcRows * (D + 2) * sizeof(float);
  static constexpr size_t kSmem =
      kQBytes + (kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the rows of matrix i.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Tile ``i``'s K and V rows into ring stage ``stage``, 16-byte cp.async
// copies evicted from L2 first, rows kPitch apart; zeros past the chunk's
// valid slots and for a bad page (which sets *bad).
template <int D>
__device__ __forceinline__ void tc_issue_tile(bf16* stage,
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v,
                                              const Chunk& c, int i, int* bad) {
  using C = TcCfg<D>;
  constexpr int kCopies = kTcTile * C::kVecs;
  static_assert(kCopies % kThreads == 0, "whole copies a thread");
  const int t0 = c.c0 + i * kTcTile;
  const unsigned long long policy = evict_first_policy();
#pragma unroll
  for (int n = 0; n < kCopies / kThreads; ++n) {
    const int idx = n * kThreads + threadIdx.x;
    const int row = idx / C::kVecs;
    const int col = (idx - row * C::kVecs) * 8;
    const int t = t0 + row;
    long long off = 0;
    bool fill = false;
    if (t < c.c1) {
      off = slot_offset(c, t);
      fill = off >= 0;
      if (!fill) {
        *bad = 1;
        off = 0;
      }
    }
    bf16* dst = stage + row * C::kPitch + col;
    cp_async16(dst, k + off + col, fill, policy);
    cp_async16(dst + kTcTile * C::kPitch, v + off + col, fill, policy);
  }
}

// One warp's 16 slots of a staged tile (K rows ``ks``, V rows ``vs``; the
// first at slot t0) folded into its online softmax of the 16 query rows
// (``sq``).  A lane holds rows quad and quad + 8 of every fragment (r = 0,
// 1), columns 2 ql and 2 ql + 1 of each 8; m, l and o are those rows'.
template <int D>
__device__ __forceinline__ void tc_fold(const bf16* sq, const bf16* ks,
                                        const bf16* vs, int t0, int c1,
                                        float qscale, float (&m)[2],
                                        float (&l)[2],
                                        float (&o)[TcCfg<D>::kNBlocks][4]) {
  using C = TcCfg<D>;
  const int lane = threadIdx.x & 31;
  const int ql = lane & 3;
  // S = q K^T: 16 rows x 16 slots, n-blocks of slots 0-7 and 8-15.
  float s[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < C::kKSteps; ++kk) {
    unsigned a[4], b[4];
    ldsm_x4(a, sq + (lane & 15) * C::kPitch + kk * 16 + (lane >> 4) * 8);
    ldsm_x4(b, ks + ((lane & 7) + ((lane >> 4) << 3)) * C::kPitch + kk * 16 +
                   ((lane >> 3) & 1) * 8);
    mma_bf16(s[0], a, b[0], b[1]);
    mma_bf16(s[1], a, b[2], b[3]);
  }
  // s[j][2 r + x] is row quad + 8 r's score of slot t0 + 8 j + 2 ql + x.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const bool valid = t0 + 8 * j + 2 * ql + x < c1;
        float& sc = s[j][2 * r + x];
        sc = valid ? sc * qscale : kNegInf;
        mx = fmaxf(mx, sc);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
    const float alpha = exp2f(m[r] - mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const bool valid = t0 + 8 * j + 2 * ql + x < c1;
        float& sc = s[j][2 * r + x];
        sc = valid ? exp2f(sc - mx) : 0.f;
        psum += sc;
      }
    }
    l[r] = l[r] * alpha + psum;  // the lane's own slots; the quad's at the end
    m[r] = mx;
#pragma unroll
    for (int nb = 0; nb < C::kNBlocks; ++nb) {
      o[nb][2 * r] *= alpha;
      o[nb][2 * r + 1] *= alpha;
    }
  }
  // P in bf16 as the A operand (16 rows x 16 slots) straight from S's
  // fragments; O += P V, V's 16 x 8 blocks by ldmatrix.trans.
  const unsigned p[4] = {pack_bf16(s[0][0], s[0][1]),
                         pack_bf16(s[0][2], s[0][3]),
                         pack_bf16(s[1][0], s[1][1]),
                         pack_bf16(s[1][2], s[1][3])};
#pragma unroll
  for (int nb = 0; nb < C::kNBlocks; nb += 2) {
    unsigned b[4];
    ldsm_x4_trans(b, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * C::kPitch +
                         nb * 8 + (lane >> 4) * 8);
    mma_bf16(o[nb], p, b[0], b[1]);
    mma_bf16(o[nb + 1], p, b[2], b[3]);
  }
}

// One block: KV head blockIdx.x of sequence blockIdx.y, chunk blockIdx.z;
// the same arguments as paged_attention_kernel's (D is the template's).
template <int D>
__global__ void __launch_bounds__(kThreads) paged_attention_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ page_table,
    const int* __restrict__ seq_lens, bf16* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ counters,
    float* __restrict__ m_out, float* __restrict__ l_out, int H, int KV,
    int /*D*/, int page, int P, int n_pages, int chunk) {
  using C = TcCfg<D>;
  extern __shared__ float4 smem4[];
  __shared__ int sm_bad;
  bf16* sq = reinterpret_cast<bf16*>(smem4);  // [kTcRows][kPitch]
  bf16* ring = sq + kTcRows * C::kPitch;      // [kStages][K, V][64][kPitch]
  float* sm_o = reinterpret_cast<float*>(ring);  // [kWarps][kTcRows][D]
  float* sm_m = sm_o + kWarps * kTcRows * D;     // [kWarps][kTcRows]
  float* sm_l = sm_m + kWarps * kTcRows;

  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int B = gridDim.y;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane >> 2;
  const int ql = lane & 3;
  const int len = min(max(seq_lens[b], 0), P * page);
  Chunk c;
  c.table = page_table + static_cast<size_t>(b) * P;
  c.c0 = split * chunk;
  c.c1 = min(c.c0 + chunk, len);
  c.kv = kv;
  c.KV = KV;
  c.D = D;
  c.page = page;
  c.n_pages = n_pages;
  c.page_shift = (page & (page - 1)) == 0 ? __ffs(page) - 1 : -1;
  const int n_tiles =
      c.c1 > c.c0 ? (c.c1 - c.c0 + kTcTile - 1) / kTcTile : 0;
  // log2(e) / sqrt(D), applied to the f32 scores: base 2.
  const float qscale = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const size_t bkv = static_cast<size_t>(b) * KV + kv;
  const Workspace w(ws, static_cast<size_t>(B) * KV * splits * G, D);

  if (threadIdx.x == 0) sm_bad = 0;
  if (splits == 1 || c.c0 < len) {
    for (int g0 = 0; g0 < G; g0 += kTcRows) {
      __syncthreads();  // sm_bad set; the last row group's merge read done
#pragma unroll
      for (int s = 0; s < C::kStages - 1; ++s) {
        if (s < n_tiles)
          tc_issue_tile<D>(ring + s * C::kStageElems, k, v, c, s, &sm_bad);
        cp_async_commit();
      }
      // The rows, while the first tiles are in flight.
      for (int i = threadIdx.x; i < kTcRows * D; i += kThreads) {
        const int r = i / D;
        const int e = i - r * D;
        sq[r * C::kPitch + e] =
            g0 + r < G ? q[(static_cast<size_t>(b) * H + kv * G + g0 + r) * D +
                           e]
                       : __float2bfloat16_rn(0.f);
      }
      float o[C::kNBlocks][4] = {};
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
      for (int i = 0; i < n_tiles; ++i) {
        // Tile i - 1 is done with: its stage takes tile i + kStages - 1
        // before tile i is waited for, so kStages tiles are in flight.
        __syncthreads();
        const int nxt = i + C::kStages - 1;
        if (nxt < n_tiles)
          tc_issue_tile<D>(ring + (nxt % C::kStages) * C::kStageElems, k, v,
                           c, nxt, &sm_bad);
        cp_async_commit();
        cp_async_wait<C::kStages - 1>();
        __syncthreads();  // tile i (and q) landed
        const int t0 = c.c0 + i * kTcTile + warp * kWarpSlots;
        if (t0 >= c.c1) continue;  // the warp's slots are all past the chunk
        const bf16* ks = ring + (i % C::kStages) * C::kStageElems +
                         warp * kWarpSlots * C::kPitch;
        tc_fold<D>(sq, ks, ks + kTcTile * C::kPitch, t0, c.c1, qscale, m, l,
                   o);
      }
      cp_async_wait<0>();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(~0u, l[r], 1);
        l[r] += __shfl_xor_sync(~0u, l[r], 2);
      }
      __syncthreads();  // the ring is free: the warps' states go there
      float* wo = sm_o + warp * kTcRows * D;
#pragma unroll
      for (int nb = 0; nb < C::kNBlocks; ++nb) {
        const int e = nb * 8 + 2 * ql;
        *reinterpret_cast<float2*>(wo + quad * D + e) =
            make_float2(o[nb][0], o[nb][1]);
        *reinterpret_cast<float2*>(wo + (quad + 8) * D + e) =
            make_float2(o[nb][2], o[nb][3]);
      }
      if (ql == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sm_m[warp * kTcRows + quad + 8 * r] = m[r];
          sm_l[warp * kTcRows + quad + 8 * r] = l[r];
        }
      }
      __syncthreads();
      const bool ok = sm_bad == 0;
      const int rows = min(kTcRows, G - g0);
      for (int i = threadIdx.x; i < rows * D; i += kThreads) {
        const int g = i / D;
        const int e = i - g * D;
        float mx = kNegInf;
#pragma unroll
        for (int s = 0; s < kWarps; ++s)
          mx = fmaxf(mx, sm_m[s * kTcRows + g]);
        float ll = 0.f, a = 0.f;
#pragma unroll
        for (int s = 0; s < kWarps; ++s) {
          const float wt = exp2f(sm_m[s * kTcRows + g] - mx);
          ll = fmaf(sm_l[s * kTcRows + g], wt, ll);
          a = fmaf(sm_o[(s * kTcRows + g) * D + e], wt, a);
        }
        leave_row(out, m_out, l_out, w, b, kv, H, KV, g0 + g, D, e, split,
                  splits, mx, ll, a, ok);
      }
    }
    __syncthreads();
    if (splits > 1 && threadIdx.x == 0)
      w.ok[bkv * splits + split] = sm_bad == 0 ? 1.f : 0.f;
  }
  if (splits == 1) return;
  merge_splits(out, m_out, l_out, w, counters, b, kv, H, KV, D, len, chunk,
               splits);
}

// ---------------------------------------------------------------------------
// Launchers.

template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, const int*,
                          const int*, T*, float*, int*, float*, float*, int,
                          int, int, int, int, int, int);

// ``kern`` over the grid (KV, B, splits) with ``smem`` bytes of dynamic
// shared memory.  ``limit``, the most any call of the instance takes, past
// the default 48 KB less the static bytes: the instance's limit is raised
// to it once for each device (bit dev % 64 of its own ``ready``).
template <typename T>
int launch_kernel(KernelFn<T> kern, size_t smem, size_t limit,
                  std::atomic<unsigned long long>& ready,
                  const PagedAttentionArgs& a) {
  if (limit > 32 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(ready.load(std::memory_order_acquire) & bit)) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(limit));
      if (e != cudaSuccess) return static_cast<int>(e);
      ready.fetch_or(bit, std::memory_order_release);
    }
  }
  const dim3 grid(static_cast<unsigned>(a.KV), static_cast<unsigned>(a.B),
                  static_cast<unsigned>(a.splits));
  kern<<<grid, kThreads, smem, reinterpret_cast<cudaStream_t>(a.stream)>>>(
      reinterpret_cast<const T*>(a.q), reinterpret_cast<const T*>(a.k_pages),
      reinterpret_cast<const T*>(a.v_pages),
      reinterpret_cast<const int*>(a.page_table),
      reinterpret_cast<const int*>(a.seq_lens), reinterpret_cast<T*>(a.out),
      reinterpret_cast<float*>(a.ws), reinterpret_cast<int*>(a.counters),
      reinterpret_cast<float*>(a.m), reinterpret_cast<float*>(a.l),
      static_cast<int>(a.H), static_cast<int>(a.KV), static_cast<int>(a.D),
      static_cast<int>(a.page), static_cast<int>(a.P),
      static_cast<int>(a.n_pages), static_cast<int>(a.chunk));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, int LPS, int PER, int GR, bool ASYNC>
int launch_one(const PagedAttentionArgs& a) {
  using C = Cfg<T, VEC, LPS, PER, GR, ASYNC>;
  static std::atomic<unsigned long long> ready{0};
  return launch_kernel<T>(paged_attention_kernel<T, VEC, LPS, PER, GR, ASYNC>,
                          C::smem_bytes(static_cast<int>(a.D)),
                          C::smem_bytes(C::kD), ready, a);
}

template <int D>
int launch_tc_d(const PagedAttentionArgs& a) {
  static std::atomic<unsigned long long> ready{0};
  return launch_kernel<bf16>(paged_attention_tc_kernel<D>, TcCfg<D>::kSmem,
                             TcCfg<D>::kSmem, ready, a);
}

// The tensor-core instance: bf16 only, one instance a head_dim.
int launch_tc(const PagedAttentionArgs& a) {
  if (a.dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (a.D) {
    case 64:
      return launch_tc_d<64>(a);
    case 128:
      return launch_tc_d<128>(a);
    case 192:
      return launch_tc_d<192>(a);
    case 256:
      return launch_tc_d<256>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int VEC, int LPS, int PER, bool ASYNC>
int launch_gr(const PagedAttentionArgs& a) {
  return a.H == a.KV ? launch_one<T, VEC, LPS, PER, 1, ASYNC>(a)
                     : launch_one<T, VEC, LPS, PER, 2, ASYNC>(a);
}

// The ring's instances: the row is nvec = D * sizeof(T) / 16 vectors, 8 to
// 64, two a lane, so nvec / 2 lanes a slot (8 for D = 128 in bf16).
template <typename T>
int launch_async(const PagedAttentionArgs& a) {
  constexpr int VEC = 16 / sizeof(T);
  switch (a.D / VEC) {
    case 8:
      return launch_gr<T, VEC, 4, 2, true>(a);
    case 16:
      return launch_gr<T, VEC, 8, 2, true>(a);
    case 32:
      return launch_gr<T, VEC, 16, 2, true>(a);
    case 64:
      return launch_gr<T, VEC, 32, 2, true>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The scalar instance: 32 lanes a slot, PER = ceil(D / 32) elements each.
template <typename T>
int launch_scalar(const PagedAttentionArgs& a) {
  if (a.D <= 32) return launch_gr<T, 1, 32, 1, false>(a);
  if (a.D <= 64) return launch_gr<T, 1, 32, 2, false>(a);
  if (a.D <= 128) return launch_gr<T, 1, 32, 4, false>(a);
  return launch_gr<T, 1, 32, 8, false>(a);
}

template <typename T>
int launch(const PagedAttentionArgs& a) {
  return a.path == 1 ? launch_async<T>(a) : launch_scalar<T>(a);
}

}  // namespace

extern "C" {

int paged_attention_launch(const PagedAttentionArgs* p) {
  const PagedAttentionArgs& a = *p;
  if (a.B <= 0 || a.B > 65535 || a.KV <= 0 || a.H % a.KV || a.D <= 0 ||
      a.D > 256 || a.splits <= 0 || a.splits > 65535 || a.chunk <= 0 ||
      (a.splits > 1 && (!a.ws || !a.counters)) || (!a.m != !a.l))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.path == 2) return launch_tc(a);
  return a.dtype == 1 ? launch<__nv_bfloat16>(a) : launch<float>(a);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
