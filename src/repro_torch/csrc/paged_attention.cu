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
// a byte, at most 1 in bf16 on every shape the repo runs (G = 1 for
// CodeQwen and moonshot, 2 for kernel_bench).  An H100 turns compute-bound
// only near 295 flops a byte in bf16 on its tensor cores, and near 20 in
// f32 on its CUDA cores.  So tensor cores (wgmma) would not shorten the
// kernel: a wgmma product needs 64 query rows and G <= 2 fills 2 of them.
// What sets the time is how many bytes are in flight and how many SMs
// take part; the design is about those two.
//
// Design.
//  * Split across blocks (flash-decoding).  The grid is (KV, B, splits);
//    a block takes the G query rows of one (b, kv) and the slots
//    [split * chunk, (split + 1) * chunk) below seq_lens[b].  The wrapper
//    picks splits from shapes alone (split_plan: the table's P * page
//    slots in chunks of 512); it never reads seq_lens, which live on the
//    device.  A block whose chunk starts at or past seq_lens[b] loads
//    nothing.  With one split (every shape of the decode path: 64 slots)
//    the block writes the output itself, with no workspace and no merge.
//  * The merge, in the same launch.  With splits > 1 each block leaves its
//    f32 partials (m_s, l_s, acc_s[G][D]) and a fault flag in a workspace
//    the wrapper provides, then counts itself done on an atomic counter of
//    its (b, kv) after __threadfence().  The block that counts last
//    merges: m = max m_s, c_s = exp(m_s - m), l = sum c_s l_s, out = sum
//    c_s acc_s / max(l, 1e-30), over the splits in split order, so the
//    result does not depend on which block came last and is the same bits
//    from run to run.  Splits at or past seq_lens[b] are not read (their
//    weight would be exp(-1e30 - m) = 0).  The merging block then resets
//    its counter to 0 for the next call on the stream.  One launch a call.
//  * 16-byte loads.  A slot's K row is split over a group of LPS lanes,
//    PER = 2 16-byte vectors each (for D = 128 in bf16: 8 lanes, 32 bytes
//    each), so a warp takes 32 / LPS slots at once and four warps take a
//    "pass"; a tile is kPasses passes (32 slots at D = 128 in bf16).  K and
//    V tiles go through a ring of kStages stages in dynamic shared memory
//    filled by cp.async.cg 16-byte copies (zero-filled past the chunk's
//    valid slots), kStages - 1 tiles ahead of the one being used (ASYNC).
//    16-byte loads straight into registers, one tile ahead, lost to the
//    ring at every shape measured (PERF.md) and are not kept.  The wrapper
//    takes the ring when a K/V row is 8, 16, 32 or 64 vectors (128 to 1024
//    bytes) and the pools are 16-byte aligned.  Any other D (D = 40 or 192
//    in bf16, D = 16) takes the scalar instance of the same template:
//    VEC = 1, 32 lanes a slot, element loads into registers (!ASYNC).
//  * Each lane group keeps its own online softmax (m, l, acc for its part
//    of D) over the slots it takes; a dot ends in a shuffle tree over the
//    group's lanes.  q is scaled by log2(e) / sqrt(D) once, so scores are
//    in base 2 and each probability is one exp2f: the kernel issues few
//    instructions a byte (the first version, with IEEE divisions, expf and
//    a division by the page size a copy, was bound by its instructions).
//    At the end of a chunk the block merges its lane groups' states
//    through shared memory in a fixed order.  Each probability is rounded
//    to v's type against its lane group's running max: the only place
//    where the split changes the arithmetic.
//  * GR = 1 or 2 query rows are held in registers at a time; G > 2 runs
//    the chunk again for each further pair of rows (no shape of the repo
//    has G > 2).
// The kernel does no synchronisation with the host and allocates nothing.
// A page index outside [0, n_pages) met below seq_lens[b] makes the rows of
// that (b, kv) NaN instead of a read out of bounds, whichever split meets
// it: the flag travels through the merge.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstddef>

// One call's arguments, packed by the wrapper as 20 int64 in this order
// (a ctypes call with one pointer argument costs the host a fraction of one
// with twenty).  dtype: 0 = float32, 1 = bfloat16 (q, the pools and out
// share it).  path: 0 = scalar loads, 1 = 16-byte cp.async ring.  ws: f32 workspace of B*KV*splits*(G*(D + 2) +
// 1) floats and counters: B*KV ints that are 0, both used only when
// splits > 1.
struct PagedAttentionArgs {
  long long q, k_pages, v_pages, page_table, seq_lens, out, ws, counters;
  long long B, H, KV, D, page, P, n_pages, splits, chunk, dtype, path;
  long long stream;
};

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;  // cp.async ring depth, in tiles
constexpr int kPasses = 2;  // slots a lane group takes from each tile
constexpr float kNegInf = -1e30f;

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

// One block: KV head blockIdx.x of sequence blockIdx.y, chunk blockIdx.z.
template <typename T, int VEC, int LPS, int PER, int GR, bool ASYNC>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ page_table, const int* __restrict__ seq_lens,
    T* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
    int H, int KV, int D, int page, int P, int n_pages, int chunk) {
  using C = Cfg<T, VEC, LPS, PER, GR, ASYNC>;
  constexpr int kE = C::kElems;
  extern __shared__ float4 smem4[];
  __shared__ int sm_bad;
  __shared__ int sm_last;
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
  // Workspace (splits > 1): acc [B*KV][splits][G][D], m and l
  // [B*KV][splits][G], ok [B*KV][splits].
  const size_t parts = static_cast<size_t>(B) * KV * splits * G;
  float* ws_acc = ws;
  float* ws_m = ws + parts * D;
  float* ws_l = ws_m + parts;
  float* ws_ok = ws_l + parts;

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
          const float w = exp2f(sm_m[s * GR + g] - mx);
          ll = fmaf(sm_l[s * GR + g], w, ll);
          a = fmaf(sm_acc[(s * GR + g) * D + e], w, a);
        }
        if (splits == 1) {
          out[(static_cast<size_t>(b) * H + kv * G + g0 + g) * D + e] =
              from_f<T>(ok ? a / fmaxf(ll, 1e-30f) : CUDART_NAN_F);
        } else {
          const size_t row = (bkv * splits + split) * G + g0 + g;
          ws_acc[row * D + e] = a;
          if (e == 0) {
            ws_m[row] = mx;
            ws_l[row] = ll;
          }
        }
      }
    }
    __syncthreads();
    if (splits > 1 && threadIdx.x == 0)
      ws_ok[bkv * splits + split] = sm_bad == 0 ? 1.f : 0.f;
  }
  if (splits == 1) return;

  // The last block of this (b, kv) to finish merges the splits.
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
    ok = ok && __ldcg(ws_ok + bkv * splits + s) != 0.f;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int e = i - g * D;
    float mx = kNegInf;
    for (int s = 0; s < n_active; ++s)
      mx = fmaxf(mx, __ldcg(ws_m + (bkv * splits + s) * G + g));
    float ll = 0.f, a = 0.f;
    for (int s = 0; s < n_active; ++s) {
      const size_t row = (bkv * splits + s) * G + g;
      const float w = exp2f(__ldcg(ws_m + row) - mx);
      ll = fmaf(__ldcg(ws_l + row), w, ll);
      a = fmaf(__ldcg(ws_acc + row * D + e), w, a);
    }
    out[(static_cast<size_t>(b) * H + kv * G + g) * D + e] =
        from_f<T>(ok ? a / fmaxf(ll, 1e-30f) : CUDART_NAN_F);
  }
  if (threadIdx.x == 0) counters[bkv] = 0;  // ready for the next call
}

template <typename T, int VEC, int LPS, int PER, int GR, bool ASYNC>
int launch_one(const PagedAttentionArgs& a) {
  using C = Cfg<T, VEC, LPS, PER, GR, ASYNC>;
  auto kern = paged_attention_kernel<T, VEC, LPS, PER, GR, ASYNC>;
  const int D = static_cast<int>(a.D);
  const size_t smem = C::smem_bytes(D);
  if (C::smem_bytes(C::kD) > 32 * 1024) {
    // Past the default 48 KB with the static bytes: raise the instance's
    // limit to its largest need, once for each device (bit dev % 64).
    static std::atomic<unsigned long long> ready{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(ready.load(std::memory_order_acquire) & bit)) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::smem_bytes(C::kD)));
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
      static_cast<int>(a.H), static_cast<int>(a.KV), D,
      static_cast<int>(a.page), static_cast<int>(a.P),
      static_cast<int>(a.n_pages), static_cast<int>(a.chunk));
  return static_cast<int>(cudaGetLastError());
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
      (a.splits > 1 && (!a.ws || !a.counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  return a.dtype == 1 ? launch<__nv_bfloat16>(a) : launch<float>(a);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
