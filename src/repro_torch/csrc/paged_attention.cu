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
// Design.  One block per (KV head, sequence): it computes only that head's
// G queries.  The Pallas body computes all KV x KV head pairs and keeps the
// diagonal with an iota mask (kernel.py:58-67, :84-92), KV-fold wasted work
// that this kernel does not copy.  A warp owns one query row at a time; its
// lanes split D (lane l holds elements l, l + 32, ...) and a shuffle tree
// finishes each dot.  The block reads the page indices itself from its
// row of page_table (the TPU's scalar prefetch) and walks the slots in
// table order, kUnroll slots at a time, loading their K and V rows together
// before using any, with an online softmax (running m, l, and
// exp(m_prev - m_new) rescaling); slots at or past seq_len are never read.
// When G < kWarps the spare warps split the slots of a query row and the
// block merges their (m, l, acc) through shared memory at the end.
//
// Bound on this card: memory.  Each valid K/V slot is 2 * D elements read
// once for G queries (4 G D flops), far below the ~295 flops a byte at
// which an H100 stops being bound by its 3.35 TB/s.  So the design reads
// each valid slot once per block, skips the invalid ones, keeps q, m, l and
// acc in registers and writes only the output.  It does not yet keep enough
// loads in flight to reach the bound (no cp.async or TMA pipeline, one
// block per (b, kv) and no split of long sequences across blocks): that is
// a later change.  The kernel does no synchronisation with the host and
// allocates nothing.  A page index outside [0, n_pages) makes the block
// write NaN to its rows instead of reading out of bounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPerLane = 8;  // head_dim <= 256
constexpr int kUnroll = 8;      // slots in flight per warp
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

template <int PER>
struct Row {  // one warp's online-softmax state for one query row
  float m, l;
  float acc[PER];
};

// Fold slots t = first, first + stride, ... (in groups of kUnroll) of
// sequence b into row state ``r``; lane l handles elements l + 32 i, i <
// PER.  Each group's K and V rows are loaded together, before any of them
// is used, so one memory round trip serves the group.  Returns false if a
// page index was out of range.
template <typename T, int PER>
__device__ bool attend(const float (&qv)[PER], const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ table,
                       int len, int first, int stride, int kv, int KV, int D,
                       int page, int n_pages, float root_d, Row<PER>& r) {
  const int lane = threadIdx.x & 31;
  const T zero = from_f<T>(0.f);
  bool ok = true;
  for (int t0 = first; t0 < len; t0 += stride) {
    bool valid[kUnroll];
    T kx[kUnroll][PER];
    T vx[kUnroll][PER];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      valid[u] = t < len;
      size_t off = 0;
      if (valid[u]) {
        const int pg = table[t / page];
        if (pg < 0 || pg >= n_pages) {
          ok = false;
          valid[u] = false;
        } else {
          off = ((static_cast<size_t>(pg) * page + t % page) * KV + kv) * D;
        }
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int d = lane + 32 * i;
        const bool in = valid[u] && d < D;
        kx[u][i] = in ? k[off + d] : zero;
        vx[u][i] = in ? v[off + d] : zero;
      }
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) part = fmaf(qv[i], to_f(kx[u][i]), part);
      s[u] = part;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s[u] += __shfl_xor_sync(~0u, s[u], o);
    }
    float m_new = r.m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = valid[u] ? s[u] / root_d : kNegInf;
      m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(r.m - m_new);
    float p[kUnroll];
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[u] = valid[u] ? expf(s[u] - m_new) : 0.f;
      psum += p[u];
      p[u] = to_f(from_f<T>(p[u]));  // probabilities in v's type
    }
    r.l = r.l * alpha + psum;
    r.m = m_new;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      float a = r.acc[i] * alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], to_f(vx[u][i]), a);
      r.acc[i] = a;
    }
  }
  return ok;
}

template <typename T, int PER>
__device__ void store_row(T* __restrict__ out, const Row<PER>& r, int D,
                          bool ok) {
  const int lane = threadIdx.x & 31;
  const float denom = fmaxf(r.l, 1e-30f);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = lane + 32 * i;
    if (d < D) out[d] = from_f<T>(ok ? r.acc[i] / denom : CUDART_NAN_F);
  }
}

// PER = ceil(D / 32) rounded up to 1, 2, 4 or 8: the elements a lane holds.
template <typename T, int PER>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ page_table,
                           const int* __restrict__ seq_lens, T* __restrict__ out,
                           int H, int KV, int D, int page, int P, int n_pages) {
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][PER * 32];
  __shared__ int sm_ok[kWarps];

  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int splits = G >= kWarps ? 1 : kWarps / G;  // warps per query row
  const int rows_at_once = kWarps / splits;
  const int split = warp % splits;
  const int len = min(max(seq_lens[b], 0), P * page);
  const int* table = page_table + static_cast<size_t>(b) * P;
  const float root_d = sqrtf(static_cast<float>(D));

  for (int g0 = 0; g0 < G; g0 += rows_at_once) {
    const int g = g0 + warp / splits;
    const int h = kv * G + g;
    Row<PER> r;
    r.m = kNegInf;
    r.l = 0.f;
    float qv[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      r.acc[i] = 0.f;
      const int d = lane + 32 * i;
      qv[i] = (g < G && d < D)
                  ? to_f(q[(static_cast<size_t>(b) * H + h) * D + d])
                  : 0.f;
    }
    bool ok = true;
    if (g < G) {
      ok = attend<T, PER>(qv, k, v, table, len, split * kUnroll,
                          splits * kUnroll, kv, KV, D, page, n_pages, root_d,
                          r);
    }
    T* dst = out + (static_cast<size_t>(b) * H + h) * D;
    if (splits == 1) {
      if (g < G) store_row<T, PER>(dst, r, D, ok);
      continue;
    }
    // Merge the splits of each row: warp w holds split w % splits.
    if (lane == 0) {
      sm_m[warp] = r.m;
      sm_l[warp] = r.l;
      sm_ok[warp] = ok;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) sm_acc[warp][lane + 32 * i] = r.acc[i];
    __syncthreads();
    if (split == 0 && g < G) {
      float m = kNegInf;
      for (int w = warp; w < warp + splits; ++w) m = fmaxf(m, sm_m[w]);
      Row<PER> all;
      all.l = 0.f;
      bool all_ok = true;
#pragma unroll
      for (int i = 0; i < PER; ++i) all.acc[i] = 0.f;
      for (int w = warp; w < warp + splits; ++w) {
        const float c = expf(sm_m[w] - m);
        all.l = fmaf(sm_l[w], c, all.l);
        all_ok = all_ok && sm_ok[w];
#pragma unroll
        for (int i = 0; i < PER; ++i)
          all.acc[i] = fmaf(sm_acc[w][lane + 32 * i], c, all.acc[i]);
      }
      store_row<T, PER>(dst, all, D, all_ok);
    }
    __syncthreads();
  }
}

template <typename T, int PER>
int launch_per(const void* q, const void* k, const void* v, const int* table,
               const int* lens, void* out, int B, int H, int KV, int D,
               int page, int P, int n_pages, cudaStream_t stream) {
  paged_attention_kernel<T, PER><<<dim3(KV, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, lens, static_cast<T*>(out), H, KV, D,
      page, P, n_pages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* lens, void* out, int B, int H, int KV, int D, int page,
           int P, int n_pages, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_per<T, 1>(q, k, v, table, lens, out, B, H, KV, D, page, P,
                            n_pages, st);
  if (D <= 64)
    return launch_per<T, 2>(q, k, v, table, lens, out, B, H, KV, D, page, P,
                            n_pages, st);
  if (D <= 128)
    return launch_per<T, 4>(q, k, v, table, lens, out, B, H, KV, D, page, P,
                            n_pages, st);
  return launch_per<T, kMaxPerLane>(q, k, v, table, lens, out, B, H, KV, D,
                                    page, P, n_pages, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out share it).
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const int* page_table,
                           const int* seq_lens, void* out, int B, int H,
                           int KV, int D, int page, int P, int n_pages,
                           int dtype, void* stream) {
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, seq_lens,
                                 out, B, H, KV, D, page, P, n_pages, stream);
  }
  return launch<float>(q, k_pages, v_pages, page_table, seq_lens, out, B, H,
                       KV, D, page, P, n_pages, stream);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
