// kv_decode and paged_attention: one-token GQA attention over a packed KV
// cache, dense or paged, through one body.
//
// Replaces the Pallas TPU kernels repro/kernels/kv_decode.py:kv_decode
// (_kv_decode_kernel) and repro/kernels/paged_attention.py:paged_attention
// (_paged_attn_kernel).
//
// Bound on this card: bytes. Each live cache row is read once (K and V,
// bits/8 bytes per element) and used by the G = H / Hkv query heads of
// its group: ~4*G flops per decoded element, far below the card's ratio
// of operations to bytes.
//
// Design: flash-decoding. At 8 slots and 8 KV heads there are only 64
// (batch, kv-head) pairs for 132 SMs, so the sequence is split into
// chunks: grid (B * Hkv, n_chunks). A block owns one pair and one chunk;
// it scores its live rows (K rows decoded in registers, a warp per row,
// lanes across head_dim, G dot products reduced across the warp), takes
// the chunk's max and exp-sums in f32, then accumulates p @ V with warp
// w owning dims [32w, 32w + 32). A second pass merges the per-chunk
// (m, l, acc) in chunk order. Rows at or past kv_len are never read;
// kv_len larger than S counts as S (idle slots keep stepping past the
// end); kv_len == 0 gives zeros. Any S works: the last chunk is masked.
//
// Paging is only the row's address. Position t of sequence b lives in
// cache row table[b, t / page] * page + t % page; the dense cache is the
// case page = S, table[b] = b (a null table). The chunks run over
// positions, so a paged call and a dense call with S = max_pages * page
// run the same chunks in the same order and give the same bits. Page
// ids come from device memory, clamped into the pool; a page whose
// first position is at or past kv_len holds no live row and is never
// read, so the scrap page 0 of unallocated table entries is never read.
// A pool of plain rows (bits 0: bf16 or f32, head_dim wide) loads its
// elements as they are.
#include <cmath>

#include "codec.cuh"

namespace {

constexpr int kMaxGroups = 8;   // head_dim <= 256
constexpr int kAccHeads = 16;   // query heads accumulated per pass over V

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// Cache row of position t of sequence b: dense (table == nullptr, page
// == S) or through the page table.
__device__ __forceinline__ long long cache_row(const int* __restrict__ table, int b, int t,
                                               int page, int max_pages, int pool_pages) {
  const int p = t / page;
  int id = b;
  if (table != nullptr) {
    id = table[(long long)b * max_pages + p];
    id = id < 0 ? 0 : (id >= pool_pages ? pool_pages - 1 : id);
  }
  return (long long)id * page + (t - p * page);
}

// Element d = 32 * t + lane of a row: a code of a packed row (B > 0,
// KT = uint32_t; the pad codes of the last group decode to 0), or a
// plain bf16/f32 element (B == 0).
template <int B, typename KT>
__device__ __forceinline__ float row_elem(const KT* __restrict__ row, int t, int lane, int D) {
  if constexpr (B == 0) {
    const int d = t * 32 + lane;
    return d < D ? rt::to_f32(row[d]) : 0.f;
  } else {
    return rt::decode_float<B>(rt::extract_code<B>(row + t * B, lane));
  }
}

template <int B, typename KT, typename QT>
__global__ void kvd_partial(const QT* __restrict__ q, const KT* __restrict__ kc,
                            const KT* __restrict__ vc, const int* __restrict__ table,
                            const int* __restrict__ kv_len, float* __restrict__ m_ws,
                            float* __restrict__ l_ws, float* __restrict__ acc_ws, int H, int Hkv,
                            int page, int max_pages, int pool_pages, int D, int words, int chunk,
                            int n_chunks, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  float* q_s = smem;            // (G, D)
  float* p_s = smem + G * D;    // (G, chunk)
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / Hkv, kvh = bh % Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int ngroups = (D + 31) >> 5;
  const int S = page * max_pages;
  int L = kv_len[b];
  L = L < 0 ? 0 : (L > S ? S : L);
  const int s0 = c * chunk;
  const int n = max(min(s0 + chunk, L) - s0, 0);
  const long long part = (long long)bh * n_chunks + c;
  if (n == 0) {
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      m_ws[part * G + g] = -INFINITY;
      l_ws[part * G + g] = 0.f;
    }
    return;
  }
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    q_s[i] = rt::to_f32(q[((long long)b * H + (long long)kvh * G) * D + i]);
  __syncthreads();

  // scores: one warp per cache row
  for (int i = warp; i < n; i += nwarps) {
    const KT* row =
        kc + (cache_row(table, b, s0 + i, page, max_pages, pool_pages) * Hkv + kvh) * words;
    float kd[kMaxGroups];
#pragma unroll
    for (int t = 0; t < kMaxGroups; ++t) kd[t] = t < ngroups ? row_elem<B>(row, t, lane, D) : 0.f;
    for (int g = 0; g < G; ++g) {
      float part_dot = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxGroups; ++t) {
        const int d = t * 32 + lane;
        if (t < ngroups && d < D) part_dot = fmaf(q_s[g * D + d], kd[t], part_dot);
      }
      part_dot = warp_sum(part_dot);
      if (lane == 0) p_s[g * chunk + i] = part_dot * scale;
    }
  }
  __syncthreads();

  // chunk softmax statistics, one warp per query head
  for (int g = warp; g < G; g += nwarps) {
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, p_s[g * chunk + i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(p_s[g * chunk + i] - m);
      p_s[g * chunk + i] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_ws[part * G + g] = m;
      l_ws[part * G + g] = l;
    }
  }
  __syncthreads();

  // p @ V: warp w owns dims [32w, 32w + 32)
  if (warp >= ngroups) return;
  const int d = warp * 32 + lane;
  for (int g0 = 0; g0 < G; g0 += kAccHeads) {
    float acc[kAccHeads];
#pragma unroll
    for (int j = 0; j < kAccHeads; ++j) acc[j] = 0.f;
    for (int i = 0; i < n; ++i) {
      const KT* row =
          vc + (cache_row(table, b, s0 + i, page, max_pages, pool_pages) * Hkv + kvh) * words;
      const float v = row_elem<B>(row, warp, lane, D);
#pragma unroll
      for (int j = 0; j < kAccHeads; ++j)
        if (g0 + j < G) acc[j] = fmaf(p_s[(g0 + j) * chunk + i], v, acc[j]);
    }
    if (d < D) {
#pragma unroll
      for (int j = 0; j < kAccHeads; ++j)
        if (g0 + j < G) acc_ws[(part * G + g0 + j) * D + d] = acc[j];
    }
  }
}

// Merges the per-chunk (m, l, acc) in chunk order: one block per query
// head, one thread per output dim.
template <typename QT>
__global__ void kvd_merge(const float* __restrict__ m_ws, const float* __restrict__ l_ws,
                          const float* __restrict__ acc_ws, QT* __restrict__ out, int H, int Hkv,
                          int D, int n_chunks) {
  const int G = H / Hkv;
  const int bq = blockIdx.x;
  const int b = bq / H, h = bq % H;
  const int kvh = h / G, g = h % G;
  const long long base = (long long)b * Hkv + kvh;
  const int d = threadIdx.x;
  if (d >= D) return;
  float mx = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, m_ws[(base * n_chunks + c) * G + g]);
  float res = 0.f;
  if (mx != -INFINITY) {
    float l = 0.f, a = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const long long part = base * n_chunks + c;
      const float mc = m_ws[part * G + g];
      if (mc == -INFINITY) continue;
      const float sc = expf(mc - mx);
      l = fmaf(l_ws[part * G + g], sc, l);
      a = fmaf(acc_ws[(part * G + g) * D + d], sc, a);
    }
    res = a / fmaxf(l, 1e-30f);
  }
  out[(long long)bq * D + d] = rt::from_f32<QT>(res);
}

template <int B, typename KT, typename QT>
int launch(const void* q, const void* k, const void* v, const void* table, const void* kv_len,
           void* out, void* m_ws, void* l_ws, void* acc_ws, int batch, int H, int Hkv, int page,
           int max_pages, int pool_pages, int D, int words, int chunk, int n_chunks,
           cudaStream_t s) {
  const int G = H / Hkv;
  const int threads = 32 * ((D + 31) / 32);
  const size_t smem = (size_t)G * (D + chunk) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kvd_partial<B, KT, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(batch * Hkv, n_chunks);
  kvd_partial<B, KT, QT><<<grid, threads, smem, s>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, (const int*)table, (const int*)kv_len,
      (float*)m_ws, (float*)l_ws, (float*)acc_ws, H, Hkv, page, max_pages, pool_pages, D, words,
      chunk, n_chunks, 1.0f / sqrtf((float)D));
  kvd_merge<QT><<<batch * H, threads, 0, s>>>((const float*)m_ws, (const float*)l_ws,
                                             (const float*)acc_ws, (QT*)out, H, Hkv, D,
                                             n_chunks);
  return 0;
}

// kv_kind: 0 packed words at ``bits``, 1 f32 rows, 2 bf16 rows.
template <typename QT>
int launch_kind(int kv_kind, int bits, const void* q, const void* k, const void* v,
                const void* table, const void* kv_len, void* out, void* m_ws, void* l_ws,
                void* acc_ws, int batch, int H, int Hkv, int page, int max_pages,
                int pool_pages, int D, int words, int chunk, int n_chunks, cudaStream_t s) {
#define RT_KVD_ARGS                                                                        \
  q, k, v, table, kv_len, out, m_ws, l_ws, acc_ws, batch, H, Hkv, page, max_pages, pool_pages, \
      D, words, chunk, n_chunks, s
  if (kv_kind == 1) return launch<0, float, QT>(RT_KVD_ARGS);
  if (kv_kind == 2) return launch<0, __nv_bfloat16, QT>(RT_KVD_ARGS);
  if (kv_kind != 0) return (int)cudaErrorInvalidValue;
  int rc;
  RT_FLOAT_WIDTHS(bits, (rc = launch<B, uint32_t, QT>(RT_KVD_ARGS)));
#undef RT_KVD_ARGS
  return rc;
}

int attend(const void* q, int q_bf16, const void* k, const void* v, int kv_kind,
           const void* table, const void* kv_len, void* out, void* m_ws, void* l_ws,
           void* acc_ws, int batch, int H, int Hkv, int page, int max_pages, int pool_pages,
           int D, int words, int bits, int chunk, int n_chunks, void* stream) {
  if (batch == 0 || H == 0) return 0;
  if (D > 32 * kMaxGroups || Hkv == 0 || H % Hkv || page < 1 || max_pages < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = q_bf16 ? launch_kind<__nv_bfloat16>(kv_kind, bits, q, k, v, table, kv_len, out,
                                                     m_ws, l_ws, acc_ws, batch, H, Hkv, page,
                                                     max_pages, pool_pages, D, words, chunk,
                                                     n_chunks, s)
                        : launch_kind<float>(kv_kind, bits, q, k, v, table, kv_len, out, m_ws,
                                             l_ws, acc_ws, batch, H, Hkv, page, max_pages,
                                             pool_pages, D, words, chunk, n_chunks, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, D) f32 or bf16; k, v (B, S, Hkv, words) int32 words; kv_len
// (B,) int32; out (B, H, D) in q's dtype; m_ws, l_ws (B*Hkv, n_chunks, G)
// and acc_ws (B*Hkv, n_chunks, G, D) f32 scratch.
extern "C" int rt_kv_decode(const void* q, int q_bf16, const void* k, const void* v,
                            const void* kv_len, void* out, void* m_ws, void* l_ws, void* acc_ws,
                            int batch, int H, int Hkv, int S, int D, int words, int bits,
                            int chunk, int n_chunks, void* stream) {
  // the dense cache is one page of S rows per sequence (none when S = 0)
  return attend(q, q_bf16, k, v, 0, nullptr, kv_len, out, m_ws, l_ws, acc_ws, batch, H, Hkv,
                S > 0 ? S : 1, S > 0 ? 1 : 0, batch, D, words, bits, chunk, n_chunks, stream);
}

// The paged twin: k, v pools (pool_pages, page, Hkv, words) of int32
// words (kv_kind 0) or of f32/bf16 rows, words = D (kv_kind 1/2); table
// (B, max_pages) int32 page ids. Scratch as for rt_kv_decode.
extern "C" int rt_paged_attention(const void* q, int q_bf16, const void* k, const void* v,
                                  int kv_kind, const void* table, const void* kv_len, void* out,
                                  void* m_ws, void* l_ws, void* acc_ws, int batch, int H, int Hkv,
                                  int page, int max_pages, int pool_pages, int D, int words,
                                  int bits, int chunk, int n_chunks, void* stream) {
  return attend(q, q_bf16, k, v, kv_kind, table, kv_len, out, m_ws, l_ws, acc_ws, batch, H, Hkv,
                page, max_pages, pool_pages, D, words, bits, chunk, n_chunks, stream);
}
