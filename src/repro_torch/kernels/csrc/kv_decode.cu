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
// of operations to bytes. At decode sizes, though, a call reads a few MB
// spread over a few hundred blocks, about one per SM, so what holds it
// back is latency: the trips to memory on each block's critical path and
// the instruction chains between them, not the bandwidth. The design
// keeps one trip for all of a tile's rows and no per-row dependence on
// memory or on other lanes.
//
// Design: flash-decoding, grid (B * Hkv, n_chunks), two launches. A block
// of 256 threads owns one (batch, kv-head) pair and one chunk of
// positions (chunk_plan in kernels/kv_decode.py); a second kernel,
// launched as a programmatic dependent of the first so that its launch
// overlaps the first one's tail, merges the per-chunk (m, l, acc) in
// chunk order. Inside a block:
// 1. One trip for kv_len (q's loads ride along), one for the page table
//    when paged: each live row's cache row is looked up once, before any
//    row is read. Then every thread issues cp.async copies of the rows
//    into shared memory, 16 bytes a copy where the row width and the
//    pointers allow (8 or 4 otherwise): the tile's K rows as one commit
//    group, then its V rows as another. All of a tile's bytes are in
//    flight at once, and the V copies land while the scores are
//    computed. A chunk whose rows do not fit in one tile (tile_rows in
//    kernels/kv_decode.py) runs a ring of two tiles: tile k + 2's copies
//    go out as soon as tile k is consumed. Staged rows are padded to an
//    odd number of 16-byte units, so 8 lanes reading 16 bytes each from
//    8 rows hit 32 distinct banks.
// 2. Scores from shared memory with no shuffles: a thread owns a row
//    (and, when the tile has fewer rows than the block has threads, a
//    share of the row's groups of 32 codes), decodes each code once and
//    takes its dot products with every query head, two heads at a time
//    (q in shared memory, f32, read as broadcasts). Shares are summed in
//    a fixed order.
// 3. Softmax statistics per tile, one warp per query head, kept as a
//    running max and sum across the tiles of the chunk.
// 4. p @ V from shared memory with every warp: warp w owns dims [32t,
//    32t + 32), t = w % groups, and one row part of the tile; parts add
//    their sums into part 0's in part order through shared memory. Four
//    query heads per pass, p read four rows at a time; what earlier
//    tiles accumulated is rescaled as the running max moves. The first
//    four heads' accumulators stay in registers across tiles; further
//    heads' live in the f32 scratch the merge reads, written and read
//    back by the thread that owns them.
// No atomics: every sum runs in a fixed order, so a call's bits do not
// change between runs. Rows at or past kv_len are never read; kv_len
// larger than S counts as S (idle slots keep stepping past the end);
// kv_len == 0 gives zeros. Any S works: the last chunk and tile are
// masked.
//
// Paging is only the row's address. Position t of sequence b lives in
// cache row table[b, t / page] * page + t % page; the dense cache is the
// case page = S, table[b] = b (a null table). The chunks and tiles run
// over positions, so a paged call and a dense call with S = max_pages *
// page run the same chunks and tiles in the same order and give the same
// bits. Page ids come from device memory, clamped into the pool; a page
// whose first position is at or past kv_len holds no live row and is
// never read, so the scrap page 0 of unallocated table entries is never
// read. A pool of plain rows (bits 0: bf16 or f32, head_dim wide) stages
// its elements as they are; its rows must be a multiple of 4 bytes.
#include <cmath>
#include <cstdint>

#include "codec.cuh"

namespace {

constexpr int kMaxGroups = 8;       // head_dim <= 256
constexpr int kThreads = 256;       // threads per kvd_partial block
constexpr int kHeadsPerPass = 4;    // query heads accumulated per pass over V
constexpr int kMaxSplits = 4;       // threads sharing one row's scores

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

// Copies BYTES (16, 8 or 4) from global to shared memory asynchronously;
// 16-byte copies bypass L1 (.cg), narrower ones cannot.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block's shared memory, in bytes from its start: the staged rows
// (stages x {K, V} x tile rows), each live row's cache row (chunk ints),
// q (Gp, 32 * groups) f32, the partial scores (splits, Gp, tile) f32, the
// p @ V partial sums of row parts 1.. (parts - 1, kHeadsPerPass, 32 *
// groups) f32, and the running max, sum and rescale factor per query
// head. Gp is G rounded up to kHeadsPerPass: the loops over heads run
// whole passes without tests, and what they compute for heads past G is
// never used. Warp w of the p @ V pass owns dims [32t, 32t + 32) for t =
// w % groups and the tile's row part w / groups.
struct Layout {
  int stride, stages, splits, parts;
  int rows_at, q_at, p_at, red_at, stat_at, bytes;
};

__host__ __device__ inline Layout layout(int G, int D, int row_bytes, int chunk, int tile) {
  Layout s;
  const int groups = (D + 31) / 32;
  int units = (row_bytes + 15) / 16;        // 16-byte units, made odd
  s.stride = 16 * (units % 2 ? units : units + 1);
  s.stages = tile < chunk ? 2 : 1;
  int splits = kThreads / tile;
  splits = splits < 1 ? 1 : splits;
  splits = splits > groups ? groups : splits;
  s.splits = splits > kMaxSplits ? kMaxSplits : splits;
  s.parts = kThreads / 32 / groups;
  s.rows_at = s.stages * 2 * tile * s.stride;
  s.q_at = s.rows_at + ((chunk * 4 + 15) / 16) * 16;
  const int Gp = (G + kHeadsPerPass - 1) / kHeadsPerPass * kHeadsPerPass;
  s.p_at = s.q_at + Gp * 32 * groups * 4;
  s.red_at = s.p_at + s.splits * Gp * tile * 4;
  s.stat_at = s.red_at + (s.parts - 1) * kHeadsPerPass * 32 * groups * 4;
  s.bytes = s.stat_at + 3 * G * 4;
  return s;
}

// Cache row of position t of sequence b: dense (table == nullptr, page
// == S) or through the page table.
__device__ __forceinline__ int cache_row(const int* __restrict__ table, int b, int t, int page,
                                         int max_pages, int pool_pages) {
  if (table == nullptr) return b * page + t;
  const int p = t / page;
  int id = table[(long long)b * max_pages + p];
  id = id < 0 ? 0 : (id >= pool_pages ? pool_pages - 1 : id);
  return id * page + (t - p * page);
}

// Issues the copies of tile k's live rows into its stage: K rows as one
// commit group, then V rows as another. A thread copies one column of
// COPY bytes of every (blockDim / per_row)-th row; every thread commits
// both groups.
template <int COPY>
__device__ __forceinline__ void issue_rows(unsigned char* stage, const unsigned char* kc,
                                           const unsigned char* vc, const int* rows, int k,
                                           int tile, int n, int Hkv, int kvh, int row_bytes,
                                           int stride) {
  unsigned char* dst = stage + (size_t)(k & 1) * 2 * tile * stride;
  const int r0 = k * tile;
  const int nk = min(tile, n - r0);
  const int per_row = row_bytes / COPY;
  const int step = blockDim.x / per_row;
  const int first = threadIdx.x / per_row;
  const int o = (threadIdx.x - first * per_row) * COPY;
  const long long pitch = (long long)Hkv * row_bytes;
  for (int half = 0; half < 2; ++half) {
    const unsigned char* src = (half ? vc : kc) + (long long)kvh * row_bytes + o;
    unsigned char* d = dst + (size_t)half * tile * stride + o;
    if (first < step) {
#pragma unroll 4
      for (int r = first; r < nk; r += step)
        cp_async<COPY>(d + (size_t)r * stride, src + rows[r0 + r] * pitch);
    }
    cp_commit();
  }
}

__device__ __forceinline__ void issue_tile(unsigned char* stage, const unsigned char* kc,
                                           const unsigned char* vc, const int* rows, int k,
                                           int tile, int n, int Hkv, int kvh, int row_bytes,
                                           int stride, int copy) {
  if (copy == 16)
    issue_rows<16>(stage, kc, vc, rows, k, tile, n, Hkv, kvh, row_bytes, stride);
  else if (copy == 8)
    issue_rows<8>(stage, kc, vc, rows, k, tile, n, Hkv, kvh, row_bytes, stride);
  else
    issue_rows<4>(stage, kc, vc, rows, k, tile, n, Hkv, kvh, row_bytes, stride);
}

// Elements [32t, 32t + 32) of a staged row as f32: the codes of group t
// (B > 0; read as 16-byte words, each code decoded once) or plain
// bf16/f32 elements (B == 0). Elements at or past D are 0.
template <int B, typename KT>
__device__ __forceinline__ void load_group(const unsigned char* row, int t, int D,
                                           float (&x)[32]) {
  if constexpr (B == 0) {
    const KT* e = (const KT*)row + t * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) x[j] = t * 32 + j < D ? rt::to_f32(e[j]) : 0.f;
  } else {
    uint32_t w[B];
    const uint4* src = (const uint4*)row + t * (B / 4);
#pragma unroll
    for (int i = 0; i < B / 4; ++i) {
      const uint4 u = src[i];
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j)
      x[j] = t * 32 + j < D ? rt::decode_value<B>(rt::extract_code<B>(w, j)) : 0.f;
  }
}

// Element 32t + lane of a staged row (0 past D for plain rows).
template <int B, typename KT>
__device__ __forceinline__ float row_elem(const unsigned char* row, int t, int lane, int D) {
  if constexpr (B == 0) {
    const int d = t * 32 + lane;
    return d < D ? rt::to_f32(((const KT*)row)[d]) : 0.f;
  } else {
    return rt::decode_value<B>(rt::extract_code<B>((const uint32_t*)row + t * B, lane));
  }
}

// The dot product of 32 elements of a staged row with 32 of q's.
__device__ __forceinline__ float dot32(const float* qv, const float (&x)[32]) {
  const float4* q4 = (const float4*)qv;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 w = q4[j];
    a0 = fmaf(w.x, x[4 * j], a0);
    a1 = fmaf(w.y, x[4 * j + 1], a1);
    a2 = fmaf(w.z, x[4 * j + 2], a2);
    a3 = fmaf(w.w, x[4 * j + 3], a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// Partial scores of a tile's nk rows: item (row r, split sp) takes the
// row's groups sp, sp + splits, ... and writes p[sp][g][r] for every
// head, two heads at a time (p is (splits, Gp, tile)).
template <int B, typename KT>
__device__ __forceinline__ void score_tile(const unsigned char* ks, const float* q_s, float* p_s,
                                           int nk, int tile, int stride, int G, int Gp, int D,
                                           int splits) {
  const int groups = (D + 31) >> 5, Dp = groups * 32;
  for (int it = threadIdx.x; it < nk * splits; it += blockDim.x) {
    const int sp = it / nk, r = it - sp * nk;
    const unsigned char* row = ks + (size_t)r * stride;
    float* dst = p_s + (size_t)sp * Gp * tile + r;
    for (int t = sp; t < groups; t += splits) {
      float x[32];
      load_group<B, KT>(row, t, D, x);
      for (int g = 0; g < G; g += 2) {           // Gp is even
        const float s0 = dot32(q_s + g * Dp + t * 32, x);
        const float s1 = dot32(q_s + (g + 1) * Dp + t * 32, x);
        dst[g * tile] = t == sp ? s0 : dst[g * tile] + s0;
        dst[(g + 1) * tile] = t == sp ? s1 : dst[(g + 1) * tile] + s1;
      }
    }
  }
}

// Sums the splits in order into p[0][g][:nk], scales, and turns them into
// exp(s - m) against the running max m; updates the running max and sum
// and leaves the factor that rescales what earlier tiles accumulated.
__device__ __forceinline__ void softmax_tile(float* p_s, float* m_s, float* l_s, float* a_s,
                                             int nk, int tile, int G, int Gp, int splits,
                                             bool first, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int g = warp; g < G; g += nwarps) {
    float* p = p_s + (size_t)g * tile;
    float mt = -INFINITY;
    for (int i = lane; i < nk; i += 32) {
      float s = p[i];
#pragma unroll
      for (int sp = 1; sp < kMaxSplits; ++sp)
        if (sp < splits) s += p[(size_t)sp * Gp * tile + i];
      s *= scale;
      p[i] = s;
      mt = fmaxf(mt, s);
    }
    mt = warp_max(mt);
    const float m_old = first ? -INFINITY : m_s[g];
    const float m = fmaxf(m_old, mt);
    float l = 0.f;
    for (int i = lane; i < nk; i += 32) {
      const float e = expf(p[i] - m);
      p[i] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      const float alpha = first ? 0.f : expf(m_old - m);
      m_s[g] = m;
      l_s[g] = first ? l : fmaf(l_s[g], alpha, l);
      a_s[g] = alpha;
    }
  }
}

// a[j] = sum over rows [i0, i1) of p[g0 + j][i] * v[i][32t + lane], for
// the kHeadsPerPass heads from g0 (rows of p exist up to Gp); p is read
// four rows at a time (i0 is a multiple of 4).
template <int B, typename KT>
__device__ __forceinline__ void pv_rows(const unsigned char* vs, const float* p_s,
                                        float (&a)[kHeadsPerPass], int g0, int i0, int i1,
                                        int t, int lane, int tile, int stride, int D) {
#pragma unroll
  for (int j = 0; j < kHeadsPerPass; ++j) a[j] = 0.f;
  const float* p = p_s + g0 * tile;
  int i = i0;
  for (; i + 4 <= i1; i += 4) {
    float v[4];
    float4 pj[kHeadsPerPass];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = row_elem<B, KT>(vs + (size_t)(i + u) * stride, t, lane, D);
#pragma unroll
    for (int j = 0; j < kHeadsPerPass; ++j) pj[j] = *(const float4*)(p + j * tile + i);
#pragma unroll
    for (int j = 0; j < kHeadsPerPass; ++j) {
      a[j] = fmaf(pj[j].x, v[0], a[j]);
      a[j] = fmaf(pj[j].y, v[1], a[j]);
      a[j] = fmaf(pj[j].z, v[2], a[j]);
      a[j] = fmaf(pj[j].w, v[3], a[j]);
    }
  }
  for (; i < i1; ++i) {
    const float v = row_elem<B, KT>(vs + (size_t)i * stride, t, lane, D);
#pragma unroll
    for (int j = 0; j < kHeadsPerPass; ++j) a[j] = fmaf(p[j * tile + i], v, a[j]);
  }
}

template <int B, typename KT, typename QT>
__global__ void __launch_bounds__(kThreads)
    kvd_partial(const QT* __restrict__ q, const KT* __restrict__ kc, const KT* __restrict__ vc,
                const int* __restrict__ table, const int* __restrict__ kv_len,
                float* __restrict__ m_ws, float* __restrict__ l_ws, float* __restrict__ acc_ws,
                int H, int Hkv, int page, int max_pages, int pool_pages, int D, int row_bytes,
                int chunk, int n_chunks, int tile, int copy, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int G = H / Hkv;
  const Layout lay = layout(G, D, row_bytes, chunk, tile);
  int* rows = (int*)(smem + lay.rows_at);
  float* q_s = (float*)(smem + lay.q_at);
  float* p_s = (float*)(smem + lay.p_at);
  float* m_s = (float*)(smem + lay.stat_at);
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / Hkv, kvh = bh % Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (D + 31) >> 5, Dp = 32 * groups;
  const int Gp = (G + kHeadsPerPass - 1) / kHeadsPerPass * kHeadsPerPass;
  const int S = page * max_pages;
  int L = kv_len[b];
  // q (f32, zero past D) while kv_len is in flight: n == 0 blocks waste it
  if (threadIdx.x < Dp) {
    const QT* qg = q + ((long long)b * H + (long long)kvh * G) * D + threadIdx.x;
    const bool in = threadIdx.x < D;
#pragma unroll 4
    for (int g = 0; g < G; ++g) q_s[g * Dp + threadIdx.x] = in ? rt::to_f32(qg[g * D]) : 0.f;
  }
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
  // each live row's cache row, looked up once
#pragma unroll 2
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    rows[i] = cache_row(table, b, s0 + i, page, max_pages, pool_pages);
  __syncthreads();

  const unsigned char* kb = (const unsigned char*)kc;
  const unsigned char* vb = (const unsigned char*)vc;
  const int n_tiles = (n + tile - 1) / tile;
  issue_tile(smem, kb, vb, rows, 0, tile, n, Hkv, kvh, row_bytes, lay.stride, copy);
  if (n_tiles > 1)
    issue_tile(smem, kb, vb, rows, 1, tile, n, Hkv, kvh, row_bytes, lay.stride, copy);

  // p @ V: warp w owns dims [32t, 32t + 32), t = w % groups, and row
  // part w / groups of each tile. Parts 1.. hand their sums to part 0
  // through red; part 0 adds them in part order and keeps the running
  // accumulator: in registers for the first kHeadsPerPass heads, in
  // acc_ws (read back by the thread that wrote it) for any further ones.
  float* red = (float*)(smem + lay.red_at);
  float* acc = acc_ws + part * G * D;
  const int t = warp % groups, rpart = warp / groups;
  const int d = t * 32 + lane;
  float acc0[kHeadsPerPass];
  for (int k = 0; k < n_tiles; ++k) {
    const bool next = k + 1 < n_tiles;       // tile k + 1's groups follow
    const int nk = min(tile, n - k * tile);
    const unsigned char* ks = smem + (size_t)(k & 1) * 2 * tile * lay.stride;
    const unsigned char* vs = ks + (size_t)tile * lay.stride;
    if (next) cp_wait<3>(); else cp_wait<1>();     // K rows of tile k
    __syncthreads();
    score_tile<B, KT>(ks, q_s, p_s, nk, tile, lay.stride, G, Gp, D, lay.splits);
    __syncthreads();
    softmax_tile(p_s, m_s, l_s, a_s, nk, tile, G, Gp, lay.splits, k == 0, scale);
    if (next) cp_wait<2>(); else cp_wait<0>();     // V rows of tile k
    __syncthreads();
    const int per = ((nk + lay.parts - 1) / lay.parts + 3) & ~3;  // rows a part
    const int i0 = min(rpart * per, nk), i1 = min(i0 + per, nk);
    for (int g0 = 0; g0 < G; g0 += kHeadsPerPass) {
      float a[kHeadsPerPass];
      if (rpart < lay.parts)
        pv_rows<B, KT>(vs, p_s, a, g0, i0, i1, t, lane, tile, lay.stride, D);
      if (lay.parts > 1) {
        if (rpart > 0 && rpart < lay.parts) {
#pragma unroll
          for (int j = 0; j < kHeadsPerPass; ++j)
            red[((rpart - 1) * kHeadsPerPass + j) * Dp + d] = a[j];
        }
        __syncthreads();
        if (rpart == 0) {
          for (int r = 1; r < lay.parts; ++r) {
#pragma unroll
            for (int j = 0; j < kHeadsPerPass; ++j)
              a[j] += red[((r - 1) * kHeadsPerPass + j) * Dp + d];
          }
        }
      }
      if (rpart == 0) {
#pragma unroll
        for (int j = 0; j < kHeadsPerPass; ++j) {
          const int g = g0 + j;
          if (g >= G) continue;
          if (g0 == 0) {
            acc0[j] = k == 0 ? a[j] : fmaf(acc0[j], a_s[g], a[j]);
          } else if (d < D) {
            acc[g * D + d] = k == 0 ? a[j] : fmaf(acc[g * D + d], a_s[g], a[j]);
          }
        }
      }
      if (lay.parts > 1) __syncthreads();          // red is free again
    }
    if (k + 2 < n_tiles) {
      __syncthreads();                              // stage k & 1 is free
      issue_tile(smem, kb, vb, rows, k + 2, tile, n, Hkv, kvh, row_bytes, lay.stride, copy);
    }
  }
  if (rpart == 0 && d < D) {
#pragma unroll
    for (int j = 0; j < kHeadsPerPass; ++j)
      if (j < G) acc[j * D + d] = acc0[j];
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_ws[part * G + g] = m_s[g];
    l_ws[part * G + g] = l_s[g];
  }
}

// Merges the per-chunk (m, l, acc) in chunk order: one block per query
// head, one thread per output dim.
template <typename QT>
__global__ void kvd_merge(const float* __restrict__ m_ws, const float* __restrict__ l_ws,
                          const float* __restrict__ acc_ws, QT* __restrict__ out, int H, int Hkv,
                          int D, int n_chunks) {
  // launched while kvd_partial runs (programmatic dependent launch): wait
  // for all of its blocks to finish and their writes to land
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int G = H / Hkv;
  const int bq = blockIdx.x;
  const int b = bq / H, h = bq % H;
  const int kvh = h / G, g = h % G;
  const long long base = (long long)b * Hkv + kvh;
  const int d = threadIdx.x;
  if (d >= D) return;
  float mx = -INFINITY;
#pragma unroll 4
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, m_ws[(base * n_chunks + c) * G + g]);
  float res = 0.f;
  if (mx != -INFINITY) {
    float l = 0.f, a = 0.f;
    // loads ahead of the test, so that several chunks' are in flight; an
    // empty chunk (m = -inf) never wrote its acc and adds nothing
#pragma unroll 4
    for (int c = 0; c < n_chunks; ++c) {
      const long long part = base * n_chunks + c;
      const float mc = m_ws[part * G + g];
      const float lc = l_ws[part * G + g];
      const float ac = acc_ws[(part * G + g) * D + d];
      if (mc != -INFINITY) {
        const float sc = expf(mc - mx);
        l = fmaf(lc, sc, l);
        a = fmaf(ac, sc, a);
      }
    }
    res = a / fmaxf(l, 1e-30f);
  }
  out[(long long)bq * D + d] = rt::from_f32<QT>(res);
}

template <int B, typename KT, typename QT>
int launch(const void* q, const void* k, const void* v, const void* table, const void* kv_len,
           void* out, void* m_ws, void* l_ws, void* acc_ws, int batch, int H, int Hkv, int page,
           int max_pages, int pool_pages, int D, int words, int chunk, int n_chunks, int tile,
           cudaStream_t s) {
  const int G = H / Hkv;
  const int row_bytes = words * (int)sizeof(KT);
  const Layout lay = layout(G, D, row_bytes, chunk, tile);
  // the widest copy that every row address allows
  const uintptr_t align = (uintptr_t)k | (uintptr_t)v | (uintptr_t)row_bytes;
  const int copy = align % 16 == 0 ? 16 : (align % 8 == 0 ? 8 : 4);
  if (align % 4) return (int)cudaErrorInvalidValue;
  if (lay.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kvd_partial<B, KT, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(batch * Hkv, n_chunks);
  kvd_partial<B, KT, QT><<<grid, kThreads, lay.bytes, s>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, (const int*)table, (const int*)kv_len,
      (float*)m_ws, (float*)l_ws, (float*)acc_ws, H, Hkv, page, max_pages, pool_pages, D,
      row_bytes, chunk, n_chunks, tile, copy, 1.0f / sqrtf((float)D));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the merge may start once every kvd_partial block has started; it
  // waits for their results itself (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * H);
  cfg.blockDim = dim3(32 * ((D + 31) / 32));
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kvd_merge<QT>, (const float*)m_ws, (const float*)l_ws,
                                 (const float*)acc_ws, (QT*)out, H, Hkv, D, n_chunks);
}

// kv_kind: 0 packed words at ``bits``, 1 f32 rows, 2 bf16 rows.
template <typename QT>
int launch_kind(int kv_kind, int bits, const void* q, const void* k, const void* v,
                const void* table, const void* kv_len, void* out, void* m_ws, void* l_ws,
                void* acc_ws, int batch, int H, int Hkv, int page, int max_pages,
                int pool_pages, int D, int words, int chunk, int n_chunks, int tile,
                cudaStream_t s) {
#define RT_KVD_ARGS                                                                        \
  q, k, v, table, kv_len, out, m_ws, l_ws, acc_ws, batch, H, Hkv, page, max_pages, pool_pages, \
      D, words, chunk, n_chunks, tile, s
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
           int D, int words, int bits, int chunk, int n_chunks, int tile, void* stream) {
  if (batch == 0 || H == 0) return 0;
  if (D < 1 || D > 32 * kMaxGroups || Hkv == 0 || H % Hkv || page < 1 || max_pages < 0 ||
      chunk < 1 || tile < 1 || tile > chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = q_bf16 ? launch_kind<__nv_bfloat16>(kv_kind, bits, q, k, v, table, kv_len, out,
                                                     m_ws, l_ws, acc_ws, batch, H, Hkv, page,
                                                     max_pages, pool_pages, D, words, chunk,
                                                     n_chunks, tile, s)
                        : launch_kind<float>(kv_kind, bits, q, k, v, table, kv_len, out, m_ws,
                                             l_ws, acc_ws, batch, H, Hkv, page, max_pages,
                                             pool_pages, D, words, chunk, n_chunks, tile, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, that a block of the shared body takes
// for G query heads per kv head, head_dim D, cache rows of row_bytes
// bytes, and the (chunk, tile) plan.
extern "C" int rt_attend_smem(int G, int D, int row_bytes, int chunk, int tile) {
  return layout(G, D, row_bytes, chunk, tile).bytes;
}

// q (B, H, D) f32 or bf16; k, v (B, S, Hkv, words) int32 words; kv_len
// (B,) int32; out (B, H, D) in q's dtype; m_ws, l_ws (B*Hkv, n_chunks, G)
// and acc_ws (B*Hkv, n_chunks, G, D) f32 scratch; chunk rows per block,
// staged tile rows at a time.
extern "C" int rt_kv_decode(const void* q, int q_bf16, const void* k, const void* v,
                            const void* kv_len, void* out, void* m_ws, void* l_ws, void* acc_ws,
                            int batch, int H, int Hkv, int S, int D, int words, int bits,
                            int chunk, int n_chunks, int tile, void* stream) {
  // the dense cache is one page of S rows per sequence (none when S = 0)
  return attend(q, q_bf16, k, v, 0, nullptr, kv_len, out, m_ws, l_ws, acc_ws, batch, H, Hkv,
                S > 0 ? S : 1, S > 0 ? 1 : 0, batch, D, words, bits, chunk, n_chunks, tile,
                stream);
}

// The paged twin: k, v pools (pool_pages, page, Hkv, words) of int32
// words (kv_kind 0) or of f32/bf16 rows, words = D (kv_kind 1/2); table
// (B, max_pages) int32 page ids. Scratch and plan as for rt_kv_decode.
extern "C" int rt_paged_attention(const void* q, int q_bf16, const void* k, const void* v,
                                  int kv_kind, const void* table, const void* kv_len, void* out,
                                  void* m_ws, void* l_ws, void* acc_ws, int batch, int H, int Hkv,
                                  int page, int max_pages, int pool_pages, int D, int words,
                                  int bits, int chunk, int n_chunks, int tile, void* stream) {
  return attend(q, q_bf16, k, v, kv_kind, table, kv_len, out, m_ws, l_ws, acc_ws, batch, H, Hkv,
                page, max_pages, pool_pages, D, words, bits, chunk, n_chunks, tile, stream);
}
