// packed_matmul: x @ decode(W), or x @ decode(W)^T, with W packed; and
// packed_matmul_batched: the same per expert, x[e] @ decode(W[e]).
//
// Replaces the Pallas TPU kernels repro/kernels/packed_matmul.py:
// packed_matmul (_pmm_kernel, _pmm_t_kernel) and packed_matmul_batched
// (_bmm_kernel, _bmm_t_kernel). Both entry points launch the same
// kernels: the expert index shares blockIdx.z with the K split, and the
// 2-D product is the batched one with a single expert.
//
// Bound on this card: bytes. On the serving path M is the slot count (8),
// so each packed code is used by 8 rows only: at AF16 the card streams
// about 7 codes a clock into each SM, each wanting 8 multiply-adds. On
// the CUDA cores that is a decode, x loads and 8 FMAs per code, ~18
// instructions, more than an SM issues in a clock (128), so a body of
// FMAs stays well short of the byte bound; and the narrower the code, the
// more codes a byte holds and the further it falls short.
//
// Normal orientation (W (K, N) packed along N; every serving call):
// - The multiply-adds run on the tensor cores. A block owns BN = 64
//   output columns, BM = 8 rows of x and one slice of K. The operands are
//   swapped so that the 8 rows of x are the mma's n: mma.m16n8k8 in TF32
//   with A = decoded W (16 columns x 8 k), B = x^T (8 k x 8 rows) and f32
//   accumulators. A warp covers the 64 columns with 4 mmas per 8 rows of
//   K. Lane group g owns columns [8g, 8g + 8), whose codes are B / 4
//   consecutive words of a row, so one shared load gives a lane its A
//   elements (the mma's rows are ordered so, and the store undoes the
//   order); the mma's k order is permuted so that one 32-bit shared load
//   of x gives a lane both of its B elements. A decoded weight goes from
//   shared memory into A registers and never reaches memory.
// - It is exact where it runs: bf16 x and AF8, AF12 and AF16 values are
//   exact in TF32, so every product is exact in f32 and only the order of
//   the f32 sums differs from the plain version. AF16 decodes with one
//   hardware conversion per code. AF8 and AF12 set their fields in an f16
//   (its conversion to f32 normalises their subnormals) and leave out the
//   power of two between the two biases, which the store puts back; a
//   code with the all-ones exponent (inf, NaN) is detected per word and
//   decoded exactly.
// - f32 x, and AF20 to AF32, which TF32 does not hold, take f32 FMAs on
//   the CUDA cores from the same ring: a lane owns two columns.
// - A deep ring of cp.async copies. Each warp takes its own RS-row chunks
//   of the block's slice and keeps its own ring of STAGES stages (the W
//   words and the x elements of a chunk), so a warp waits only on its own
//   copies and the loop has no block barrier: 8 warps x 3 stages in
//   flight, 48 KB of weights per block at AF16. Rows are padded so that
//   the A and B loads hit 32 distinct banks.
// - One launch, no workspace. The blocks of a K split form one
//   thread-block cluster (at most 8, the portable size); each block adds
//   its warps' sums in warp order, then rank 0 adds the ranks' sums
//   through distributed shared memory in rank (= split) order and stores.
//   No atomics: a call's bits do not change between runs.
// Grid: N / BN column tiles x M / BM row tiles x E * splits (split_plan
// in kernels/packed_matmul.py cuts K until the grid has a block for
// every SM, at most 8 ways). Ragged M, N and K are masked in the kernel.
//
// Transposed orientation (W (N, K) packed along K: the tied heads of
// paligemma-3b and recurrentgemma-9b on every decode call, and the expert
// banks' dx orientation). The same byte bound, and the same answer to it,
// turned to codes that run along K:
// - Tensor cores with W as the mma's A operand: 16 weight rows (output
//   columns) x 8 k against B = x^T (8 k x 8 rows of x). Inside each group
//   of 32 codes the k order is permuted so that lane (g, t) decodes codes
//   [8t, 8t + 8) of rows g and g + 8 (one decode8 unit each, one 16-byte
//   shared load at AF16) and uses them over the group's 4 k-steps: at
//   step q the mma's k column t is code 8t + 2q, column t + 4 code
//   8t + 2q + 1. Its B elements are x[g][8t .. 8t + 8), one 16-byte
//   shared load of bf16 x per group. decode8 and the store's kScale as in
//   the normal orientation, so bf16 x at AF8-AF16 is exact in TF32.
// - f32 x, and AF20 to AF32, take f32 FMAs on the CUDA cores from the
//   same staged data: a lane sums its codes' k for its two rows and all
//   BM rows of x, then the 4 lanes of a row meet by shuffles.
// - A ring of cp.async copies per warp: a warp streams its own 16 weight
//   rows along K, G groups of 32 codes a stage (2 KB at AF8 and AF16),
//   STAGES_T stages deep, no block barrier in the loop; 8 warps x 3
//   stages in flight, 48 KB of weights per block at AF16, 2 blocks an SM.
//   A stage is stored group-major (a group's 16 rows B words apart), so
//   the A loads hit 32 distinct banks.
// - x's K slice (BM rows) is copied into shared memory once per block
//   before the weight loop and read by every warp; its rows are padded to
//   64 bytes past a multiple of 128 so the B loads are conflict free. The
//   slice holds at most X_SLICE_BYTES; grid_plan splits K (one cluster,
//   the normal orientation's epilogue) so that it fits, and a block whose
//   slice is longer still (K past 8 slices) walks it in passes.
// Grid: N / BN_T tiles of W's rows, M / BM tiles of x's rows, E * splits.
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "codec.cuh"

namespace cg = cooperative_groups;

namespace {

using rt::decode8;
using rt::halves;
using rt::kScale;

constexpr int BN = 64;          // normal orientation: output columns per block
constexpr int BM = 8;           // rows of x per block: the mma's n
constexpr int WARPS = 8;        // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int RS = 16;          // rows a warp takes per ring stage: two mma k-steps
constexpr int STAGES = 4;       // ring depth per warp
constexpr int MAX_SPLITS = 8;   // K slices of one tile: the blocks of a cluster
constexpr int RW_T = 16;        // transposed orientation: weight rows a warp streams (an mma tile)
constexpr int BN_T = WARPS * RW_T;  // and a block: its output columns
constexpr int STAGES_T = 4;     // its ring depth per warp
constexpr int X_SLICE_BYTES = 32 * 1024;  // its x slice's budget: BM rows of k_chunk elements

// The tensor-core path: bf16 x and a width whose values TF32 holds.
template <int B, typename XT>
constexpr bool kMma = std::is_same<XT, __nv_bfloat16>::value && B <= 16;

// A warp's ring, in 32-bit words: STAGES stages of RS tile rows (two
// groups of 32 codes, WPR words, padded to S) and BM rows of RS elements
// of x (padded to XS). S = WPR + 4 puts rows 2 apart 8 banks apart, and
// XS = XW + 4 puts x rows 12 banks apart, so the mma loads are conflict
// free. After the loop a warp's ring holds its sums, (BM, BN) f32.
template <int B, typename XT>
struct Ring {
  static constexpr int WPR = 2 * B;
  static constexpr int S = WPR + 4;
  static constexpr int XW = RS * (int)sizeof(XT) / 4;
  static constexpr int XS = XW + 4;
  static constexpr int STAGE = RS * S + BM * XS;
  static constexpr int WARP = STAGES * STAGE;
  static constexpr int BYTES = 4 * WARPS * WARP;
  static_assert(WARP >= BM * BN, "a warp's sums overlay its ring");
};

// Copies 16 bytes from global to shared memory asynchronously, or writes
// 16 zero bytes and reads nothing when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of one stage: rows [k0, k0 + RS) of the tile's words
// (zeros past the slice or the row) and the matching elements of x's BM
// rows (zeros past M or the slice). x rows that are not 16-byte aligned
// are copied element by element, synchronously.
template <int B, typename XT>
__device__ __forceinline__ void load_stage(uint32_t* st, const uint32_t* w, const XT* x, int k0,
                                           int ke, int K, int M, int m0, int wwords, int wofs,
                                           int x_vec, int lane) {
  using R = Ring<B, XT>;
  constexpr int VPR = R::WPR / 4;            // 16-byte vectors of a tile row
  static_assert(RS * VPR % 32 == 0, "whole vectors per lane");
#pragma unroll
  for (int i = 0; i < RS * VPR / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c / VPR, v = c % VPR;
    const int k = k0 + r, word = wofs + 4 * v;
    const bool ok = k < ke && word < wwords;
    cp_async16(st + r * R::S + 4 * v, ok ? w + (long long)k * wwords + word : w, ok);
  }
  uint32_t* xs = st + RS * R::S;
  if (x_vec) {
    constexpr int XV = R::XW / 4;            // 16-byte vectors of an x row
    constexpr int EV = 16 / (int)sizeof(XT);  // elements per vector
    if (lane < BM * XV) {
      const int mm = lane / XV, v = lane % XV;
      const int m = m0 + mm, k = k0 + v * EV;
      const bool ok = m < M && k < ke;
      cp_async16(xs + mm * R::XS + 4 * v, ok ? x + (long long)m * K + k : x, ok);
    }
  } else {
    constexpr int XE = R::XS * 4 / (int)sizeof(XT);
    XT* xe = reinterpret_cast<XT*>(xs);
    for (int c = lane; c < BM * RS; c += 32) {
      const int mm = c / RS, kk = c % RS;
      const int m = m0 + mm, k = k0 + kk;
      xe[mm * XE + kk] = (m < M && k < ke) ? x[(long long)m * K + k] : rt::from_f32<XT>(0.f);
    }
  }
}

__device__ __forceinline__ void mma_tf32(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// U words from shared memory, in 16- or 8-byte loads where U allows
// (p is then aligned so).
template <int U>
__device__ __forceinline__ void load_unit(const uint32_t* p, uint32_t (&u)[U]) {
  if constexpr (U % 4 == 0) {
#pragma unroll
    for (int i = 0; i < U; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      u[i] = v.x, u[i + 1] = v.y, u[i + 2] = v.z, u[i + 3] = v.w;
    }
  } else if constexpr (U % 2 == 0) {
#pragma unroll
    for (int i = 0; i < U; i += 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + i);
      u[i] = v.x, u[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < U; ++i) u[i] = p[i];
  }
}

// decode8's values for any code, inf and NaN included (decode_float).
template <int B>
__device__ __forceinline__ void decode8_exact(const uint32_t (&u)[B / 4], float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = i * B, w0 = s >> 5, off = s & 31;
    uint32_t code = u[w0] >> off;
    if (off + B > 32) code |= u[w0 + 1] << (32 - off);
    f[i] = rt::decode_value<B>(code & rt::width_mask<B>()) * (1.f / kScale<B>);
  }
}

// One stage on the tensor cores. Lane (g, t) = (lane / 4, lane % 4); for
// k-step q the mma's k column t is row 8q + 2t of the stage and column
// t + 4 is row 8q + 2t + 1. Tile j's mma row g is column 8g + 2j of the
// block, row g + 8 column 8g + 2j + 1; acc[4j..4j+3] are the mma's c0..c3.
template <int B>
__device__ __forceinline__ void mma_stage(const uint32_t* st, float (&acc)[16], int lane) {
  using R = Ring<B, __nv_bfloat16>;
  constexpr int U = B / 4;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* xs = st + RS * R::S;
#pragma unroll
  for (int q = 0; q < RS / 8; ++q) {
    const int r = 8 * q + 2 * t;
    uint32_t u0[U], u1[U];
    load_unit<U>(st + r * R::S + U * g, u0);
    load_unit<U>(st + (r + 1) * R::S + U * g, u1);
    float f0[8], f1[8];
    const bool bad0 = decode8<B>(u0, f0);
    const bool bad1 = decode8<B>(u1, f1);
    if constexpr (B != 16) {
      if (__any_sync(0xFFFFFFFFu, bad0 || bad1)) {
        float e0[8], e1[8];
        decode8_exact<B>(u0, e0);
        decode8_exact<B>(u1, e1);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          f0[i] = bad0 ? e0[i] : f0[i];
          f1[i] = bad1 ? e1[i] : f1[i];
        }
      }
    }
    const uint32_t xp = xs[g * R::XS + 4 * q + t];   // x[g][r] and x[g][r + 1], bf16
    const uint32_t b0 = xp << 16, b1 = xp & 0xFFFF0000u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mma_tf32(acc + 4 * j, __float_as_uint(f0[2 * j]), __float_as_uint(f0[2 * j + 1]),
               __float_as_uint(f1[2 * j]), __float_as_uint(f1[2 * j + 1]), b0, b1);
  }
}

// One stage on the CUDA cores: lane owns columns lane and lane + 32 of the
// block; acc[2m + c] is row m's sum for column lane + 32c.
template <int B, typename XT>
__device__ __forceinline__ void fma_stage(const uint32_t* st, float (&acc)[16], int lane) {
  using R = Ring<B, XT>;
  constexpr int XE = R::XS * 4 / (int)sizeof(XT);
  const XT* xs = reinterpret_cast<const XT*>(st + RS * R::S);
#pragma unroll 4
  for (int r = 0; r < RS; ++r) {
    const uint32_t* row = st + r * R::S;
    const float w0 = rt::decode_value<B>(rt::extract_code<B>(row, lane));
    const float w1 = rt::decode_value<B>(rt::extract_code<B>(row + B, lane));
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const float xv = rt::to_f32(xs[m * XE + r]);
      acc[2 * m] = fmaf(xv, w0, acc[2 * m]);
      acc[2 * m + 1] = fmaf(xv, w1, acc[2 * m + 1]);
    }
  }
}

// Stores a block's sums (BM, COLS), times scale, in x's dtype: at once
// without a K split; with one, the cluster's blocks (rank = split) meet
// and rank 0 adds every rank's sums in rank order through distributed
// shared memory. Every thread calls it once the sums are written and the
// block has synchronised.
template <typename XT, int COLS, int NT>
__device__ __forceinline__ void finish(float* sums, XT* out, int M, int N, int m0, int n0,
                                       int splits, float scale) {
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) cluster.sync();    // every rank's sums are written
  if (splits == 1 || cluster.block_rank() == 0) {
    for (int o = threadIdx.x; o < BM * COLS; o += NT) {
      const int m = m0 + o / COLS, n = n0 + o % COLS;
      if (m >= M || n >= N) continue;
      float s = sums[o];
      for (int r = 1; r < splits; ++r) s += cluster.map_shared_rank(sums, r)[o];
      out[(long long)m * N + n] = rt::from_f32<XT>(s * scale);
    }
  }
  if (splits > 1) cluster.sync();    // rank 0 has read them
}

// Normal orientation: W (E, K, wwords) int32 words, packed along N;
// x (E, M, K), out (E, M, N). W is 16-byte aligned and wwords a multiple
// of 4, so every row of every expert is.
template <int B, typename XT>
__global__ void __launch_bounds__(THREADS, 2)
pmm_kernel(const XT* __restrict__ xb, const uint32_t* __restrict__ wb, XT* __restrict__ outb,
           int M, int N, int K, int wwords, int k_chunk, int splits, int x_vec) {
  using R = Ring<B, XT>;
  constexpr bool MMA = kMma<B, XT>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* ring = smem + warp * R::WARP;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int split = blockIdx.z % splits;
  const long long e = blockIdx.z / splits;
  const XT* x = xb + e * M * K;
  const uint32_t* w = wb + e * K * wwords;
  XT* out = outb + e * M * N;
  const int kb = split * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int wofs = blockIdx.x * R::WPR;       // the tile's first word in a row
  // warp w takes the slice's RS-row chunks w, w + WARPS, w + 2 WARPS, ...
  const int chunks = ke > kb ? (ke - kb + RS - 1) / RS : 0;
  const int steps = chunks > warp ? (chunks - warp + WARPS - 1) / WARPS : 0;

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  // stage i of this warp: rows [k0, k0 + RS) into slot i % STAGES
  auto issue = [&](int i) {
    load_stage<B, XT>(ring + (i % STAGES) * R::STAGE, w, x, kb + (warp + i * WARPS) * RS, ke,
                      K, M, m0, wwords, wofs, x_vec, lane);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_wait<STAGES - 2>();             // stage i has landed
    __syncwarp();                      // and every lane is done with stage i - 1
    if (i + STAGES - 1 < steps) issue(i + STAGES - 1);
    cp_commit();
    const uint32_t* st = ring + (i % STAGES) * R::STAGE;
    if constexpr (MMA) mma_stage<B>(st, acc, lane);
    else fma_stage<B, XT>(st, acc, lane);
  }
  cp_wait<0>();
  __syncwarp();

  // this warp's sums (BM, BN) over its ring; then the block's, in warp
  // order, over warp 0's
  float* red = reinterpret_cast<float*>(ring);
  if constexpr (MMA) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * g + 2 * j;
      *reinterpret_cast<float2*>(red + 2 * t * BN + col) = make_float2(acc[4 * j], acc[4 * j + 2]);
      *reinterpret_cast<float2*>(red + (2 * t + 1) * BN + col) =
          make_float2(acc[4 * j + 1], acc[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      red[m * BN + lane] = acc[2 * m];
      red[m * BN + lane + 32] = acc[2 * m + 1];
    }
  }
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem);
  for (int o = threadIdx.x; o < BM * BN; o += THREADS) {
    float s = sums[o];
#pragma unroll
    for (int v = 1; v < WARPS; ++v) s += sums[v * R::WARP + o];
    sums[o] = s;
  }
  __syncthreads();
  finish<XT, BN, THREADS>(sums, out, M, N, m0, n0, splits, MMA ? kScale<B> : 1.f);
}

// The transposed orientation's ring: per warp STAGES_T stages of G groups
// of 32 codes of its RW_T weight rows, group-major (group j's rows B words
// apart), then the block's x slice. G makes a stage 2 KB at AF8 and AF16.
template <int B>
struct TRing {
  static constexpr int G = B <= 8 ? 4 : (B <= 16 ? 2 : 1);
  static constexpr int GROUP = RW_T * B;       // words of one group's rows
  static constexpr int STAGE = G * GROUP;
  static constexpr int WARP = STAGES_T * STAGE;
  static constexpr int BYTES = 4 * WARPS * WARP;
  static constexpr int VPG = B / 4;            // 16-byte vectors of a row's group
  static constexpr int VECS = RW_T * G * VPG;  // of a stage
  static_assert(BYTES >= 4 * BM * BN_T, "the block's sums overlay the rings");
};

// Columns of x the slice buffer holds, and its row stride in elements:
// 64 bytes past a multiple of 128, so that rows g and g + 1 of a B load
// fall on distinct banks.
template <typename XT>
constexpr int kXCap = X_SLICE_BYTES / (BM * (int)sizeof(XT));

template <typename XT>
__host__ __device__ constexpr int x_stride(int cols) {
  return (cols * (int)sizeof(XT) / 128 * 128 + 64) / (int)sizeof(XT);
}

template <int B, typename XT>
int t_smem_bytes(int k_chunk) {
  const int cols = k_chunk < kXCap<XT> ? k_chunk : kXCap<XT>;
  return TRing<B>::BYTES + BM * x_stride<XT>(cols) * (int)sizeof(XT);
}

// Issues one stage of a warp's ring: groups [g0, g0 + G) of weight rows
// [n0, n0 + RW_T), zeros for rows past N and groups past gend.
template <int B>
__device__ __forceinline__ void load_t_stage(uint32_t* st, const uint32_t* w, int n0, int N,
                                             int g0, int gend, int wwords, int lane) {
  using R = TRing<B>;
#pragma unroll
  for (int i = 0; i < (R::VECS + 31) / 32; ++i) {
    const int c = lane + 32 * i;
    if (R::VECS % 32 != 0 && c >= R::VECS) break;
    const int r = c / (R::G * R::VPG), j = c / R::VPG % R::G, v = c % R::VPG;
    const int n = n0 + r, grp = g0 + j;
    const bool ok = n < N && grp < gend;
    cp_async16(st + j * R::GROUP + r * B + 4 * v,
               ok ? w + (long long)n * wwords + grp * B + 4 * v : w, ok);
  }
}

// Copies x's rows [m0, m0 + BM), columns [p0, p0 + cols) into xs (row
// stride xse), zeros past M and pe; the whole block takes part. Rows that
// are not 16-byte aligned are copied element by element, synchronously.
template <typename XT>
__device__ __forceinline__ void load_x_slice(XT* xs, int xse, const XT* x, int M, int K, int m0,
                                             int p0, int pe, int cols, int x_vec) {
  if (x_vec) {
    constexpr int EV = 16 / (int)sizeof(XT);
    const int vpr = cols / EV;
    for (int c = threadIdx.x; c < BM * vpr; c += THREADS) {
      const int mm = c / vpr, kk = c % vpr * EV;
      const bool ok = m0 + mm < M && p0 + kk < pe;
      cp_async16(xs + mm * xse + kk, ok ? x + (long long)(m0 + mm) * K + p0 + kk : x, ok);
    }
  } else {
    for (int c = threadIdx.x; c < BM * cols; c += THREADS) {
      const int mm = c / cols, kk = c % cols;
      xs[mm * xse + kk] = (m0 + mm < M && p0 + kk < pe) ? x[(long long)(m0 + mm) * K + p0 + kk]
                                                         : rt::from_f32<XT>(0.f);
    }
  }
}

// 8 elements of x from shared memory (16-byte aligned) as floats.
__device__ __forceinline__ void load_x8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void load_x8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// decode8's floats (over kScale<B>) for every code of every width, inf
// and NaN included.
template <int B>
__device__ __forceinline__ void decode8_any(const uint32_t (&u)[B / 4], float (&f)[8]) {
  if constexpr (B > 16) {
    decode8_exact<B>(u, f);
  } else {
    const bool bad = decode8<B>(u, f);
    if constexpr (B != 16) {
      if (__any_sync(0xFFFFFFFFu, bad)) {
        float e[8];
        decode8_exact<B>(u, e);
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = bad ? e[i] : f[i];
      }
    }
  }
}

// Transposed orientation: W (E, N, wwords) int32 words, packed along K;
// x (E, M, K), out (E, M, N). W is 16-byte aligned and wwords a multiple
// of 4. A block takes BN_T weight rows (warp w rows [16w, 16w + 16)) and
// BM rows of x over its K slice, in passes of at most xk columns (one
// pass unless K is past 8 full slices).
template <int B, typename XT>
__global__ void __launch_bounds__(THREADS, 2)
pmm_t_mma_kernel(const XT* __restrict__ xb, const uint32_t* __restrict__ wb,
                 XT* __restrict__ outb, int M, int N, int K, int wwords, int k_chunk,
                 int splits, int xk, int x_vec) {
  using R = TRing<B>;
  constexpr bool MMA = kMma<B, XT>;
  constexpr int U = B / 4;
  constexpr int ACC = MMA ? 4 : 2 * BM;   // mma: c0..c3; FMA: rows g, g + 8 by x row
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* ring = smem + warp * R::WARP;
  XT* xs = reinterpret_cast<XT*>(smem + WARPS * R::WARP);
  const int xse = x_stride<XT>(xk);
  const int n0 = blockIdx.x * BN_T, m0 = blockIdx.y * BM;
  const int split = blockIdx.z % splits;
  const long long e = blockIdx.z / splits;
  const XT* x = xb + e * M * K;
  const uint32_t* w = wb + e * N * wwords;
  XT* out = outb + e * M * N;
  const int kb = split * k_chunk;
  const int ke = min(K, kb + k_chunk);

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  for (int p0 = kb; p0 < ke; p0 += xk) {
    const int pe = min(ke, p0 + xk);
    const int gb = p0 / 32, gend = (pe + 31) / 32;
    const int steps = (gend - gb + R::G - 1) / R::G;
    if (p0 > kb) __syncthreads();      // every warp is done with the last pass's x
    load_x_slice<XT>(xs, xse, x, M, K, m0, p0, pe, (gend - gb) * 32, x_vec);
    cp_commit();
    // stage i of this warp: groups [gb + i G, gb + (i + 1) G) into slot i % STAGES_T
    auto issue = [&](int i) {
      load_t_stage<B>(ring + (i % STAGES_T) * R::STAGE, w, n0 + warp * RW_T, N, gb + i * R::G,
                      gend, wwords, lane);
    };
#pragma unroll
    for (int s = 0; s < STAGES_T - 1; ++s) {
      if (s < steps) issue(s);
      cp_commit();
    }
    cp_wait<STAGES_T - 1>();           // this thread's x copies have landed
    __syncthreads();                   // and every thread's
    for (int i = 0; i < steps; ++i) {
      cp_wait<STAGES_T - 2>();         // stage i has landed
      __syncwarp();                    // and every lane is done with stage i - 1
      if (i + STAGES_T - 1 < steps) issue(i + STAGES_T - 1);
      cp_commit();
      const uint32_t* st = ring + (i % STAGES_T) * R::STAGE;
#pragma unroll
      for (int j = 0; j < R::G; ++j) {
        const int k0 = (gb + i * R::G + j) * 32;   // the group's first k
        if (k0 >= pe) break;
        uint32_t u0[U], u1[U];
        load_unit<U>(st + j * R::GROUP + g * B + U * t, u0);
        load_unit<U>(st + j * R::GROUP + (g + 8) * B + U * t, u1);
        float f0[8], f1[8];
        decode8_any<B>(u0, f0);
        decode8_any<B>(u1, f1);
        if (k0 + 32 > pe) {            // codes past the slice's end are not W's
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (k0 + 8 * t + c >= pe) f0[c] = f1[c] = 0.f;
        }
        const XT* xg = xs + (k0 - p0) + 8 * t;
        if constexpr (MMA) {
          // x[g][8t + 2q] and x[g][8t + 2q + 1] in word q, bf16
          const uint4 q4 = *reinterpret_cast<const uint4*>(xg + g * xse);
          const uint32_t xw[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma_tf32(acc, __float_as_uint(f0[2 * q]), __float_as_uint(f1[2 * q]),
                     __float_as_uint(f0[2 * q + 1]), __float_as_uint(f1[2 * q + 1]), xw[q] << 16,
                     xw[q] & 0xFFFF0000u);
        } else {
#pragma unroll
          for (int m = 0; m < BM; ++m) {
            float xv[8];
            load_x8(xg + m * xse, xv);
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              acc[m] = fmaf(xv[c], f0[c] * kScale<B>, acc[m]);
              acc[BM + m] = fmaf(xv[c], f1[c] * kScale<B>, acc[BM + m]);
            }
          }
        }
      }
    }
    cp_wait<0>();
    __syncwarp();
  }

  // the block's sums (BM, BN_T) over the rings: mma row g (g + 8) is the
  // warp's weight row g (g + 8), its column 2t (2t + 1) a row of x
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem);
  const int r = warp * RW_T + g;
  if constexpr (MMA) {
    sums[2 * t * BN_T + r] = acc[0];
    sums[(2 * t + 1) * BN_T + r] = acc[1];
    sums[2 * t * BN_T + r + 8] = acc[2];
    sums[(2 * t + 1) * BN_T + r + 8] = acc[3];
  } else {
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      acc[i] += __shfl_xor_sync(0xFFFFFFFFu, acc[i], 1);
      acc[i] += __shfl_xor_sync(0xFFFFFFFFu, acc[i], 2);
    }
    if (t == 0) {
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        sums[m * BN_T + r] = acc[m];
        sums[m * BN_T + r + 8] = acc[BM + m];
      }
    }
  }
  __syncthreads();
  finish<XT, BN_T, THREADS>(sums, out, M, N, m0, n0, splits, MMA ? kScale<B> : 1.f);
}

// Launches a kernel whose blocks along z form clusters of ``splits``.
template <typename... P, typename... A>
int launch_cluster(void (*kernel)(P...), dim3 grid, int threads, int smem, int splits,
                   cudaStream_t s, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = splits;
  cfg.attrs = &attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Lets ``kernel`` take ``smem`` bytes of dynamic shared memory.
template <typename F>
cudaError_t allow_smem(F* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int B, bool TRANS, typename XT>
int launch(const void* x, const void* w, void* out, int E, int M, int N, int K, int wwords,
           int splits, int k_chunk, cudaStream_t s) {
  // both bodies stream W with 16-byte copies
  if ((uintptr_t)w % 16 || wwords % 4) return (int)cudaErrorInvalidValue;
  const unsigned rows = (unsigned)((M + BM - 1) / BM), z = (unsigned)(E * splits);
  const int x_vec = (uintptr_t)x % 16 == 0 && (long long)K * (long long)sizeof(XT) % 16 == 0;
  if constexpr (TRANS) {
    const int smem = t_smem_bytes<B, XT>(k_chunk);
    const cudaError_t e = allow_smem(pmm_t_mma_kernel<B, XT>, smem);
    if (e != cudaSuccess) return (int)e;
    const int xk = k_chunk < kXCap<XT> ? k_chunk : kXCap<XT>;
    return launch_cluster(pmm_t_mma_kernel<B, XT>, dim3((N + BN_T - 1) / BN_T, rows, z),
                          THREADS, smem, splits, s, (const XT*)x, (const uint32_t*)w, (XT*)out,
                          M, N, K, wwords, k_chunk, splits, xk, x_vec);
  } else {
    constexpr int smem = Ring<B, XT>::BYTES;
    const cudaError_t e = allow_smem(pmm_kernel<B, XT>, smem);
    if (e != cudaSuccess) return (int)e;
    return launch_cluster(pmm_kernel<B, XT>, dim3((N + BN - 1) / BN, rows, z), THREADS, smem,
                          splits, s, (const XT*)x, (const uint32_t*)w, (XT*)out, M, N, K,
                          wwords, k_chunk, splits, x_vec);
  }
}

template <typename XT>
int dispatch(const void* x, const void* w, void* out, int E, int M, int N, int K, int wwords,
             int bits, int transpose, int splits, int k_chunk, cudaStream_t s) {
  int rc;
  if (transpose) {
    RT_FLOAT_WIDTHS(bits, (rc = launch<B, true, XT>(x, w, out, E, M, N, K, wwords, splits,
                                                    k_chunk, s)));
  } else {
    RT_FLOAT_WIDTHS(bits, (rc = launch<B, false, XT>(x, w, out, E, M, N, K, wwords, splits,
                                                     k_chunk, s)));
  }
  return rc;
}

int run(const void* x, int x_bf16, const void* w, void* out, int E, int M, int N, int K,
        int wwords, int bits, int transpose, int splits, int k_chunk, void* stream) {
  if (E == 0 || M == 0 || N == 0) return 0;
  // a split is a cluster, and the slices must cover K
  if (splits < 1 || splits > MAX_SPLITS || k_chunk < 32 || k_chunk % 32 ||
      (long long)splits * k_chunk < K || (long long)E * splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = x_bf16
      ? dispatch<__nv_bfloat16>(x, w, out, E, M, N, K, wwords, bits, transpose, splits,
                                k_chunk, s)
      : dispatch<float>(x, w, out, E, M, N, K, wwords, bits, transpose, splits, k_chunk, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

template <int B>
int ring_bytes(int x_bf16) {
  return x_bf16 ? Ring<B, __nv_bfloat16>::BYTES : Ring<B, float>::BYTES;
}

template <int B>
int t_ring_bytes(int x_bf16, int k_chunk) {
  return x_bf16 ? t_smem_bytes<B, __nv_bfloat16>(k_chunk) : t_smem_bytes<B, float>(k_chunk);
}

}  // namespace

// x (M, K) f32 or bf16; w int32 words, (K, wwords) or (N, wwords) when
// transposed, 16-byte aligned with wwords a multiple of 4; out (M, N)
// in x's dtype; K cut into splits (1..8) slices of k_chunk rows, a
// multiple of 32. One launch.
extern "C" int rt_packed_matmul(const void* x, int x_bf16, const void* w, void* out, int M,
                                int N, int K, int wwords, int bits, int transpose, int splits,
                                int k_chunk, void* stream) {
  return run(x, x_bf16, w, out, 1, M, N, K, wwords, bits, transpose, splits, k_chunk, stream);
}

// The same per expert: x (E, M, K); w (E, K, wwords) or (E, N, wwords)
// when transposed; out (E, M, N). One launch for all experts.
extern "C" int rt_packed_matmul_batched(const void* x, int x_bf16, const void* w, void* out,
                                        int E, int M, int N, int K, int wwords, int bits,
                                        int transpose, int splits, int k_chunk, void* stream) {
  return run(x, x_bf16, w, out, E, M, N, K, wwords, bits, transpose, splits, k_chunk, stream);
}

// Dynamic shared memory, in bytes, that a block of the normal orientation
// takes at ``bits`` for bf16 (x_bf16) or f32 x; -1 for an unknown width.
extern "C" int rt_pmm_smem(int bits, int x_bf16) {
  switch (bits) {
    case 8: return ring_bytes<8>(x_bf16);
    case 12: return ring_bytes<12>(x_bf16);
    case 16: return ring_bytes<16>(x_bf16);
    case 20: return ring_bytes<20>(x_bf16);
    case 24: return ring_bytes<24>(x_bf16);
    case 28: return ring_bytes<28>(x_bf16);
    case 32: return ring_bytes<32>(x_bf16);
    default: return -1;
  }
}

// The same for the transposed orientation, whose x slice buffer holds
// min(k_chunk, its cap) columns.
extern "C" int rt_pmm_t_smem(int bits, int x_bf16, int k_chunk) {
  switch (bits) {
    case 8: return t_ring_bytes<8>(x_bf16, k_chunk);
    case 12: return t_ring_bytes<12>(x_bf16, k_chunk);
    case 16: return t_ring_bytes<16>(x_bf16, k_chunk);
    case 20: return t_ring_bytes<20>(x_bf16, k_chunk);
    case 24: return t_ring_bytes<24>(x_bf16, k_chunk);
    case 28: return t_ring_bytes<28>(x_bf16, k_chunk);
    case 32: return t_ring_bytes<32>(x_bf16, k_chunk);
    default: return -1;
  }
}
