// packed_matmul: x @ decode(W), or x @ decode(W)^T, with W packed; and
// packed_matmul_batched: the same per expert, x[e] @ decode(W[e]).
//
// Replaces the Pallas TPU kernels repro/kernels/packed_matmul.py:
// packed_matmul (_pmm_kernel, _pmm_t_kernel) and packed_matmul_batched
// (_bmm_kernel, _bmm_t_kernel). Both entry points launch the same
// kernels: the expert index shares blockIdx.z with the K split, and the
// 2-D product is the batched one with a single expert.
//
// Bound on this card: bytes. On the serving path M is the slot count
// (8), so each packed weight word is used by 8 rows only: ~2*8 flops per
// decoded value against bits/8 bytes read. The packed weights stream
// from device memory once per pass and the decoded weight never leaves
// registers.
//
// Design: a block owns BN = 256 output columns (one per thread), BM = 8
// rows of x and one slice of K, and walks the slice in tiles of BK = 32
// rows. Normal orientation (W (K, N) packed along N, the serving path):
// each tile's packed words are loaded with 16-byte loads into shared
// memory, and the next tile's loads are issued before the current tile
// is consumed, so the loads stay in flight while the SM decodes; every
// thread then decodes its column's 32 codes straight from shared memory
// and runs 8 f32 FMAs per code against the x tile. Transposed
// orientation (W (N, K) packed along K, the tied heads): a warp decodes
// one weight row's group of 32 codes per step into a shared f32 tile,
// read directly from device memory. No tensor cores and no TF32: the sum
// is plain f32, as in the reference.
// Grid size is the hard part at these shapes: wk/wv have N = 1024, only 4
// column tiles for 132 SMs, so K is split into slices whose f32 partial
// sums go to a workspace and a second pass adds them in a fixed order
// (deterministic). Ragged M, N and K are masked in the kernel rather
// than padded as the reference does. The MoE expert banks (E = 64 banks
// of 2048 x 1408 at full deepseek-moe-16b width, M = capacity = 1 row
// per expert) are a pure weight stream: 64 x 6 = 384 column tiles fill
// the card without a K split, and each expert's words are read once.
#include "codec.cuh"

namespace {

constexpr int BN = 256;   // output columns per block = threads per block
constexpr int BM = 8;     // rows of x per block
constexpr int BK = 32;    // K tile

// Writes a block's sums: to out (already offset to this expert), or to
// workspace slice z = expert * splits + split when K is split.
template <typename XT>
__device__ __forceinline__ void store_out(XT* out, float* ws, const float* acc, int M, int N,
                                          int m0, int n, int z, int splits) {
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int m = m0 + i;
    if (m >= M) break;
    if (splits == 1) out[(long long)m * N + n] = rt::from_f32<XT>(acc[i]);
    else ws[((long long)z * M + m) * N + n] = acc[i];
  }
}

// Loads one K tile of the normal orientation into registers: NV 16-byte
// vectors of packed words per thread (zeros past the slice or the row)
// and one element of x.
template <int NV, int VPR, typename XT>
__device__ __forceinline__ void fetch_tile(uint4 (&pre)[NV], float& xpre, const uint4* wv,
                                           const XT* x, int k0, int ke, int K, int wwords,
                                           int wofs, int xm, int xk, int M) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int i = threadIdx.x + v * BN;
    const int k = k0 + i / VPR;
    const int word = wofs + (i % VPR) * 4;
    pre[v] = (k < ke && word < wwords) ? __ldg(wv + (((long long)k * wwords + word) >> 2))
                                       : make_uint4(0u, 0u, 0u, 0u);
  }
  const int k = k0 + xk;
  xpre = (xm < M && k < ke) ? rt::to_f32(x[(long long)xm * K + k]) : 0.f;
}

// Normal orientation: W (E, K, wwords) int32 words, packed along N;
// x (E, M, K), out (E, M, N). wwords is a multiple of 4, so every
// expert's rows stay 16-byte aligned.
template <int B, typename XT>
__global__ void __launch_bounds__(BN)
pmm_kernel(const XT* __restrict__ xb, const uint32_t* __restrict__ wb, XT* __restrict__ outb,
           float* __restrict__ ws, int M, int N, int K, int wwords, int k_chunk, int splits) {
  constexpr int WPR = (BN / 32) * B;      // words of one tile row
  constexpr int VPR = WPR / 4;            // 16-byte vectors of one tile row
  constexpr int NV = BK * VPR / BN;       // vectors each thread loads per tile
  __shared__ __align__(16) uint32_t Wst[BK * WPR];
  __shared__ __align__(16) float Xs[BK][BM];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int split = blockIdx.z % splits;
  const long long e = blockIdx.z / splits;
  const XT* x = xb + e * M * K;
  XT* out = outb + e * M * N;
  const int kb = split * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int wofs = (n0 >> 5) * B;         // this tile's first word in a row
  const uint4* wv = reinterpret_cast<const uint4*>(wb + e * K * wwords);
  const int xm = m0 + tid % BM, xk = tid / BM;

  uint4 pre[NV];
  float xpre;

  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;
  const uint32_t* grp = Wst + (tid >> 5) * B;   // this thread's group in a tile row
  const int j = tid & 31;                       // and its code in the group

  if (kb < ke) fetch_tile<NV, VPR>(pre, xpre, wv, x, kb, ke, K, wwords, wofs, xm, xk, M);
  for (int k0 = kb; k0 < ke; k0 += BK) {
#pragma unroll
    for (int v = 0; v < NV; ++v) reinterpret_cast<uint4*>(Wst)[tid + v * BN] = pre[v];
    Xs[xk][tid % BM] = xpre;
    __syncthreads();
    if (k0 + BK < ke)                           // in flight during the FMAs below
      fetch_tile<NV, VPR>(pre, xpre, wv, x, k0 + BK, ke, K, wwords, wofs, xm, xk, M);
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float wval = rt::decode_float<B>(rt::extract_code<B>(grp + kk * WPR, j));
      const float4 xa = *reinterpret_cast<const float4*>(&Xs[kk][0]);
      const float4 xb = *reinterpret_cast<const float4*>(&Xs[kk][4]);
      acc[0] = fmaf(xa.x, wval, acc[0]);
      acc[1] = fmaf(xa.y, wval, acc[1]);
      acc[2] = fmaf(xa.z, wval, acc[2]);
      acc[3] = fmaf(xa.w, wval, acc[3]);
      acc[4] = fmaf(xb.x, wval, acc[4]);
      acc[5] = fmaf(xb.y, wval, acc[5]);
      acc[6] = fmaf(xb.z, wval, acc[6]);
      acc[7] = fmaf(xb.w, wval, acc[7]);
    }
    __syncthreads();
  }
  store_out<XT>(out, ws, acc, M, N, m0, n0 + tid, blockIdx.z, splits);
}

// Transposed orientation: W (E, N, wwords) int32 words, packed along K;
// x (E, M, K), out (E, M, N).
template <int B, typename XT>
__global__ void __launch_bounds__(BN)
pmm_t_kernel(const XT* __restrict__ xb, const uint32_t* __restrict__ wb,
             XT* __restrict__ outb, float* __restrict__ ws, int M, int N, int K, int wwords,
             int k_chunk, int splits) {
  __shared__ float Ws[BK][BN + 1];
  __shared__ float Xs[BM][BK];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int split = blockIdx.z % splits;
  const long long e = blockIdx.z / splits;
  const XT* x = xb + e * M * K;
  const uint32_t* w = wb + e * N * wwords;
  XT* out = outb + e * M * N;
  const int kb = split * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int wp = tid >> 5, lane = tid & 31;
  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    {
      const int mm = tid / BK, kk = tid % BK;
      const int m = m0 + mm, k = k0 + kk;
      Xs[mm][kk] = (m < M && k < ke) ? rt::to_f32(x[(long long)m * K + k]) : 0.f;
    }
    const int goff = (k0 >> 5) * B;
#pragma unroll 4
    for (int nn = wp; nn < BN; nn += BN / 32) {
      const int n = n0 + nn;
      float v = 0.f;
      if (n < N && k0 + lane < ke)
        v = rt::decode_float<B>(rt::extract_code<B>(w + (long long)n * wwords + goff, lane));
      Ws[lane][nn] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float wval = Ws[kk][tid];
#pragma unroll
      for (int i = 0; i < BM; ++i) acc[i] = fmaf(Xs[i][kk], wval, acc[i]);
    }
    __syncthreads();
  }
  store_out<XT>(out, ws, acc, M, N, m0, n0 + tid, blockIdx.z, splits);
}

// Adds each expert's split-K partial sums in split order and converts to
// x.dtype: ws (E, splits, M, N) -> out (E, M, N).
template <typename XT>
__global__ void pmm_reduce(const float* __restrict__ ws, XT* __restrict__ out, long long mn,
                           long long total, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long e = i / mn, r = i - e * mn;
  const float* p0 = ws + e * splits * mn + r;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += p0[(long long)p * mn];
  out[i] = rt::from_f32<XT>(s);
}

template <int B, bool TRANS, typename XT>
int launch(const void* x, const void* w, void* out, void* ws, int E, int M, int N, int K,
           int wwords, int splits, int k_chunk, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E * splits);
  if (TRANS) {
    pmm_t_kernel<B, XT><<<grid, BN, 0, s>>>((const XT*)x, (const uint32_t*)w, (XT*)out,
                                           (float*)ws, M, N, K, wwords, k_chunk, splits);
  } else {
    pmm_kernel<B, XT><<<grid, BN, 0, s>>>((const XT*)x, (const uint32_t*)w, (XT*)out,
                                         (float*)ws, M, N, K, wwords, k_chunk, splits);
  }
  if (splits > 1) {
    const long long mn = (long long)M * N, total = mn * E;
    pmm_reduce<XT><<<(unsigned)((total + 255) / 256), 256, 0, s>>>((const float*)ws, (XT*)out,
                                                                    mn, total, splits);
  }
  return 0;
}

template <typename XT>
int dispatch(const void* x, const void* w, void* out, void* ws, int E, int M, int N, int K,
             int wwords, int bits, int transpose, int splits, int k_chunk, cudaStream_t s) {
  if (transpose) {
    RT_FLOAT_WIDTHS(bits, (launch<B, true, XT>(x, w, out, ws, E, M, N, K, wwords, splits,
                                                 k_chunk, s)));
  } else {
    RT_FLOAT_WIDTHS(bits, (launch<B, false, XT>(x, w, out, ws, E, M, N, K, wwords, splits,
                                                  k_chunk, s)));
  }
  return 0;
}

int run(const void* x, int x_bf16, const void* w, void* out, void* ws, int E, int M, int N,
        int K, int wwords, int bits, int transpose, int splits, int k_chunk, void* stream) {
  if (E == 0 || M == 0 || N == 0) return 0;
  if (E * splits > 65535) return (int)cudaErrorInvalidValue;   // gridDim.z
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = x_bf16
      ? dispatch<__nv_bfloat16>(x, w, out, ws, E, M, N, K, wwords, bits, transpose, splits,
                                k_chunk, s)
      : dispatch<float>(x, w, out, ws, E, M, N, K, wwords, bits, transpose, splits, k_chunk,
                        s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) f32 or bf16; w int32 words, (K, wwords) or (N, wwords) when
// transposed, 16-byte aligned with wwords a multiple of 4 in the normal
// orientation; out (M, N) in x's dtype; ws (splits, M, N) f32 when
// splits > 1; k_chunk a multiple of 32.
extern "C" int rt_packed_matmul(const void* x, int x_bf16, const void* w, void* out, void* ws,
                                int M, int N, int K, int wwords, int bits, int transpose,
                                int splits, int k_chunk, void* stream) {
  return run(x, x_bf16, w, out, ws, 1, M, N, K, wwords, bits, transpose, splits, k_chunk,
             stream);
}

// The same per expert: x (E, M, K); w (E, K, wwords) or (E, N, wwords)
// when transposed; out (E, M, N); ws (E, splits, M, N) f32 when
// splits > 1. One launch (two with a K split) for all experts.
extern "C" int rt_packed_matmul_batched(const void* x, int x_bf16, const void* w, void* out,
                                        void* ws, int E, int M, int N, int K, int wwords,
                                        int bits, int transpose, int splits, int k_chunk,
                                        void* stream) {
  return run(x, x_bf16, w, out, ws, E, M, N, K, wwords, bits, transpose, splits, k_chunk,
             stream);
}
