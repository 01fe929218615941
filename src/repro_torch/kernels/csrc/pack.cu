// pack: f32 rows -> Table 3 codes -> group-of-32 packed words.
//
// Replaces the Pallas TPU kernel repro/kernels/pack.py:pack
// (_pack_kernel), the Value Truncator write path.
//
// Bound on this card: bytes. Each input float is read once and each
// output word written once; the encode is ~40 integer operations per
// value against 4 + bits/8 bytes moved, far below the card's ratio of
// operations to bytes.
//
// Design: one warp per group of 32 codes. Lane j reads x[r, 32g + j]
// (one coalesced 128-byte read per warp) and encodes it; the codes meet
// in a per-warp shared-memory slot and lane w < bits assembles word w of
// the group, so each warp writes its ``bits`` words contiguously. N need
// not be a multiple of 32: lanes past N contribute pad code 0, which the
// reference's kernel refused (pack.py asserts N % 32 == 0).
#include "codec.cuh"

namespace {

constexpr int kWarps = 8;

template <int B>
__global__ void pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ out,
                            long long rows, int n, int groups) {
  __shared__ uint32_t codes[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gid = (long long)blockIdx.x * kWarps + warp;   // (row, group)
  if (gid >= rows * groups) return;                              // whole warp exits
  const long long r = gid / groups;
  const int g = (int)(gid % groups);
  const int col = g * 32 + lane;
  codes[warp][lane] = col < n ? rt::encode_float<B>(x[r * n + col]) : 0u;
  __syncwarp();
  if (lane < B) {
    uint32_t word = 0;
    // codes overlapping word ``lane``: bits [32*lane, 32*lane + 32)
    const int j_lo = (32 * lane) / B, j_hi = (32 * lane + 31) / B;
    for (int j = j_lo; j <= j_hi && j < 32; ++j) {
      const int s = j * B;
      const uint32_t c = codes[warp][j];
      if ((s >> 5) == lane) word |= c << (s & 31);
      else if (B < 32) word |= c >> (32 - (s & 31));   // spill from the previous word
    }
    out[r * (long long)groups * B + (long long)g * B + lane] = word;
  }
}

template <int B>
void launch(const void* x, void* out, long long rows, int n, int groups, cudaStream_t s) {
  const long long total = rows * groups;
  const dim3 grid((unsigned)((total + kWarps - 1) / kWarps));
  pack_kernel<B><<<grid, kWarps * 32, 0, s>>>((const float*)x, (uint32_t*)out, rows, n,
                                               groups);
}

}  // namespace

// x (rows, n) f32; out (rows, ceil(n/32) * bits) int32 words.
extern "C" int rt_pack(const void* x, void* out, long long rows, int n, int bits,
                       void* stream) {
  const int groups = (n + 31) / 32;
  if (rows == 0 || groups == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  RT_FLOAT_WIDTHS(bits, (launch<B>(x, out, rows, n, groups, s)));
  return (int)cudaGetLastError();
}
