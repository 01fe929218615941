// unpack: group-of-32 packed words -> decoded f32 or bf16 rows.
//
// Replaces the Pallas TPU kernel repro/kernels/unpack.py:unpack
// (_unpack_kernel), the Value Extractor + Converter materialized path.
//
// Bound on this card: bytes. Each packed word is read once and each
// decoded value written once: rows * n * (bits/8 + 4) bytes for f32
// output. The decode is a few dozen integer operations per value, far
// below the card's ratio of operations to bytes.
//
// Design: pack.cu turned around. One warp per (row, group of 32 codes):
// lanes < bits load the group's ``bits`` words (one coalesced read) into
// a per-warp shared-memory slot, lane j extracts and decodes code j, and
// the warp writes its 32 outputs contiguously. Any n: codes past n in
// the last group are not written (the reference asserts n % 32 == 0).
// Row offsets are 64-bit: an embedding table has 151936 rows.
#include "codec.cuh"

namespace {

constexpr int kWarps = 8;

// The output element. A bf16 NaN is written as the reference writes it,
// its sign | 0x7FC0; __float2bfloat16_rn would write another NaN.
template <typename OutT> __device__ __forceinline__ OutT to_out(float v) {
  return rt::from_f32<OutT>(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u)
    return __ushort_as_bfloat16((unsigned short)(((u >> 16) & 0x8000u) | 0x7FC0u));
  return rt::from_f32<__nv_bfloat16>(v);
}

template <int B, typename OutT>
__global__ void unpack_kernel(const uint32_t* __restrict__ packed, OutT* __restrict__ out,
                              long long rows, int n, int groups) {
  __shared__ uint32_t words[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gid = (long long)blockIdx.x * kWarps + warp;   // (row, group)
  if (gid >= rows * groups) return;                              // whole warp exits
  const long long r = gid / groups;
  const int g = (int)(gid % groups);
  if (lane < B) words[warp][lane] = packed[r * (long long)groups * B + (long long)g * B + lane];
  __syncwarp();
  const int col = g * 32 + lane;
  if (col < n) {
    const uint32_t code = rt::extract_code<B>(words[warp], lane);
    out[r * n + col] = to_out<OutT>(rt::decode_float<B>(code));
  }
}

template <int B, typename OutT>
void launch(const void* packed, void* out, long long rows, int n, int groups,
            cudaStream_t s) {
  const long long total = rows * groups;
  const dim3 grid((unsigned)((total + kWarps - 1) / kWarps));
  unpack_kernel<B, OutT><<<grid, kWarps * 32, 0, s>>>((const uint32_t*)packed, (OutT*)out,
                                                      rows, n, groups);
}

}  // namespace

// packed (rows, ceil(n/32) * bits) int32 words; out (rows, n) float32
// (out_dtype 0) or bfloat16 (out_dtype 1).
extern "C" int rt_unpack(const void* packed, void* out, long long rows, int n, int bits,
                         int out_dtype, void* stream) {
  const int groups = (n + 31) / 32;
  if (out_dtype != 0 && out_dtype != 1) return (int)cudaErrorInvalidValue;
  if (rows == 0 || groups == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_dtype == 0) {
    RT_FLOAT_WIDTHS(bits, (launch<B, float>(packed, out, rows, n, groups, s)));
  } else {
    RT_FLOAT_WIDTHS(bits, (launch<B, __nv_bfloat16>(packed, out, rows, n, groups, s)));
  }
  return (int)cudaGetLastError();
}
