// unpack: group-of-32 packed words -> decoded f32 or bf16 rows.
//
// Replaces the Pallas TPU kernel repro/kernels/unpack.py:unpack
// (_unpack_kernel), the Value Extractor + Converter materialized path.
//
// Bound on this card: bytes. Each packed word is read once and each
// decoded value written once: rows * n * (bits/8 + 4) bytes for f32
// output (bits/8 + 2 for bf16). The decode is a few to a few dozen
// integer operations per value, below the card's ratio of operations to
// bytes.
//
// Design: a stream of chunks. Every Table 3 width is a multiple of 4, so
// 8 consecutive codes that start a quarter group always start a word and
// fill exactly B / 4 words; and a row's words follow the previous row's,
// so the payload is one flat array of such chunks. A thread takes chunks
// c, c + T, ... (T the grid's threads), UNROLL of them loaded before any
// is decoded, so a warp's every load and store covers whole sectors and
// an SM keeps tens of KB of loads in flight: a chunk is one 16-byte load at
// AF16, two at AF32, 8-byte loads at AF8 and AF24 and 4-byte loads at
// AF12, AF20 and AF28 (the warp's span is contiguous, so the sectors are
// whole), and 32 (f32) or 16 (bf16) output bytes stored 16 at a time
// with the streaming hint. The grid is the blocks the SMs hold at once.
// Decoding: AF16 by the hardware conversion, AF8 and AF12 by decode8's
// f16 fields and one power of two (a chunk holding an inf or NaN code
// takes decode_float), the other widths by decode_float; a NaN comes out
// as decode_float's canonical NaN with its sign (bf16: sign | 0x7FC0).
// When n is a multiple of 32 the output is flat too (chunk c writes
// values [8c, 8c + 8); a full warp stages its 1 KB of f32 output in
// shared memory, so that each store instruction covers 512 contiguous
// bytes, not every other 16 of 1,024); otherwise a chunk finds its row by a division
// and writes the codes below n, 16 bytes at a time where aligned. A base
// that is not 16-byte aligned takes 4-byte loads and stores throughout.
// Offsets are 64-bit: an embedding table has 151936 rows.
#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// The B / 4 words of a chunk, in the widest loads its alignment allows
// (the chunk starts at byte 4 B c).
template <int U, bool VEC>
__device__ __forceinline__ void load_chunk(const uint32_t* p, uint32_t (&u)[U]) {
  if constexpr (VEC && U % 4 == 0) {
#pragma unroll
    for (int i = 0; i < U; i += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + i));
      u[i] = v.x, u[i + 1] = v.y, u[i + 2] = v.z, u[i + 3] = v.w;
    }
  } else if constexpr (VEC && U % 2 == 0) {
#pragma unroll
    for (int i = 0; i < U; i += 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + i));
      u[i] = v.x, u[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < U; ++i) u[i] = __ldg(p + i);
  }
}

// decode_float of the chunk's 8 codes, exactly: NaNs canonical.
template <int B>
__device__ __forceinline__ void decode_chunk(const uint32_t (&u)[B / 4], float (&f)[8]) {
  if constexpr (B == 8 || B == 12 || B == 16) {
    const bool special = rt::decode8<B>(u, f);   // always false at AF16
    if constexpr (B == 16) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {          // a NaN code -> the canonical NaN, its sign
        const uint32_t c = u[i >> 1] >> (16 * (i & 1));   // the conversion drops it
        if ((c & 0x7FFFu) > 0x7C00u) f[i] = __uint_as_float(((c & 0x8000u) << 16) | 0x7FC00000u);
      }
    } else if (special) {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = rt::decode_float<B>(rt::extract_code<B>(u, i));
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] *= rt::kScale<B>;   // a power of two: exact
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = rt::decode_float<B>(rt::extract_code<B>(u, i));
  }
}

// The output element. A bf16 NaN is written as the reference writes it,
// its sign | 0x7FC0; __float2bfloat16_rn would write another NaN.
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return ((u >> 16) & 0x8000u) | 0x7FC0u;
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Stores values [0, valid) of f at out (16-byte stores when ``vec``).
template <typename OutT>
__device__ __forceinline__ void store_chunk(OutT* out, const float (&f)[8], int valid, bool vec) {
  if constexpr (sizeof(OutT) == 4) {
    if (vec && valid == 8) {
      __stcs(reinterpret_cast<float4*>(out), make_float4(f[0], f[1], f[2], f[3]));
      __stcs(reinterpret_cast<float4*>(out) + 1, make_float4(f[4], f[5], f[6], f[7]));
    } else {
      for (int i = 0; i < valid; ++i) reinterpret_cast<float*>(out)[i] = f[i];
    }
  } else {
    if (vec && valid == 8) {
      uint32_t p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
      __stcs(reinterpret_cast<uint4*>(out), make_uint4(p[0], p[1], p[2], p[3]));
    } else {
      unsigned short* o = reinterpret_cast<unsigned short*>(out);
      for (int i = 0; i < valid; ++i) o[i] = (unsigned short)bf16_bits(f[i]);
    }
  }
}

// FLAT: n % 32 == 0, chunk c writes out[8c, 8c + 8). VEC: both bases are
// 16-byte aligned.
template <int B, typename OutT, bool FLAT, bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
unpack_kernel(const uint32_t* __restrict__ packed, OutT* __restrict__ out, long long chunks,
              long long chunks_per_row, int n) {
  constexpr int U = B / 4;
  // f32 output: a full warp's 32 chunks are 1 KB of output, staged here
  // so that each store instruction covers 512 contiguous bytes
  __shared__ float4 stage[FLAT && sizeof(OutT) == 4 ? kThreads / 32 : 1][64];
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long c0 = (long long)blockIdx.x * kThreads + threadIdx.x; c0 < chunks;
       c0 += stride * kUnroll) {
    uint32_t u[kUnroll][U];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long c = c0 + k * stride;
      if (c < chunks) load_chunk<U, VEC>(packed + c * U, u[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long c = c0 + k * stride;
      if (c >= chunks) break;
      float f[8];
      decode_chunk<B>(u[k], f);
      if constexpr (FLAT && sizeof(OutT) == 4) {
        if (c - lane + 31 < chunks) {            // the whole warp (uniform)
          float4* st = stage[threadIdx.x >> 5];
          __syncwarp();                          // the last round's reads are done
          st[2 * lane] = make_float4(f[0], f[1], f[2], f[3]);
          st[2 * lane + 1] = make_float4(f[4], f[5], f[6], f[7]);
          __syncwarp();
          float4* o = reinterpret_cast<float4*>(out + (c - lane) * 8);
          __stcs(o + lane, st[lane]);
          __stcs(o + 32 + lane, st[32 + lane]);
          continue;
        }
      }
      if constexpr (FLAT) {
        store_chunk<OutT>(out + c * 8, f, 8, VEC);
      } else {
        const long long r = c / chunks_per_row;
        const int col = (int)(c - r * chunks_per_row) * 8;
        const int valid = min(8, n - col);
        if (valid <= 0) continue;                 // past n in the last group
        OutT* o = out + r * n + col;
        store_chunk<OutT>(o, f, valid, VEC && ((size_t)o & 15) == 0);
      }
    }
  }
}

template <int B, typename OutT, bool FLAT, bool VEC>
void launch_as(const uint32_t* p, OutT* o, long long chunks, long long chunks_per_row, int n,
               int sms, cudaStream_t s) {
  // resident blocks an SM holds, once per instantiation
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, unpack_kernel<B, OutT, FLAT, VEC>,
                                                  kThreads, 0);
    return b > 0 ? b : 1;
  }();
  const long long want = (chunks + (long long)kThreads * kUnroll - 1) / ((long long)kThreads * kUnroll);
  const long long cap = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  unpack_kernel<B, OutT, FLAT, VEC><<<grid, kThreads, 0, s>>>(p, o, chunks, chunks_per_row, n);
}

template <int B, typename OutT>
void launch(const void* packed, void* out, long long rows, int n, int aligned, int sms,
            cudaStream_t s) {
  const long long chunks_per_row = (n + 31) / 32 * 4;
  const long long chunks = rows * chunks_per_row;
  const uint32_t* p = (const uint32_t*)packed;
  OutT* o = (OutT*)out;
  if (aligned && n % 32 == 0)
    launch_as<B, OutT, true, true>(p, o, chunks, chunks_per_row, n, sms, s);
  else if (aligned)
    launch_as<B, OutT, false, true>(p, o, chunks, chunks_per_row, n, sms, s);
  else
    launch_as<B, OutT, false, false>(p, o, chunks, chunks_per_row, n, sms, s);
}

}  // namespace

// packed (rows, ceil(n/32) * bits) int32 words; out (rows, n) float32
// (out_dtype 0) or bfloat16 (out_dtype 1). ``aligned``: both bases are
// 16-byte aligned; ``sms``: the card's SM count.
extern "C" int rt_unpack(const void* packed, void* out, long long rows, int n, int bits,
                         int out_dtype, int aligned, int sms, void* stream) {
  if (out_dtype != 0 && out_dtype != 1) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_dtype == 0) {
    RT_FLOAT_WIDTHS(bits, (launch<B, float>(packed, out, rows, n, aligned, sms, s)));
  } else {
    RT_FLOAT_WIDTHS(bits, (launch<B, __nv_bfloat16>(packed, out, rows, n, aligned, sms, s)));
  }
  return (int)cudaGetLastError();
}
