// unpack and take_rows: group-of-32 packed words -> decoded rows, one
// chunk stream read in order or through an index.
//
// Replaces the Pallas TPU kernels repro/kernels/unpack.py:unpack
// (_unpack_kernel), the Value Extractor + Converter materialized path,
// and repro/kernels/take.py:take_rows (_take_kernel), the packed
// ``embed`` path: gather rows of a table by index (any order, repeats,
// out-of-range indices clamped into the table) and decode only those.
//
// Bound on this card: bytes. Each packed word is read once and each
// decoded value written once: rows * n * (bits/8 + 4) bytes for f32
// output (bits/8 + 2 for bf16); take_rows reads the gathered rows and
// the index. The decode is a few to a few dozen integer operations per
// value, below the card's ratio of operations to bytes. A decode tick's
// take_rows moves ~130 KB (8 rows of d = 4096): there the launch and two
// dependent trips to memory, the index and then the row, are the cost.
//
// Design: a stream of chunks. Every Table 3 width and every int width
// (4..32, step 4) is a multiple of 4, so 8 consecutive codes that start
// a quarter group always start a word and fill exactly U = B / 4 words,
// and a packed row of ceil(n/32) * B words is cpr = ceil(n/32) * 4
// chunks. Chunk c of the output is chunk j = c mod cpr of output row
// r = c div cpr: it reads words [U j, U j + U) of source row r (unpack,
// whose rows follow each other: one flat array of chunks) or of table
// row clamp(idx[r]) (take_rows), and writes values [8j, 8j + 8) of
// output row r. A thread takes chunks c, c + T, ... (T the grid's
// threads), UNROLL of them loaded (their indices first) before any is
// decoded, so a warp's every load and store covers whole sectors and an
// SM keeps tens of KB of loads in flight: a chunk is one 16-byte load at
// AF16, two at AF32, 8-byte loads at AF8 and AF24 and 4-byte loads at
// AF12, AF20 and AF28 (the warp's span is contiguous, so the sectors are
// whole), and 32 (f32) or 16 (bf16) output bytes stored 16 at a time
// with the streaming hint. The grid is a block per 256 chunks, up to the
// blocks the SMs hold at once: a count that fits in one wave gives every
// chunk its own thread and no loop (a decode tick's 8 rows are 16 blocks
// at d = 4096, 8 at d = 2048), a larger one streams. A thread finds the
// (r, j) of its first chunk by one 32-bit division and steps it by T's
// quotient and remainder, so no thread divides in the loop.
// Decoding: AF16 by the hardware conversion, AF8 and AF12 by decode8's
// f16 fields and one power of two (a chunk holding an inf or NaN code
// takes decode_float), the other widths by decode_float; a NaN comes out
// as decode_float's canonical NaN with its sign (bf16: sign | 0x7FC0, as
// the reference writes it). Int kind sign- or zero-extends each code
// (decode_int) to int32 or f32. When n is a multiple of 32 the output is
// flat too (chunk c writes values [8c, 8c + 8); a full warp stages its
// 1 KB of 32-bit output in shared memory, so that each store instruction
// covers 512 contiguous bytes, not every other 16 of 1,024); otherwise a
// chunk writes the codes of its row below n, 16 bytes at a time where
// aligned. A base that is not 16-byte aligned takes 4-byte loads and
// stores throughout. Offsets are 64-bit: an embedding table has 151936
// rows.
#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// What a chunk's codes decode to: Table 3 floats, or int codes sign- or
// zero-extended and written as f32 or as int32.
enum Kind { kFloat, kIntF32, kInt32 };

// take_rows' source rows: output row r reads table row clamp(idx[r]).
struct Gather {
  const void* idx;   // int32, or int64 when idx64
  long long rows;    // the table's rows
  int idx64;
};

// The B / 4 words of a chunk, in the widest loads its alignment allows
// (the chunk starts at byte 4 B c of a row that starts 16-byte aligned).
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

// The chunk's 8 outputs as 32-bit words. Float kind: decode_float of
// each code, exactly, NaNs canonical. Int kind: decode_int, as a float
// (kIntF32) or as its int32 bits (kInt32), which the stores move as
// they are.
template <int B, int KIND>
__device__ __forceinline__ void decode_chunk(const uint32_t (&u)[B / 4], float (&f)[8],
                                             bool is_signed) {
  if constexpr (KIND != kFloat) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int32_t v = rt::decode_int<B>(rt::extract_code<B>(u, i), is_signed);
      f[i] = KIND == kIntF32 ? (float)v : __int_as_float(v);
    }
  } else if constexpr (B == 8 || B == 12 || B == 16) {
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

// Stores values [0, valid) of f at out (16-byte stores when ``vec``);
// a 32-bit output takes f's words as they are.
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
// 16-byte aligned. GATHER: source rows through g (take_rows).
template <int B, int KIND, typename OutT, bool FLAT, bool VEC, bool GATHER>
__global__ void __launch_bounds__(kThreads, 4)
chunk_kernel(const uint32_t* __restrict__ packed, OutT* __restrict__ out, long long chunks,
             int cpr, int n, Gather g, bool is_signed) {
  constexpr int U = B / 4;
  constexpr bool kRows = GATHER || !FLAT;    // the chunk's (r, j) is read
  // 32-bit output: a full warp's 32 chunks are 1 KB of output, staged
  // here so that each store instruction covers 512 contiguous bytes
  __shared__ float4 stage[FLAT && sizeof(OutT) == 4 ? kThreads / 32 : 1][64];
  const int lane = threadIdx.x & 31;
  const unsigned first = blockIdx.x * kThreads + threadIdx.x;
  const unsigned stride = gridDim.x * kThreads;   // a resident grid's threads
  // (r, j) of the thread's next chunk, stepped by (dr, dj) = T divmod cpr
  unsigned r = 0, dr = 0;
  int j = 0, dj = 0;
  if constexpr (kRows) {
    r = first / (unsigned)cpr, j = (int)(first - r * (unsigned)cpr);
    dr = stride / (unsigned)cpr, dj = (int)(stride - dr * (unsigned)cpr);
  }
  for (long long c0 = first; c0 < chunks; c0 += (long long)stride * kUnroll) {
    unsigned row[kUnroll];
    int col[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if constexpr (kRows) {
        row[k] = r, col[k] = j;
        r += dr, j += dj;
        if (j >= cpr) j -= cpr, ++r;
      }
    }
    long long src[kUnroll];                      // the source rows, indices in flight together
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if constexpr (GATHER) {
        if (c0 + (long long)k * stride < chunks) {
          long long s = g.idx64 ? __ldg(static_cast<const long long*>(g.idx) + row[k])
                                : (long long)__ldg(static_cast<const int*>(g.idx) + row[k]);
          src[k] = s < 0 ? 0 : (s >= g.rows ? g.rows - 1 : s);
        }
      }
    }
    uint32_t u[kUnroll][U];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long c = c0 + (long long)k * stride;
      if (c >= chunks) break;
      if constexpr (GATHER) load_chunk<U, VEC>(packed + (src[k] * cpr + col[k]) * U, u[k]);
      else load_chunk<U, VEC>(packed + c * U, u[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long c = c0 + (long long)k * stride;
      if (c >= chunks) break;
      float f[8];
      decode_chunk<B, KIND>(u[k], f, is_signed);
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
        const int valid = min(8, n - 8 * col[k]);
        if (valid <= 0) continue;                 // past n in the last group
        OutT* o = out + (long long)row[k] * n + 8 * col[k];
        store_chunk<OutT>(o, f, valid, VEC && ((size_t)o & 15) == 0);
      }
    }
  }
}

template <int B, int KIND, typename OutT, bool FLAT, bool VEC, bool GATHER>
void launch_as(const uint32_t* p, OutT* o, long long chunks, int cpr, int n, const Gather& g,
               bool is_signed, int sms, cudaStream_t s) {
  // resident blocks an SM holds, once per instantiation
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, chunk_kernel<B, KIND, OutT, FLAT, VEC, GATHER>, kThreads, 0);
    return b > 0 ? b : 1;
  }();
  const long long want = (chunks + kThreads - 1) / kThreads;   // a chunk a thread
  const long long cap = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  chunk_kernel<B, KIND, OutT, FLAT, VEC, GATHER><<<grid, kThreads, 0, s>>>(p, o, chunks, cpr, n,
                                                                          g, is_signed);
}

// rows output rows of n values, from ``packed`` (unpack) or through g
// from the table ``packed`` (take_rows, GATHER).
template <int B, int KIND, typename OutT, bool GATHER>
void launch(const void* packed, void* out, long long rows, int n, const Gather& g,
            bool is_signed, int aligned, int sms, cudaStream_t s) {
  const int cpr = (int)(((long long)n + 31) / 32 * 4);
  const long long chunks = rows * cpr;
  const uint32_t* p = (const uint32_t*)packed;
  OutT* o = (OutT*)out;
  if (aligned && n % 32 == 0)
    launch_as<B, KIND, OutT, true, true, GATHER>(p, o, chunks, cpr, n, g, is_signed, sms, s);
  else if (aligned)
    launch_as<B, KIND, OutT, false, true, GATHER>(p, o, chunks, cpr, n, g, is_signed, sms, s);
  else
    launch_as<B, KIND, OutT, false, false, GATHER>(p, o, chunks, cpr, n, g, is_signed, sms, s);
}

}  // namespace

// Width dispatch for the int widths 4..32, step 4, as RT_FLOAT_WIDTHS.
#define RT_INT_WIDTHS(bits, BODY)                                \
  switch (bits) {                                                \
    case 4:  { constexpr int B = 4;  BODY; } break;              \
    case 8:  { constexpr int B = 8;  BODY; } break;              \
    case 12: { constexpr int B = 12; BODY; } break;              \
    case 16: { constexpr int B = 16; BODY; } break;              \
    case 20: { constexpr int B = 20; BODY; } break;              \
    case 24: { constexpr int B = 24; BODY; } break;              \
    case 28: { constexpr int B = 28; BODY; } break;              \
    case 32: { constexpr int B = 32; BODY; } break;              \
    default: return (int)cudaErrorInvalidValue;                  \
  }

// packed (rows, ceil(n/32) * bits) int32 words; out (rows, n) float32
// (out_dtype 0) or bfloat16 (out_dtype 1). ``aligned``: both bases are
// 16-byte aligned; ``sms``: the card's SM count.
extern "C" int rt_unpack(const void* packed, void* out, long long rows, int n, int bits,
                         int out_dtype, int aligned, int sms, void* stream) {
  if (out_dtype != 0 && out_dtype != 1) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Gather none{nullptr, 0, 0};
  if (out_dtype == 0) {
    RT_FLOAT_WIDTHS(bits, (launch<B, kFloat, float, false>(packed, out, rows, n, none, false,
                                                          aligned, sms, s)));
  } else {
    RT_FLOAT_WIDTHS(bits, (launch<B, kFloat, __nv_bfloat16, false>(packed, out, rows, n, none,
                                                                  false, aligned, sms, s)));
  }
  return (int)cudaGetLastError();
}

// table (rows, ceil(n/32) * bits) int32 words; idx (count,) int32, or
// int64 when idx_is_64, clamped into [0, rows); out (count, n) float32
// (out_kind 0), bfloat16 (1, float kind) or int32 (2, int kind).
// ``aligned``: table and out are 16-byte aligned; ``sms``: the card's SM
// count.
extern "C" int rt_take_rows(const void* table, const void* idx, int idx_is_64, void* out,
                            int out_kind, long long rows, long long count, int n, int bits,
                            int int_kind, int is_signed, int aligned, int sms, void* stream) {
  if (count == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Gather g{idx, rows, idx_is_64};
  const bool sg = is_signed != 0;
  if (!int_kind && out_kind == 0) {
    RT_FLOAT_WIDTHS(bits, (launch<B, kFloat, float, true>(table, out, count, n, g, sg,
                                                         aligned, sms, s)));
  } else if (!int_kind && out_kind == 1) {
    RT_FLOAT_WIDTHS(bits, (launch<B, kFloat, __nv_bfloat16, true>(table, out, count, n, g, sg,
                                                                 aligned, sms, s)));
  } else if (int_kind && out_kind == 0) {
    RT_INT_WIDTHS(bits, (launch<B, kIntF32, float, true>(table, out, count, n, g, sg, aligned,
                                                        sms, s)));
  } else if (int_kind && out_kind == 2) {
    RT_INT_WIDTHS(bits, (launch<B, kInt32, int32_t, true>(table, out, count, n, g, sg, aligned,
                                                         sms, s)));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
