// Table 3 codec shared by every kernel of the port.
//
// The device twin of repro_torch/core/formats.py (and of the reference
// repro/core/formats.py): one decode and one encode routine, templated on
// the code width, bit for bit equal to the Python versions, plus the
// group-of-32 code extraction of core/bitpack.py; beside them the fast
// routes (AF16 through the hardware conversions, decode8 for 8 codes of
// AF8-AF16 at once). Packed words are int32 tensors on the Python side
// and are read here as uint32_t.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace rt {

template <int BITS> struct Fmt;
template <> struct Fmt<8>  { static constexpr int E = 3, M = 4; };
template <> struct Fmt<12> { static constexpr int E = 4, M = 7; };
template <> struct Fmt<16> { static constexpr int E = 5, M = 10; };
template <> struct Fmt<20> { static constexpr int E = 5, M = 14; };
template <> struct Fmt<24> { static constexpr int E = 6, M = 17; };
template <> struct Fmt<28> { static constexpr int E = 7, M = 20; };
template <> struct Fmt<32> { static constexpr int E = 8, M = 23; };

template <int BITS>
__device__ __forceinline__ uint32_t width_mask() {
  return BITS == 32 ? 0xFFFFFFFFu : ((1u << (BITS & 31)) - 1u);
}

// Code j (0..31) of the group whose first word is ``g``: bits
// [j*BITS, (j+1)*BITS) of the group, little-endian, possibly straddling
// two words.
template <int BITS>
__device__ __forceinline__ uint32_t extract_code(const uint32_t* g, int j) {
  if constexpr (BITS == 32) return g[j];
  const int s = j * BITS;
  const int w0 = s >> 5, off = s & 31;
  uint32_t lo = g[w0] >> off;
  // a width that divides 32 never straddles two words
  if constexpr (32 % BITS != 0) {
    if (off + BITS > 32) lo |= g[w0 + 1] << (32 - off);
  }
  return lo & width_mask<BITS>();
}

// Narrow float code -> f32, exact. NaN codes come out as the canonical
// quiet NaN (mantissa 1 << 22) with their sign, as decode_float does.
template <int BITS>
__device__ __forceinline__ float decode_float(uint32_t code) {
  if constexpr (BITS == 32) {
    return __uint_as_float(code);
  } else {
    constexpr int M = Fmt<BITS>::M;
    constexpr int MAXE = (1 << Fmt<BITS>::E) - 1;
    constexpr int BIAS = (1 << (Fmt<BITS>::E - 1)) - 1;
    const uint32_t sign = (code >> (BITS - 1)) & 1u;
    const uint32_t exp = (code >> M) & MAXE;
    const uint32_t man = code & ((1u << M) - 1u);
    if constexpr (BITS == 16) {
      // AF16 is IEEE half: the hardware conversion is exact for every code
      // but keeps NaN payloads, so NaN codes are canonicalised after it.
      if (exp == MAXE && man != 0) return __uint_as_float((sign << 31) | 0x7FC00000u);
      return __half2float(__ushort_as_half((unsigned short)code));
    }
    uint32_t e32, m32;
    if (exp == MAXE) {
      e32 = 255;
      m32 = man ? (1u << 22) : 0u;
    } else if (exp == 0) {
      if (man == 0) {
        e32 = 0;
        m32 = 0;
      } else {                       // subnormal: normalise on the leading one
        const int top = 31 - __clz(man);
        m32 = (man << (23 - top)) & 0x7FFFFFu;
        e32 = (uint32_t)((top - M) + (1 - BIAS) + 127);
      }
    } else {
      e32 = exp - BIAS + 127;
      m32 = man << (23 - M);
    }
    return __uint_as_float((sign << 31) | (e32 << 23) | m32);
  }
}

// Narrow float code -> f32 for arithmetic: decode_float's value for every
// code that is not a NaN, and a NaN (payload not canonicalised) for one
// that is. For sums and products, whose NaN results carry no payload of
// their inputs, this is decode_float; AF16 is one hardware conversion.
template <int BITS>
__device__ __forceinline__ float decode_value(uint32_t code) {
  if constexpr (BITS == 16) return __half2float(__ushort_as_half((unsigned short)code));
  else return decode_float<BITS>(code);
}

// f32 -> narrow float code: round to nearest even, subnormals on
// underflow, inf on overflow, NaN as mantissa 1 << (M-1), f32 subnormal
// inputs flushed to signed zero. Line for line formats.encode_float.
template <int BITS>
__device__ __forceinline__ uint32_t encode_float(float x) {
  const uint32_t u = __float_as_uint(x);
  if constexpr (BITS == 32) {
    return u;
  } else {
    constexpr int M = Fmt<BITS>::M;
    constexpr int MAXE = (1 << Fmt<BITS>::E) - 1;
    constexpr int BIAS = (1 << (Fmt<BITS>::E - 1)) - 1;
    constexpr int SHIFT = 23 - M;
    const uint32_t sign = u >> 31;
    const uint32_t exp = (u >> 23) & 0xFFu;
    const uint32_t man = u & 0x7FFFFFu;
    const int e_new = (int)exp - 127 + BIAS;

    // normal path
    uint32_t kept = man >> SHIFT;
    uint32_t round_bit = (man >> (SHIFT - 1)) & 1u;
    uint32_t sticky = (man & ((1u << (SHIFT - 1)) - 1u)) != 0u;
    const uint32_t man_rounded = kept + (round_bit & (sticky | (kept & 1u)));
    const uint32_t man_carry = man_rounded >> M;
    const int e_norm = e_new + (int)man_carry;
    const uint32_t man_norm = man_carry ? 0u : man_rounded;

    // subnormal path
    const uint32_t full = man | (1u << 23);
    int sub_shift = (1 - e_new) + SHIFT;
    sub_shift = sub_shift < 0 ? 0 : (sub_shift > 31 ? 31 : sub_shift);
    kept = full >> sub_shift;
    round_bit = sub_shift > 0 ? (full >> (sub_shift - 1)) & 1u : 0u;
    const uint32_t below_mask = sub_shift > 1 ? (1u << (sub_shift - 1)) - 1u : 0u;
    sticky = (full & below_mask) != 0u;
    uint32_t man_sub = kept + (round_bit & (sticky | (kept & 1u)));
    const uint32_t sub_to_norm = man_sub >> M;
    if (sub_to_norm) man_sub = 0u;

    const bool is_sub = e_new <= 0;
    int e_out = is_sub ? (int)sub_to_norm : e_norm;
    uint32_t man_out = is_sub ? man_sub : man_norm;
    if (e_out >= MAXE) {
      e_out = MAXE;
      man_out = 0u;
    }
    if (exp == 0xFFu) {
      e_out = MAXE;
      man_out = man ? (1u << (M - 1)) : 0u;
    }
    if (exp == 0u) {
      e_out = 0;
      man_out = 0u;
    }
    return (sign << (BITS - 1)) | ((uint32_t)e_out << M) | (man_out & ((1u << M) - 1u));
  }
}

// f32 -> AF16 code through the hardware conversion (cvt.rn.f16.f32):
// round to nearest even, half subnormals, inf from 65520 up, f32
// subnormals to signed zero, as encode_float<16> does; only its NaN
// (0x7FFF) differs, so a NaN input takes encode_float's sign | 0x7E00.
__device__ __forceinline__ uint32_t encode_af16(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return ((u >> 16) & 0x8000u) | 0x7E00u;
  return __half_as_ushort(__float2half_rn(x));
}

// encode_float's code, AF16 through the hardware conversion.
template <int BITS>
__device__ __forceinline__ uint32_t encode_code(float x) {
  if constexpr (BITS == 16) return encode_af16(x);
  else return encode_float<BITS>(x);
}

// Narrow integer code -> int32: zero extension, or sign extension.
template <int BITS>
__device__ __forceinline__ int32_t decode_int(uint32_t code, bool is_signed) {
  if (BITS == 32) return (int32_t)code;
  code &= width_mask<BITS>();
  if (!is_signed) return (int32_t)code;
  const uint32_t sbit = 1u << (BITS - 1);
  return (int32_t)(code ^ sbit) - (int32_t)sbit;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The power of two that decode8 leaves out of AF8 and AF12 values: their
// fields read as an f16, whose bias is 15, not 3 or 7.
template <int B>
constexpr float kScale = B == 8 ? 4096.f : (B == 12 ? 256.f : 1.f);

// Two f16 lanes of a word -> two floats (the hardware conversion, exact).
__device__ __forceinline__ float2 halves(uint32_t h) {
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}

// 8 consecutive codes that start at a word boundary (codes [8g, 8g + 8)
// of a group), held in the B / 4 words u, as floats over kScale<B>.
// Returns true when one of them has the all-ones exponent (inf or NaN),
// which this decode gets wrong for AF8 and AF12; AF16 NaNs keep their
// payload.
template <int B>
__device__ __forceinline__ bool decode8(const uint32_t (&u)[B / 4], float (&f)[8]) {
  if constexpr (B == 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = halves(u[i]);
      f[2 * i] = v.x, f[2 * i + 1] = v.y;
    }
    return false;
  } else if constexpr (B == 8) {
    // byte c of a word is a code: the f16 lanes of h02 take codes 0 and 2,
    // those of h13 codes 1 and 3, each its sign at bit 15 and its exponent
    // and mantissa at bits 6-12
    uint32_t ok = 0xFFFFFFFFu;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t w = u[i];
      const float2 a = halves(((w << 6) & 0x1FC01FC0u) | ((w << 8) & 0x80008000u));
      const float2 b = halves(((w >> 2) & 0x1FC01FC0u) | (w & 0x80008000u));
      f[4 * i] = a.x, f[4 * i + 1] = b.x, f[4 * i + 2] = a.y, f[4 * i + 3] = b.y;
      // bit 7 of a byte clears exactly when its exponent is all ones
      ok &= (w | 0x8F8F8F8Fu) + 0x01010101u;
    }
    return (ok & 0x80808080u) != 0x80808080u;
  } else {
    static_assert(B == 12, "decode8 takes AF8, AF12 and AF16");
    // code c at bits [12c, 12c + 12): p[i] holds codes 2i and 2i + 1 in
    // its 16-bit lanes, then each lane takes its sign at bit 15 and its
    // exponent and mantissa at bits 3-13
    uint32_t p[4];
    p[0] = (u[0] & 0xFFFu) | ((u[0] << 4) & 0x0FFF0000u);
    p[1] = (__funnelshift_r(u[0], u[1], 24) & 0xFFFu) | ((u[1] << 12) & 0x0FFF0000u);
    p[2] = ((u[1] >> 16) & 0xFFFu) | ((__funnelshift_r(u[1], u[2], 28) << 16) & 0x0FFF0000u);
    p[3] = ((u[2] >> 8) & 0xFFFu) | ((u[2] >> 4) & 0x0FFF0000u);
    uint32_t bad = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = halves(((p[i] << 4) & 0x80008000u) | ((p[i] << 3) & 0x3FF83FF8u));
      f[2 * i] = v.x, f[2 * i + 1] = v.y;
      // bit 12 of a lane sets exactly when its exponent is all ones
      bad |= (p[i] | 0x087F087Fu) + 0x00010001u;
    }
    return (bad & 0x10001000u) != 0;
  }
}

}  // namespace rt

// Width dispatch for the Table 3 float widths: runs BODY with a
// constexpr int B bound to ``bits``; an unknown width returns
// cudaErrorInvalidValue from the enclosing C entry point.
#define RT_FLOAT_WIDTHS(bits, BODY)                              \
  switch (bits) {                                                \
    case 8:  { constexpr int B = 8;  BODY; } break;              \
    case 12: { constexpr int B = 12; BODY; } break;              \
    case 16: { constexpr int B = 16; BODY; } break;              \
    case 20: { constexpr int B = 20; BODY; } break;              \
    case 24: { constexpr int B = 24; BODY; } break;              \
    case 28: { constexpr int B = 28; BODY; } break;              \
    case 32: { constexpr int B = 32; BODY; } break;              \
    default: return (int)cudaErrorInvalidValue;                  \
  }
