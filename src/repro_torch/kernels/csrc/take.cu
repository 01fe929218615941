// take_rows: gather rows of a packed table by index and decode only them.
//
// Replaces the Pallas TPU kernel repro/kernels/take.py:take_rows
// (_take_kernel), the packed ``embed`` path.
//
// Bound on this card: bytes. A decode tick gathers one row per slot out
// of a 151936-row table; the work is the gathered rows' packed words in
// and the decoded rows out, a few microseconds of traffic, so in
// practice the launch itself is the cost.
//
// Design: one block per gathered row. The block reads its index itself
// (the TPU kernel prefetched it as a scalar), clamps it into the table,
// and its threads walk the row's codes with consecutive threads on
// consecutive codes, so each warp reads one group's ``bits`` words.
// Indices may repeat and come in any order. Float kind decodes through
// rt::decode_float; int kind sign- or zero-extends (rt::decode_int).
#include "codec.cuh"

namespace {

template <int B, bool FLOAT_KIND, typename OutT, typename IdxT>
__global__ void take_kernel(const uint32_t* __restrict__ table, const IdxT* __restrict__ idx,
                            OutT* __restrict__ out, long long rows, int words, int n,
                            bool is_signed) {
  long long r = (long long)idx[blockIdx.x];
  r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
  const uint32_t* row = table + r * words;
  OutT* o = out + (long long)blockIdx.x * n;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const uint32_t code = rt::extract_code<B>(row + (c >> 5) * B, c & 31);
    if constexpr (FLOAT_KIND) {
      o[c] = rt::from_f32<OutT>(rt::decode_float<B>(code));
    } else {
      o[c] = (OutT)rt::decode_int<B>(code, is_signed);
    }
  }
}

// out_kind: 0 float32, 1 bfloat16, 2 int32 (int kind only)
template <int B, bool FLOAT_KIND, typename IdxT>
int launch(const void* table, const void* idx, void* out, int out_kind, long long rows,
           int words, int count, int n, bool is_signed, cudaStream_t s) {
  const int threads = 256;
  const uint32_t* t = (const uint32_t*)table;
  const IdxT* ix = (const IdxT*)idx;
  if (out_kind == 0) {
    take_kernel<B, FLOAT_KIND, float, IdxT><<<count, threads, 0, s>>>(
        t, ix, (float*)out, rows, words, n, is_signed);
    return 0;
  }
  if constexpr (FLOAT_KIND) {
    if (out_kind == 1) {
      take_kernel<B, true, __nv_bfloat16, IdxT><<<count, threads, 0, s>>>(
          t, ix, (__nv_bfloat16*)out, rows, words, n, is_signed);
      return 0;
    }
  } else {
    if (out_kind == 2) {
      take_kernel<B, false, int32_t, IdxT><<<count, threads, 0, s>>>(
          t, ix, (int32_t*)out, rows, words, n, is_signed);
      return 0;
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename IdxT>
int dispatch(const void* table, const void* idx, void* out, int out_kind, long long rows,
             int words, int count, int n, int bits, int int_kind, int is_signed,
             cudaStream_t s) {
#define RT_TAKE(BB, FK) \
  return launch<BB, FK, IdxT>(table, idx, out, out_kind, rows, words, count, n, is_signed != 0, s)
  if (!int_kind) {
    switch (bits) {
      case 8: RT_TAKE(8, true);
      case 12: RT_TAKE(12, true);
      case 16: RT_TAKE(16, true);
      case 20: RT_TAKE(20, true);
      case 24: RT_TAKE(24, true);
      case 28: RT_TAKE(28, true);
      case 32: RT_TAKE(32, true);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (bits) {
    case 4: RT_TAKE(4, false);
    case 8: RT_TAKE(8, false);
    case 12: RT_TAKE(12, false);
    case 16: RT_TAKE(16, false);
    case 20: RT_TAKE(20, false);
    case 24: RT_TAKE(24, false);
    case 28: RT_TAKE(28, false);
    case 32: RT_TAKE(32, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RT_TAKE
}

}  // namespace

extern "C" int rt_take_rows(const void* table, const void* idx, int idx_is_64, void* out,
                            int out_kind, long long rows, int words, int count, int n,
                            int bits, int int_kind, int is_signed, void* stream) {
  if (count == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = idx_is_64
      ? dispatch<long long>(table, idx, out, out_kind, rows, words, count, n, bits, int_kind,
                            is_signed, s)
      : dispatch<int32_t>(table, idx, out, out_kind, rows, words, count, n, bits, int_kind,
                          is_signed, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
