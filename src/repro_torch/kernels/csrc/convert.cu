// convert / truncate: the standalone Value Converter and Truncator lanes.
//
// Replaces the Pallas TPU kernels repro/kernels/convert.py:convert
// (_convert_kernel) and truncate (_truncate_kernel), both launched
// through _elementwise_call.
//
// Bound on this card: bytes. convert reads one int32 code and writes one
// f32 per element, truncate reads one f32 (or bf16) and writes one int32
// code: 8 bytes per element for f32 input, against a few dozen integer
// operations.
//
// Design: an elementwise grid-stride loop over rt::decode_float<B> and
// rt::encode_float<B> (codec.cuh, shared with the other kernels, so the
// rounding lives in one place), consecutive threads on consecutive
// elements. Any shape: the wrapper passes the element count. Truncate
// widens bf16 input to f32 exactly, as the reference's
// ``.astype(jnp.float32)`` does.
#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

dim3 grid_for(long long numel) {
  const long long blocks = (numel + kThreads - 1) / kThreads;
  return dim3((unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks));
}

template <int B>
__global__ void convert_kernel(const uint32_t* __restrict__ code, float* __restrict__ out,
                               long long numel) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < numel; i += stride)
    out[i] = rt::decode_float<B>(code[i]);
}

template <int B, typename InT>
__global__ void truncate_kernel(const InT* __restrict__ x, uint32_t* __restrict__ out,
                                long long numel) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < numel; i += stride)
    out[i] = rt::encode_float<B>(rt::to_f32(x[i]));
}

template <int B>
void launch_convert(const void* code, void* out, long long numel, cudaStream_t s) {
  convert_kernel<B><<<grid_for(numel), kThreads, 0, s>>>((const uint32_t*)code, (float*)out,
                                                         numel);
}

template <int B, typename InT>
void launch_truncate(const void* x, void* out, long long numel, cudaStream_t s) {
  truncate_kernel<B, InT><<<grid_for(numel), kThreads, 0, s>>>((const InT*)x, (uint32_t*)out,
                                                               numel);
}

}  // namespace

// code (numel,) int32 codes -> out (numel,) float32.
extern "C" int rt_convert(const void* code, void* out, long long numel, int bits,
                          void* stream) {
  if (numel == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  RT_FLOAT_WIDTHS(bits, (launch_convert<B>(code, out, numel, s)));
  return (int)cudaGetLastError();
}

// x (numel,) float32 (in_dtype 0) or bfloat16 (in_dtype 1) -> out
// (numel,) int32 codes.
extern "C" int rt_truncate(const void* x, void* out, long long numel, int bits,
                           int in_dtype, void* stream) {
  if (in_dtype != 0 && in_dtype != 1) return (int)cudaErrorInvalidValue;
  if (numel == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == 0) {
    RT_FLOAT_WIDTHS(bits, (launch_truncate<B, float>(x, out, numel, s)));
  } else {
    RT_FLOAT_WIDTHS(bits, (launch_truncate<B, __nv_bfloat16>(x, out, numel, s)));
  }
  return (int)cudaGetLastError();
}
