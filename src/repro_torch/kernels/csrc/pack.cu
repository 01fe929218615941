// pack: f32 or bf16 rows -> Table 3 codes -> group-of-32 packed words;
// and append_kv: one decode token's K and V rows of a layer packed and
// stored at their cache rows, dense or paged, in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/pack.py:pack
// (_pack_kernel), the Value Truncator write path, and, for append_kv,
// the program the reference traces around it for the KV append
// (repro/models/attention.py: update_kv_cache / append_kv_pool_row, a
// pack of the flat (B, Hkv * D) row, then dynamic_update_slice or a
// scatter at the page table's row).
//
// Bound on this card: at the shapes a decode tick gives them, neither
// bytes nor operations but the launch. A tick call packs 8 rows of 1,024
// or 2,048 values (32-64 KB, 15-29 ns of the card's byte rate) and costs
// about one launch; done eagerly, the KV append around it took ~12
// launches a layer (casts, the packs, the row index, index_put), which
// append_kv makes one. On a large operand
// (a weight leaf at load) pack is bound by bytes: 4 + bits / 8 (f32) or
// 2 + bits / 8 (bf16) bytes a value against ~40 integer operations.
//
// Design: one thread per output word, no shared memory and no barrier.
// The thread reads the (at most four) values whose codes overlap its word,
// encodes them (AF16 through the hardware conversion) and stores the
// word; a code that straddles two words is encoded by both threads. At
// AF8, AF16 and AF32, on rows of a multiple of 4 contiguous and aligned
// values, a thread instead packs 4 values (one vector load) into their
// B / 8 words (one store). The
// word's group and offset come from a division by the constant width; the
// row is blockIdx.y (pack) or (blockIdx.y, blockIdx.x) = (sequence, kv
// head) with K or V on blockIdx.z (append_kv), so a call is one short
// wave with 64-bit row offsets and no 64-bit division. bf16 input is
// widened in registers (a shift), exactly as Tensor.float() widens it.
// append_kv reads K and V through their strides (views straight from
// the projection) and reads its row index (kv_len, then the page table)
// on the card, first, so that those loads overlap the values' and the
// host never waits on them.
#include "codec.cuh"

namespace {

template <typename InT> __device__ __forceinline__ float load_f32(const InT* p);
template <> __device__ __forceinline__ float load_f32<float>(const float* p) { return __ldg(p); }
template <> __device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// Word wb (0 <= wb < B) of a group of 32 codes: bits [32 wb, 32 wb + 32).
// ``value(j)`` is the value of code j; codes at or past ``valid`` are the
// pad code 0.
template <int B, typename Value>
__device__ __forceinline__ uint32_t pack_word(int wb, int valid, Value value) {
  if constexpr (B == 32) {
    return wb < valid ? __float_as_uint(value(wb)) : 0u;
  } else {
    constexpr int KMAX = (32 + B - 1) / B + 1;   // codes that can overlap a word
    const int j_lo = (32 * wb) / B;
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int j = j_lo + k;
      const int s = j * B - 32 * wb;               // code j's first bit in this word
      if (s < 32 && j < 32 && j < valid) {
        const uint32_t c = rt::encode_code<B>(value(j));
        word |= s >= 0 ? c << s : c >> -s;         // s < 0: spills in from the previous word
      }
    }
    return word;
  }
}

constexpr int kPackThreads = 128;

template <int B, typename InT>
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const InT* __restrict__ x, uint32_t* __restrict__ out, long long rows, int n,
            int words) {
  const int w = blockIdx.x * kPackThreads + threadIdx.x;   // word of the row
  if (w >= words) return;
  const int g = w / B, wb = w - g * B;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const InT* xg = x + r * n + 32 * g;
    out[r * words + w] = pack_word<B>(wb, n - 32 * g, [&](int j) { return load_f32(xg + j); });
  }
}

// Four consecutive values: one 16-byte (f32) or 8-byte (bf16) load.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xFFFF0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xFFFF0000u);
}

// The codes of 4 consecutive values as the B / 8 words they fill (B
// divides 32), stored at o with one store.
template <int B>
__device__ __forceinline__ void store_quad(uint32_t* o, const uint32_t (&c)[4]) {
  static_assert(32 % B == 0, "codes of a quad fill whole words");
  if constexpr (B == 8) {
    *o = c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24);
  } else if constexpr (B == 16) {
    *reinterpret_cast<uint2*>(o) = make_uint2(c[0] | (c[1] << 16), c[2] | (c[3] << 16));
  } else {
    *reinterpret_cast<uint4*>(o) = make_uint4(c[0], c[1], c[2], c[3]);
  }
}

// The codes of the quad at p, or pad codes 0 when !valid.
template <int B, typename InT>
__device__ __forceinline__ void encode_quad(const InT* p, bool valid, uint32_t (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0u;
  if (valid) {
    float v[4];
    load4(p, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = rt::encode_code<B>(v[i]);
  }
}

// The widths whose codes never straddle a word (8, 16, 32), on rows with
// n % 4 == 0 from an aligned base: a thread packs 4 values into B / 8
// words with one load and one store. Quads past n (a ragged last group)
// write pad codes 0.
template <int B, typename InT>
__global__ void __launch_bounds__(kPackThreads)
pack4_kernel(const InT* __restrict__ x, uint32_t* __restrict__ out, long long rows, int n,
             int words) {
  const int q = blockIdx.x * kPackThreads + threadIdx.x;   // quad of the row
  if (q >= words * 8 / B) return;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    uint32_t c[4];
    encode_quad<B>(x + r * n + 4 * q, 4 * q < n, c);
    store_quad<B>(out + r * words + q * (B / 8), c);
  }
}

template <int B, typename InT>
void launch_pack(const void* x, void* out, long long rows, int n, int words, cudaStream_t s) {
  const unsigned grid_y = (unsigned)(rows < 65535 ? rows : 65535);
  if constexpr (32 % B == 0) {
    if (n % 4 == 0 && (size_t)x % 16 == 0) {
      const int quads = words * 8 / B;
      const dim3 grid((unsigned)((quads + kPackThreads - 1) / kPackThreads), grid_y);
      pack4_kernel<B, InT><<<grid, kPackThreads, 0, s>>>((const InT*)x, (uint32_t*)out, rows,
                                                         n, words);
      return;
    }
  }
  const dim3 grid((unsigned)((words + kPackThreads - 1) / kPackThreads), grid_y);
  pack_kernel<B, InT><<<grid, kPackThreads, 0, s>>>((const InT*)x, (uint32_t*)out, rows, n,
                                                    words);
}

struct Append {
  const void* src[2];            // K and V rows, (batch, hkv, d) through strides
  long long stride[2][3];        // in elements: sequence, head, value
  uint32_t* cache[2];            // (rows, hkv, w) int32 words, contiguous
  const int* kv_len;             // (batch,)
  const int* table;              // (batch, mp) page ids, or null for a dense cache
  int hkv, d, w;
  int seq;                       // dense: rows per sequence (S); paged: the page size
  int mp;                        // paged: table entries per sequence
  int pages;                     // paged: pool pages (P + 1), ids outside are not written
};

// Block (h, b, kv): head h of sequence b's new K (kv = 0) or V row. With
// QUAD (a width that divides 32, D % 4 == 0, values contiguous and
// 16-byte aligned) thread t packs values [4t, 4t + 4) into their B / 8
// words with one load and one store; else thread t packs word t of the
// head's W words.
template <int B, typename InT, bool QUAD>
__global__ void append_kernel(Append a) {
  const int h = blockIdx.x, b = blockIdx.y, kv = blockIdx.z, t = threadIdx.x;
  // the row the append names, first, so that its loads overlap the
  // values': clamp(kv_len, 0, S - 1) of a dense cache
  // (dynamic_update_slice clamps so); on a paged one the page the table
  // names for clamp(kv_len, 0, mp * page - 1). Several idle slots may
  // name one scrap-page row: which write lands there is not fixed, as in
  // the reference's scatter, and no live row is such a row.
  const int len = max(__ldg(a.kv_len + b), 0);
  long long row;
  bool in_pool = true;
  if (a.table == nullptr) {
    row = (long long)b * a.seq + min(len, a.seq - 1);
  } else {
    const int pos = min(len, a.mp * a.seq - 1);
    const int id = __ldg(a.table + (long long)b * a.mp + pos / a.seq);
    in_pool = id >= 0 && id < a.pages;
    row = (long long)id * a.seq + pos % a.seq;
  }
  const InT* src = (const InT*)a.src[kv] + b * a.stride[kv][0] + h * a.stride[kv][1];
  uint32_t* dst = a.cache[kv] + (row * a.hkv + h) * a.w;
  if constexpr (QUAD) {
    if (t >= a.w * 8 / B) return;
    uint32_t c[4];
    encode_quad<B>(src + 4 * t, 4 * t < a.d, c);
    if (in_pool) store_quad<B>(dst + t * (B / 8), c);
  } else {
    if (t >= a.w) return;
    const long long sd = a.stride[kv][2];
    const int g = t / B, wb = t - g * B;
    const InT* xg = src + 32 * g * sd;
    const uint32_t word =
        pack_word<B>(wb, a.d - 32 * g, [&](int j) { return load_f32(xg + j * sd); });
    if (in_pool) dst[t] = word;
  }
}

template <int B, typename InT>
void launch_append(const Append& a, int batch, cudaStream_t s) {
  const dim3 grid((unsigned)a.hkv, (unsigned)batch, 2);
  if constexpr (32 % B == 0) {
    bool quad = a.d % 4 == 0;
    for (int kv = 0; kv < 2; ++kv) {
      const long long bytes = (long long)sizeof(InT);
      quad = quad && a.stride[kv][2] == 1 && (size_t)a.src[kv] % 16 == 0 &&
             a.stride[kv][0] * bytes % 16 == 0 && a.stride[kv][1] * bytes % 16 == 0;
    }
    if (quad) {
      append_kernel<B, InT, true><<<grid, (a.w * 8 / B + 31) / 32 * 32, 0, s>>>(a);
      return;
    }
  }
  append_kernel<B, InT, false><<<grid, (a.w + 31) / 32 * 32, 0, s>>>(a);
}

}  // namespace

// x (rows, n) f32 (in_bf16 = 0) or bf16 (1); out (rows, ceil(n/32) *
// bits) int32 words.
extern "C" int rt_pack(const void* x, void* out, long long rows, int n, int bits, int in_bf16,
                       void* stream) {
  const int words = (n + 31) / 32 * bits;
  if (rows == 0 || words == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16) {
    RT_FLOAT_WIDTHS(bits, (launch_pack<B, __nv_bfloat16>(x, out, rows, n, words, s)));
  } else {
    RT_FLOAT_WIDTHS(bits, (launch_pack<B, float>(x, out, rows, n, words, s)));
  }
  return (int)cudaGetLastError();
}

// One layer's KV append: k, v (batch, hkv, d) f32 or bf16 with element
// strides (sb, sh, sd); k_cache, v_cache contiguous int32 words (rows,
// hkv, w) with w = ceil(d / 32) * bits and d % 32 == 0 or hkv == 1 (so
// packing each head alone gives the words of the flat (batch, hkv * d)
// row); kv_len (batch,) int32. Dense: table null and seq = S, rows =
// batch * S. Paged: table (batch, mp) int32, seq = the page size, pages
// = P + 1.
extern "C" int rt_append_kv(const void* k, long long k_sb, long long k_sh, long long k_sd,
                            const void* v, long long v_sb, long long v_sh, long long v_sd,
                            int in_bf16, void* k_cache, void* v_cache, const void* kv_len,
                            const void* table, int batch, int hkv, int d, int w, int seq,
                            int mp, int pages, int bits, void* stream) {
  if (batch == 0 || hkv == 0 || w == 0) return 0;
  if (w > 1024 || batch > 65535 || seq <= 0 || (table != nullptr && mp <= 0))
    return (int)cudaErrorInvalidValue;
  Append a{{k, v},
           {{k_sb, k_sh, k_sd}, {v_sb, v_sh, v_sd}},
           {(uint32_t*)k_cache, (uint32_t*)v_cache},
           (const int*)kv_len,
           (const int*)table,
           hkv, d, w, seq, mp, pages};
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16) {
    RT_FLOAT_WIDTHS(bits, (launch_append<B, __nv_bfloat16>(a, batch, s)));
  } else {
    RT_FLOAT_WIDTHS(bits, (launch_append<B, float>(a, batch, s)));
  }
  return (int)cudaGetLastError();
}
