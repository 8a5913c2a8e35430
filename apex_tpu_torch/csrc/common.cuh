// Helpers shared by the port's kernels: the dtype codes the Python
// wrappers pass, conversions to and from fp32, 16-byte vector loads and
// stores, warp reductions, and the attention-dropout keep-mask.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace apex {

// the flash / decode modules' NEG_INF (ops/flash_attention.py,
// ops/decode_attention.py); a row whose running max never rose above
// kNegInf / 2 saw no live key and is written as zeros
constexpr float kNegInf = -1e30f;

// must match apex_tpu_torch/_kernels/build.py::DTYPE_CODES
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// N elements of T moved as one vector: with sizeof(T) * N == 16 a load
// or store of a Pack from a 16-byte-aligned address is one 16-byte
// instruction (ld/st.global.v4), and with constant indices after
// unrolling its elements stay in registers
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, N>& v) {
  *reinterpret_cast<Pack<T, N>*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// N elements of W at p widened to fp32, read as vectors of at most 16
// bytes (p aligned to the vector: N * sizeof(W) bytes up to 16)
template <typename W, int N>
__device__ __forceinline__ void load_float(const W* p, float (&out)[N]) {
  constexpr int E = 16 / sizeof(W) < N ? 16 / sizeof(W) : N;
#pragma unroll
  for (int u = 0; u < N / E; ++u) {
    const Pack<W, E> pk = load_pack<W, E>(p + u * E);
#pragma unroll
    for (int e = 0; e < E; ++e) out[u * E + e] = to_float(pk.v[e]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The keep-mask of attention-probability dropout, bit for bit
// apex_tpu/ops/flash_attention.py::_dropout_keep (the murmur3 finalizer of
// the global coordinate and the step seed, top 24 bits as a uniform):
// uint32 arithmetic wraps as the TPU's does.  The one in-kernel mapping:
// the flash forward (B4d) and both backward kernels (B5d, B6d) call it
// with row = q + seed[1], col = key + seed[2] and
// bh = b * seed[4] + seed[3] + h, so they cannot drift apart.  `rate` is
// the drop probability as fp32; true = keep.
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh,
                                             uint32_t row, uint32_t col,
                                             float rate) {
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u) ^
               ((bh + 1u) * 0xC2B2AE3Du) ^ (seed * 0x27D4EB2Fu);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  // < 2^24, so int then float is exact (the JAX cast's route)
  const float u = static_cast<float>(static_cast<int>(x >> 8)) *
                  5.9604644775390625e-08f;  // 2^-24
  return u >= rate;
}

// The 5-int32 seed array [seed, row_off, col_off, head_off,
// num_heads_total] (ops/flash_attention.py::seed_array) read from device
// memory, resolved for one (batch, head): the hash's seed, the global
// batch*head index, and the row and column offsets.
struct DropoutCoords {
  uint32_t seed, bh;
  int row_off, col_off;
};

__device__ __forceinline__ DropoutCoords dropout_coords(const int* seed,
                                                        int b, int h) {
  DropoutCoords c;
  c.seed = static_cast<uint32_t>(seed[0]);
  c.row_off = seed[1];
  c.col_off = seed[2];
  c.bh = static_cast<uint32_t>(b * seed[4] + seed[3] + h);
  return c;
}

}  // namespace apex
