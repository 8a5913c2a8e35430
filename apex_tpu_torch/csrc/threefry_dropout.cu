// Dropout on JAX's threefry stream for Hopper: flax's nn.Dropout, bit for
// bit, in one pass.
//
// No TPU kernel of the JAX package does this: there BERT's hidden dropout
// (after the embedding LayerNorm, on the attention output, on the MLP
// output) is flax's nn.Dropout, plain jnp that XLA fuses.  The port needs
// the same bits for the same key (apex_tpu_torch/ops/threefry.py derives
// the key from flax's scope path and call count on the host), and its
// plain version, threefry's 20 rounds as int64 tensor operations, would
// be ~170 elementwise launches a call.  Same function as
// flax.linen.Dropout with jax_threefry_partitionable (JAX 0.9):
//   bits  = w0 ^ w1 of threefry2x32(key, (i >> 32, i mod 2^32))
//           for the row-major index i of the element;
//   u     = float((bits >> 9) | 0x3f800000) - 1        (uniform [0, 1));
//   keep  = u < keep_prob                               (fp32 compare);
//   y     = keep ? x / divisor : 0, in x's dtype,
// where keep_prob is 1 - rate rounded to fp32 and divisor is 1 - rate
// rounded to x's dtype (JAX types a Python float divisor as the array),
// the division done in fp32 and rounded once to x's dtype.  The gradient
// is the same launch on dy with the same key (dropout is linear in x).
//
// Bound on the H100: its 32-bit integer instructions, not its bytes.  The
// loop issues 79 of them an element in bf16 and 78 in fp32 (counted in
// the built SASS by chip_smoke.py's threefry_int_ops: threefry's adds,
// funnel-shift rotates and xors, with some key-injection adds folded
// into three-input adds, plus the loop's index, address and compare
// arithmetic), at 64 a clock an SM (the CUDA programming guide's rate
// for compute capability 9.0): BERT-large's 32 x 128 x 1024 bf16
// activation takes 0.0198 ms at 1.98 GHz, against 0.0050 ms for its
// 16.8 MB of bytes (x read once, y written once) at 3.35 TB/s.  Design:
// a grid-stride loop, one element a thread per step, the key schedule
// in registers, rotations as funnel shifts, all 20 rounds unrolled;
// loads and stores are coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// four rounds of threefry2x32 with the rotation set of block i % 2
template <int kSet>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x0 += x1;
    x1 = rotl(x1, kRot[kSet][j]) ^ x0;
  }
}

// the XOR of the two output words of threefry2x32(key, (x0, x1))
// (jax/_src/prng.py::_threefry2x32_lowering, unrolled)
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  rounds<0>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  rounds<1>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  rounds<0>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  rounds<1>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  rounds<0>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return x0 ^ x1;
}

// kWindow: x is a window of a larger tensor's stream (module note at
// the entry point); without it the loop is the whole stream's, as
// before windows existed
template <typename T, bool kWindow>
__global__ void __launch_bounds__(kThreads)
threefry_dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                        int64_t n, uint32_t k0, uint32_t k1, float keep_prob,
                        float divisor, int64_t row, int64_t row_stride,
                        int64_t base) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    // element i of a window of the stream: rows of `row` counters
    // `row_stride` apart from `base`
    const int64_t c = kWindow ? base + (i / row) * row_stride + i % row : i;
    const uint32_t bits =
        threefry_bits(k0, k1, static_cast<uint32_t>(c >> 32),
                      static_cast<uint32_t>(c));
    const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    y[i] = u < keep_prob ? apex::from_float<T>(apex::to_float(x[i]) / divisor)
                         : apex::from_float<T>(0.0f);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int64_t n, uint32_t k0,
                   uint32_t k1, float keep_prob, float divisor, int64_t row,
                   int64_t row_stride, int64_t base, cudaStream_t stream) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  if (row == n && base == 0) {
    threefry_dropout_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n, k0, k1, keep_prob,
        divisor, row, row_stride, base);
  } else {
    threefry_dropout_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n, k0, k1, keep_prob,
        divisor, row, row_stride, base);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: (n,) contiguous in `dtype` (float32 or bfloat16); (k0, k1): the
// threefry key; keep_prob: 1 - rate in fp32; divisor: 1 - rate rounded
// to `dtype`, as a float; element i draws stream counter
// base + (i / row) * row_stride + i % row (row == n and base 0: counter
// i), so a slice of a larger tensor draws what the whole tensor's call
// draws there.
extern "C" int apex_threefry_dropout(const void* x, void* y, int64_t n,
                                     uint32_t k0, uint32_t k1,
                                     float keep_prob, float divisor,
                                     int64_t row, int64_t row_stride,
                                     int64_t base, int dtype, void* stream) {
  if (n <= 0) return 0;
  if (row <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case apex::kFloat32:
      return static_cast<int>(launch<float>(
          x, y, n, k0, k1, keep_prob, divisor, row, row_stride, base, s));
    case apex::kBFloat16:
      return static_cast<int>(launch<__nv_bfloat16>(
          x, y, n, k0, k1, keep_prob, divisor, row, row_stride, base, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
