// Single-token (decode) attention over a gathered KV context, for Hopper.
//
// Replaces apex_tpu/ops/decode_attention.py::_decode_kernel (launched by
// _decode_pallas, sharing _stream_step) without the int8 front.  Same
// function: one query token per (batch, head) attends T cached
// positions, s = q.k * scale + bias[key] with an fp32 (B, T) additive
// bias, fp32 softmax, o = softmax(s) @ v in q's dtype; a row whose max
// score is not above NEG_INF / 2 gives zeros.
//
// Bound on the H100: bytes — every K and V element is read once and
// used for two FLOPs, so the floor is 2 * B * T * H * D * itemsize over
// 3.35 TB/s.  Design: one block of 256 threads per (batch, head); the
// TPU's sequential k grid axis becomes loops inside the block.  Phase 1:
// each warp takes keys in turn (four at a time, loads issued before the
// reductions), lanes reading neighbouring head dims so each key's row is
// one coalesced read, and a shuffle sum gives the score, kept in shared
// memory (T floats).  Phase 2: block max and sum of exp — an exact
// softmax over the score row instead of the TPU kernel's running
// (m, l, acc), the same function to fp32 rounding.  Phase 3: thread
// (g, d) sums p_j * v[j, d] over every G-th key, coalesced along d, and
// the G partial sums meet in shared memory.  The ragged T tail needs no
// padding: loops stop at T.  K and V are read in the JAX (B, T, H, D)
// layout through strides, so no transpose copy is made.  With B * H = 96
// blocks on 132 SMs the card is under-filled; splitting T across blocks
// (flash-decoding) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerWarp = 4;

__device__ __forceinline__ float block_reduce(float v, float* red,
                                              bool take_max) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = take_max ? apex::warp_max(v) : apex::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = take_max ? -INFINITY : 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r = take_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red may be reused
  return r;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias, T* __restrict__ o,
                        int H, int T_len, int64_t q_sb, int64_t q_sh,
                        int64_t k_sb, int64_t k_st, int64_t k_sh,
                        int64_t v_sb, int64_t v_st, int64_t v_sh,
                        int64_t o_sb, int64_t o_sh, float scale) {
  constexpr int G = kThreads / D;          // key groups in phase 3
  constexpr int DPL = (D + 31) / 32;       // head dims per lane, phase 1
  extern __shared__ float smem[];
  float* q_s = smem;                       // D
  float* sc = q_s + D;                     // T_len scores, then probs
  float* red = sc + T_len;                 // kThreads partials

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int d = tid; d < D; d += kThreads)
    q_s[d] = apex::to_float(q[b * q_sb + h * q_sh + d]);
  __syncthreads();

  // phase 1: scores
  const T* kb = k + b * k_sb + h * k_sh;
  const float* brow = bias != nullptr ? bias + static_cast<int64_t>(b) * T_len
                                      : nullptr;
  for (int j0 = warp * kKeysPerWarp; j0 < T_len;
       j0 += kWarps * kKeysPerWarp) {
    float kv[kKeysPerWarp][DPL];
#pragma unroll
    for (int u = 0; u < kKeysPerWarp; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        kv[u][i] = (j < T_len && d < D)
                       ? apex::to_float(kb[static_cast<int64_t>(j) * k_st + d])
                       : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kKeysPerWarp; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) dot += q_s[d] * kv[u][i];
      }
      dot = apex::warp_sum(dot);
      const int j = j0 + u;
      if (lane == 0 && j < T_len)
        sc[j] = dot * scale + (brow != nullptr ? brow[j] : 0.f);
    }
  }
  __syncthreads();

  // phase 2: softmax over the score row
  float mx = -INFINITY;
  for (int j = tid; j < T_len; j += kThreads) mx = fmaxf(mx, sc[j]);
  mx = block_reduce(mx, red, true);
  T* orow = o + b * o_sb + h * o_sh;
  if (!(mx > apex::kNegInf * 0.5f)) {  // no live key: zeros
    for (int d = tid; d < D; d += kThreads) orow[d] = apex::from_float<T>(0.f);
    return;
  }
  float lsum = 0.f;
  for (int j = tid; j < T_len; j += kThreads) {
    const float p = expf(sc[j] - mx);
    sc[j] = p;
    lsum += p;
  }
  lsum = block_reduce(lsum, red, false);  // its barriers publish sc

  // phase 3: o = sum_j p_j v_j / l
  const int d = tid % D, g = tid / D;
  const T* vb = v + b * v_sb + h * v_sh + d;
  float a = 0.f;
#pragma unroll 8
  for (int j = g; j < T_len; j += G) a += sc[j] * apex::to_float(vb[static_cast<int64_t>(j) * v_st]);
  red[tid] = a;
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int gg = 1; gg < G; ++gg) a += red[gg * D + d];
    orow[d] = apex::from_float<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* o, int B, int H, int T_len,
                   const int64_t* st, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (D + T_len + kThreads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_attention_kernel<T, D><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), H, T_len, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const float* bias, void* o, int B, int H, int T_len,
                       const int64_t* st, float scale, cudaStream_t stream) {
  // head_dim 64 only: GPT-2 small and medium; another head_dim is built
  // when a configuration that needs it is ported
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, bias, o, B, H, T_len, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, 1, H, D), k/v: (B, T, H, D), o: (B, 1, H, D), all in `dtype`
// with unit stride on D.  strides[10] = q (sb, sh), k (sb, st, sh),
// v (sb, st, sh), o (sb, sh) in elements.  bias: (B, T) fp32 contiguous
// or null.
extern "C" int apex_decode_attention(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* o, int B, int H, int T_len, int D,
                                     const void* strides, float scale,
                                     int dtype, void* stream) {
  const int64_t* st = static_cast<const int64_t*>(strides);
  const float* bs = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case apex::kFloat32:
      err = dispatch_d<float>(D, q, k, v, bs, o, B, H, T_len, st, scale, s);
      break;
    case apex::kBFloat16:
      err = dispatch_d<__nv_bfloat16>(D, q, k, v, bs, o, B, H, T_len, st, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
