// Single-token (decode) attention over a gathered KV context, for Hopper.
//
// Replaces apex_tpu/ops/decode_attention.py::_decode_kernel (B7) and its
// int8 front ::_decode_kernel_q8 (B8), both launched by _decode_pallas
// and sharing _stream_step.  Same function: one query token per (batch,
// head) attends T cached positions, s = q.k * scale + bias[key] with an
// fp32 (B, T) additive bias, fp32 softmax, o = softmax(s) @ v in q's
// dtype; a row whose max score is not above NEG_INF / 2 gives zeros.
// B8 (template flag kQ8) reads int8 K/V and per-(b, t, h) fp32 scales
// and widens each element at the load exactly as dequantize_kv does,
// (float(x8) * scale) rounded to q's dtype, so on dequantized inputs B7
// and B8 compute the same bits; a block stages its (b, h) row of K and V
// scales in shared memory once, so each element's scale is a shared
// broadcast read, not a global load.
//
// Bound on the H100: bytes — every K and V element is read once and
// used for two FLOPs, so the floor is the K/V bytes (2 * B * T * H * D *
// itemsize, plus 8 * B * T * H scale bytes for B8) over 3.35 TB/s.
// Design: one block of 256 threads per (batch, head); the TPU's
// sequential k grid axis becomes loops inside the block.  Phase 1:
// each warp takes keys in turn (four at a time, loads issued before the
// reductions), lanes reading neighbouring head dims so each key's row is
// one coalesced read, and a shuffle sum gives the score, kept in shared
// memory (T floats; B8 also keeps its 2T scales there).  Phase 2: block
// max and sum of exp — an exact softmax over the score row instead of
// the TPU kernel's running (m, l, acc), the same function to fp32
// rounding.  Phase 3: thread
// (g, d) sums p_j * v[j, d] over every G-th key, coalesced along d, and
// the G partial sums meet in shared memory.  The ragged T tail needs no
// padding (the TPU wrapper pads T with zero scales): loops stop at T.
// K, V and the scales are read in the JAX (B, T, H, D) / (B, T, H)
// layouts through strides, so the gathered-and-concatenated context
// needs no copy.  With B * H = 96 blocks on 132 SMs the card is
// under-filled, and B8 loads one byte a lane; wider int8 loads and
// splitting T across blocks (flash-decoding) are later work.
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

// the K/V element type: q's dtype for B7, int8 for B8
template <typename T, bool kQ8>
struct KVType {
  using type = T;
};
template <typename T>
struct KVType<T, true> {
  using type = int8_t;
};

// one K/V element as the fp32 the dot products take; B8's widening is
// dequantize_kv's rule: one fp32 multiply, then the cast to q's dtype
template <typename T, bool kQ8>
__device__ __forceinline__ float widen(typename KVType<T, kQ8>::type x,
                                       float s) {
  if constexpr (kQ8) {
    return apex::to_float(apex::from_float<T>(static_cast<float>(x) * s));
  } else {
    return apex::to_float(x);
  }
}

// element strides: q (sb, sh), k (sb, st, sh), v (sb, st, sh), o (sb,
// sh), and for B8 k_scale (sb, st, sh), v_scale (sb, st, sh)
struct Strides {
  int64_t q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh;
  int64_t ks_sb, ks_st, ks_sh, vs_sb, vs_st, vs_sh;
};

template <typename T, int D, bool kQ8>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q,
                        const typename KVType<T, kQ8>::type* __restrict__ k,
                        const typename KVType<T, kQ8>::type* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const float* __restrict__ bias, T* __restrict__ o,
                        int H, int T_len, const Strides st, float scale) {
  using KV = typename KVType<T, kQ8>::type;
  constexpr int G = kThreads / D;          // key groups in phase 3
  constexpr int DPL = (D + 31) / 32;       // head dims per lane, phase 1
  extern __shared__ float smem[];
  float* q_s = smem;                       // D
  float* sc = q_s + D;                     // T_len scores, then probs
  float* red = sc + T_len;                 // kThreads partials
  float* ks_s = red + kThreads;            // B8: T_len K scales
  float* vs_s = ks_s + T_len;              // B8: T_len V scales

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int d = tid; d < D; d += kThreads)
    q_s[d] = apex::to_float(q[b * st.q_sb + h * st.q_sh + d]);
  if constexpr (kQ8) {  // the row's scales, staged once for both phases
    const float* ksb = k_scale + b * st.ks_sb + h * st.ks_sh;
    const float* vsb = v_scale + b * st.vs_sb + h * st.vs_sh;
    for (int j = tid; j < T_len; j += kThreads) {
      ks_s[j] = ksb[static_cast<int64_t>(j) * st.ks_st];
      vs_s[j] = vsb[static_cast<int64_t>(j) * st.vs_st];
    }
  }
  __syncthreads();

  // phase 1: scores
  const KV* kb = k + b * st.k_sb + h * st.k_sh;
  const float* brow = bias != nullptr ? bias + static_cast<int64_t>(b) * T_len
                                      : nullptr;
  for (int j0 = warp * kKeysPerWarp; j0 < T_len;
       j0 += kWarps * kKeysPerWarp) {
    float kv[kKeysPerWarp][DPL];
#pragma unroll
    for (int u = 0; u < kKeysPerWarp; ++u) {
      const int j = j0 + u;
      float ks = 1.f;
      if constexpr (kQ8) {
        if (j < T_len) ks = ks_s[j];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        kv[u][i] = (j < T_len && d < D)
                       ? widen<T, kQ8>(kb[static_cast<int64_t>(j) * st.k_st + d], ks)
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
  T* orow = o + b * st.o_sb + h * st.o_sh;
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
  const KV* vb = v + b * st.v_sb + h * st.v_sh + d;
  float a = 0.f;
#pragma unroll 8
  for (int j = g; j < T_len; j += G) {
    float vs = 1.f;
    if constexpr (kQ8) vs = vs_s[j];
    a += sc[j] * widen<T, kQ8>(vb[static_cast<int64_t>(j) * st.v_st], vs);
  }
  red[tid] = a;
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int gg = 1; gg < G; ++gg) a += red[gg * D + d];
    orow[d] = apex::from_float<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D, bool kQ8>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const float* bias, void* o, int B, int H, int T_len,
                   const Strides& st, float scale, cudaStream_t stream) {
  using KV = typename KVType<T, kQ8>::type;
  const size_t smem =
      sizeof(float) * (D + T_len + kThreads + (kQ8 ? 2 * T_len : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, D, kQ8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_attention_kernel<T, D, kQ8><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), k_scale, v_scale, bias, static_cast<T*>(o),
      H, T_len, st, scale);
  return cudaGetLastError();
}

template <bool kQ8>
cudaError_t dispatch(int dtype, int D, const void* q, const void* k,
                     const void* v, const float* k_scale,
                     const float* v_scale, const float* bias, void* o, int B,
                     int H, int T_len, const Strides& st, float scale,
                     cudaStream_t stream) {
  // head_dim 64 only: GPT-2 small and medium; another head_dim is built
  // when a configuration that needs it is ported
  if (D != 64) return cudaErrorInvalidValue;
  switch (dtype) {
    case apex::kFloat32:
      return launch<float, 64, kQ8>(q, k, v, k_scale, v_scale, bias, o, B, H,
                                    T_len, st, scale, stream);
    case apex::kBFloat16:
      return launch<__nv_bfloat16, 64, kQ8>(q, k, v, k_scale, v_scale, bias,
                                            o, B, H, T_len, st, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// B7. q: (B, 1, H, D), k/v: (B, T, H, D), o: (B, 1, H, D), all in
// `dtype` with unit stride on D.  strides[10] = q (sb, sh), k (sb, st,
// sh), v (sb, st, sh), o (sb, sh) in elements.  bias: (B, T) fp32
// contiguous or null.
extern "C" int apex_decode_attention(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* o, int B, int H, int T_len, int D,
                                     const void* strides, float scale,
                                     int dtype, void* stream) {
  const int64_t* s = static_cast<const int64_t*>(strides);
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                   s[9], 0, 0, 0, 0, 0, 0};
  return static_cast<int>(dispatch<false>(
      dtype, D, q, k, v, nullptr, nullptr, static_cast<const float*>(bias),
      o, B, H, T_len, st, scale, static_cast<cudaStream_t>(stream)));
}

// B8. As apex_decode_attention with int8 k/v and their fp32 scales
// k_scale/v_scale (B, T, H); strides[16] = the ten above, then k_scale
// (sb, st, sh) and v_scale (sb, st, sh) in elements.  q and o in
// `dtype` (fp32 or bf16), the compute dtype K/V widen to.
extern "C" int apex_decode_attention_q8(const void* q, const void* k,
                                        const void* v, const void* k_scale,
                                        const void* v_scale, const void* bias,
                                        void* o, int B, int H, int T_len,
                                        int D, const void* strides,
                                        float scale, int dtype,
                                        void* stream) {
  const int64_t* s = static_cast<const int64_t*>(strides);
  const Strides st{s[0],  s[1],  s[2],  s[3],  s[4],  s[5],  s[6],  s[7],
                   s[8],  s[9],  s[10], s[11], s[12], s[13], s[14], s[15]};
  return static_cast<int>(dispatch<true>(
      dtype, D, q, k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const float*>(bias), o,
      B, H, T_len, st, scale, static_cast<cudaStream_t>(stream)));
}
