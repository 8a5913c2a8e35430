// FusedAdam over flat fp32 buffers for Hopper.
//
// Replaces apex_tpu/optimizers/fused_adam.py::_adam_kernel (launched by
// _adam_flat_pallas).  Same function (_adam_math):
//   g      = grad / combined_scale
//   m'     = beta1 * m + (1 - beta1) * g
//   v'     = beta2 * v + (1 - beta2) * g * g
//   denom  = sqrt(v' + eps)  (eps inside)  |  sqrt(v') + eps  (outside)
//   p'     = p - step_size * (m' / denom + weight_decay * p)
// with p, m and v updated in place, and the amp skip-step select: keep
// the new values when keep > 0.5, else the old ones.  The seven scalars
// [step_size, beta1, beta2, eps, combined_scale, weight_decay, keep] are
// read from DEVICE memory (the TPU kernel took them in SMEM): the
// wrapper builds them with torch ops on the card, so neither the bias
// correction nor the overflow skip needs the host to see a value.
//
// Bound on the H100: bytes.  Each element reads p, m, v, g and writes
// p, m, v: 28 bytes for ~15 flops, far below the ~20 flops/byte at which
// the fp32 units would limit.  GPT-2 small's 124.4M parameters move
// 3.5 GB, ~1.04 ms at 3.35 TB/s.  Design: one grid-stride pass with
// 128-bit (float4) loads and stores, the buffer padded to a multiple of
// 128 elements by the wrapper so it divides by 4, a few blocks per SM to
// keep enough loads in flight.  The select is a where-select, never a
// blend: an overflowed g carries inf/nan and 0 * nan is nan.  keep is
// uniform over the launch, so a skipped step stores nothing at all:
// p, m and v keep their bits, and the step moves no bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kEpsInside>
__device__ __forceinline__ void adam_one(float& p, float& m, float& v,
                                         float g, float step_size,
                                         float beta1, float beta2, float eps,
                                         float combined_scale, float wd) {
  g = g / combined_scale;
  m = beta1 * m + (1.0f - beta1) * g;
  v = beta2 * v + (1.0f - beta2) * g * g;
  const float denom = kEpsInside ? sqrtf(v + eps) : sqrtf(v) + eps;
  p = p - step_size * (m / denom + wd * p);
}

template <bool kEpsInside>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(float4* __restrict__ p, float4* __restrict__ m,
                  float4* __restrict__ v, const float4* __restrict__ g,
                  const float* __restrict__ scalars, int64_t n4) {
  const float keep = scalars[6];
  if (!(keep > 0.5f)) return;  // skipped step: every old value stays
  const float step_size = scalars[0], beta1 = scalars[1], beta2 = scalars[2],
              eps = scalars[3], cs = scalars[4], wd = scalars[5];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n4; i += stride) {
    float4 pp = p[i], mm = m[i], vv = v[i];
    const float4 gg = g[i];
    adam_one<kEpsInside>(pp.x, mm.x, vv.x, gg.x, step_size, beta1, beta2, eps, cs, wd);
    adam_one<kEpsInside>(pp.y, mm.y, vv.y, gg.y, step_size, beta1, beta2, eps, cs, wd);
    adam_one<kEpsInside>(pp.z, mm.z, vv.z, gg.z, step_size, beta1, beta2, eps, cs, wd);
    adam_one<kEpsInside>(pp.w, mm.w, vv.w, gg.w, step_size, beta1, beta2, eps, cs, wd);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// p, m, v, g: (n,) fp32, 16-byte aligned, n a multiple of 4; p, m, v are
// updated in place.  scalars: 7 fp32 on the device (see above).
extern "C" int apex_fused_adam(void* p, void* m, void* v, const void* g,
                               const void* scalars, int64_t n,
                               int eps_inside_sqrt, void* stream) {
  if (n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n4 = n / 4;
  if (n4 == 0) return 0;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (n4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* p4 = static_cast<float4*>(p);
  float4* m4 = static_cast<float4*>(m);
  float4* v4 = static_cast<float4*>(v);
  const float4* g4 = static_cast<const float4*>(g);
  const float* sc = static_cast<const float*>(scalars);
  if (eps_inside_sqrt)
    fused_adam_kernel<true><<<blocks, kThreads, 0, s>>>(p4, m4, v4, g4, sc, n4);
  else
    fused_adam_kernel<false><<<blocks, kThreads, 0, s>>>(p4, m4, v4, g4, sc, n4);
  return static_cast<int>(cudaGetLastError());
}
