// LayerNorm forward for Hopper.
//
// Replaces apex_tpu/normalization/fused_layer_norm.py::_ln_fwd_kernel
// (launched by _ln_fwd_pallas).  Per row of the (n1, n2) view: fp32
// mean, TWO-PASS biased variance (sum of (x - mean)^2, not
// E[x^2] - mean^2), invvar = rsqrt(var + eps).  The TPU kernel wrote an
// fp32 xhat and left the affine step to XLA; here the affine step is
// fused and the kernel writes y = xhat * w + b in x's dtype plus the
// fp32 mean and invvar.  The fp32 xhat round trip only fed the backward,
// which can recompute it from x, mean and invvar.
//
// Bound on the H100: bytes.  GPT-2 small normalises rows of 768, and
// n1 is 8 (decode) to 1024 (the largest prefill bucket), so one call
// moves at most a few MB and at decode is bound by its launch, not by
// the 3.35 TB/s of device memory.  Design: one warp per row, lanes
// striding the row so every load instruction reads 32 neighbouring
// elements, fp32 sums reduced with shuffles — no shared memory and no
// block barrier.  The row is read three times (mean, variance,
// output); the second and third reads hit L1.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ invvar_out, int n1, int n2,
                      float eps) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n1) return;  // the whole warp leaves together
  const T* xr = x + static_cast<int64_t>(row) * n2;
  const float n = static_cast<float>(n2);

  float s = 0.f;
  for (int i = lane; i < n2; i += 32) s += apex::to_float(xr[i]);
  const float mean = apex::warp_sum(s) / n;

  float ss = 0.f;
  for (int i = lane; i < n2; i += 32) {
    const float d = apex::to_float(xr[i]) - mean;
    ss += d * d;
  }
  const float var = apex::warp_sum(ss) / n;
  const float invvar = rsqrtf(var + eps);

  T* yr = y + static_cast<int64_t>(row) * n2;
  for (int i = lane; i < n2; i += 32) {
    float v = (apex::to_float(xr[i]) - mean) * invvar;
    if (w != nullptr) v = v * w[i] + b[i];
    yr[i] = apex::from_float<T>(v);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    invvar_out[row] = invvar;
  }
}

}  // namespace

// x, y: (n1, n2) contiguous in `dtype`; w, b: (n2,) fp32 or both null
// (no affine step); mean, invvar: (n1,) fp32.
extern "C" int apex_layer_norm_fwd(const void* x, const void* w,
                                   const void* b, void* y, void* mean,
                                   void* invvar, int n1, int n2, float eps,
                                   int dtype, void* stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n1 + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* mf = static_cast<float*>(mean);
  float* iv = static_cast<float*>(invvar);
  switch (dtype) {
    case apex::kFloat32:
      layer_norm_fwd_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(x), wf, bf, static_cast<float*>(y), mf,
          iv, n1, n2, eps);
      break;
    case apex::kBFloat16:
      layer_norm_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), wf, bf,
          static_cast<__nv_bfloat16*>(y), mf, iv, n1, n2, eps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
