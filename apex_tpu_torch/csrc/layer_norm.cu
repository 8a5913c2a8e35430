// LayerNorm forward (B2) and input-gradient backward (B3, below) for
// Hopper.
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
// n1 is 8 (decode) to 1024 (the largest prefill bucket) when serving and
// 8192 in a training step (8 x 1024 tokens): a call moves at most ~25 MB
// and at decode is bound by its launch, not by the 3.35 TB/s of device
// memory.  Design: one warp per row, lanes
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

// LayerNorm backward, input gradient (B3).
//
// Replaces apex_tpu/normalization/fused_layer_norm.py::_ln_bwd_kernel
// (launched by _ln_bwd_pallas).  Per row, with dy' = dy * gamma (or dy
// without an affine step) and xhat = (x - mean) * invvar:
//   dx = invvar * (dy' - (sum(dy') + xhat * sum(dy' * xhat)) / n2)
// in fp32, written in x's dtype.  The TPU kernel read an fp32 xhat that
// its forward had stored and a dy' its caller had formed; here xhat is
// recomputed from x and the forward's fp32 mean/invvar (the forward
// stores no xhat) and the gamma multiply is done in the kernel, so the
// only full-size reads are dy and x.  dgamma and dbeta, column sums over
// the rows, stay in PyTorch as the JAX package left them to XLA.
//
// Bound on the H100: bytes.  A GPT-2 small training step normalises
// (8192, 768) rows: read dy and x, write dx, ~3 * itemsize * n1 * n2
// (38 MB in bf16, ~11 us at 3.35 TB/s).  Design: one warp per row as in
// the forward, lanes striding the row (coalesced), two sums reduced with
// shuffles in one pass, then a second pass that rereads the row from L1
// and writes dx.  No shared memory, no block barrier.
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
layer_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                      const float* __restrict__ mean,
                      const float* __restrict__ invvar,
                      const float* __restrict__ w, T* __restrict__ dx,
                      int n1, int n2) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n1) return;
  const int64_t base = static_cast<int64_t>(row) * n2;
  const T* dyr = dy + base;
  const T* xr = x + base;
  const float mu = mean[row], iv = invvar[row];

  float s1 = 0.f, s2 = 0.f;
  for (int i = lane; i < n2; i += 32) {
    float d = apex::to_float(dyr[i]);
    if (w != nullptr) d *= w[i];
    const float xh = (apex::to_float(xr[i]) - mu) * iv;
    s1 += d;
    s2 += d * xh;
  }
  s1 = apex::warp_sum(s1);
  s2 = apex::warp_sum(s2);
  const float n = static_cast<float>(n2);

  T* dxr = dx + base;
  for (int i = lane; i < n2; i += 32) {
    float d = apex::to_float(dyr[i]);
    if (w != nullptr) d *= w[i];
    const float xh = (apex::to_float(xr[i]) - mu) * iv;
    dxr[i] = apex::from_float<T>(iv * (d - (s1 + xh * s2) / n));
  }
}

}  // namespace

// dy, x, dx: (n1, n2) contiguous in `dtype`; mean, invvar: (n1,) fp32;
// w: (n2,) fp32 gamma or null (non-affine).
extern "C" int apex_layer_norm_bwd(const void* dy, const void* x,
                                   const void* mean, const void* invvar,
                                   const void* w, void* dx, int n1, int n2,
                                   int dtype, void* stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n1 + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(invvar);
  const float* wf = static_cast<const float*>(w);
  switch (dtype) {
    case apex::kFloat32:
      layer_norm_bwd_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(dy), static_cast<const float*>(x), mf, iv,
          wf, static_cast<float*>(dx), n1, n2);
      break;
    case apex::kBFloat16:
      layer_norm_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(dy),
          static_cast<const __nv_bfloat16*>(x), mf, iv, wf,
          static_cast<__nv_bfloat16*>(dx), n1, n2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

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
