// LayerNorm forward (B2) and backward (B3, below: dx, dgamma and dbeta)
// for Hopper.
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

// LayerNorm backward (B3): dx, and dgamma / dbeta fused in.
//
// Replaces apex_tpu/normalization/fused_layer_norm.py::_ln_bwd_kernel
// (launched by _ln_bwd_pallas) and the column sums its caller _fla_bwd
// leaves to XLA.  Per row, with dy' = dy * gamma (or dy without an
// affine step) and xhat = (x - mean) * invvar:
//   dx = invvar * (dy' - (sum(dy') + xhat * sum(dy' * xhat)) / n2)
// in fp32, written in x's dtype; and over the rows, in fp32,
//   dgamma = sum_rows dy * xhat,   dbeta = sum_rows dy,
// written in gamma's dtype.  The TPU kernel read an fp32 xhat its forward
// had stored and a dy' its caller had formed; here xhat is recomputed
// from x and the forward's fp32 mean/invvar and the gamma multiply is
// done in the kernel, so the only full-size reads are dy and x, and the
// only full-size write is dx.
//
// Bound on the H100: bytes.  BERT-large's step normalises (4096, 1024)
// rows and GPT-2 small's (8192, 768), bf16 under O2: read dy and x, write
// dx, 3 * 2 * n1 * n2 bytes (25 MB, 7.5 us at 3.35 TB/s).  Two launches
// from one entry point:
//  1. layer_norm_bwd_kernel (n2 % (16 / sizeof(T)) == 0, n2 <= 1024 and
//     16-byte-aligned rows): a persistent grid (as many blocks as fit on
//     the card at once), one warp per row, rows walked in a loop.  Lane l
//     owns the same 16-byte chunks l, l + 32, ... of every row it
//     handles (at most 32 elements), loads them with one 16-byte
//     instruction each, keeps its slice of dy and x in registers between
//     the two row sums and the dx pass (the row is read from device
//     memory once) and accumulates its columns' dy * xhat and dy across
//     all its rows in registers.  The warps then store their column
//     sums in shared memory, every thread adds a column's eight in warp
//     order, and the block writes one fp32 partial row of each: grid x
//     2 x n2 floats (132 blocks, 1 MB at BERT's shape, against 25 MB of
//     rows).  Any other n2 takes
//     layer_norm_bwd_generic_kernel: one block per row in a grid-stride
//     loop, thread t owning columns t, t + 256, ..., its column sums in
//     its own slots of the block's partial row in device memory.
//  2. layer_norm_bwd_colsum_kernel adds the partial rows column by
//     column in a fixed order (eight strided groups, then the groups in
//     order) and writes dgamma and dbeta.  It runs only when the weight
//     gradients are asked for, launched as a programmatic dependent of
//     the row kernel so that its launch overlaps the row kernel's tail.
// No float atomics: two launches on the same inputs give the same bits.
constexpr int kBwdWarps = 8;         // rows a block of the fast path holds
constexpr int kBwdMaxPerLane = 32;   // elements of a row a lane keeps
constexpr int kGenericThreads = 256;

template <typename T>
__global__ void __launch_bounds__(32 * kBwdWarps)
layer_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                      const float* __restrict__ mean,
                      const float* __restrict__ invvar,
                      const float* __restrict__ w, T* __restrict__ dx,
                      float* __restrict__ part, int n1, int n2) {
  constexpr int V = 16 / sizeof(T);          // elements a 16-byte chunk
  constexpr int NC = kBwdMaxPerLane / V;     // chunks a lane may own
  using P = apex::Pack<T, V>;
  extern __shared__ float col_s[];  // kBwdWarps x (dgamma, dbeta) x n2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nch = n2 / V;
  const float n = static_cast<float>(n2);
  float gacc[NC][V], bacc[NC][V];
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) gacc[i][e] = bacc[i][e] = 0.f;

  for (int row = blockIdx.x * kBwdWarps + warp; row < n1;
       row += gridDim.x * kBwdWarps) {
    const int64_t base = static_cast<int64_t>(row) * n2;
    P dyv[NC], xv[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int ci = lane + 32 * i;
      if (ci < nch) {
        dyv[i] = apex::load_pack<T, V>(dy + base + ci * V);
        xv[i] = apex::load_pack<T, V>(x + base + ci * V);
      }
    }
    const float mu = mean[row], iv = invvar[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int ci = lane + 32 * i;
      if (ci >= nch) continue;
      apex::Pack<float, 4> wv[V / 4 > 0 ? V / 4 : 1];
      if (w != nullptr) {
#pragma unroll
        for (int u = 0; u < V / 4; ++u)
          wv[u] = apex::load_pack<float, 4>(w + ci * V + 4 * u);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = apex::to_float(dyv[i].v[e]);
        const float dw = w != nullptr ? d * wv[e / 4].v[e % 4] : d;
        const float xh = (apex::to_float(xv[i].v[e]) - mu) * iv;
        s1 += dw;
        s2 += dw * xh;
        if (part != nullptr) {
          gacc[i][e] += d * xh;
          bacc[i][e] += d;
        }
      }
    }
    s1 = apex::warp_sum(s1);
    s2 = apex::warp_sum(s2);
    if (dx == nullptr) continue;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int ci = lane + 32 * i;
      if (ci >= nch) continue;
      apex::Pack<float, 4> wv[V / 4 > 0 ? V / 4 : 1];
      if (w != nullptr) {
#pragma unroll
        for (int u = 0; u < V / 4; ++u)
          wv[u] = apex::load_pack<float, 4>(w + ci * V + 4 * u);
      }
      P out;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = apex::to_float(dyv[i].v[e]);
        const float dw = w != nullptr ? d * wv[e / 4].v[e % 4] : d;
        const float xh = (apex::to_float(xv[i].v[e]) - mu) * iv;
        out.v[e] = apex::from_float<T>(iv * (dw - (s1 + xh * s2) / n));
      }
      apex::store_pack<T, V>(dx + base + ci * V, out);
    }
  }
  if (part == nullptr) return;
  // the block's column sums: each warp stores its own (16-byte stores),
  // then every thread adds a column's eight in warp order
  float* mine = col_s + warp * 2 * n2;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int ci = lane + 32 * i;
    if (ci >= nch) continue;
#pragma unroll
    for (int u = 0; u < V / 4; ++u) {
      apex::Pack<float, 4> gp, bp;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gp.v[e] = gacc[i][4 * u + e];
        bp.v[e] = bacc[i][4 * u + e];
      }
      apex::store_pack<float, 4>(mine + ci * V + 4 * u, gp);
      apex::store_pack<float, 4>(mine + n2 + ci * V + 4 * u, bp);
    }
  }
  __syncthreads();
  float* pb = part + static_cast<int64_t>(blockIdx.x) * 2 * n2;
  for (int i = threadIdx.x; i < 2 * n2; i += blockDim.x) {
    float t = col_s[i];
#pragma unroll
    for (int wp = 1; wp < kBwdWarps; ++wp) t += col_s[wp * 2 * n2 + i];
    pb[i] = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(kGenericThreads)
layer_norm_bwd_generic_kernel(const T* __restrict__ dy,
                              const T* __restrict__ x,
                              const float* __restrict__ mean,
                              const float* __restrict__ invvar,
                              const float* __restrict__ w,
                              T* __restrict__ dx, float* __restrict__ part,
                              int n1, int n2) {
  constexpr int kWarps = kGenericThreads / 32;
  __shared__ float red[2][kWarps];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float n = static_cast<float>(n2);
  float* pb = part != nullptr
                  ? part + static_cast<int64_t>(blockIdx.x) * 2 * n2
                  : nullptr;
  if (pb != nullptr)
    for (int i = tid; i < n2; i += kGenericThreads) pb[i] = pb[n2 + i] = 0.f;
  for (int row = blockIdx.x; row < n1; row += gridDim.x) {
    const int64_t base = static_cast<int64_t>(row) * n2;
    const T* dyr = dy + base;
    const T* xr = x + base;
    const float mu = mean[row], iv = invvar[row];
    float s1 = 0.f, s2 = 0.f;
    for (int i = tid; i < n2; i += kGenericThreads) {
      float d = apex::to_float(dyr[i]);
      if (w != nullptr) d *= w[i];
      const float xh = (apex::to_float(xr[i]) - mu) * iv;
      s1 += d;
      s2 += d * xh;
    }
    s1 = apex::warp_sum(s1);
    s2 = apex::warp_sum(s2);
    if (lane == 0) {
      red[0][warp] = s1;
      red[1][warp] = s2;
    }
    __syncthreads();
    s1 = s2 = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) {
      s1 += red[0][wp];
      s2 += red[1][wp];
    }
    __syncthreads();  // red is rewritten by the next row
    for (int i = tid; i < n2; i += kGenericThreads) {
      const float d = apex::to_float(dyr[i]);
      const float dw = w != nullptr ? d * w[i] : d;
      const float xh = (apex::to_float(xr[i]) - mu) * iv;
      if (dx != nullptr)
        dx[base + i] = apex::from_float<T>(iv * (dw - (s1 + xh * s2) / n));
      if (pb != nullptr) {
        pb[i] += d * xh;
        pb[n2 + i] += d;
      }
    }
  }
}

// dgamma (blockIdx.y 0) and dbeta (1) from the (parts, 2, n2) partial
// rows: 32 columns a block, eight row groups a column (group g adds rows
// g, g + 8, ...), then the groups in order
template <typename W>
__global__ void __launch_bounds__(256)
layer_norm_bwd_colsum_kernel(const float* __restrict__ part, int parts,
                             int n2, W* __restrict__ dgamma,
                             W* __restrict__ dbeta) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x % 32, grp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane, which = blockIdx.y;
  // wait for the row kernel (launched before this one as its programmatic
  // dependency) to finish and its partials to be visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float s = 0.f;
  if (col < n2) {
#pragma unroll 4
    for (int p = grp; p < parts; p += 8)
      s += part[(static_cast<int64_t>(p) * 2 + which) * n2 + col];
  }
  red[grp][lane] = s;
  __syncthreads();
  if (grp != 0 || col >= n2) return;
#pragma unroll
  for (int g = 1; g < 8; ++g) s += red[g][lane];
  (which == 0 ? dgamma : dbeta)[col] = apex::from_float<W>(s);
}

// the fast kernel's shared memory at the widest row (64 KB): every
// warp's column sums
constexpr size_t kFastSmemMax =
    sizeof(float) * kBwdWarps * 2 * 32 * kBwdMaxPerLane;

// blocks of the fast kernel resident on the card at once: its grid
template <typename T>
int fast_grid() {
  static int blocks = 0;
  if (blocks == 0) {
    cudaFuncSetAttribute(layer_norm_bwd_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kFastSmemMax));
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layer_norm_bwd_kernel<T>, 32 * kBwdWarps, kFastSmemMax);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

int generic_grid() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    blocks = 4 * sms;
  }
  return blocks;
}

template <typename T>
cudaError_t launch_bwd(const void* dy, const void* x, const float* mean,
                       const float* invvar, const float* w, void* dx,
                       float* part, int parts, void* dgamma, void* dbeta,
                       int w_dtype, int n1, int n2, int fast,
                       cudaStream_t s) {
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  if (fast) {
    fast_grid<T>();  // sets the kernel's shared-memory limit once
    layer_norm_bwd_kernel<T>
        <<<parts, 32 * kBwdWarps,
           part != nullptr ? sizeof(float) * kBwdWarps * 2 * n2 : 0, s>>>(
            dyt, xt, mean, invvar, w, dxt, part, n1, n2);
  } else {
    layer_norm_bwd_generic_kernel<T><<<parts, kGenericThreads, 0, s>>>(
        dyt, xt, mean, invvar, w, dxt, part, n1, n2);
  }
  if (part == nullptr) return cudaGetLastError();
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // launched while the row kernel drains (programmatic dependent
  // launch); it waits for the row kernel's partials before reading them
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n2 + 31) / 32, 2);
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  switch (w_dtype) {
    case apex::kFloat32:
      return cudaLaunchKernelEx(&cfg, layer_norm_bwd_colsum_kernel<float>,
                                static_cast<const float*>(part), parts, n2,
                                static_cast<float*>(dgamma),
                                static_cast<float*>(dbeta));
    case apex::kBFloat16:
      return cudaLaunchKernelEx(
          &cfg, layer_norm_bwd_colsum_kernel<__nv_bfloat16>,
          static_cast<const float*>(part), parts, n2,
          static_cast<__nv_bfloat16*>(dgamma),
          static_cast<__nv_bfloat16*>(dbeta));
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The partial rows the backward writes for (n1, n2) in `dtype`: the grid
// of the kernel it takes (`fast`: the 16-byte path), at most n1 rows'
// worth.  The wrapper allocates (parts, 2, n2) fp32 for them.
extern "C" int apex_layer_norm_bwd_parts(int n1, int n2, int dtype,
                                         int fast) {
  int grid = 0;
  if (!fast) {
    grid = generic_grid();
    // keep the generic path's partial rows within 16 MB
    const int cap = (4 << 20) / (2 * (n2 > 0 ? n2 : 1));
    grid = grid < cap ? grid : (cap > 0 ? cap : 1);
    return n1 < grid ? (n1 > 0 ? n1 : 1) : grid;
  }
  switch (dtype) {
    case apex::kFloat32:
      grid = fast_grid<float>();
      break;
    case apex::kBFloat16:
      grid = fast_grid<__nv_bfloat16>();
      break;
    default:
      return 1;
  }
  const int rows = (n1 + kBwdWarps - 1) / kBwdWarps;
  return rows < grid ? (rows > 0 ? rows : 1) : grid;
}

// dy, x, dx: (n1, n2) contiguous in `dtype` (dx null: no input gradient);
// mean, invvar: (n1,) fp32; w: (n2,) fp32 gamma or null (non-affine).
// part: (parts, 2, n2) fp32 scratch from apex_layer_norm_bwd_parts, or
// null for no weight gradients; dgamma, dbeta: (n2,) in `w_dtype`.
// `fast`: n2 a multiple of 16 / itemsize, n2 <= 1024, and dy, x, dx
// and w 16-byte aligned.
extern "C" int apex_layer_norm_bwd(const void* dy, const void* x,
                                   const void* mean, const void* invvar,
                                   const void* w, void* dx, void* part,
                                   int parts, void* dgamma, void* dbeta,
                                   int w_dtype, int n1, int n2, int fast,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(invvar);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(part);
  switch (dtype) {
    case apex::kFloat32:
      return static_cast<int>(launch_bwd<float>(
          dy, x, mf, iv, wf, dx, pf, parts, dgamma, dbeta, w_dtype, n1, n2,
          fast, s));
    case apex::kBFloat16:
      return static_cast<int>(launch_bwd<__nv_bfloat16>(
          dy, x, mf, iv, wf, dx, pf, parts, dgamma, dbeta, w_dtype, n1, n2,
          fast, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
