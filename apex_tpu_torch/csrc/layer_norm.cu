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
// which can recompute it from x, mean and invvar.  w and b are read in
// their own dtype (fp32, or bf16 as amp O2 keeps LayerNorm's params) and
// widened in registers, as the reference's affine step widens them
// inside XLA's fusion, so O2 launches no cast kernels for them.
//
// Bound on the H100: bytes, 2 * n1 * n2 * itemsize (x read, y written)
// at 3.35 TB/s.  The paths' rows are 768 (GPT-2 small) and 1024
// (BERT-large) wide: 8 rows at decode and up to 1024 at prefill (fp32),
// 8192 x 768 and 4096 x 1024 in a training step (bf16 under O2, 13-17 MB:
// 3.8-5.0 us).  At decode the bytes take 0.02 us, so there the bound is
// latency: the number of dependent round trips to memory.
//
// Fast path (n2 % (16 / itemsize) == 0, n2 <= 1024, x, y, w and b
// 16-byte aligned; every row the port's paths normalise):
// layer_norm_fwd_kernel, one warp a row.  Lane l owns the row's 16-byte
// chunks l, l + 32, ... (at most 32 elements).  The row's loads and then
// the lane's columns of w and b (held in registers for every row the
// warp takes) go out before the first add, so a row costs one round
// trip to memory.  The mean and the two-pass variance come from the
// registers (warp shuffles, no shared memory, no block barrier), and y
// goes out in 16-byte stores.  The grid is resident: one-warp blocks,
// no more than the card holds at once (8 rows land on 8 SMs), each warp
// walking rows with the next row's loads issued before this row's sums.
//
// Candidates timed on an H100 at 700 W (chip_smoke.py's B2 rows, with
// L2 warm and flushed; an empty launch reads 0.0049 ms there):
//  - one row a warp, its w and b loaded beside it (113-130 registers):
//    4096 x 1024 bf16 0.0093 ms warm, 0.0120 with L2 flushed; 8192 x
//    768 bf16 0.0117 / 0.0147.  Two rows a warp (153-181 registers) was
//    slower at every shape: fewer warps fit, and 4096 rows ran in two
//    waves that each waited out a full load latency;
//  - w and b loaded at the output pass instead (53-58 registers): twice
//    as slow at the training shapes, as those loads then missed L1
//    behind the streaming rows and sat on every warp's critical path;
//  - the resident grid (this design): 0.0093 / 0.0118 and 0.0111 /
//    0.0139, against 0.0109 / 0.0136 and 0.0146 / 0.0174 for the same
//    kernel launched one row a warp.  Blocks of 1, 2, 4 and 8 warps:
//    at 8-256 rows within 2% of each other; at 4096 x 1024 bf16
//    0.00934, 0.00931, 0.00941, 0.00976 ms warm and 0.01206, 0.01194,
//    0.01187, 0.01189 cold; at 8192 x 768 bf16 0.01130, 0.01133,
//    0.01130, 0.01274 warm and 0.01413, 0.01416, 0.01402, 0.01445
//    cold.  So one size serves every shape: one warp, which spreads a
//    few rows over as many SMs.
// Every other row (n2 = 7, 33 or 1001, a bf16 row of 100, wider than
// 1024, or a misaligned view) takes layer_norm_fwd_generic_kernel,
// the first version: one warp a row, four a block, lanes striding the
// row with scalar loads, which reads it three times (mean, variance,
// output).
#include "common.cuh"

namespace {

constexpr int kMaxPerLane = 32;     // elements of a row a lane keeps
constexpr int kFwdGenericWarps = 4;

template <typename T, int V, int NC>
__device__ __forceinline__ void load_row(const T* __restrict__ xr, int lane,
                                         int nch, apex::Pack<T, V> (&v)[NC]) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int ci = lane + 32 * i;
    if (ci < nch) v[i] = apex::load_pack<T, V>(xr + ci * V);
  }
}

// one warp a block
template <typename T, typename W>
__global__ void __launch_bounds__(32)
layer_norm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                      const W* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ invvar_out, int n1, int n2,
                      float eps) {
  constexpr int V = 16 / sizeof(T);     // elements a 16-byte chunk
  constexpr int NC = kMaxPerLane / V;   // chunks a lane may own
  using P = apex::Pack<T, V>;
  const int lane = threadIdx.x;
  const int stride = gridDim.x;  // warps in the grid
  int row = blockIdx.x;
  if (row >= n1) return;
  const int nch = n2 / V;
  const float n = static_cast<float>(n2);

  // the first row's loads, then the lane's columns of w and b (held for
  // every row the warp takes), all before the first add
  P xv[NC];
  load_row<T, V, NC>(x + static_cast<int64_t>(row) * n2, lane, nch, xv);
  float wv[NC][V], bv[NC][V];
  if (w != nullptr) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int ci = lane + 32 * i;
      if (ci < nch) {
        apex::load_float<W, V>(w + ci * V, wv[i]);
        apex::load_float<W, V>(b + ci * V, bv[i]);
      }
    }
  }

  for (; row < n1; row += stride) {
    // the warp's next row (a resident grid walks the rows) is loaded
    // before this row's sums
    P nx[NC];
    if (row + stride < n1)
      load_row<T, V, NC>(x + static_cast<int64_t>(row + stride) * n2, lane,
                         nch, nx);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (lane + 32 * i >= nch) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) s += apex::to_float(xv[i].v[e]);
    }
    const float mean = apex::warp_sum(s) / n;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (lane + 32 * i >= nch) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = apex::to_float(xv[i].v[e]) - mean;
        ss += d * d;
      }
    }
    const float invvar = rsqrtf(apex::warp_sum(ss) / n + eps);
    T* yr = y + static_cast<int64_t>(row) * n2;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int ci = lane + 32 * i;
      if (ci >= nch) continue;
      P out;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float v = (apex::to_float(xv[i].v[e]) - mean) * invvar;
        if (w != nullptr) v = v * wv[i][e] + bv[i][e];
        out.v[e] = apex::from_float<T>(v);
      }
      apex::store_pack<T, V>(yr + ci * V, out);
    }
    if (lane == 0) {
      mean_out[row] = mean;
      invvar_out[row] = invvar;
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) xv[i] = nx[i];
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(32 * kFwdGenericWarps)
layer_norm_fwd_generic_kernel(const T* __restrict__ x,
                              const W* __restrict__ w,
                              const W* __restrict__ b, T* __restrict__ y,
                              float* __restrict__ mean_out,
                              float* __restrict__ invvar_out, int n1, int n2,
                              float eps) {
  const int row = blockIdx.x * kFwdGenericWarps + threadIdx.x / 32;
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
    if (w != nullptr) v = v * apex::to_float(w[i]) + apex::to_float(b[i]);
    yr[i] = apex::from_float<T>(v);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    invvar_out[row] = invvar;
  }
}

// one-warp blocks of the fast kernel resident on the card at once
template <typename T, typename W>
int fwd_resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layer_norm_fwd_kernel<T, W>, 32, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <typename T, typename W>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* y,
                       float* mean, float* invvar, int n1, int n2, float eps,
                       int fast, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const W* wt = static_cast<const W*>(w);
  const W* bt = static_cast<const W*>(b);
  T* yt = static_cast<T*>(y);
  if (!fast) {
    layer_norm_fwd_generic_kernel<T, W>
        <<<(n1 + kFwdGenericWarps - 1) / kFwdGenericWarps,
           32 * kFwdGenericWarps, 0, s>>>(xt, wt, bt, yt, mean, invvar, n1,
                                          n2, eps);
    return cudaGetLastError();
  }
  const int cap = fwd_resident_blocks<T, W>();
  layer_norm_fwd_kernel<T, W><<<n1 < cap ? n1 : cap, 32, 0, s>>>(
      xt, wt, bt, yt, mean, invvar, n1, n2, eps);
  return cudaGetLastError();
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
// written in gamma's dtype.  gamma is read in its own dtype (fp32 or
// bf16) and widened in registers once for all the rows a warp takes, as
// in the forward.  The TPU kernel
// read an fp32 xhat its forward had stored and a dy' its caller had
// formed; here xhat is recomputed from x and the forward's fp32
// mean/invvar and the gamma multiply is done in the kernel, so the only
// full-size reads are dy and x, and the only full-size write is dx.
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
constexpr int kGenericThreads = 256;

template <typename T, typename W>
__global__ void __launch_bounds__(32 * kBwdWarps)
layer_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                      const float* __restrict__ mean,
                      const float* __restrict__ invvar,
                      const W* __restrict__ w, T* __restrict__ dx,
                      float* __restrict__ part, int n1, int n2) {
  constexpr int V = 16 / sizeof(T);          // elements a 16-byte chunk
  constexpr int NC = kMaxPerLane / V;        // chunks a lane may own
  using P = apex::Pack<T, V>;
  extern __shared__ float col_s[];  // kBwdWarps x (dgamma, dbeta) x n2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nch = n2 / V;
  const float n = static_cast<float>(n2);
  float gacc[NC][V], bacc[NC][V], wv[NC][V];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int e = 0; e < V; ++e) gacc[i][e] = bacc[i][e] = 0.f;
    // the lane's columns of gamma, the same in every row it takes
    if (w != nullptr && lane + 32 * i < nch)
      apex::load_float<W, V>(w + (lane + 32 * i) * V, wv[i]);
  }

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
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = apex::to_float(dyv[i].v[e]);
        const float dw = w != nullptr ? d * wv[i][e] : d;
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
      P out;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = apex::to_float(dyv[i].v[e]);
        const float dw = w != nullptr ? d * wv[i][e] : d;
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

template <typename T, typename W>
__global__ void __launch_bounds__(kGenericThreads)
layer_norm_bwd_generic_kernel(const T* __restrict__ dy,
                              const T* __restrict__ x,
                              const float* __restrict__ mean,
                              const float* __restrict__ invvar,
                              const W* __restrict__ w,
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
      if (w != nullptr) d *= apex::to_float(w[i]);
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
      const float dw = w != nullptr ? d * apex::to_float(w[i]) : d;
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
    sizeof(float) * kBwdWarps * 2 * 32 * kMaxPerLane;

// blocks of the fast kernel resident on the card at once: its grid
template <typename T, typename W>
int fast_grid() {
  static int blocks = 0;
  if (blocks == 0) {
    cudaFuncSetAttribute(layer_norm_bwd_kernel<T, W>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kFastSmemMax));
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layer_norm_bwd_kernel<T, W>, 32 * kBwdWarps, kFastSmemMax);
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

template <typename T, typename W>
cudaError_t launch_bwd(const void* dy, const void* x, const float* mean,
                       const float* invvar, const void* w, void* dx,
                       float* part, int parts, void* dgamma, void* dbeta,
                       int n1, int n2, int fast, cudaStream_t s) {
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  const W* wt = static_cast<const W*>(w);
  T* dxt = static_cast<T*>(dx);
  if (fast) {
    fast_grid<T, W>();  // sets the kernel's shared-memory limit once
    layer_norm_bwd_kernel<T, W>
        <<<parts, 32 * kBwdWarps,
           part != nullptr ? sizeof(float) * kBwdWarps * 2 * n2 : 0, s>>>(
            dyt, xt, mean, invvar, wt, dxt, part, n1, n2);
  } else {
    layer_norm_bwd_generic_kernel<T, W><<<parts, kGenericThreads, 0, s>>>(
        dyt, xt, mean, invvar, wt, dxt, part, n1, n2);
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
  return cudaLaunchKernelEx(&cfg, layer_norm_bwd_colsum_kernel<W>,
                            static_cast<const float*>(part), parts, n2,
                            static_cast<W*>(dgamma), static_cast<W*>(dbeta));
}

// f<T, W>(args...) for the (dtype, w_dtype) codes: x's type and the
// affine weights' (fp32 or bf16)
template <template <typename, typename> class F, typename... A>
cudaError_t dispatch(int dtype, int w_dtype, A... args) {
  const bool wf = w_dtype == apex::kFloat32;
  if (!wf && w_dtype != apex::kBFloat16) return cudaErrorInvalidValue;
  switch (dtype) {
    case apex::kFloat32:
      return wf ? F<float, float>::run(args...)
                : F<float, __nv_bfloat16>::run(args...);
    case apex::kBFloat16:
      return wf ? F<__nv_bfloat16, float>::run(args...)
                : F<__nv_bfloat16, __nv_bfloat16>::run(args...);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename W>
struct Fwd {
  template <typename... A>
  static cudaError_t run(A... args) {
    return launch_fwd<T, W>(args...);
  }
};

template <typename T, typename W>
struct Bwd {
  template <typename... A>
  static cudaError_t run(A... args) {
    return launch_bwd<T, W>(args...);
  }
};

template <typename T, typename W>
struct BwdGrid {
  static cudaError_t run(int* grid) {
    *grid = fast_grid<T, W>();
    return cudaSuccess;
  }
};

}  // namespace

// The partial rows the backward writes for (n1, n2) in `dtype` with a
// `w_dtype` weight: the grid of the kernel it takes (`fast`: the 16-byte
// path), at most n1 rows' worth.  The wrapper allocates (parts, 2, n2)
// fp32 for them.
extern "C" int apex_layer_norm_bwd_parts(int n1, int n2, int dtype,
                                         int w_dtype, int fast) {
  int grid = 0;
  if (!fast) {
    grid = generic_grid();
    // keep the generic path's partial rows within 16 MB
    const int cap = (4 << 20) / (2 * (n2 > 0 ? n2 : 1));
    grid = grid < cap ? grid : (cap > 0 ? cap : 1);
    return n1 < grid ? (n1 > 0 ? n1 : 1) : grid;
  }
  if (dispatch<BwdGrid>(dtype, w_dtype, &grid) != cudaSuccess) return 1;
  const int rows = (n1 + kBwdWarps - 1) / kBwdWarps;
  return rows < grid ? (rows > 0 ? rows : 1) : grid;
}

// dy, x, dx: (n1, n2) contiguous in `dtype` (dx null: no input gradient);
// mean, invvar: (n1,) fp32; w: (n2,) gamma in `w_dtype` (fp32 or bf16) or
// null (non-affine).  part: (parts, 2, n2) fp32 scratch from
// apex_layer_norm_bwd_parts, or null for no weight gradients; dgamma,
// dbeta: (n2,) in `w_dtype`.  `fast`: n2 a multiple of 16 / itemsize,
// n2 <= 1024, and dy, x, dx and w 16-byte aligned.
extern "C" int apex_layer_norm_bwd(const void* dy, const void* x,
                                   const void* mean, const void* invvar,
                                   const void* w, void* dx, void* part,
                                   int parts, void* dgamma, void* dbeta,
                                   int w_dtype, int n1, int n2, int fast,
                                   int dtype, void* stream) {
  return static_cast<int>(dispatch<Bwd>(
      dtype, w_dtype, dy, x, static_cast<const float*>(mean),
      static_cast<const float*>(invvar), w, dx, static_cast<float*>(part),
      parts, dgamma, dbeta, n1, n2, fast,
      static_cast<cudaStream_t>(stream)));
}

// x, y: (n1, n2) contiguous in `dtype`; w, b: (n2,) in `w_dtype` (fp32 or
// bf16) or both null (no affine step); mean, invvar: (n1,) fp32.
// `fast`: n2 a multiple of 16 / itemsize, n2 <= 1024, and x, y, w and b
// 16-byte aligned; it then launches one-warp blocks, no more than fit
// on the card at once, each warp walking rows.
extern "C" int apex_layer_norm_fwd(const void* x, const void* w,
                                   const void* b, void* y, void* mean,
                                   void* invvar, int n1, int n2, float eps,
                                   int dtype, int w_dtype, int fast,
                                   void* stream) {
  return static_cast<int>(dispatch<Fwd>(
      dtype, w_dtype, x, w, b, y, static_cast<float*>(mean),
      static_cast<float*>(invvar), n1, n2, eps, fast,
      static_cast<cudaStream_t>(stream)));
}
