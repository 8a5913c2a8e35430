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
//
// Each operation rounds on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn: never contracted into an FMA), in the order of
// the plain PyTorch version (fused_adam.py::_adam_plain), whose ops are
// one kernel each: so the kernel equals its plain version bit for bit,
// and the flat and multi-tensor forms below equal each other.
//
// The multi-tensor form (fused_adam_multi_kernel) replaces the same TPU
// kernel where the moments are not one flat buffer: FusedAdam's tree
// layout (one segment per leaf) and its grouped flat layout (one
// segment per param group's slice, whose starts flatten_grouped does
// not align).  One launch walks a device-resident chunk table, each
// chunk a piece of one segment (at most the wrapper's _CHUNK elements)
// with its four pointers, its length and its group, and reads the
// group's seven scalars from a (G, 7) array.  A chunk whose four pointers share one misalignment
// mod 16 bytes runs a scalar head up to the 16-byte boundary, the
// float4 body of the flat kernel, and a scalar tail; a chunk whose
// pointers differ runs scalar.  Every element goes through the same
// adam_one, so a segment's result is bit for bit the flat kernel's.
// Bound: the same 28 bytes an element; the table (48 bytes a chunk of
// up to 256 KB of each operand) adds < 0.1%.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // float4 of each operand in flight a thread

template <bool kEpsInside>
__device__ __forceinline__ void adam_one(float& p, float& m, float& v,
                                         float g, float step_size,
                                         float beta1, float beta2, float eps,
                                         float combined_scale, float wd) {
  g = __fdiv_rn(g, combined_scale);
  m = __fadd_rn(__fmul_rn(beta1, m), __fmul_rn(__fsub_rn(1.0f, beta1), g));
  v = __fadd_rn(__fmul_rn(beta2, v),
                __fmul_rn(__fmul_rn(__fsub_rn(1.0f, beta2), g), g));
  const float denom = kEpsInside ? __fsqrt_rn(__fadd_rn(v, eps))
                                 : __fadd_rn(__fsqrt_rn(v), eps);
  p = __fsub_rn(p, __fmul_rn(step_size, __fadd_rn(__fdiv_rn(m, denom),
                                                  __fmul_rn(wd, p))));
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

// one row of the chunk table (built by fused_adam.py::_chunk_table as
// int64 columns p, m, v, g, n, group)
struct AdamChunk {
  float* p;
  float* m;
  float* v;
  const float* g;
  int64_t n;
  int64_t group;
};

template <bool kEpsInside>
__device__ __forceinline__ void adam_scalar(const AdamChunk& c, int64_t i,
                                            const float* sc) {
  float p = c.p[i], m = c.m[i], v = c.v[i];
  adam_one<kEpsInside>(p, m, v, c.g[i], sc[0], sc[1], sc[2], sc[3], sc[4],
                       sc[5]);
  c.p[i] = p;
  c.m[i] = m;
  c.v[i] = v;
}

template <bool kEpsInside>
__global__ void __launch_bounds__(kThreads)
fused_adam_multi_kernel(const AdamChunk* __restrict__ chunks,
                        int64_t n_chunks, const float* __restrict__ scalars) {
  for (int64_t k = blockIdx.x; k < n_chunks; k += gridDim.x) {
    const AdamChunk c = chunks[k];
    const float* sc = scalars + 7 * c.group;
    if (!(sc[6] > 0.5f)) continue;  // this group's step is skipped
    const uintptr_t mis = reinterpret_cast<uintptr_t>(c.p) & 15u;
    const bool together =
        (reinterpret_cast<uintptr_t>(c.m) & 15u) == mis &&
        (reinterpret_cast<uintptr_t>(c.v) & 15u) == mis &&
        (reinterpret_cast<uintptr_t>(c.g) & 15u) == mis;
    int64_t head = together ? static_cast<int64_t>((16u - mis) & 15u) / 4
                            : c.n;
    if (head > c.n) head = c.n;
    const int64_t n4 = (c.n - head) / 4;
    for (int64_t i = threadIdx.x; i < head; i += blockDim.x)
      adam_scalar<kEpsInside>(c, i, sc);
    float4* p4 = reinterpret_cast<float4*>(c.p + head);
    float4* m4 = reinterpret_cast<float4*>(c.m + head);
    float4* v4 = reinterpret_cast<float4*>(c.v + head);
    const float4* g4 = reinterpret_cast<const float4*>(c.g + head);
    const float step_size = sc[0], beta1 = sc[1], beta2 = sc[2],
                eps = sc[3], cs = sc[4], wd = sc[5];
    // kUnroll float4 of each operand loaded before any is stored: the
    // table's pointers carry no __restrict__, so the compiler would not
    // hoist a later load above an earlier store by itself
    for (int64_t base = threadIdx.x; base < n4;
         base += kUnroll * blockDim.x) {
      float4 pp[kUnroll], mm[kUnroll], vv[kUnroll], gg[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * blockDim.x;
        if (i < n4) {
          pp[u] = p4[i];
          mm[u] = m4[i];
          vv[u] = v4[i];
          gg[u] = g4[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * blockDim.x;
        if (i < n4) {
          adam_one<kEpsInside>(pp[u].x, mm[u].x, vv[u].x, gg[u].x, step_size, beta1, beta2, eps, cs, wd);
          adam_one<kEpsInside>(pp[u].y, mm[u].y, vv[u].y, gg[u].y, step_size, beta1, beta2, eps, cs, wd);
          adam_one<kEpsInside>(pp[u].z, mm[u].z, vv[u].z, gg[u].z, step_size, beta1, beta2, eps, cs, wd);
          adam_one<kEpsInside>(pp[u].w, mm[u].w, vv[u].w, gg[u].w, step_size, beta1, beta2, eps, cs, wd);
          p4[i] = pp[u];
          m4[i] = mm[u];
          v4[i] = vv[u];
        }
      }
    }
    for (int64_t i = head + 4 * n4 + threadIdx.x; i < c.n; i += blockDim.x)
      adam_scalar<kEpsInside>(c, i, sc);
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

// chunks: (n_chunks,) AdamChunk rows on the device, each a piece of
// 4-byte-aligned fp32 p, m, v (updated in place) and g; scalars: (G, 7) fp32 on the device, row ``group`` for each chunk.
extern "C" int apex_fused_adam_multi(const void* chunks, int64_t n_chunks,
                                     const void* scalars,
                                     int eps_inside_sqrt, void* stream) {
  if (n_chunks <= 0) return 0;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int blocks = static_cast<int>(
      n_chunks < 8LL * sms ? n_chunks : 8LL * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AdamChunk* c = static_cast<const AdamChunk*>(chunks);
  const float* sc = static_cast<const float*>(scalars);
  if (eps_inside_sqrt)
    fused_adam_multi_kernel<true><<<blocks, kThreads, 0, s>>>(c, n_chunks, sc);
  else
    fused_adam_multi_kernel<false><<<blocks, kThreads, 0, s>>>(c, n_chunks, sc);
  return static_cast<int>(cudaGetLastError());
}
