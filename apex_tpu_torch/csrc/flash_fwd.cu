// FlashAttention-2 forward for Hopper, with and without attention dropout.
//
// Replaces apex_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _fwd_pallas): B4 with dropout_rate == 0 (serving prefill, GPT training)
// and its dropout branch B4d (BERT pretraining).  Same function:
// s = q.k * scale + mask[key], causal on global positions, fp32 streaming
// softmax (running max m, normaliser l, accumulator acc), o = acc / l in
// q's dtype and lse = m + log(l) in fp32; a row that saw no live key (m
// never above NEG_INF / 2) gives zeros and lse = NEG_INF.  Dropout
// (kDropout, a template flag, so the rate-0 kernel is the code it was)
// drops the normalized probs: l and the lse take the undropped p, the
// accumulator keep ? p / (1 - rate) : 0, with the keep bit from
// apex::dropout_keep on the global (batch*head, q, key) coordinate, so a
// masked key (p = 0) contributes 0 whatever it keeps; the 5-int32 seed
// array is read from device memory and the divisor 1 - rate comes
// rounded to fp32 from the host.  The hash costs ~12 integer ops per
// score on each of the row's D/16 threads.  BERT-large trains at B = 32,
// H = 16, S = 128, non-causal: a 2 x 512 grid of blocks.
//
// Bound on the H100: operations.  Prefill runs B = 1, H = 12, D = 64,
// S up to 1024: ~4 * H * S^2 * D / 2 causal FLOPs against a few MB of
// q/k/v.  This first kernel computes in fp32 on the CUDA cores (no
// tensor cores), so its ceiling is the fp32 FMA rate, not the bf16
// tensor-core rate; wgmma/mma.sync is later work.  Design: the TPU's
// sequential k grid axis becomes a loop inside the block.  One block per
// (batch*head, 64-row q tile); each query row is owned by D/16 adjacent
// threads holding 16 interleaved dims of q and of the accumulator in
// registers, so a score is 16 FMAs plus a shuffle reduction.  K and V
// tiles are staged in shared memory as fp32 (one coalesced load per
// tile, read back as broadcasts without bank conflicts).  The softmax
// state is updated once per chunk of 16 keys, not per key.  Causal
// k tiles wholly past the q tile's last row are never loaded, and the
// ragged sequence tail is masked here (no padding by the wrapper).
// Operands are read in the JAX (B, S, H, D) layout through strides.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;     // query rows per block
constexpr int kDPT = 16;    // head dims per thread
constexpr int kChunk = 16;  // keys per softmax-state update

template <int D>
struct TileCfg {
  static constexpr int kTPR = D / kDPT;  // threads per query row
  static constexpr int kThreads = kBQ * kTPR;
  static constexpr int kBK = D <= 64 ? 64 : 32;  // keys per smem tile
};

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(TileCfg<D>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Sq,
                 int Sk, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                 int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                 int64_t o_sh, float scale, int causal,
                 const int* __restrict__ seed, float rate, float keep_div) {
  constexpr int TPR = TileCfg<D>::kTPR;
  constexpr int NT = TileCfg<D>::kThreads;
  constexpr int BK = TileCfg<D>::kBK;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  __shared__ float ms[BK];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR, part = tid % TPR;
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;

  float qv[kDPT], acc[kDPT];
  {
    const T* qrow = q + b * q_sb + static_cast<int64_t>(row_ok ? qi : 0) * q_ss
                    + h * q_sh;
#pragma unroll
    for (int i = 0; i < kDPT; ++i) {
      qv[i] = row_ok ? apex::to_float(qrow[part + TPR * i]) : 0.f;
      acc[i] = 0.f;
    }
  }
  float m = apex::kNegInf, l = 0.f;
  apex::DropoutCoords dc{};
  if constexpr (kDropout) dc = apex::dropout_coords(seed, b, h);

  // causal: keys past the tile's last query row are fully masked
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx % D, key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        kv = apex::to_float(kb[static_cast<int64_t>(key) * k_ss + d]);
        vv = apex::to_float(vb[static_cast<int64_t>(key) * v_ss + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    for (int j = tid; j < BK; j += NT) {
      const int key = k0 + j;
      ms[j] = (mask != nullptr && key < Sk)
                  ? mask[static_cast<int64_t>(b) * Sk + key] : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < BK; j0 += kChunk) {
      float s[kChunk];
      float cmax = apex::kNegInf;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c, key = k0 + j;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kDPT; ++i) dot += qv[i] * ks[j][part + TPR * i];
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        float sc = dot * scale + ms[j];
        if (key >= Sk || (causal && key > qi)) sc = apex::kNegInf;
        s[c] = sc;
        cmax = fmaxf(cmax, sc);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < kDPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = expf(s[c] - m_new);
        l += p;
        float pv = p;
        if constexpr (kDropout) {
          const bool keep = apex::dropout_keep(
              dc.seed, dc.bh, static_cast<uint32_t>(qi + dc.row_off),
              static_cast<uint32_t>(k0 + j0 + c + dc.col_off), rate);
          pv = keep ? p / keep_div : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kDPT; ++i) acc[i] += pv * vs[j0 + c][part + TPR * i];
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const bool valid = m > apex::kNegInf * 0.5f;
    const float lc = fmaxf(l, 1e-30f);
    T* orow = o + b * o_sb + static_cast<int64_t>(qi) * o_ss + h * o_sh;
#pragma unroll
    for (int i = 0; i < kDPT; ++i)
      orow[part + TPR * i] = apex::from_float<T>(valid ? acc[i] / lc : 0.f);
    if (part == 0)
      lse[static_cast<int64_t>(bh) * Sq + qi] =
          valid ? m + logf(lc) : apex::kNegInf;
  }
}

template <typename T, int D, bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* o, float* lse, int B, int H,
                   int Sq, int Sk, const int64_t* st, float scale, int causal,
                   const int* seed, float rate, float keep_div,
                   cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D, kDropout><<<grid, TileCfg<D>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, H, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal, seed, rate, keep_div);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const float* mask, void* o, float* lse, int B, int H,
                       int Sq, int Sk, const int64_t* st, float scale,
                       int causal, const int* seed, float rate,
                       float keep_div, cudaStream_t stream) {
  // head_dim 64 only: GPT-2 small/medium and BERT-base/large; another
  // head_dim is built when a configuration that needs it is ported
  if (D != 64) return cudaErrorInvalidValue;
  if (seed != nullptr && rate > 0.f)
    return launch<T, 64, true>(q, k, v, mask, o, lse, B, H, Sq, Sk, st,
                               scale, causal, seed, rate, keep_div, stream);
  return launch<T, 64, false>(q, k, v, mask, o, lse, B, H, Sq, Sk, st, scale,
                              causal, nullptr, 0.f, 1.f, stream);
}

}  // namespace

// q: (B, Sq, H, D), k/v: (B, Sk, H, D), o: (B, Sq, H, D), all in `dtype`
// with unit stride on D; strides[12] = (sb, ss, sh) for q, k, v, o in
// elements.  mask: (B, Sk) fp32 contiguous or null.  lse: (B, H, Sq) fp32.
// seed: the (5,) int32 seed array in device memory, or null; dropout runs
// when it is given and rate > 0, dividing kept probs by keep_div.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              const void* mask, void* o, void* lse, int B,
                              int H, int Sq, int Sk, int D,
                              const void* strides, float scale, int causal,
                              const void* seed, float rate, float keep_div,
                              int dtype, void* stream) {
  const int64_t* st = static_cast<const int64_t*>(strides);
  const float* mk = static_cast<const float*>(mask);
  float* ls = static_cast<float*>(lse);
  const int* sd = static_cast<const int*>(seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case apex::kFloat32:
      err = dispatch_d<float>(D, q, k, v, mk, o, ls, B, H, Sq, Sk, st, scale,
                              causal, sd, rate, keep_div, s);
      break;
    case apex::kBFloat16:
      err = dispatch_d<__nv_bfloat16>(D, q, k, v, mk, o, ls, B, H, Sq, Sk, st,
                                      scale, causal, sd, rate, keep_div, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
