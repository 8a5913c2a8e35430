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
// rounded to fp32 from the host.  Operands are read in the JAX
// (B, S, H, D) layout through strides; the ragged sequence tail is
// masked here (no padding by the wrapper).  head_dim 64 only.
//
// Two bodies, chosen by dtype in apex_flash_fwd:
//
// bf16: flash_fwd_kernel_wgmma, on the tensor cores.  Bound on the H100
// SXM: operations.  GPT-2 small's step (B 8, H 12, S 1024, causal) is
// 4 * D * B*H*S(S+1)/2 = 12.9 GFLOP, 0.0130 ms at 989 TFLOP/s dense bf16,
// against 50.7 MB of q, k, v, o and lse, 0.0151 ms at 3.35 TB/s (so the
// larger, the byte time, is the bound the kernels table states).  What
// held the first (CUDA-core) version back, and what this one does:
// - no tensor-core instruction (ceiling 67 TFLOP/s fp32): S = Q K^T and
//   O += P V are wgmma m64n64k16 bf16 -> fp32 (sm90_mma.cuh), four k16
//   steps each per 64-key tile;
// - every FMA read its K/V operand back from shared memory: wgmma reads
//   Q, K and V from 128-byte-swizzled shared memory through descriptors
//   (no bank conflicts, no per-element loads), and S, P and O stay in
//   registers: the softmax runs on the accumulator fragment (row max and
//   sum over a quad's four lanes), P is rounded to bf16 in registers and
//   fed back as the A operand of the second product (RS form, V read
//   MN-major with B's transpose bit);
// - 2-byte scalar loads serialized with compute: 16-byte cp.async into a
//   two-stage ring of K, V and key-mask tiles, the next tile loading
//   while this one computes (one barrier pair per tile);
// - causal q tiles launched light first: blockIdx.y is walked from the
//   last (heaviest) q tile down, with batch*head on blockIdx.x, so the
//   heaviest blocks of every head start first.
// A block owns 128 query rows of one batch*head: two warpgroups of 64
// rows sharing each K/V tile (48 KB of dynamic shared memory plus the
// mask ring).  Causal tiles past the block's last row are not loaded; a
// warpgroup skips a tile past its own last row; only tiles crossing the
// diagonal apply the causal mask (key > q on global positions), only
// the last one the tail (key >= Sk).  The softmax runs in base 2 (the
// scale folded by log2 e, 2^x on the SFU); the lse is written in natural
// log.  Under dropout each lane hashes its 32 keep bits of the tile
// while the tensor cores compute S, and a kept p is multiplied by
// 1 / (1 - rate).  P and the output are rounded to bf16 where the TPU's
// MXU and SDPA round them.
// Operands must meet the 16-byte rule (base and (b, s, h) strides in
// multiples of 16 bytes); the wrapper copies one that does not.
//
// fp32: flash_fwd_kernel, the first version, on the CUDA cores (no TF32:
// serving and the O0 checks compare fp32 against fp32 oracles).  The
// TPU's sequential k grid axis becomes a loop inside the block.  One
// block per (batch*head, 64-row q tile); each query row is owned by D/16
// adjacent threads holding 16 interleaved dims of q and of the
// accumulator in registers, so a score is 16 FMAs plus a shuffle
// reduction.  K and V tiles are staged in shared memory as fp32.  The
// softmax state is updated once per chunk of 16 keys, not per key.
// Causal k tiles wholly past the q tile's last row are never loaded.
#include "common.cuh"
#include "sm90_mma.cuh"

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

// -- bf16 on the tensor cores ------------------------------------------

namespace wg {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWG = 2;               // warpgroups per block, 64 rows each
constexpr int kBM = 64 * kWG;        // query rows per block
constexpr int kBN = 64;              // keys per streamed tile
constexpr int kThreads = 128 * kWG;
constexpr int kTile = kBN * 128;     // bytes of one K or V tile
constexpr int kQBytes = kBM * 128;
// Q | K[2] | V[2] | mask[2][kBN] fp32, behind 1024 bytes of alignment
// slack (the swizzle needs 1024-byte aligned tiles)
constexpr int kSmem = 1024 + kQBytes + 4 * kTile + 2 * kBN * 4;

struct Args {
  const bf16 *q, *k, *v;
  const float* mask;
  bf16* o;
  float* lse;
  int H, Sq, Sk;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
      o_sh;
  float scale_log2;  // scale * log2(e)
  int causal;
  const int* seed;
  float rate, inv_keep;  // the drop rate and 1 / (1 - rate)
};

template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel_wgmma(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sK = sQ + kQBytes;    // + stage * kTile
  const uint32_t sV = sK + 2 * kTile;
  const uint32_t sM = sV + 2 * kTile;  // + (stage * kBN + j) * 4
  const float* mask_s =
      reinterpret_cast<const float*>(smem_raw + (sM - raw));

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  // causal: the heaviest q tiles first
  const int tile = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * kBM;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int qw0 = q0 + 64 * wg;                 // the warpgroup's rows
  const int row0 = qw0 + 16 * warp + lane / 4;  // and row0 + 8: this thread's

  const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* kb = a.k + b * a.k_sb + h * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + h * a.v_sh;
  const float* mb = a.mask == nullptr ? nullptr
                                      : a.mask + static_cast<int64_t>(b) * a.Sk;

  // causal: keys past the block's last row are masked for all its rows
  const int k_end = a.causal ? min(a.Sk, q0 + kBM) : a.Sk;
  const int n_tiles = (k_end + kBN - 1) / kBN;

  auto load_kv = [&](int t, int stage) {
    const int k0 = t * kBN;
    for (int i = tid; i < kBN * 8; i += kThreads) {
      const int r = i / 8, c = i % 8, key = k0 + r;
      const bool ok = key < a.Sk;
      const int64_t kr = ok ? key : 0;
      sm90::cp_async16(sK + stage * kTile + sm90::sw128(r, c),
                       kb + kr * a.k_ss + 8 * c, ok);
      sm90::cp_async16(sV + stage * kTile + sm90::sw128(r, c),
                       vb + kr * a.v_ss + 8 * c, ok);
    }
    if (mb != nullptr && tid < kBN) {
      const int key = k0 + tid;
      const bool ok = key < a.Sk;
      sm90::cp_async4(sM + (stage * kBN + tid) * 4, mb + (ok ? key : 0), ok);
    }
  };

  for (int i = tid; i < kBM * 8; i += kThreads) {
    const int r = i / 8, c = i % 8, row = q0 + r;
    const bool ok = row < a.Sq;
    sm90::cp_async16(sQ + sm90::sw128(r, c),
                     qb + static_cast<int64_t>(ok ? row : 0) * a.q_ss + 8 * c,
                     ok);
  }
  if (n_tiles > 0) load_kv(0, 0);
  sm90::cp_async_commit();

  apex::DropoutCoords dc{};
  if constexpr (kDropout) dc = apex::dropout_coords(a.seed, b, h);

  float acc[32], s[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = s[r] = 0.f;
  float m[2] = {apex::kNegInf, apex::kNegInf};  // running max, base 2
  float l[2] = {0.f, 0.f};  // this lane's part of the normaliser
  const uint32_t sQw = sQ + wg * 64 * 128;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, stage ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // tile t (and Q) landed
    sm90::fence_proxy_async();
    __syncthreads();
    const int k0 = t * kBN;
    // a warpgroup-uniform branch: tiles past this warpgroup's last row
    // hold no live key for it
    if (!a.causal || k0 <= qw0 + 63) {
      sm90::fence_regs(s);
      sm90::wgmma_tile_ss(s, sQw, sK + stage * kTile);  // S = Q K^T
      sm90::wgmma_commit();
      // the tile's keep bits, hashed while S computes
      uint32_t keep = 0;
      if constexpr (kDropout)
        keep = sm90::keep_bits(dc, row0, k0, lane, a.rate);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      const bool diag = a.causal && k0 + kBN - 1 > qw0;
      const bool tail = k0 + kBN > a.Sk;
      const float* ms = mask_s + stage * kBN;
      float mx[2] = {apex::kNegInf, apex::kNegInf};
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int i = sm90::acc_row_half(r);
        const int col = sm90::acc_col(r, lane);
        float x = s[r] * a.scale_log2;
        if (mb != nullptr) x = fmaf(ms[col], kLog2e, x);
        if ((tail && k0 + col >= a.Sk) || (diag && k0 + col > row0 + 8 * i))
          x = apex::kNegInf;
        s[r] = x;
        mx[i] = fmaxf(mx[i], x);
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], sm90::quad_max(mx[i]));
        corr[i] = sm90::exp2_approx(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int i = sm90::acc_row_half(r);
        acc[r] *= corr[i];
        const float p = sm90::exp2_approx(s[r] - m[i]);
        l[i] += p;
        if constexpr (kDropout) s[r] = (keep >> r) & 1u ? p * a.inv_keep : 0.f;
        else s[r] = p;
      }
      uint32_t pa[4][4];
      sm90::acc_to_a(s, pa);
      sm90::fence_regs(acc);
      sm90::wgmma_tile_rs(acc, pa, sV + stage * kTile);  // O += P V
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    __syncthreads();  // the stage is consumed before tile t + 2 fills it
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const float lsum = sm90::quad_sum(l[i]);
    if (row >= a.Sq) continue;
    // m > NEG_INF / 2 in natural-log units
    const bool valid = m[i] > apex::kNegInf * 0.5f * kLog2e;
    const float lc = fmaxf(lsum, 1e-30f);
    bf16* orow = a.o + b * a.o_sb + static_cast<int64_t>(row) * a.o_ss +
                 h * a.o_sh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = 4 * j + 2 * i;
      const float x0 = valid ? acc[r] / lc : 0.f;
      const float x1 = valid ? acc[r + 1] / lc : 0.f;
      *reinterpret_cast<uint32_t*>(orow + sm90::acc_col(r, lane)) =
          sm90::pack_bf16(x0, x1);
    }
    if ((lane & 3) == 0)
      a.lse[static_cast<int64_t>(bh) * a.Sq + row] =
          valid ? m[i] * kLn2 + logf(lc) : apex::kNegInf;
  }
}

template <bool kDropout>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  static unsigned done = 0;
  cudaError_t err =
      sm90::allow_smem(flash_fwd_kernel_wgmma<kDropout>, kSmem, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, (a.Sq + kBM - 1) / kBM);
  flash_fwd_kernel_wgmma<kDropout><<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const float* mask, void* o, float* lse, int B, int H,
                     int Sq, int Sk, const int64_t* st, float scale,
                     int causal, const int* seed, float rate, float keep_div,
                     cudaStream_t stream) {
  if (D != 64) return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), mask, static_cast<bf16*>(o), lse,
               H, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
               st[7], st[8], st[9], st[10], st[11], scale * kLog2e, causal,
               seed, rate, 1.f / keep_div};
  if (seed != nullptr && rate > 0.f) return launch<true>(a, B, stream);
  return launch<false>(a, B, stream);
}

}  // namespace wg

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
      err = wg::dispatch(D, q, k, v, mk, o, ls, B, H, Sq, Sk, st, scale,
                         causal, sd, rate, keep_div, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// the bf16 kernel's dynamic shared memory in bytes (the build report)
extern "C" int apex_flash_fwd_wgmma_smem() { return wg::kSmem; }
