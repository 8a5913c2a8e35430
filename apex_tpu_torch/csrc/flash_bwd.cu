// FlashAttention-2 backward for Hopper: dq (B5) and dk/dv (B6), two
// kernels as in the JAX package, so each output is owned by one block and
// needs no atomics (the result is deterministic), each with its dropout
// branch (B5d, B6d).
//
// Replaces apex_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (both launched by _bwd_pallas): dropout_rate == 0 for
// GPT training (examples/gpt/main_amp.py runs deterministic=True) and the
// dropout branch for BERT pretraining.  Same function: p is recomputed
// from the saved fp32 lse as p = exp(q.k * scale + mask[key] - lse),
// causal on global positions, with p = 0 on a row whose lse is NEG_INF (a
// fully-masked row: its s and lse would both be NEG_INF and exp(0) = 1,
// _recompute_p);
//   ds = p * (do.v - delta)         delta = rowsum(do * o) (- dlse)
//   dq = sum_k ds k * scale         (B5, q-major)
//   dv = sum_q p do,  dk = sum_q ds q * scale   (B6, k-major)
// delta comes from the wrapper (one PyTorch row sum).  With dropout
// (kDropout, a template flag: the rate-0 kernels are the code they were)
// the keep bit of apex::dropout_keep, on the same global coordinate as the
// forward's, scales do.v to keep ? do.v / (1 - rate) : 0 in ds, and dv
// takes the dropped p (keep ? p / (1 - rate) : 0); delta is unchanged
// because o already carries the dropout.  Ragged tails and the key mask
// are handled in the kernels, and operands are read in the JAX
// (B, S, H, D) layout through strides: no transpose or padding copy.
//
// B5 in bf16: flash_bwd_dq_kernel_wgmma, on the tensor cores.  Bound on
// the H100 SXM: operations.  GPT-2 small trains at B 8, H 12, S 1024,
// D 64: 6 * D * B*H*S(S+1)/2 = 19.3 GFLOP causal, 0.0196 ms at 989
// TFLOP/s dense bf16, against 63 MB of q, k, v, do, lse, delta and dq
// (0.0189 ms at 3.35 TB/s).  What held the first version back, and what
// this one does:
// - fp32 scalar FMAs on the CUDA cores (ceiling 67 TFLOP/s): S = Q K^T
//   and dP = dO V^T are SS wgmma chains (q, do, k and v all K-major as
//   they lie, [row][d]) and dQ += dS K an RS wgmma with dS in registers
//   and K read MN-major through B's transpose bit (sm90_mma.cuh);
// - every FMA read a K or V element back from shared memory, with two
//   shuffles per dot product: the products read 128-byte-swizzled tiles
//   through descriptors, and P, dP and dS never leave registers;
// - 2-byte loads serialized with compute: 16-byte cp.async into a
//   two-stage ring of K, V and key-mask tiles, the next tile loading
//   while this one computes;
// - light causal tiles first: blockIdx.y walks from the heaviest q tile
//   down, batch*head on blockIdx.x.
// A block owns a 64-row q tile (one warpgroup): q and do stay resident
// in swizzled shared memory, lse (base 2) and delta for the thread's two
// rows in registers.  Per 64-key tile: S and dP as two commit groups, P
// = live ? exp(S * scale + mask - lse) : 0 (2^x on the SFU) while dP
// still runs, with dropout dP = keep ? dP / (1 - rate) : 0 (the keep
// bits hashed while S and dP run), dS = P (dP - delta) rounded to bf16
// in registers (where the TPU's MXU and SDPA round it), then dQ += dS K.
// One 64-row warpgroup per block with three blocks resident per SM (a
// launch bound that caps a thread at 168 registers; ptxas gives 150, and
// 163 with dropout, on the H100 build) hides the serial waits better
// than 128-row blocks of two warpgroups and two blocks per SM.  Causal
// tiles past the diagonal are not loaded; only the tile crossing it applies the causal mask, only the
// last one the tail.  dq = acc * scale in bf16.  Operands must meet the
// 16-byte rule (base and (b, s, h) strides in multiples of 16 bytes);
// the wrapper copies one that does not.
//
// B6 in bf16: flash_bwd_dkv_kernel_wgmma, on the tensor cores.  Bound on
// the H100 SXM: operations.  At GPT-2 small's step, 8 * D *
// B*H*S(S+1)/2 = 25.8 GFLOP causal, 0.0261 ms at 989 TFLOP/s dense bf16,
// against 76 MB of q, k, v, do, lse, delta, dk and dv (0.0228 ms at 3.35
// TB/s); BERT-large's B6d (B 32, H 16, S 128, not causal) is bound by
// its 51 MB (0.0152 ms).  The CUDA-core version needed P^T and dS^T as
// operands; this one computes them directly, with keys on the
// accumulator's rows and queries on its columns:
// - S^T = K Q^T and dP^T = V dO^T are SS wgmma chains (k, v, q and do
//   all K-major as they lie, [row][d]); P^T and dS^T, rounded to bf16 in
//   registers (acc_to_a), are the A operands of the RS products dV +=
//   P^T dO and dK += dS^T Q, which read the dO and Q tiles MN-major
//   through B's transpose bit (as B4 reads V): every operand tile is
//   loaded once, nothing is transposed;
// - the per-query statistics move with the queries: lse and delta stream
//   with each Q/dO tile into shared memory (4-byte cp.async, as dq's key
//   mask) and are read per accumulator column; the key mask is per row,
//   in registers for the thread's two keys;
// - the dropout keep bits come from sm90::keep_bits_t, the transposed
//   twin of keep_bits (the hash's row is still the query, its column the
//   key), hashed while S^T and dP^T run;
// - Q, dO, lse and delta in a two-stage cp.async ring; causal query
//   tiles wholly before the key tile are not loaded, only the first
//   tile (the one on the diagonal) applies the causal mask and only the
//   last the query tail; the earliest keys, the heaviest causal blocks,
//   launch first.
// A block owns a 64-key tile of one batch*head (one warpgroup); dK, dV,
// S^T and dP^T take 4 x 32 fp32 registers a thread, so two blocks are
// resident per SM (the launch bound caps a thread at 255 registers).
// Per query tile: S^T and dP^T as two commit groups, P^T while dP^T
// runs, then both RS products in one group.  dk = acc * scale and dv in
// bf16.  Operands must meet the 16-byte rule; the wrapper copies one that
// does not.
//
// B5 and B6 in fp32: the first version, on the CUDA cores (fp32
// arithmetic; the fp32 instantiations keep the oracle checks free of
// TF32).  The TPU's sequential grid axis becomes a loop inside the
// block.  B5: one block per (batch*head, 64-row q tile) looping over k
// tiles up to the causal diagonal; B6: one block per (batch*head, 64-key
// tile) looping over q tiles from the diagonal on.  Each row of the
// block's own operand (query for B5, key for B6) belongs to D/16
// adjacent threads holding 16 interleaved dims of it and of its fp32
// accumulators in registers, so a dot product is 16 FMAs plus a two-step
// shuffle; the streamed tiles are staged in shared memory as fp32 and
// read back as broadcasts without bank conflicts.
#include "common.cuh"
#include "sm90_mma.cuh"

namespace {

constexpr int kTile = 64;   // rows per block and per streamed tile
constexpr int kDPT = 16;    // head dims per thread

template <int D>
struct Cfg {
  static constexpr int kTPR = D / kDPT;  // threads per row
  static constexpr int kThreads = kTile * kTPR;
};

// (sb, ss, sh) in elements for q, k, v and do, in that order
struct Strides {
  int64_t q[3], k[3], v[3], o[3];
};

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D], const T* src,
                                          int64_t row_stride, int row0,
                                          int rows, int tid, int nt) {
  for (int idx = tid; idx < kTile * D; idx += nt) {
    const int r = idx / D, d = idx % D;
    dst[r][d] = row0 + r < rows
        ? apex::to_float(src[static_cast<int64_t>(row0 + r) * row_stride + d])
        : 0.f;
  }
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ mask,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Sq, int Sk, Strides st, float scale,
                    int causal, const int* __restrict__ seed, float rate,
                    float keep_div) {
  constexpr int TPR = Cfg<D>::kTPR;
  constexpr int NT = Cfg<D>::kThreads;
  __shared__ float ks[kTile][D];
  __shared__ float vs[kTile][D];
  __shared__ float ms[kTile];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int r = tid / TPR, part = tid % TPR;
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;

  float qv[kDPT], dov[kDPT], acc[kDPT];
  {
    const int64_t row = row_ok ? qi : 0;
    const T* qrow = q + b * st.q[0] + row * st.q[1] + h * st.q[2];
    const T* orow = dout + b * st.o[0] + row * st.o[1] + h * st.o[2];
#pragma unroll
    for (int i = 0; i < kDPT; ++i) {
      qv[i] = row_ok ? apex::to_float(qrow[part + TPR * i]) : 0.f;
      dov[i] = row_ok ? apex::to_float(orow[part + TPR * i]) : 0.f;
      acc[i] = 0.f;
    }
  }
  const int64_t srow = static_cast<int64_t>(bh) * Sq + qi;
  const float L = row_ok ? lse[srow] : apex::kNegInf;
  const float dl = row_ok ? delta[srow] : 0.f;
  const bool live = L > apex::kNegInf * 0.5f;
  apex::DropoutCoords dc{};
  if constexpr (kDropout) dc = apex::dropout_coords(seed, b, h);

  const int k_end = causal ? min(Sk, q0 + kTile) : Sk;
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<T, D>(ks, kb, st.k[1], k0, Sk, tid, NT);
    load_tile<T, D>(vs, vb, st.v[1], k0, Sk, tid, NT);
    for (int j = tid; j < kTile; j += NT)
      ms[j] = (mask != nullptr && k0 + j < Sk)
                  ? mask[static_cast<int64_t>(b) * Sk + k0 + j] : 0.f;
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const int key = k0 + j;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kDPT; ++i) {
        s += qv[i] * ks[j][part + TPR * i];
        dp += dov[i] * vs[j][part + TPR * i];
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      float p = 0.f;
      if (live && key < Sk && !(causal && key > qi))
        p = expf(s * scale + ms[j] - L);
      if constexpr (kDropout) {
        const bool keep = apex::dropout_keep(
            dc.seed, dc.bh, static_cast<uint32_t>(qi + dc.row_off),
            static_cast<uint32_t>(key + dc.col_off), rate);
        dp = keep ? dp / keep_div : 0.f;
      }
      const float ds = p * (dp - dl);
#pragma unroll
      for (int i = 0; i < kDPT; ++i) acc[i] += ds * ks[j][part + TPR * i];
    }
  }

  if (row_ok) {
    T* out = dq + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < kDPT; ++i)
      out[part + TPR * i] = apex::from_float<T>(acc[i] * scale);
  }
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ mask,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, Strides st,
                     float scale, int causal, const int* __restrict__ seed,
                     float rate, float keep_div) {
  constexpr int TPR = Cfg<D>::kTPR;
  constexpr int NT = Cfg<D>::kThreads;
  __shared__ float qs[kTile][D];
  __shared__ float os[kTile][D];
  __shared__ float ls[kTile];
  __shared__ float dls[kTile];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int r = tid / TPR, part = tid % TPR;
  const int kj = k0 + r;
  const bool key_ok = kj < Sk;

  float kv[kDPT], vv[kDPT], dka[kDPT], dva[kDPT];
  {
    const int64_t row = key_ok ? kj : 0;
    const T* krow = k + b * st.k[0] + row * st.k[1] + h * st.k[2];
    const T* vrow = v + b * st.v[0] + row * st.v[1] + h * st.v[2];
#pragma unroll
    for (int i = 0; i < kDPT; ++i) {
      kv[i] = key_ok ? apex::to_float(krow[part + TPR * i]) : 0.f;
      vv[i] = key_ok ? apex::to_float(vrow[part + TPR * i]) : 0.f;
      dka[i] = 0.f;
      dva[i] = 0.f;
    }
  }
  const float mk = (mask != nullptr && key_ok)
                       ? mask[static_cast<int64_t>(b) * Sk + kj] : 0.f;
  apex::DropoutCoords dc{};
  if constexpr (kDropout) dc = apex::dropout_coords(seed, b, h);

  // causal: query tiles wholly before the key tile see none of its keys
  const int q_begin = causal ? (k0 / kTile) * kTile : 0;
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* ob = dout + b * st.o[0] + h * st.o[2];
  for (int q0 = q_begin; q0 < Sq; q0 += kTile) {
    __syncthreads();
    load_tile<T, D>(qs, qb, st.q[1], q0, Sq, tid, NT);
    load_tile<T, D>(os, ob, st.o[1], q0, Sq, tid, NT);
    for (int i = tid; i < kTile; i += NT) {
      const bool ok = q0 + i < Sq;
      const int64_t srow = static_cast<int64_t>(bh) * Sq + q0 + i;
      ls[i] = ok ? lse[srow] : apex::kNegInf;
      dls[i] = ok ? delta[srow] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      const int qi = q0 + i;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kDPT; ++d) {
        s += kv[d] * qs[i][part + TPR * d];
        dp += vv[d] * os[i][part + TPR * d];
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const float L = ls[i];
      float p = 0.f;
      if (key_ok && L > apex::kNegInf * 0.5f && !(causal && kj > qi))
        p = expf(s * scale + mk - L);
      float pv = p;
      if constexpr (kDropout) {
        const bool keep = apex::dropout_keep(
            dc.seed, dc.bh, static_cast<uint32_t>(qi + dc.row_off),
            static_cast<uint32_t>(kj + dc.col_off), rate);
        pv = keep ? p / keep_div : 0.f;
        dp = keep ? dp / keep_div : 0.f;
      }
      const float ds = p * (dp - dls[i]);
#pragma unroll
      for (int d = 0; d < kDPT; ++d) {
        dva[d] += pv * os[i][part + TPR * d];
        dka[d] += ds * qs[i][part + TPR * d];
      }
    }
  }

  if (key_ok) {
    const int64_t off = ((static_cast<int64_t>(b) * Sk + kj) * H + h) * D;
#pragma unroll
    for (int d = 0; d < kDPT; ++d) {
      dk[off + part + TPR * d] = apex::from_float<T>(dka[d] * scale);
      dv[off + part + TPR * d] = apex::from_float<T>(dva[d]);
    }
  }
}

// -- B5 / B5d in bf16 on the tensor cores ------------------------------

namespace wg {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBM = 64;                // query rows per block: one warpgroup
constexpr int kBN = 64;                // keys per streamed tile
constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;          // resident blocks per SM
constexpr int kTile = kBN * 128;       // bytes of one K or V tile
constexpr int kQBytes = kBM * 128;
// Q | dO | K[2] | V[2] | mask[2][kBN] fp32, behind 1024 bytes of
// alignment slack (the swizzle needs 1024-byte aligned tiles)
constexpr int kSmem = 1024 + 2 * kQBytes + 4 * kTile + 2 * kBN * 4;

struct DqArgs {
  const bf16 *q, *k, *v, *dout;
  const float *mask, *lse, *delta;
  bf16* dq;
  int H, Sq, Sk;
  Strides st;
  float scale, scale_log2;  // scale, scale * log2(e)
  int causal;
  const int* seed;
  float rate, inv_keep;  // the drop rate and 1 / (1 - rate)
};

template <bool kDropout>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dq_kernel_wgmma(const DqArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sO = sQ + kQBytes;    // do
  const uint32_t sK = sO + kQBytes;    // + stage * kTile
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
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + 16 * warp + lane / 4;  // and row0 + 8: this thread's

  const bf16* qb = a.q + b * a.st.q[0] + h * a.st.q[2];
  const bf16* ob = a.dout + b * a.st.o[0] + h * a.st.o[2];
  const bf16* kb = a.k + b * a.st.k[0] + h * a.st.k[2];
  const bf16* vb = a.v + b * a.st.v[0] + h * a.st.v[2];
  const float* mb = a.mask == nullptr ? nullptr
                                      : a.mask + static_cast<int64_t>(b) * a.Sk;

  const int k_end = a.causal ? min(a.Sk, q0 + kBM) : a.Sk;
  const int n_tiles = (k_end + kBN - 1) / kBN;

  auto load_kv = [&](int t, int stage) {
    const int k0 = t * kBN;
    for (int i = tid; i < kBN * 8; i += kThreads) {
      const int r = i / 8, c = i % 8, key = k0 + r;
      const bool ok = key < a.Sk;
      const int64_t kr = ok ? key : 0;
      sm90::cp_async16(sK + stage * kTile + sm90::sw128(r, c),
                       kb + kr * a.st.k[1] + 8 * c, ok);
      sm90::cp_async16(sV + stage * kTile + sm90::sw128(r, c),
                       vb + kr * a.st.v[1] + 8 * c, ok);
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
    const int64_t qr = ok ? row : 0;
    sm90::cp_async16(sQ + sm90::sw128(r, c), qb + qr * a.st.q[1] + 8 * c, ok);
    sm90::cp_async16(sO + sm90::sw128(r, c), ob + qr * a.st.o[1] + 8 * c, ok);
  }
  if (n_tiles > 0) load_kv(0, 0);
  sm90::cp_async_commit();

  // this thread's two rows: lse in base 2, delta, and whether any key
  // of the row is live (a fully-masked row has lse = NEG_INF and p = 0)
  float L2[2], dl[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const int64_t srow = static_cast<int64_t>(bh) * a.Sq + row;
    const float L = row < a.Sq ? a.lse[srow] : apex::kNegInf;
    live[i] = L > apex::kNegInf * 0.5f;
    L2[i] = L * kLog2e;
    dl[i] = row < a.Sq ? a.delta[srow] : 0.f;
  }
  apex::DropoutCoords dc{};
  if constexpr (kDropout) dc = apex::dropout_coords(a.seed, b, h);

  float acc[32], s[32], dp[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = s[r] = dp[r] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, stage ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // tile t (and Q, dO) landed
    sm90::fence_proxy_async();
    __syncthreads();
    const int k0 = t * kBN;
    const uint32_t kt = sK + stage * kTile, vt = sV + stage * kTile;
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::wgmma_tile_ss(s, sQ, kt);  // S = Q K^T
    sm90::wgmma_commit();
    sm90::wgmma_tile_ss(dp, sO, vt);  // dP = dO V^T
    sm90::wgmma_commit();
    // the tile's keep bits, hashed while S and dP run
    uint32_t keep = 0;
    if constexpr (kDropout)
      keep = sm90::keep_bits(dc, row0, k0, lane, a.rate);
    sm90::wgmma_wait<1>();  // S landed: P while dP runs
    sm90::fence_regs(s);

    const bool diag = a.causal && k0 + kBN - 1 > q0;
    const bool tail = k0 + kBN > a.Sk;
    const float* ms = mask_s + stage * kBN;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int i = sm90::acc_row_half(r);
      const int col = sm90::acc_col(r, lane);
      const float mk = mb != nullptr ? ms[col] * kLog2e : 0.f;
      const float p =
          sm90::exp2_approx(fmaf(s[r], a.scale_log2, mk - L2[i]));
      s[r] = (!live[i] || (tail && k0 + col >= a.Sk) ||
              (diag && k0 + col > row0 + 8 * i)) ? 0.f : p;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      float g = dp[r];
      if constexpr (kDropout) g = (keep >> r) & 1u ? g * a.inv_keep : 0.f;
      s[r] *= g - dl[sm90::acc_row_half(r)];  // dS = P (dP - delta)
    }
    uint32_t da[4][4];  // dS as the A operand of dQ += dS K
    sm90::acc_to_a(s, da);
    sm90::fence_regs(acc);
    sm90::wgmma_tile_rs(acc, da, kt);  // dQ += dS K
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    __syncthreads();  // the stage is consumed before tile t + 2 fills it
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= a.Sq) continue;
    bf16* out = a.dq + ((static_cast<int64_t>(b) * a.Sq + row) * a.H + h) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = 4 * j + 2 * i;
      *reinterpret_cast<uint32_t*>(out + sm90::acc_col(r, lane)) =
          sm90::pack_bf16(acc[r] * a.scale, acc[r + 1] * a.scale);
    }
  }
}

template <bool kDropout>
cudaError_t launch_dq(const DqArgs& a, int B, cudaStream_t stream) {
  static unsigned done = 0;
  cudaError_t err =
      sm90::allow_smem(flash_bwd_dq_kernel_wgmma<kDropout>, kSmem, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, (a.Sq + kBM - 1) / kBM);
  flash_bwd_dq_kernel_wgmma<kDropout><<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

// -- B6 / B6d in bf16 on the tensor cores ------------------------------

constexpr int kDkvMinBlocks = 2;  // resident blocks per SM
// K | V | Q[2] | dO[2] | (lse, delta)[2][kBM] fp32, behind 1024 bytes of
// alignment slack
constexpr int kDkvSmem = 1024 + 2 * kTile + 4 * kQBytes + 4 * kBM * 4;

struct DkvArgs {
  const bf16 *q, *k, *v, *dout;
  const float *mask, *lse, *delta;
  bf16 *dk, *dv;
  int H, Sq, Sk;
  Strides st;
  float scale, scale_log2;  // scale, scale * log2(e)
  int causal;
  const int* seed;
  float rate, inv_keep;  // the drop rate and 1 / (1 - rate)
};

template <bool kDropout>
__global__ void __launch_bounds__(kThreads, kDkvMinBlocks)
flash_bwd_dkv_kernel_wgmma(const DkvArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + kTile;
  const uint32_t sQ = sV + kTile;        // + stage * kQBytes
  const uint32_t sO = sQ + 2 * kQBytes;  // do, + stage * kQBytes
  const uint32_t sL = sO + 2 * kQBytes;  // lse, delta: + (2 stage + i) kBM 4
  const float* stats = reinterpret_cast<const float*>(smem_raw + (sL - raw));

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  // causal: key tile 0 sees every query tile, so the lowest blockIdx.y
  // (launched first) is the heaviest
  const int k0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int key0 = k0 + 16 * warp + lane / 4;  // and key0 + 8: this thread's

  const bf16* qb = a.q + b * a.st.q[0] + h * a.st.q[2];
  const bf16* ob = a.dout + b * a.st.o[0] + h * a.st.o[2];
  const bf16* kb = a.k + b * a.st.k[0] + h * a.st.k[2];
  const bf16* vb = a.v + b * a.st.v[0] + h * a.st.v[2];
  const int64_t srow0 = static_cast<int64_t>(bh) * a.Sq;

  // causal: query tiles wholly before the key tile see none of its keys
  const int q_begin = a.causal ? k0 : 0;
  const int n_tiles = q_begin < a.Sq ? (a.Sq - q_begin + kBM - 1) / kBM : 0;

  auto load_q = [&](int t, int stage) {
    const int q0 = q_begin + t * kBM;
    for (int i = tid; i < kBM * 8; i += kThreads) {
      const int r = i / 8, c = i % 8, row = q0 + r;
      const bool ok = row < a.Sq;
      const int64_t qr = ok ? row : 0;
      sm90::cp_async16(sQ + stage * kQBytes + sm90::sw128(r, c),
                       qb + qr * a.st.q[1] + 8 * c, ok);
      sm90::cp_async16(sO + stage * kQBytes + sm90::sw128(r, c),
                       ob + qr * a.st.o[1] + 8 * c, ok);
    }
    // threads 0..63 bring the tile's lse, 64..127 its delta
    const int row = q0 + tid % kBM;
    const bool ok = row < a.Sq;
    const float* src = tid < kBM ? a.lse : a.delta;
    sm90::cp_async4(sL + ((2 * stage + tid / kBM) * kBM + tid % kBM) * 4,
                    src + srow0 + (ok ? row : 0), ok);
  };

  for (int i = tid; i < kBN * 8; i += kThreads) {
    const int r = i / 8, c = i % 8, key = k0 + r;
    const bool ok = key < a.Sk;
    const int64_t kr = ok ? key : 0;
    sm90::cp_async16(sK + sm90::sw128(r, c), kb + kr * a.st.k[1] + 8 * c, ok);
    sm90::cp_async16(sV + sm90::sw128(r, c), vb + kr * a.st.v[1] + 8 * c, ok);
  }
  if (n_tiles > 0) load_q(0, 0);
  sm90::cp_async_commit();

  // this thread's two keys: in range, and their mask in base 2
  bool key_ok[2];
  float mk2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    key_ok[i] = key < a.Sk;
    mk2[i] = (a.mask != nullptr && key_ok[i])
                 ? a.mask[static_cast<int64_t>(b) * a.Sk + key] * kLog2e
                 : 0.f;
  }
  apex::DropoutCoords dc{};
  if constexpr (kDropout) dc = apex::dropout_coords(a.seed, b, h);

  float dk[32], dv[32], s[32], dp[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) dk[r] = dv[r] = s[r] = dp[r] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) load_q(t + 1, stage ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // tile t (and K, V) landed
    sm90::fence_proxy_async();
    __syncthreads();
    const int q0 = q_begin + t * kBM;
    const uint32_t qt = sQ + stage * kQBytes, ot = sO + stage * kQBytes;
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::wgmma_tile_ss(s, sK, qt);  // S^T = K Q^T
    sm90::wgmma_commit();
    sm90::wgmma_tile_ss(dp, sV, ot);  // dP^T = V dO^T
    sm90::wgmma_commit();
    // the tile's keep bits, hashed while S^T and dP^T run
    uint32_t keep = 0;
    if constexpr (kDropout)
      keep = sm90::keep_bits_t(dc, key0, q0, lane, a.rate);
    sm90::wgmma_wait<1>();  // S^T landed: P^T while dP^T runs
    sm90::fence_regs(s);

    // the query columns' statistics: lse (a fully-masked row has NEG_INF
    // and p = 0) and delta
    const float* ls = stats + 2 * stage * kBM;
    const float* dl = ls + kBM;
    const bool diag = a.causal && t == 0;  // q0 == k0
    const bool tail = q0 + kBM > a.Sq;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int i = sm90::acc_row_half(r);
      const int col = sm90::acc_col(r, lane);
      const float L = ls[col];
      const float p =
          sm90::exp2_approx(fmaf(s[r], a.scale_log2, mk2[i] - L * kLog2e));
      s[r] = (!key_ok[i] || !(L > apex::kNegInf * 0.5f) ||
              (tail && q0 + col >= a.Sq) ||
              (diag && key0 + 8 * i > q0 + col)) ? 0.f : p;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);

    // P^T as dV's A operand (dropped and scaled under dropout), then
    // dS^T = P^T (dP^T - delta), dP^T dropped and scaled the same way
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 8 * kk + 2 * j;
        float lo = s[r], hi = s[r + 1];
        if constexpr (kDropout) {
          lo = (keep >> r) & 1u ? lo * a.inv_keep : 0.f;
          hi = (keep >> (r + 1)) & 1u ? hi * a.inv_keep : 0.f;
        }
        pa[kk][j] = sm90::pack_bf16(lo, hi);
      }
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      float g = dp[r];
      if constexpr (kDropout) g = (keep >> r) & 1u ? g * a.inv_keep : 0.f;
      s[r] *= g - dl[sm90::acc_col(r, lane)];
    }
    sm90::acc_to_a(s, da);
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::wgmma_tile_rs(dv, pa, ot);  // dV += P^T dO
    sm90::wgmma_tile_rs(dk, da, qt);  // dK += dS^T Q
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_frags(pa);
    sm90::fence_frags(da);
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    __syncthreads();  // the stage is consumed before tile t + 2 fills it
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (!key_ok[i]) continue;
    const int64_t off = ((static_cast<int64_t>(b) * a.Sk + key) * a.H + h) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = 4 * j + 2 * i;
      const int col = sm90::acc_col(r, lane);
      *reinterpret_cast<uint32_t*>(a.dk + off + col) =
          sm90::pack_bf16(dk[r] * a.scale, dk[r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(a.dv + off + col) =
          sm90::pack_bf16(dv[r], dv[r + 1]);
    }
  }
}

template <bool kDropout>
cudaError_t launch_dkv(const DkvArgs& a, int B, cudaStream_t stream) {
  static unsigned done = 0;
  cudaError_t err =
      sm90::allow_smem(flash_bwd_dkv_kernel_wgmma<kDropout>, kDkvSmem, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, (a.Sk + kBN - 1) / kBN);
  flash_bwd_dkv_kernel_wgmma<kDropout>
      <<<grid, kThreads, kDkvSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace wg

Strides read_strides(const void* strides) {
  const int64_t* s = static_cast<const int64_t*>(strides);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.o[i] = s[9 + i];
  }
  return st;
}

// the dropout arguments of both kernels: the (5,) int32 seed array in
// device memory (null: no dropout), the fp32 rate and divisor 1 - rate
struct Dropout {
  const int* seed;
  float rate, keep_div;
  bool on() const { return seed != nullptr && rate > 0.f; }
};

template <typename T, bool kDropout>
void dq_kernel(const dim3& grid, cudaStream_t stream, const void* q,
               const void* k, const void* v, const void* dout,
               const float* mask, const float* lse, const float* delta,
               void* dq, int H, int Sq, int Sk, const Strides& st,
               float scale, int causal, const Dropout& dr) {
  flash_bwd_dq_kernel<T, 64, kDropout><<<grid, Cfg<64>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), mask, lse, delta,
      static_cast<T*>(dq), H, Sq, Sk, st, scale, causal, dr.seed, dr.rate,
      dr.keep_div);
}

template <typename T>
cudaError_t launch_dq(int D, const void* q, const void* k, const void* v,
                      const void* dout, const float* mask, const float* lse,
                      const float* delta, void* dq, int B, int H, int Sq,
                      int Sk, const Strides& st, float scale, int causal,
                      const Dropout& dr, cudaStream_t stream) {
  // head_dim 64 only, like flash_fwd.cu and decode_attention.cu
  if (D != 64) return cudaErrorInvalidValue;
  const dim3 grid((Sq + kTile - 1) / kTile, B * H);
  if (dr.on())
    dq_kernel<T, true>(grid, stream, q, k, v, dout, mask, lse, delta, dq, H,
                       Sq, Sk, st, scale, causal, dr);
  else
    dq_kernel<T, false>(grid, stream, q, k, v, dout, mask, lse, delta, dq, H,
                        Sq, Sk, st, scale, causal, dr);
  return cudaGetLastError();
}

template <typename T, bool kDropout>
void dkv_kernel(const dim3& grid, cudaStream_t stream, const void* q,
                const void* k, const void* v, const void* dout,
                const float* mask, const float* lse, const float* delta,
                void* dk, void* dv, int H, int Sq, int Sk, const Strides& st,
                float scale, int causal, const Dropout& dr) {
  flash_bwd_dkv_kernel<T, 64, kDropout><<<grid, Cfg<64>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), mask, lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, st, scale, causal,
      dr.seed, dr.rate, dr.keep_div);
}

template <typename T>
cudaError_t launch_dkv(int D, const void* q, const void* k, const void* v,
                       const void* dout, const float* mask, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int H,
                       int Sq, int Sk, const Strides& st, float scale,
                       int causal, const Dropout& dr, cudaStream_t stream) {
  if (D != 64) return cudaErrorInvalidValue;
  const dim3 grid((Sk + kTile - 1) / kTile, B * H);
  if (dr.on())
    dkv_kernel<T, true>(grid, stream, q, k, v, dout, mask, lse, delta, dk, dv,
                        H, Sq, Sk, st, scale, causal, dr);
  else
    dkv_kernel<T, false>(grid, stream, q, k, v, dout, mask, lse, delta, dk,
                         dv, H, Sq, Sk, st, scale, causal, dr);
  return cudaGetLastError();
}

}  // namespace

// q, do: (B, Sq, H, D); k, v: (B, Sk, H, D); all in `dtype` with unit
// stride on D; strides[12] = (sb, ss, sh) for q, k, v, do in elements.
// mask: (B, Sk) fp32 contiguous or null; lse, delta: (B, H, Sq) fp32
// contiguous.  dq: (B, Sq, H, D) contiguous in `dtype`.  seed: the (5,)
// int32 seed array in device memory, or null; dropout runs when it is
// given and rate > 0, dividing kept values by keep_div.
extern "C" int apex_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* mask,
                                 const void* lse, const void* delta,
                                 void* dq, int B, int H, int Sq, int Sk,
                                 int D, const void* strides, float scale,
                                 int causal, const void* seed, float rate,
                                 float keep_div, int dtype, void* stream) {
  const Strides st = read_strides(strides);
  const Dropout dr{static_cast<const int*>(seed), rate, keep_div};
  const float* mk = static_cast<const float*>(mask);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case apex::kFloat32:
      return static_cast<int>(launch_dq<float>(
          D, q, k, v, dout, mk, ls, dl, dq, B, H, Sq, Sk, st, scale, causal,
          dr, s));
    case apex::kBFloat16: {
      if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
      using wg::bf16;
      const wg::DqArgs a{static_cast<const bf16*>(q),
                         static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v),
                         static_cast<const bf16*>(dout), mk, ls, dl,
                         static_cast<bf16*>(dq), H, Sq, Sk, st, scale,
                         scale * wg::kLog2e, causal, dr.seed, dr.rate,
                         1.f / dr.keep_div};
      return static_cast<int>(dr.on() ? wg::launch_dq<true>(a, B, s)
                                      : wg::launch_dq<false>(a, B, s));
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// as apex_flash_bwd_dq; dk, dv: (B, Sk, H, D) contiguous in `dtype`.
extern "C" int apex_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* mask,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int H, int Sq,
                                  int Sk, int D, const void* strides,
                                  float scale, int causal, const void* seed,
                                  float rate, float keep_div, int dtype,
                                  void* stream) {
  const Strides st = read_strides(strides);
  const Dropout dr{static_cast<const int*>(seed), rate, keep_div};
  const float* mk = static_cast<const float*>(mask);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case apex::kFloat32:
      return static_cast<int>(launch_dkv<float>(
          D, q, k, v, dout, mk, ls, dl, dk, dv, B, H, Sq, Sk, st, scale,
          causal, dr, s));
    case apex::kBFloat16: {
      if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
      using wg::bf16;
      const wg::DkvArgs a{static_cast<const bf16*>(q),
                          static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v),
                          static_cast<const bf16*>(dout), mk, ls, dl,
                          static_cast<bf16*>(dk), static_cast<bf16*>(dv), H,
                          Sq, Sk, st, scale, scale * wg::kLog2e, causal,
                          dr.seed, dr.rate, 1.f / dr.keep_div};
      return static_cast<int>(dr.on() ? wg::launch_dkv<true>(a, B, s)
                                      : wg::launch_dkv<false>(a, B, s));
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the bf16 dq and dk/dv kernels' dynamic shared memory in bytes (the
// build report)
extern "C" int apex_flash_bwd_dq_wgmma_smem() { return wg::kSmem; }
extern "C" int apex_flash_bwd_dkv_wgmma_smem() { return wg::kDkvSmem; }
