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
// and B8 compute the same bits: one body, one arithmetic order.
//
// Bound on the H100: bytes — every K and V element is read once and
// used for two FLOPs, so the floor is the K/V bytes (2 * B * T * H * D *
// itemsize, plus 8 * B * T * H scale bytes for B8) over 3.35 TB/s: at
// the serve path's 8 x 1025 x 12 x 64, 4 us for int8 and 15 us for fp32.
// Design (split across the context, as flash-decoding does):
//  - The context is cut into 64-key tiles, and the tiles of a (b, h)
//    into at most 32 splits of consecutive tiles, one block a split.
//    The wrapper's _split cuts a (b, h) into as many splits as keep all
//    the blocks within one an SM; it depends on B * H and T only, so B7
//    and B8 split alike.  Above half as many (b, h) as SMs (the serve
//    paths' 8 and 16 slots: 96 and 192) that is one split of 17 tiles a
//    (b, h), no combine; a small batch splits its contexts.
//  - A block has 256 threads; four take a key, each 16 of its 64 head
//    dims.  Tiles stream through a ring of shared-memory stages (four
//    for int8 and bf16 K/V, two for fp32) filled by 16-byte cp.async.  A
//    thread reads back only the chunks it copied itself, so its own
//    cp.async wait orders the loop: no block barrier a tile.  Steps of
//    two tiles (one for fp32) are computed while the next step loads.  A
//    key whose bias is <= NEG_INF / 2 reads nothing (its chunks fill
//    with zeros).  This is exact: any row with a live key has a max
//    above NEG_INF / 2 (~-5e29, where fp32 spacing is ~3e22), so
//    exp(s - max) of a masked key is exactly 0, and a row with none
//    gives zeros anyway.
//  - Each key slot (a quad of threads) keeps its own online softmax over
//    the split's tiles: running max, sum of exp and p @ v, updated tile
//    by tile in key order, so a step's size changes no bit.  The score
//    is a thread's 16-term fma chain summed over the quad with shuffles.
//    At the end the 64 slots meet in shared memory with exp(m_slot - M)
//    weights, in a fixed order.
//  - With more than one split, each writes its fp32 (m, l, acc[64])
//    partial to scratch the wrapper allocates; the last split of a
//    (b, h) to finish (an integer counter per (b, h), which that block
//    sets back to 0) loads all the partials at once, combines them in
//    split order and writes o.  One launch a call, no float atomics: a
//    launch's bits do not depend on which block finishes last.
// K, V and the scales are read in the JAX (B, T, H, D) / (B, T, H)
// layouts through strides, so the gathered-and-concatenated context
// needs no copy (the wrapper copies K/V only when a row is not 16-byte
// aligned).  T is limited only by the int32 key index.
#include "common.cuh"
#include "sm90_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;               // keys a tile
constexpr int kD = 64;                  // head dim
constexpr int kDimsPerThread = 16;      // four threads a key
constexpr int kGroups = kThreads / kD;  // key and split groups of the sums
constexpr int kPvStride = kD + 4;       // a p * v row in shared memory
constexpr int kBiasTiles = 16;          // tiles' bias rows held at once
constexpr int kMaxSplits = 32;          // splits a (b, h)
constexpr int kSplitsPerThread = kMaxSplits / kGroups;
static_assert(kTile * (kD / kDimsPerThread) == kThreads, "one key a quad");

// the K/V element type: q's dtype for B7, int8 for B8
template <typename T, bool kQ8>
struct KVType {
  using type = T;
};
template <typename T>
struct KVType<T, true> {
  using type = int8_t;
};

// a thread's 16 K or V elements (in shared memory) as the fp32 values
// the products take.  B8's widening is dequantize_kv's rule: one fp32
// multiply by the scale, then the cast to q's dtype.  The int8 value
// goes through the exponent: the byte permute builds 2^23 + (x + 128)
// and one subtraction leaves x exactly, in full-rate instructions where
// an int-to-float conversion runs at a quarter of the rate.
template <typename T, bool kQ8>
__device__ __forceinline__ void slice_to_float(
    const typename KVType<T, kQ8>::type* p, float s,
    float (&out)[kDimsPerThread]) {
  if constexpr (kQ8) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = words[i] ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float f =
            __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + e)) -
            8388736.f;  // 2^23 + 128
        out[4 * i + e] = apex::to_float(apex::from_float<T>(f * s));
      }
    }
  } else {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int u = 0; u < kDimsPerThread / kPer; ++u) {
      const apex::Pack<T, kPer> pk = apex::load_pack<T, kPer>(p + u * kPer);
#pragma unroll
      for (int e = 0; e < kPer; ++e) out[u * kPer + e] = apex::to_float(pk.v[e]);
    }
  }
}

// element strides: q (sb, sh), k (sb, st, sh), v (sb, st, sh), o (sb,
// sh), and for B8 k_scale (sb, st, sh), v_scale (sb, st, sh)
struct Strides {
  int64_t q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh;
  int64_t ks_sb, ks_st, ks_sh, vs_sb, vs_st, vs_sh;
};

// tiles in the ring: 8 KB a tile of int8 K and V, 16 KB of bf16, 32 KB
// of fp32
template <typename KV>
constexpr int kStages = sizeof(KV) == 4 ? 2 : 4;

// a block's shared memory (dynamic: 47 KB for int8 K/V, 79 KB for bf16,
// 75 KB for fp32); the p * v rows of the final sums reuse the stages
template <typename KV>
struct Smem {
  KV kv[kStages<KV>][2][kTile][kD];  // K, V of each stage
  float sc[kStages<KV>][2][kThreads];  // their scales (B8), a thread's
  float bias[kBiasTiles][kTile];     // a run of the split's, -inf past T
  float q[kD];
  float wm[kWarps];                  // each warp's largest slot max
  float red[kGroups];
  float grp[kGroups][kD];
  float lp[kTile];
  int last;
};
static_assert(sizeof(int8_t) * kStages<int8_t> * 2 * kTile * kD >=
                  sizeof(float) * kTile * kPvStride,
              "the p * v rows fit in the stages");

// scratch: ml[bh * splits + split] = (m, l), acc[(bh * splits + split) *
// kD + d]; counters[bh] = splits of (b, h) finished in this launch.  A
// split is `tiles` consecutive 64-key tiles.
template <typename T, bool kQ8>
__global__ void __launch_bounds__(kThreads, 2)
decode_attention_kernel(const T* __restrict__ q,
                        const typename KVType<T, kQ8>::type* __restrict__ k,
                        const typename KVType<T, kQ8>::type* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const float* __restrict__ bias, T* __restrict__ o,
                        float2* ml, float* acc, int* counters, int H,
                        int T_len, int tiles, const Strides st,
                        float scale) {
  using KV = typename KVType<T, kQ8>::type;
  constexpr int S = kStages<KV>;
  constexpr int U = S / 2;  // tiles a step
  constexpr int kPer = 16 / sizeof(KV);           // elements a 16-byte chunk
  constexpr int kChunks = kDimsPerThread / kPer;  // chunks of a slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<KV>& sm = *reinterpret_cast<Smem<KV>*>(smem_raw);

  const int split = blockIdx.x, splits = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r = tid / 4, c = tid % 4;  // key slot r, dims 16c .. 16c + 15
  const int t0 = split * tiles;
  const int nt = min(tiles, (T_len + kTile - 1) / kTile - t0);
  const KV* kb = k + b * st.k_sb + h * st.k_sh + c * kDimsPerThread;
  const KV* vb = v + b * st.v_sb + h * st.v_sh + c * kDimsPerThread;
  if (tid < kD) sm.q[tid] = apex::to_float(q[b * st.q_sb + h * st.q_sh + tid]);
  // tile i of the split into stage i % S: a thread's 16-byte chunks of its
  // key's K and V slices, and (B8) the key's scales; a masked key reads
  // nothing and its chunks fill with zeros.  Its bias row is bias[i - i0].
  auto issue = [&](int i, int i0) {
    const int stg = i % S;
    const bool live = sm.bias[i - i0][r] > apex::kNegInf * 0.5f;
    const int64_t j = live ? static_cast<int64_t>(t0 + i) * kTile + r : 0;
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      sm90::cp_async16(
          sm90::smem_u32(&sm.kv[stg][0][r][c * kDimsPerThread + u * kPer]),
          kb + j * st.k_st + u * kPer, live);
      sm90::cp_async16(
          sm90::smem_u32(&sm.kv[stg][1][r][c * kDimsPerThread + u * kPer]),
          vb + j * st.v_st + u * kPer, live);
    }
    if constexpr (kQ8) {
      sm90::cp_async4(sm90::smem_u32(&sm.sc[stg][0][tid]),
                      k_scale + b * st.ks_sb + j * st.ks_st + h * st.ks_sh,
                      live);
      sm90::cp_async4(sm90::smem_u32(&sm.sc[stg][1][tid]),
                      v_scale + b * st.vs_sb + j * st.vs_st + h * st.vs_sh,
                      live);
    }
  };

  // online softmax over the split's tiles, per key slot: its running
  // max, sum of exp and (a thread's dims of) p @ v
  float qv[kDimsPerThread];
  float m_run = -INFINITY, lp = 0.f, pv[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) pv[i] = 0.f;
  for (int i0 = 0; i0 < nt; i0 += kBiasTiles) {  // runs of bias rows
    const int i1 = min(nt, i0 + kBiasTiles);
    __syncthreads();  // the previous run's bias rows and stages are read
    for (int x = tid; x < (i1 - i0) * kTile; x += kThreads) {
      const int j = (t0 + i0) * kTile + x;
      sm.bias[x / kTile][x % kTile] =
          j >= T_len ? -INFINITY
                     : (bias != nullptr
                            ? bias[static_cast<int64_t>(b) * T_len + j]
                            : 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i)
      qv[i] = sm.q[c * kDimsPerThread + i];
    // steps of U tiles: a step is computed while the next one loads
    sm90::cp_async_wait<0>();  // no copy of the previous run pending
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u < i1) issue(i0 + u, i0);
    sm90::cp_async_commit();
    for (int i = i0; i < i1; i += U) {
      // a thread reads only the chunks it copied itself, so its own wait
      // makes the step's tiles visible and frees the previous step's
      // stages: no barrier
      sm90::cp_async_wait<0>();
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + U + u < i1) issue(i + U + u, i0);
      sm90::cp_async_commit();

      // the step's scores first (independent fma chains, then each key's
      // quad), then the online updates tile by tile
      float sc[U], vf[U][kDimsPerThread];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int stg = (i + u) % S;
        sc[u] = -INFINITY;
        if (i + u >= i1) continue;
        const float bj = sm.bias[i + u - i0][r];
        float kf[kDimsPerThread];
        slice_to_float<T, kQ8>(&sm.kv[stg][0][r][c * kDimsPerThread],
                               kQ8 ? sm.sc[stg][0][tid] : 1.f, kf);
        slice_to_float<T, kQ8>(&sm.kv[stg][1][r][c * kDimsPerThread],
                               kQ8 ? sm.sc[stg][1][tid] : 1.f, vf[u]);
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kDimsPerThread; ++d) dot += qv[d] * kf[d];
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (bj > apex::kNegInf * 0.5f) sc[u] = dot * scale + bj;
      }
#pragma unroll
      for (int u = 0; u < U && i + u < i1; ++u) {
        const float m_new = fmaxf(m_run, sc[u]);
        if (m_new == -INFINITY) continue;  // no live key in the slot yet
        const float p = __expf(sc[u] - m_new);  // 0 for masked keys
        if (m_new != m_run) {  // rescale: 0 before the first live key
          const float alpha = __expf(m_run - m_new);
          lp *= alpha;
#pragma unroll
          for (int d = 0; d < kDimsPerThread; ++d) pv[d] *= alpha;
        }
        lp += p;
#pragma unroll
        for (int d = 0; d < kDimsPerThread; ++d) pv[d] += p * vf[u][d];
        m_run = m_new;
      }
    }
  }

  // the split's max over key slots; each slot's sums weighted by
  // exp(m_slot - m)
  sm90::cp_async_wait<0>();
  const float mw = apex::warp_max(m_run);
  if (lane == 0) sm.wm[warp] = mw;
  __syncthreads();  // the stages are free: the p * v rows reuse them
  float m = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, sm.wm[w]);
  const float wt = m_run == -INFINITY ? 0.f : expf(m_run - m);
  float(*pv_s)[kPvStride] = reinterpret_cast<float(*)[kPvStride]>(sm.kv);
#pragma unroll
  for (int u = 0; u < kDimsPerThread / 4; ++u) {
    apex::Pack<float, 4> pk;
#pragma unroll
    for (int e = 0; e < 4; ++e) pk.v[e] = wt * pv[4 * u + e];
    apex::store_pack<float, 4>(&pv_s[r][c * kDimsPerThread + 4 * u], pk);
  }
  if (c == 0) sm.lp[r] = wt * lp;
  __syncthreads();
  // group g = tid / 64 adds key slots 16g .. 16g + 15 in order for head
  // dim tid % 64, then the groups meet in order
  const int g = tid / kD, d = tid % kD;
  {
    float gs = 0.f;
#pragma unroll
    for (int rr = 0; rr < kTile / kGroups; ++rr)
      gs += pv_s[g * (kTile / kGroups) + rr][d];
    sm.grp[g][d] = gs;
    if (d == 0) {
      float ps = 0.f;
#pragma unroll
      for (int rr = 0; rr < kTile / kGroups; ++rr)
        ps += sm.lp[g * (kTile / kGroups) + rr];
      sm.red[g] = ps;
    }
  }
  __syncthreads();
  float l = sm.red[0], a = 0.f;  // a: acc[tid] for tid < kD
#pragma unroll
  for (int gg = 1; gg < kGroups; ++gg) l += sm.red[gg];
  if (tid < kD) {
    a = sm.grp[0][tid];
#pragma unroll
    for (int gg = 1; gg < kGroups; ++gg) a += sm.grp[gg][tid];
  }
  T* orow = o + b * st.o_sb + h * st.o_sh;
  if (splits == 1) {  // the only split: its partial is the row
    if (tid < kD)
      orow[tid] = apex::from_float<T>(
          m > apex::kNegInf * 0.5f ? a / fmaxf(l, 1e-30f) : 0.f);
    return;
  }
  // the partial, made visible to the other splits' blocks before the count
  const int64_t slot = static_cast<int64_t>(bh) * splits + split;
  if (tid == 0) ml[slot] = make_float2(m, l);
  if (tid < kD) {
    acc[slot * kD + tid] = a;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) sm.last = atomicAdd(&counters[bh], 1) == splits - 1;
  __syncthreads();
  if (!sm.last) return;

  // the last split of (b, h): thread (g, d) loads the partials of splits
  // g, g + 4, ... at once; the max over splits, then group g adds its
  // splits in order for head dim d, and the four groups meet in order
  __threadfence();
  const float2* mlr = ml + static_cast<int64_t>(bh) * splits;
  const float* ar = acc + static_cast<int64_t>(bh) * splits * kD + d;
  float2 mt[kSplitsPerThread];
  float at[kSplitsPerThread];
  float mx = -INFINITY;
#pragma unroll
  for (int u = 0; u < kSplitsPerThread; ++u) {
    const int sp = g + u * kGroups;
    mt[u] = sp < splits ? __ldcg(&mlr[sp]) : make_float2(-INFINITY, 0.f);
    at[u] = sp < splits ? __ldcg(&ar[static_cast<int64_t>(sp) * kD]) : 0.f;
    mx = fmaxf(mx, mt[u].x);
  }
  mx = apex::warp_max(mx);
  if (lane == 0) sm.wm[warp] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm.wm[w]);
  const bool any_live = mx > apex::kNegInf * 0.5f;
  float lsum = 0.f, asum = 0.f;
  if (any_live) {
#pragma unroll
    for (int u = 0; u < kSplitsPerThread; ++u) {
      if (mt[u].x == -INFINITY) continue;  // a split with no live key
      const float w8 = expf(mt[u].x - mx);
      lsum += w8 * mt[u].y;
      asum += w8 * at[u];
    }
  }
  sm.grp[g][d] = asum;
  if (d == 0) sm.red[g] = lsum;
  __syncthreads();
  if (tid < kD) {
    float out = 0.f;
    if (any_live) {
      float lt = sm.red[0], as = sm.grp[0][tid];
#pragma unroll
      for (int gg = 1; gg < kGroups; ++gg) {
        lt += sm.red[gg];
        as += sm.grp[gg][tid];
      }
      out = as / fmaxf(lt, 1e-30f);
    }
    orow[tid] = apex::from_float<T>(out);
  }
  if (tid == 0) counters[bh] = 0;  // ready for the next launch
}

// tiles: the 64-key tiles of a split (a block); splits =
// ceil(ceil(T / 64) / tiles) <= kMaxSplits
template <typename T, bool kQ8>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const float* bias, void* o, void* scratch, int* counters,
                   int B, int H, int T_len, int tiles, const Strides& st,
                   float scale, cudaStream_t stream) {
  using KV = typename KVType<T, kQ8>::type;
  const int n_tiles = (T_len + kTile - 1) / kTile;
  const int splits = tiles > 0 ? (n_tiles + tiles - 1) / tiles : 0;
  if (B * H > 65535 || splits < 1 || splits > kMaxSplits)
    return cudaErrorInvalidValue;
  static unsigned smem_done = 0;
  constexpr int kSmem = sizeof(Smem<KV>);
  const cudaError_t err = sm90::allow_smem(decode_attention_kernel<T, kQ8>,
                                           kSmem, &smem_done);
  if (err != cudaSuccess) return err;
  // scratch: (B * H * splits) float2 (m, l), then (B * H * splits * kD)
  float2* ml = static_cast<float2*>(scratch);
  float* acc = reinterpret_cast<float*>(
      ml + static_cast<int64_t>(B) * H * splits);
  decode_attention_kernel<T, kQ8><<<dim3(splits, B * H), kThreads, kSmem,
                                    stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), k_scale, v_scale, bias, static_cast<T*>(o),
      ml, acc, counters, H, T_len, tiles, st, scale);
  return cudaGetLastError();
}

template <bool kQ8>
cudaError_t dispatch(int dtype, int D, const void* q, const void* k,
                     const void* v, const float* k_scale,
                     const float* v_scale, const float* bias, void* o,
                     void* scratch, int* counters, int B, int H, int T_len,
                     int tiles, const Strides& st, float scale,
                     cudaStream_t stream) {
  // head_dim 64 only: GPT-2 small and medium; another head_dim is built
  // when a configuration that needs it is ported
  if (D != kD) return cudaErrorInvalidValue;
  switch (dtype) {
    case apex::kFloat32:
      return launch<float, kQ8>(q, k, v, k_scale, v_scale, bias, o, scratch,
                                counters, B, H, T_len, tiles, st, scale,
                                stream);
    case apex::kBFloat16:
      return launch<__nv_bfloat16, kQ8>(q, k, v, k_scale, v_scale, bias, o,
                                        scratch, counters, B, H, T_len, tiles,
                                        st, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// B7. q: (B, 1, H, D), k/v: (B, T, H, D), o: (B, 1, H, D), all in
// `dtype` with unit stride on D, k/v rows 16-byte aligned.  strides[10]
// = q (sb, sh), k (sb, st, sh), v (sb, st, sh), o (sb, sh) in elements.
// bias: (B, T) fp32 contiguous or null.  tiles: the 64-key tiles a
// block takes, so that splits = ceil(ceil(T / 64) / tiles) <= 32.  With
// more than one split: scratch holds B * H * splits * 66 floats, and
// counters B * H int32 zeros that the launch leaves zero (one set per
// stream: launches that share it run in order).
extern "C" int apex_decode_attention(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* o, void* scratch, void* counters,
                                     int B, int H, int T_len, int D,
                                     int tiles, const void* strides,
                                     float scale, int dtype, void* stream) {
  const int64_t* s = static_cast<const int64_t*>(strides);
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                   s[9], 0, 0, 0, 0, 0, 0};
  return static_cast<int>(dispatch<false>(
      dtype, D, q, k, v, nullptr, nullptr, static_cast<const float*>(bias),
      o, scratch, static_cast<int*>(counters), B, H, T_len, tiles, st, scale,
      static_cast<cudaStream_t>(stream)));
}

// B8. As apex_decode_attention with int8 k/v and their fp32 scales
// k_scale/v_scale (B, T, H); strides[16] = the ten above, then k_scale
// (sb, st, sh) and v_scale (sb, st, sh) in elements.  q and o in
// `dtype` (fp32 or bf16), the compute dtype K/V widen to.
extern "C" int apex_decode_attention_q8(const void* q, const void* k,
                                        const void* v, const void* k_scale,
                                        const void* v_scale, const void* bias,
                                        void* o, void* scratch,
                                        void* counters, int B, int H,
                                        int T_len, int D, int tiles,
                                        const void* strides, float scale,
                                        int dtype, void* stream) {
  const int64_t* s = static_cast<const int64_t*>(strides);
  const Strides st{s[0],  s[1],  s[2],  s[3],  s[4],  s[5],  s[6],  s[7],
                   s[8],  s[9],  s[10], s[11], s[12], s[13], s[14], s[15]};
  return static_cast<int>(dispatch<true>(
      dtype, D, q, k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const float*>(bias), o,
      scratch, static_cast<int*>(counters), B, H, T_len, tiles, st, scale,
      static_cast<cudaStream_t>(stream)));
}
