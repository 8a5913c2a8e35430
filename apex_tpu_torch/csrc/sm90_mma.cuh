// Hopper (sm_90a) pieces shared by the bf16 flash kernels (flash_fwd.cu,
// flash_bwd.cu): 16-byte cp.async into 128-byte-swizzled shared memory,
// the wgmma shared-memory descriptor for that swizzle, wgmma
// m64n64k16 bf16 -> fp32 with A from shared memory (SS) or registers
// (RS), the fences that order them, the register maps of the
// accumulator and of the A fragment, 2^x and the dropout keep bits of a
// score fragment (as S, or transposed as S^T for dk/dv), and the opt-in
// to dynamic shared memory above 48 KB.
//
// Tiles.  Every tile is rows of 64 bf16 (head_dim 64 = 128 bytes, the
// swizzle's width) in shared memory whose base is 1024-byte aligned; the
// 16-byte chunk c of row r lies at r * 128 + ((c ^ (r % 8)) * 16), the
// pattern the hardware's SWIZZLE_128B reads (address bits 4-6 XOR bits
// 7-9).  Such a tile is an operand two ways:
//   K-major (the reduction index runs along the row): A = q or do as
//     [row][d], or B = k or v as [key][d] for a product over d.  Rows
//     come in 8-row groups 1024 bytes apart (SBO); a k16 step moves the
//     start address 32 bytes along the row.
//   MN-major (the output column runs along the row): B = v or k as
//     [key][d] for a product over keys, or q or do as [query][d] for a
//     product over queries (transpose bit 1).  8 rows per 1024-byte
//     group (SBO); a k16 step is two groups, 2048 bytes.
// Fragments (per warp w of the warpgroup, lane t, g = t / 4, c = t % 4):
//   accumulator m64n64 fp32, 32 registers: d[4 * j + 2 * i + e] is row
//     16 w + g + 8 i, column 8 j + 2 c + e (j < 8, i, e < 2);
//   A m64k16 bf16, 4 registers of two: a[0] row g cols 2c..2c+1,
//     a[1] row g+8, a[2] row g cols 8+2c.., a[3] row g+8 cols 8+2c..
// so columns 16 k..16 k+15 of an accumulator are, packed in pairs, the A
// fragment of k16 step k of the next product (acc_to_a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0..7) of row r in a swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// -- cp.async: 16 bytes (4 for the key mask) from global to shared; a
// false `full` reads nothing and writes zeros ---------------------------
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// makes this thread's completed shared-memory writes visible to wgmma
// (the async proxy); a block barrier after it covers every thread's
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma -------------------------------------------------------------

// shared-memory matrix descriptor: start address, leading and stride
// byte offsets in 16-byte units, layout SWIZZLE_128B (1 << 62)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t sbo_bytes) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;  // LBO: unused by these layouts
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// k16 step `kk` of a K-major tile (A, or B for a product over d)
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return desc_sw128(tile + 32 * kk, 1024);
}

// k16 step `kk` of an MN-major B tile ([key][d] for a product over keys)
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return desc_sw128(tile + 2048 * kk, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator
// registers across an asynchronous wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for A fragments in registers: an RS wgmma reads them after it
// is issued, so they must stay live and unchanged until its wait
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][r])::"memory");
}

#define APEX_WGMMA_D32                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define APEX_WGMMA_OUT32(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (+)= A B, m64n64k16, A and B from shared memory; scale_d = 0
// overwrites d.  kTnspB = 1 reads an MN-major B.
template <int kTnspB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " APEX_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : APEX_WGMMA_OUT32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTnspB));
}

// d += A B, m64n64k16, A from registers (acc_to_a), B from shared memory
template <int kTnspB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " APEX_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : APEX_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(kTnspB));
}

// d = A B^T over a 64-wide reduction (four k16 steps) from two K-major
// tiles, e.g. S = Q K^T; issued, not committed or waited for
__device__ __forceinline__ void wgmma_tile_ss(float (&d)[32], uint32_t a_tile,
                                              uint32_t b_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0>(d, desc_k_major(a_tile, kk), desc_k_major(b_tile, kk),
                kk > 0);
}

// d += A B over 64 keys (four k16 steps), A in registers (acc_to_a), B
// an MN-major [key][d] tile, e.g. O += P V; issued, not committed
__device__ __forceinline__ void wgmma_tile_rs(float (&d)[32],
                                              const uint32_t (&a)[4][4],
                                              uint32_t b_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<1>(d, a[kk], desc_mn_major(b_tile, kk));
}

#undef APEX_WGMMA_D32
#undef APEX_WGMMA_OUT32

// -- fragments ---------------------------------------------------------

// two fp32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// an m64n64 fp32 accumulator, rounded to bf16, as the A fragments of the
// four k16 steps of a product over its 64 columns
__device__ __forceinline__ void acc_to_a(const float (&d)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[k][r] = pack_bf16(d[8 * k + 2 * r], d[8 * k + 2 * r + 1]);
  }
}

// row (0 or 1: g or g + 8 within the warp's 16) and column (0..63) of
// accumulator register r for lane `lane`
__device__ __forceinline__ constexpr int acc_row_half(int r) {
  return (r >> 1) & 1;
}
__device__ __forceinline__ int acc_col(int r, int lane) {
  return 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
}

// 2^x on the SFU (ex2.approx.ftz): one instruction; a result below
// 2^-126 flushes to 0, and -1e30 (a masked score) gives 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the attention-dropout keep bits of this lane's 32 elements of a 64x64
// score accumulator (bit r: register r), for the rows row0 and row0 + 8
// and keys k0.. (apex::dropout_keep on global coordinates)
__device__ __forceinline__ uint32_t keep_bits(const apex::DropoutCoords& dc,
                                              int row0, int k0, int lane,
                                              float rate) {
  uint32_t bits = 0;
#pragma unroll
  for (int r = 0; r < 32; ++r)
    bits |= static_cast<uint32_t>(apex::dropout_keep(
                dc.seed, dc.bh,
                static_cast<uint32_t>(row0 + 8 * acc_row_half(r) + dc.row_off),
                static_cast<uint32_t>(k0 + acc_col(r, lane) + dc.col_off),
                rate))
            << r;
  return bits;
}

// the same bits for a TRANSPOSED score accumulator, whose rows are keys
// and columns queries (dk/dv compute S^T = K Q^T): bit r for register r,
// keys key0 and key0 + 8, queries q0..; the hash's row is still the
// query and its column the key, so both forms draw one mask
__device__ __forceinline__ uint32_t keep_bits_t(const apex::DropoutCoords& dc,
                                                int key0, int q0, int lane,
                                                float rate) {
  uint32_t bits = 0;
#pragma unroll
  for (int r = 0; r < 32; ++r)
    bits |= static_cast<uint32_t>(apex::dropout_keep(
                dc.seed, dc.bh,
                static_cast<uint32_t>(q0 + acc_col(r, lane) + dc.row_off),
                static_cast<uint32_t>(key0 + 8 * acc_row_half(r) + dc.col_off),
                rate))
            << r;
  return bits;
}

// sum and max over the four lanes of a quad (one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

// -- launch ------------------------------------------------------------

// lets `kernel` take `bytes` of dynamic shared memory (above 48 KB it
// must ask); set once per device, the devices done kept in *done
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

}  // namespace sm90
