// Building blocks of the bfloat16 SR-attention kernels on Hopper's tensor
// cores through warp-level mma.sync (sm_80+ instructions, built for sm_90a):
// 16-byte cp.async copies, ldmatrix loads of mma fragments, the
// m16n8k16 bf16 product with float32 accumulation, and the rule that turns
// an accumulator (C) fragment into an A fragment so that a tile of
// probabilities or score gradients computed in registers feeds the next
// product without a trip through shared memory.
//
// Fragments of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16x16, row-major)   a0: (g,   2t..2t+1)   a1: (g+8, 2t..2t+1)
//                          a2: (g,   2t+8..+9)   a3: (g+8, 2t+8..+9)
//   B (16x8, k x n)        b0: (k 2t..2t+1, n g) b1: (k 2t+8..+9, n g)
//   C (16x8, float32)      c0, c1: (g, 2t..2t+1) c2, c3: (g+8, 2t..2t+1)
// Two C tiles side by side (columns 0-7 and 8-15) hold, lane by lane, the
// elements of one A tile: `c_to_a`.
//
// Tiles live in shared memory row-major with a row stride of D + 8
// elements: 16 bytes past a multiple of 128, so the eight rows an ldmatrix
// phase reads fall in eight different 16-byte bank groups (no conflicts).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace sr_mma {

using bf16 = __nv_bfloat16;

// Shared-memory row stride, in elements, of a tile D elements wide.
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with valid false the
// destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a * b: one 16x8x16 product, bf16 in, float32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (relative error ~2^-22; 0 for -inf).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 in one register, `lo` in the low half (the
// lower column of a fragment).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of the 16x16 tile whose columns 0-7 are the C tile c0 and
// columns 8-15 the C tile c1, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Two floats as bf16 hi = bf16(x) and lo = bf16(x - hi) (the difference is
// exact in float32), packed as `pack` does.
__device__ __forceinline__ void pack_split(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  __nv_bfloat162 h = __halves2bfloat162(h0, h1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

// As `c_to_a`, in two parts hi and lo, so that a product with hi plus one
// with lo carries the float32 values to about 16 bits.
__device__ __forceinline__ void c_to_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&c0)[4],
                                             const float (&c1)[4]) {
  pack_split(c0[0], c0[1], hi[0], lo[0]);
  pack_split(c0[2], c0[3], hi[1], lo[1]);
  pack_split(c1[0], c1[1], hi[2], lo[2]);
  pack_split(c1[2], c1[3], hi[3], lo[3]);
}

// Softmax, in place, of a warp's 16 score rows held as C tiles: s[t][n] is
// the tile of keys 16t + 8n .. 16t + 8n + 7, element i in row g (i < 2) or
// g + 8 (i >= 2), a row's keys spread over the 4 lanes of a quad. The raw
// scores q.k of the nk valid keys become p = 2^(s c - m) / l with
// c = scale log2(e), m the row max of s c and l the row sum; p is 0 past
// nk. Returns m and 1 / l of rows g and g + 8 (the same in the 4 lanes of
// a quad). Every tile takes the same straight-line code (no branch on nk):
// with control flow that depends on nk the compiler moves s to local
// memory. The row max and sum run in 4 partial chains (by tile % 4), not
// one chain of 2 KT dependent operations per row.
template <int KT>
__device__ __forceinline__ void softmax_rows(float (&s)[KT][2][4], int nk,
                                             float scale_log2, int lane,
                                             float (&m)[2],
                                             float (&inv_l)[2]) {
  const int t4 = lane & 3;
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[r][j] = -INFINITY;
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = t * 16 + n * 8 + 2 * t4 + (i & 1);
        s[t][n][i] = key < nk ? s[t][n][i] : -INFINITY;
        part[i >> 1][t & 3] = fmaxf(part[i >> 1][t & 3], s[t][n][i]);
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3]));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    m[r] *= scale_log2;
#pragma unroll
    for (int j = 0; j < 4; ++j) part[r][j] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[t][n][i] = exp2_approx(fmaf(s[t][n][i], scale_log2, -m[i >> 1]));
        part[i >> 1][t & 3] += s[t][n][i];
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv_l[r] = 1.f / l;
  }
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[t][n][i] *= inv_l[i >> 1];
}

// Where lane `lane` points ldmatrix_x4 for each operand, in elements from
// the tile's origin (row0, col0), for a row-major tile of stride ld:
//
// the A fragment of the 16x16 tile at (row0, col0);
__device__ __forceinline__ int a_offset(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
// the B fragments (b0, b1 of n-tile 0, b0, b1 of n-tile 1) of a tile
// stored n-major, [n][k] (K for q k^T: a key's row is the k dimension);
__device__ __forceinline__ int b_offset_nk(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}
// the same fragments of a tile stored k-major, [k][n] (V for p v), read
// with ldmatrix_x4_trans.
__device__ __forceinline__ int b_offset_kn(int lane, int ld) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + (lane >> 4) * 8;
}

// Lets `kernel` take the most dynamic shared memory a block may have on
// Hopper (227 KB), once per device; `done` holds one bit per device and
// belongs to the caller's kernel instantiation. Launches above 48 KB are
// refused without it.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel* kernel, std::atomic<uint32_t>& done) {
  constexpr int kMaxSmemBytes = 232448;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace sr_mma
