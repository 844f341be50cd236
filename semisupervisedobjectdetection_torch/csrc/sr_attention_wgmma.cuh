// Building blocks of the SR-attention kernels on Hopper (sm_90a), shared by
// the forward (sr_attention_fwd.cu) and the backward (sr_attention_bwd.cu):
// bf16 packing and the special-function exponential, the opt-in to a
// block's full shared memory, mbarriers, TMA loads and stores through
// tensor maps (and their encoding on the host), the wgmma descriptors of a
// swizzled tile and the wgmma products the kernels issue.
//
// One swizzle serves a tile of rows D bf16 wide (a row of q, k, v, g, dq:
// one head): swizzle_bits<D>() is used by the tensor maps that write the
// tile and by the descriptors that read it, so TMA and wgmma agree. A tile
// is read K-major (the product's reduction runs along the row: q and k in
// q k^T) or MN-major (along the columns: v in p v, k in ds k), the latter
// with wgmma's transpose bit for 16-bit types; both from the same bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace sr_wgmma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x by the special-function unit (relative error ~2^-22; 0 for -inf).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1/x by the special-function unit (relative error ~2^-23).
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 in one register, `lo` in the low half (the
// lower column of a fragment).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// The swizzle of a row of D bf16, shared by the tensor maps and the wgmma
// descriptors: 128 bytes at D = 64, 64 at D = 32 (Swizzle<B, 4, 3>: address
// bits [7, 7 + B) XORed into bits [4, 4 + B), B = 3 or 2).
template <int D>
__host__ __device__ constexpr int swizzle_bits() {
  static_assert(D == 32 || D == 64, "head width 32 or 64");
  return D == 64 ? 3 : 2;
}

// The byte offset of element (row r, column col) of a tile whose rows are D
// bf16 wide, as the tensor maps and the descriptors of swizzle_bits<D>()
// lay it out.
template <int D>
__device__ __forceinline__ uint32_t swizzled(uint32_t r, uint32_t col) {
  uint32_t off = r * D * sizeof(bf16) + col * sizeof(bf16);
  return off ^ (((off >> 7) & ((1u << swizzle_bits<D>()) - 1)) << 4);
}

// ---- mbarriers, TMA and wgmma in PTX ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arrive once and expect `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of `map` at (c0, c1, c2) into shared memory at dst; completion is
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Shared memory at src to the box of `map` at (c0, c1, c2); rows outside
// the tensor are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's TMA stores have read their shared memory
// (`Read`) or completed.
template <bool Read>
__device__ __forceinline__ void tma_store_wait() {
  if (Read)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared-memory writes of this thread made visible to the async proxy
// (TMA stores and wgmma operand reads) that the next barrier orders.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// the wgmma fences and waits (the products run asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The wgmma descriptor of a tile in shared memory at `addr` whose rows are
// D bf16 wide, swizzled as the tensor maps write them: 8-row groups
// 8 * D * 2 bytes apart. The same offset goes in both stride fields: a
// K-major operand uses only the 8-row stride, and an MN-major one (whose
// MN extent, D, is one swizzle atom) only the stride between 8-row groups
// along K.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t group = (8 * D * sizeof(bf16)) >> 4;
  constexpr uint64_t layout = swizzle_bits<D>() == 3 ? 1 : 2;  // 128B, 64B
  return uint64_t((addr & 0x3FFFF) >> 4) | (group << 16) | (group << 32) |
         (layout << 62);
}

#define SR_F1(i) "+f"(d[i])
#define SR_F4(i) SR_F1(i), SR_F1((i) + 1), SR_F1((i) + 2), SR_F1((i) + 3)
#define SR_F16(i) SR_F4(i), SR_F4((i) + 4), SR_F4((i) + 8), SR_F4((i) + 12)
#define SR_F32(i) SR_F16(i), SR_F16((i) + 16)
#define SR_F64(i) SR_F32(i), SR_F32((i) + 32)
#define SR_F128(i) SR_F64(i), SR_F64((i) + 64)

// d (+)= A B for a 64 x 256 tile over k = 16: A (64 x 16) and B (256 x 16)
// both K-major in shared memory (descriptors), d float32 in registers.
__device__ __forceinline__ void wgmma_ss_n256(float* d, uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : SR_F128(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B for a 64 x 32 tile over k = 16: A (64 x 16) and B (32 x 16)
// in shared memory (descriptors), K-major, or MN-major where TA / TB is 1
// (wgmma's transpose bits); d float32 in registers.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : SR_F16(0)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// As wgmma_ss_n32 for a 64 x 16 tile.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : SR_F4(0), SR_F4(4)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// As wgmma_ss_n32 for a 64 x 64 tile.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : SR_F32(0)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (+)= A B for a 64 x 64 tile over k = 16: A (64 x 16 bf16) in registers
// as four bf16 pairs per thread, B (16 x 64) MN-major in shared memory
// (its descriptor, trans-b), d float32 in registers.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SR_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= A B for a 64 x 32 tile over k = 16: A (64 x 16 bf16) in registers
// as four bf16 pairs per thread, B (16 x 32) MN-major in shared memory
// (its descriptor, trans-b), d float32 in registers.
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : SR_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// ---- float32 products on the TF32 tensor cores (3xTF32) ----
//
// A float32 x splits into hi = tf32(x) (round to nearest) and
// lo = tf32(x - hi); a b is then a_lo b_hi + a_hi b_lo + a_hi b_hi, each a
// TF32 product summed in float32 in the same accumulator (the a_lo b_lo
// term dropped is ~2^-22 of a b). wgmma takes .tf32 operands in shared
// memory K-major only (the transpose bits are for 16-bit types), so every
// shared-memory operand here is a tile whose rows run along the product's
// reduction: a float32 tile of R rows and W columns is stored as W / 32
// panels of [R][32] floats (128-byte rows, 128-byte swizzle), each panel
// R * 128 bytes, as the float32 tensor maps write them.

// tf32(x) by round to nearest (ties away), as the bits of a float.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both TF32 (lo holds what tf32(x) drops, rounded again).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The byte offset of element (r, c) of a float32 panel tile of `rows` rows.
__device__ __forceinline__ uint32_t f32_off(uint32_t r, uint32_t c,
                                            uint32_t rows) {
  uint32_t off = (c >> 5) * rows * 128u + r * 128u + (c & 31u) * 4u;
  return off ^ (((off >> 7) & 7u) << 4);
}

// The wgmma descriptor of k-step kk (8 columns) of a float32 panel tile of
// `rows` rows at `addr` (1024-aligned), K-major, 128-byte swizzle: 8-row
// groups 1024 bytes apart.
__device__ __forceinline__ uint64_t f32_desc(uint32_t addr, int kk,
                                             uint32_t rows) {
  const uint32_t a = addr + (kk >> 2) * rows * 128u + (kk & 3) * 32u;
  return uint64_t((a & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// d (+)= A B for a 64 x 32 tile over k = 8: A (64 x 8 tf32) in registers
// (thread (warp w, lane 4g + t): a[0] row 16w + g column t, a[1] row
// 16w + g + 8 column t, a[2] and a[3] the same rows at column t + 4), B
// (32 x 8) K-major in shared memory (its descriptor), d float32.
__device__ __forceinline__ void wgmma_tf32_n32(float* d, const uint32_t* a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : SR_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// As wgmma_tf32_n32 for a 64 x 64 tile.
__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SR_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef SR_F1
#undef SR_F4
#undef SR_F16
#undef SR_F32
#undef SR_F64
#undef SR_F128

// The 3xTF32 product d (+)= A B over k = 8 * KS of an N-column tile (32 or
// 64): A split in registers (ahi, alo: 4 values a k-step), B the hi and lo
// panel tiles of `rows` rows at bhi, blo; per k-step lo hi, hi lo, then
// hi hi (with Swap, hi lo first: the same terms in the same order as the
// product with A and B exchanged, so the two give the same bits).
// `accumulate` 0 starts d from zero.
template <int N, int KS, bool Swap = false>
__device__ __forceinline__ void wgmma_3xtf32(float* d, const uint32_t* ahi,
                                             const uint32_t* alo,
                                             uint32_t bhi, uint32_t blo,
                                             uint32_t rows, int accumulate) {
  static_assert(N == 32 || N == 64, "N is 32 or 64");
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t dh = f32_desc(bhi, kk, rows), dl = f32_desc(blo, kk, rows);
    const uint32_t* a1 = Swap ? ahi + 4 * kk : alo + 4 * kk;
    const uint32_t* a2 = Swap ? alo + 4 * kk : ahi + 4 * kk;
    const uint64_t b1 = Swap ? dl : dh, b2 = Swap ? dh : dl;
    if constexpr (N == 64) {
      wgmma_tf32_n64(d, a1, b1, kk > 0 || accumulate);
      wgmma_tf32_n64(d, a2, b2, 1);
      wgmma_tf32_n64(d, ahi + 4 * kk, dh, 1);
    } else {
      wgmma_tf32_n32(d, a1, b1, kk > 0 || accumulate);
      wgmma_tf32_n32(d, a2, b2, 1);
      wgmma_tf32_n32(d, ahi + 4 * kk, dh, 1);
    }
  }
}

// The A fragments (hi, lo) of k-steps 0 .. KS - 1 of rows 0-63 of a float32
// panel tile of `rows` rows at `tile` (generic pointer), for thread (warp w,
// lane 4g + t) of a warpgroup: row 16w + g (+ 8), column 8kk + t (+ 4).
template <int KS>
__device__ __forceinline__ void load_a_tf32(const unsigned char* tile,
                                            uint32_t rows, int warp, int g,
                                            int t, uint32_t* hi,
                                            uint32_t* lo) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t r = 16 * warp + g + 8 * (j & 1);
      const uint32_t c = 8 * kk + t + 4 * (j >> 1);
      split_tf32(*reinterpret_cast<const float*>(tile + f32_off(r, c, rows)),
                 hi[4 * kk + j], lo[4 * kk + j]);
    }
}

// The accumulator of a 64 x N product (thread (warp w, lane 4g + t): d[i]
// at row 16w + g + 8 ((i >> 1) & 1), column 8 (i / 4) + 2t + (i & 1)) as
// the split register A operand of a product along its N columns. A k-step
// holds 8 columns; the A layout wants columns t and t + 4 where the
// accumulator has 2t and 2t + 1, so A's column t is taken to be column 2t
// and its column t + 4 column 2t + 1: the B operand of that product stores
// its 8 reduction positions of a k-step in the order kperm() gives.
template <int N>
__device__ __forceinline__ void acc_to_a_tf32(const float* d, uint32_t* hi,
                                              uint32_t* lo) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    split_tf32(d[4 * kk + 0], hi[4 * kk + 0], lo[4 * kk + 0]);
    split_tf32(d[4 * kk + 2], hi[4 * kk + 1], lo[4 * kk + 1]);
    split_tf32(d[4 * kk + 1], hi[4 * kk + 2], lo[4 * kk + 2]);
    split_tf32(d[4 * kk + 3], hi[4 * kk + 3], lo[4 * kk + 3]);
  }
}

// The source index of reduction position `pos` of a B tile read by
// acc_to_a_tf32's A operand: within each 8, positions 0-3 hold 0, 2, 4, 6
// and 4-7 hold 1, 3, 5, 7.
__host__ __device__ __forceinline__ int kperm(int pos) {
  const int c = pos & 7;
  return (pos & ~7) | (c < 4 ? 2 * c : 2 * (c - 4) + 1);
}

// The register-A product of N = D columns (64 or 32).
template <int D>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b, int accumulate) {
  if constexpr (D == 64)
    wgmma_rs_n64(d, a, b, accumulate);
  else
    wgmma_rs_n32(d, a, b, accumulate);
}

// The shared-memory product of N columns (64, 32 or 16).
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64, "N is 16, 32 or 64");
  if constexpr (N == 64)
    wgmma_ss_n64<TA, TB>(d, a, b, accumulate);
  else if constexpr (N == 32)
    wgmma_ss_n32<TA, TB>(d, a, b, accumulate);
  else
    wgmma_ss_n16<TA, TB>(d, a, b, accumulate);
}

// The accumulator of a 64 x N product as the register A operand of the
// next product along N: thread (warp w, lane 4g + t) holds rows 16w + g
// (d[i] with bit 1 of i clear) and 16w + g + 8, columns
// 8 (i / 4) + 2t + (i & 1); the A fragment of k-tile kk (columns 16kk ..
// 16kk + 15) is elements 8kk .. 8kk + 7 in pairs, rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_a(const float* d, uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack(d[2 * i], d[2 * i + 1]);
}

// ---- tensor maps (host) ----

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (no
// link against libcuda).
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// Makes the current device's primary context current on the calling
// thread, as the runtime does at its first call that needs one.
// cuTensorMapEncodeTiled needs a current context, and a thread whose first
// CUDA work is this launch (a Python thread, autograd's backward thread)
// may have none yet.
inline bool bind_context() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess &&
         cudaSetDevice(dev) == cudaSuccess;
}

// The 3-D tensor map over a (B, N, C) bf16 tensor that a kernel reads or
// writes in boxes of (D columns, `rows` rows, 1 batch), swizzled for
// wgmma; out-of-bounds rows read as zero and are not written.
template <int D>
bool encode_map(CUtensorMap* map, const void* ptr, int b, int n, int c,
                int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || !bind_context()) return false;
  const cuuint64_t dims[3] = {cuuint64_t(c), cuuint64_t(n), cuuint64_t(b)};
  const cuuint64_t strides[2] = {cuuint64_t(c) * sizeof(bf16),
                                 cuuint64_t(n) * c * sizeof(bf16)};
  const cuuint32_t box[3] = {cuuint32_t(D), cuuint32_t(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle_bits<D>() == 3 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 3-D tensor map over a (B, N, C) float32 tensor that a kernel reads in
// boxes of (32 columns, `rows` rows, 1 batch): one panel of a float32 panel
// tile, 128-byte swizzle; out-of-bounds rows read as zero.
inline bool encode_map_f32(CUtensorMap* map, const void* ptr, int b, int n,
                           int c, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || !bind_context()) return false;
  const cuuint64_t dims[3] = {cuuint64_t(c), cuuint64_t(n), cuuint64_t(b)};
  const cuuint64_t strides[2] = {cuuint64_t(c) * sizeof(float),
                                 cuuint64_t(n) * c * sizeof(float)};
  const cuuint32_t box[3] = {32, cuuint32_t(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sr_wgmma
