// SR-attention forward for Hopper (sm_90a): out = softmax(q k^T / sqrt(d)) v
// per (batch, head), with q of shape (B, Nq, C) and k, v of shape (B, Nk, C),
// C = heads * d, all row-major and contiguous.
//
// Replaces the Pallas TPU kernel semisupervisedobjectdetection_tpu/ops/
// sr_attention.py::_attn_kernel and computes the same function: scores and
// softmax in float32, one full-row softmax (the key row is short: Nk is 256
// plus a few prompt/CLS tokens at MiT shapes, at most 288 here), the
// normalised probabilities rounded to v's type before P.V, float32
// accumulation, output in q's type.
//
// Bound. At MiT-B5 512x512 shapes the function is bound by the bytes it
// must move (q in, out back: 2*B*Nq*C elements) on the bf16 tensor-core
// peak: 4*B*Nq*Nk*C flops over 2*B*(Nq+Nk)*C*2 bytes is ~250 flops a byte
// at Nk = 256, d = 64, under the card's ~295. So the products must run on
// the tensor cores at near their rate while q streams through at near the
// memory rate; the softmax around them (one exp2 per score on the
// special-function units, 16 a cycle an SM: at d = 64 as many cycles as the
// products take on the tensor cores) is the next limit. Two kernels:
//
// The Hopper kernel (sr_attention_fwd_wgmma_kernel, bfloat16, taken when
// the caller asks for it: every bfloat16 path of the package). A CTA is two
// consumer warpgroups and a producer warpgroup, one CTA an SM. A persistent
// grid of one CTA per SM walks the 64-row query tiles of all (batch,
// head)s in order, each CTA a contiguous, equal range, so a CTA takes many
// tiles of the same (batch, head) and loads its K and V once for them
// (again only where its range crosses into the next (batch, head)); its
// tiles alternate between the two consumers, which share K and V. The
// producer thread loads K and V by TMA (boxes of 32 keys) into shared
// memory in the layout wgmma reads (128-byte swizzle at d = 64, 64-byte at
// d = 32), K and V on separate mbarriers so that the first product waits
// for K only, and keeps query tiles in flight in a ring of 3 stages per
// consumer (3-D tensor maps over (C, N, B), box (d, 64, 1) at column h*d:
// ragged query tails and keys past Nk are zero-filled by the TMA unit,
// never read across a batch boundary). A consumer warpgroup, per tile:
// s = q k^T by wgmma m64n256k16 (+ m64n32k16 for the keys past 256) from
// shared memory, both operands K-major; the query stage released; the
// keys past Nk masked to -inf, the row max and sum over the 4 lanes of a
// quad, p = 2^(s c - m) / l rounded to bf16 in registers as the A operand
// (the accumulator layout of one product is the register-A layout of the
// next), so the rounding point is the plain version's; o = p v by wgmma
// m64n{d}k16 with V read MN-major (trans-b) from shared memory; o through
// its swizzled staging tile to a TMA store, which overlaps the next tile's
// products.
//
// What bounds it, measured on the H100 (PERF.md): per 64-row tile at
// Nk 256, d 64, the products take ~1,000 tensor-core cycles of an SM and
// the softmax ~700 instructions a thread (a max, an FMA, an exp2 on the
// special-function unit, an add, a multiply per score, a pack per pair)
// on the issue slots of the same SM, about as long as the products and
// the query/output bytes together. So the two consumers take turns at the
// softmax (a pair of named barriers): one's softmax runs while the other's
// products and store run. The result sits at 2.3-4x the byte bound, about
// SDPA's time at Nk 256 and under it at Nk 257-288.
//
// Resources per CTA: shared memory at d = 64 is 64 KB of K and V at
// Nk <= 256 (72 KB at Nk <= 288), 48 KB of query rings, 16 KB of staging,
// ~129-137 KB; 384 threads at 168 registers (setmaxnreg moves registers
// from the producer, 24, to the consumers, 240; ptxas compiles the kernel
// within the 168 a thread starts with, which the 144-float score row at
// Nk <= 288 fits). One CTA fits an SM. Its sums run in the tensor cores'
// order, so a bf16 output differs from the plain version's by an ulp or
// two in ~0.07% of elements.
//
// The scalar kernel (sr_attention_fwd_kernel, float32 and bfloat16). Its
// bf16 results equal the plain version's bit for bit, and TF32 tensor cores
// would not hold float32 results to their tolerance. One CTA of 8 warps per
// (batch*head, block of query rows) stages K^T and V in shared memory; a
// warp holds kRows query rows at once, lane l owns key columns l, l+32,
// ..., so the row max and row sum are warp shuffles. The probabilities go
// to a per-warp shared-memory row, from which every lane reads them as
// broadcasts for P.V; lane l owns output columns l and l+32. Its products
// are scalar float32 FMAs, so the FMA pipes and shared-memory reads bound
// it rather than the bytes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <chrono>

#include "sr_attention_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;      // query rows a warp holds at once
constexpr int kMaxSlots = 9;  // key columns per lane: Nk <= 288

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Shared-memory layout, in bytes from the start of the dynamic buffer:
//   kt [d][nkp + 1] T   K transposed (the +1 spreads the transposing
//                       stores over the banks)
//   vs [nkp][d]     T   V
//   qs [kWarps][kRows][d]   float   each warp's query rows
//   ps [kWarps][kRows][nkp] float   each warp's probabilities
struct Layout {
  int nkp, ldk;
  size_t kt, vs, qs, ps, total;
  __host__ __device__ Layout(int nk, int d, int elem) {
    nkp = (nk + 31) / 32 * 32;
    ldk = nkp + 1;
    kt = 0;
    vs = align16(kt + size_t(d) * ldk * elem);
    qs = align16(vs + size_t(nkp) * d * elem);
    ps = qs + size_t(kWarps) * kRows * d * sizeof(float);
    total = ps + size_t(kWarps) * kRows * nkp * sizeof(float);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sr_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        int nq, int nk, int heads, int block_q, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(nk, D, sizeof(T));
  const int nkp = lay.nkp, ldk = lay.ldk, nc = nkp / 32;
  T* kt = reinterpret_cast<T*>(smem + lay.kt);
  T* vs = reinterpret_cast<T*>(smem + lay.vs);
  const int c = heads * D;

  const int bh = int(blockIdx.y), b = bh / heads, h = bh % heads;
  const int tid = int(threadIdx.x), warp = tid >> 5, lane = tid & 31;
  float* qw = reinterpret_cast<float*>(smem + lay.qs) + warp * kRows * D;
  float* pw = reinterpret_cast<float*>(smem + lay.ps) + warp * kRows * nkp;

  // Stage this (b, h)'s K^T and V in 16-byte loads; rows past nk are zero.
  constexpr int kVec = 16 / sizeof(T);
  const T* kb = k + size_t(b) * nk * c + h * D;
  const T* vb = v + size_t(b) * nk * c + h * D;
#pragma unroll 4
  for (int i = tid; i < nkp * (D / kVec); i += kThreads) {
    const int j = i / (D / kVec), e = (i % (D / kVec)) * kVec;
    uint4 kraw = make_uint4(0u, 0u, 0u, 0u), vraw = kraw;
    if (j < nk) {
      kraw = *reinterpret_cast<const uint4*>(kb + size_t(j) * c + e);
      vraw = *reinterpret_cast<const uint4*>(vb + size_t(j) * c + e);
    }
    const T* kv = reinterpret_cast<const T*>(&kraw);
#pragma unroll
    for (int x = 0; x < kVec; ++x) kt[(e + x) * ldk + j] = kv[x];
    *reinterpret_cast<uint4*>(vs + j * D + e) = vraw;
  }
  __syncthreads();

  const T* qb = q + size_t(b) * nq * c + h * D;
  T* ob = out + size_t(b) * nq * c + h * D;
  const int q0 = int(blockIdx.x) * block_q;
  const int q_end = min(q0 + block_q, nq);
  constexpr int kCols = D / 32;  // output columns per lane

  for (int r0 = q0 + warp * kRows; r0 < q_end; r0 += kWarps * kRows) {
    // This warp's query rows as float32; rows past the end are zero.
    for (int i = lane; i < kRows * D; i += 32) {
      const int row = r0 + i / D;
      qw[i] = row < q_end ? to_f(qb[size_t(row) * c + i % D]) : 0.f;
    }
    __syncwarp();

    // s[r][t] = q_r . k_(32t + lane)
    float s[kRows][kMaxSlots];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < kMaxSlots; ++t) s[r][t] = 0.f;
#pragma unroll 2
    for (int e = 0; e < D; e += 4) {
      float4 qa[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        qa[r] = *reinterpret_cast<const float4*>(qw + r * D + e);
#pragma unroll
      for (int t = 0; t < kMaxSlots; ++t) {
        if (t < nc) {
          const T* kp = kt + e * ldk + t * 32 + lane;
          const float k0 = to_f(kp[0]), k1 = to_f(kp[ldk]);
          const float k2 = to_f(kp[2 * ldk]), k3 = to_f(kp[3 * ldk]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float a = s[r][t];
            a = fmaf(qa[r].x, k0, a);
            a = fmaf(qa[r].y, k1, a);
            a = fmaf(qa[r].z, k2, a);
            a = fmaf(qa[r].w, k3, a);
            s[r][t] = a;
          }
        }
      }
    }

    // Row softmax over the nk valid keys; probabilities to shared memory,
    // rounded to v's type (zero in the padded tail).
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < kMaxSlots; ++t) {
        const bool ok = t < nc && t * 32 + lane < nk;
        s[r][t] = ok ? s[r][t] * scale : -INFINITY;
        m = fmaxf(m, s[r][t]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float l = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxSlots; ++t) {
        const bool ok = t < nc && t * 32 + lane < nk;
        s[r][t] = ok ? expf(s[r][t] - m) : 0.f;
        l += s[r][t];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
      for (int t = 0; t < kMaxSlots; ++t)
        if (t < nc) pw[r * nkp + t * 32 + lane] = to_f(from_f<T>(s[r][t] / l));
    }
    __syncwarp();

    // o[r][u] = sum_j p[r][j] * v[j][32u + lane]
    float acc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int u = 0; u < kCols; ++u) acc[r][u] = 0.f;
#pragma unroll 2
    for (int j = 0; j < nkp; j += 4) {
      float4 pa[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pa[r] = *reinterpret_cast<const float4*>(pw + r * nkp + j);
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const T* vp = vs + j * D + u * 32 + lane;
        const float v0 = to_f(vp[0]), v1 = to_f(vp[D]);
        const float v2 = to_f(vp[2 * D]), v3 = to_f(vp[3 * D]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float a = acc[r][u];
          a = fmaf(pa[r].x, v0, a);
          a = fmaf(pa[r].y, v1, a);
          a = fmaf(pa[r].z, v2, a);
          a = fmaf(pa[r].w, v3, a);
          acc[r][u] = a;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = r0 + r;
      if (row < q_end) {
#pragma unroll
        for (int u = 0; u < kCols; ++u)
          ob[size_t(row) * c + u * 32 + lane] = from_f<T>(acc[r][u]);
      }
    }
    __syncwarp();  // qw/pw are rewritten by the next row group
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int nq, int nk, int heads, int block_q, cudaStream_t stream) {
  const Layout lay(nk, D, sizeof(T));
  auto kernel = sr_attention_fwd_kernel<T, D>;
  static std::atomic<uint32_t> opted{0};
  cudaError_t err = sr_mma::opt_in_smem(kernel, opted);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((nq + block_q - 1) / block_q, b * heads);
  kernel<<<grid, kThreads, lay.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), nq, nk, heads, block_q,
      1.0f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

// ---- bfloat16: the wgmma + TMA kernel ----

using sr_mma::bf16;
using sr_mma::smem_u32;

constexpr int kTileQ = 64;             // query rows of a tile: wgmma's M
constexpr int kKeyBox = 32;            // key rows of a TMA box of K or V
constexpr int kStages = 3;             // query tiles in flight per consumer
constexpr int kConsumers = 2;          // consumer warpgroups of a CTA
constexpr int kConsumerThreads = 128;  // one warpgroup
constexpr int kWgThreads = (kConsumers + 1) * kConsumerThreads;
constexpr int kProducerRegs = 24;      // setmaxnreg: 128 * 24 + 256 * 240
constexpr int kConsumerRegs = 240;     // = the 384 * 168 a CTA starts with
constexpr int kMaxKeyTiles = 18;       // 16-key tiles of a score row
static_assert(kMaxKeyTiles * 16 == kMaxSlots * 32, "one Nk limit");

// The swizzle of a row of D bf16, shared by the tensor maps and the wgmma
// descriptors: 128 bytes at D = 64, 64 at D = 32 (Swizzle<B, 4, 3>: address
// bits [7, 7 + B) XORed into bits [4, 4 + B), B = 3 or 2).
template <int D>
__host__ __device__ constexpr int swizzle_bits() {
  static_assert(D == 32 || D == 64, "head width 32 or 64");
  return D == 64 ? 3 : 2;
}

// Shared memory of the wgmma kernel, in bytes from a 1024-aligned base:
//   k [16 KT][D]                          K, keys past Nk zero (TMA fill)
//   v [16 KT][D]                          V
//   q [kConsumers][kStages][kTileQ][D]    each consumer's query ring
//   o [kConsumers][kTileQ][D]             each consumer's output staging
//   barriers                              q_full and q_empty
//                                         [kConsumers][kStages], k_full,
//                                         v_full, kv_empty (8 bytes each)
// Every region starts on a multiple of 1024 bytes, as the swizzle needs;
// `total` includes the slack to align the dynamic buffer's base.
struct WgLayout {
  size_t k, v, q, o, bar, total;
  __host__ __device__ WgLayout(int d, int kt) {
    const size_t row = size_t(d) * sizeof(bf16);
    k = 0;
    v = k + size_t(kt) * 16 * row;
    q = v + size_t(kt) * 16 * row;
    o = q + size_t(kConsumers) * kStages * kTileQ * row;
    bar = o + size_t(kConsumers) * kTileQ * row;
    total = bar + (2 * kConsumers * kStages + 3) * 8 + 1024;
  }
};

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

// Consumer warpgroup c's own barrier (id 1 + c; 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(kConsumerThreads)
               : "memory");
}

// The softmax turn of consumer c (barrier 3 + c, both consumers' threads):
// c waits for it with `softmax_turn_wait`, the other consumer hands it
// over with `softmax_turn_give`, so the two softmaxes (ALU-bound) never run
// at once and each overlaps the other consumer's products.
__device__ __forceinline__ void softmax_turn_wait(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(3 + c),
               "n"(kConsumers * kConsumerThreads)
               : "memory");
}
__device__ __forceinline__ void softmax_turn_give(int c) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(3 + c),
               "n"(kConsumers * kConsumerThreads)
               : "memory");
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
// K-major operand uses only the 8-row stride, and an MN-major one (V, whose
// MN extent D is one swizzle atom) only the stride between 8-row groups
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
// both K-major in shared memory (descriptors), d float32 in registers.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : SR_F16(0)
      : "l"(a), "l"(b), "r"(accumulate));
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


#undef SR_F1
#undef SR_F4
#undef SR_F16
#undef SR_F32
#undef SR_F64
#undef SR_F128

template <int D>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b, int accumulate) {
  if constexpr (D == 64)
    wgmma_rs_n64(d, a, b, accumulate);
  else
    wgmma_rs_n32(d, a, b, accumulate);
}

// The softmax of a consumer warpgroup's 64 score rows, held as the
// accumulator of s = q k^T: thread (warp w, lane 4g + t) holds rows
// 16w + g (s[i] with bit 1 of i clear) and 16w + g + 8, keys
// 8 (i / 4) + 2t + (i & 1), a row's keys spread over the 4 lanes of a quad.
// p = 2^(s c - m) / l over the nk valid keys (c = scale log2(e), m the row
// max of s c, l the row sum), 0 past nk, rounded to bf16 into the register
// A operand of o = p v: key tile kk's A fragment is the accumulator's
// elements 8kk .. 8kk + 7 in pairs. Three passes: `row_max` (with the mask),
// `exp_rowsum` (the special-function unit's pass) and `normalize_pack`.
// Every element takes the same straight-line code (a branch on nk inside
// the unrolled loops would move the row to local memory); the max and sum
// run in 4 partial chains per row.

// Masks keys past nk to -inf and returns m of rows g and g + 8 (the same
// in the 4 lanes of a quad).
template <int KT>
__device__ __forceinline__ void row_max(float (&s)[KT * 8], int nk,
                                        float scale_log2, int t4,
                                        float (&m)[2]) {
  // Keys past nk: at KT = 18 (256 < nk <= 288) only in the last two key
  // tiles; at KT = 16 only when nk < 256 (a branch on a uniform value
  // around straight-line code, which keeps s in registers).
  if (nk < KT * 16) {
    constexpr int kFirst = KT > 16 ? 128 : 0;
#pragma unroll
    for (int i = kFirst; i < KT * 8; ++i) {
      const int key = 8 * (i >> 2) + 2 * t4 + (i & 1);
      s[i] = key < nk ? s[i] : -INFINITY;
    }
  }
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[r][j] = -INFINITY;
#pragma unroll
  for (int i = 0; i < KT * 8; ++i)
    part[(i >> 1) & 1][(i >> 3) & 3] =
        fmaxf(part[(i >> 1) & 1][(i >> 3) & 3], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3]));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    m[r] *= scale_log2;
  }
}

// s = 2^(s c - m) in place; returns 1 / l of rows g and g + 8.
template <int KT>
__device__ __forceinline__ void exp_rowsum(float (&s)[KT * 8],
                                           float scale_log2,
                                           const float (&m)[2],
                                           float (&inv_l)[2]) {
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[r][j] = 0.f;
#pragma unroll
  for (int i = 0; i < KT * 8; ++i) {
    s[i] = sr_mma::exp2_approx(fmaf(s[i], scale_log2, -m[(i >> 1) & 1]));
    part[(i >> 1) & 1][(i >> 3) & 3] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv_l[r] = 1.f / l;
  }
}

// p = s / l rounded to bf16, as the A fragments of o = p v.
template <int KT>
__device__ __forceinline__ void normalize_pack(const float (&s)[KT * 8],
                                               const float (&inv_l)[2],
                                               uint32_t (&p)[KT * 4]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const float* t = s + 8 * kk;
    p[4 * kk + 0] = sr_mma::pack(t[0] * inv_l[0], t[1] * inv_l[0]);
    p[4 * kk + 1] = sr_mma::pack(t[2] * inv_l[1], t[3] * inv_l[1]);
    p[4 * kk + 2] = sr_mma::pack(t[4] * inv_l[0], t[5] * inv_l[0]);
    p[4 * kk + 3] = sr_mma::pack(t[6] * inv_l[1], t[7] * inv_l[1]);
  }
}

// KT: the 16-key tiles of a score row, 16 (Nk <= 256: one m64n256k16 per
// 16 columns of d) or 18 (Nk <= 288: and one m64n32k16). Threads 0-255 are
// the two consumer warpgroups, 256-383 the producer (thread 256 issues
// every TMA load). CTA x takes the global query tiles
// [x T / G, (x + 1) T / G) of T = B * heads * tiles_per_bh, in (batch,
// head, tile) order: a run of them with one (batch, head) is a segment,
// whose K and V are loaded once; its tiles alternate between the two
// consumers (the CTA's i-th tile goes to consumer i % 2).
template <int D, int KT>
__global__ void __launch_bounds__(kWgThreads, 1)
sr_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap to, int nk,
                              int heads, int tiles_per_bh, int total,
                              float scale_log2) {
  static_assert(KT == 16 || KT == kMaxKeyTiles, "KT is 16 or 18");
  constexpr uint32_t kRow = D * sizeof(bf16);
  constexpr uint32_t kQBytes = kTileQ * kRow;
  constexpr uint32_t kKVBytes = KT * 16 * kRow;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const WgLayout lay(D, KT);
  const uint32_t base = smem_u32(smem);
  const uint32_t k_s = base + uint32_t(lay.k), v_s = base + uint32_t(lay.v);
  const uint32_t q_s = base + uint32_t(lay.q), o_s = base + uint32_t(lay.o);
  const uint32_t bars = base + uint32_t(lay.bar);
  // the query ring of consumer c: stage st at q_slot(c, st)
  auto q_slot = [&](int c, int st) {
    return q_s + (c * kStages + st) * kQBytes;
  };
  auto q_full = [&](int c, int st) { return bars + 8 * (c * kStages + st); };
  auto q_empty = [&](int c, int st) {
    return bars + 8 * ((kConsumers + c) * kStages + st);
  };
  const uint32_t k_full = bars + 16 * kConsumers * kStages,
                 v_full = k_full + 8, kv_empty = k_full + 16;

  const int tid = int(threadIdx.x);
  if (tid == 0) {
    for (int c = 0; c < kConsumers; ++c)
      for (int st = 0; st < kStages; ++st) {
        mbar_init(q_full(c, st), 1);
        mbar_init(q_empty(c, st), kConsumerThreads / 32);
      }
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(kv_empty, kConsumers * kConsumerThreads / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int begin = int(int64_t(blockIdx.x) * total / gridDim.x);
  const int end = int(int64_t(blockIdx.x + 1) * total / gridDim.x);

  // the warpgroup's role, warp-uniform as ptxas needs it to give each
  // role its own register count (setmaxnreg)
  const int wg = __shfl_sync(0xffffffffu, tid / kConsumerThreads, 0);
  if (wg == kConsumers) {
    // ---- producer: K and V per segment, query tiles into the rings
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers * kConsumerThreads) {
      uint32_t gen = 0;
      for (int u = begin; u < end; ++gen) {
        const int bh = u / tiles_per_bh, b = bh / heads, h = bh - b * heads;
        const int seg_end = min(end, (bh + 1) * tiles_per_bh);
        // both consumers are done with the previous segment's K and V
        if (gen) mbar_wait(kv_empty, (gen - 1) & 1);
        mbar_expect_tx(k_full, kKVBytes);
#pragma unroll 1
        for (int j = 0; j < KT * 16 / kKeyBox; ++j)
          tma_load(k_s + j * kKeyBox * kRow, &tk, k_full, h * D, j * kKeyBox,
                   b);
        mbar_expect_tx(v_full, kKVBytes);
#pragma unroll 1
        for (int j = 0; j < KT * 16 / kKeyBox; ++j)
          tma_load(v_s + j * kKeyBox * kRow, &tv, v_full, h * D, j * kKeyBox,
                   b);
        for (; u < seg_end; ++u) {
          const int i = u - begin, c = i & 1, n = i >> 1, st = n % kStages;
          mbar_wait(q_empty(c, st), ((n / kStages) & 1) ^ 1);
          mbar_expect_tx(q_full(c, st), kQBytes);
          tma_load(q_slot(c, st), &tq, q_full(c, st), h * D,
                   (u - bh * tiles_per_bh) * kTileQ, b);
        }
      }
    }
  } else {
    // ---- consumer wg: s = q k^T, softmax, o = p v, o stored by TMA
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ct = tid - wg * kConsumerThreads;
    const int warp = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t4 = lane & 3;
    unsigned char* stage_o = smem + lay.o + wg * kQBytes;
    const uint32_t stage_o_s = o_s + wg * kQBytes;
    // Softmax turns alternate in tile order (consumer 0 has the CTA's
    // even tiles, consumer 1 the odd ones); a turn is handed over only to
    // a consumer that has a tile left, so no arrival is left pending.
    const int tiles_wg0 = (end - begin + 1) / 2, tiles_wg1 = (end - begin) / 2;
    if (wg == 1) softmax_turn_give(0);
    int n = 0;  // this consumer's tiles so far
    uint32_t gen = 0;
    for (int u = begin; u < end; ++gen) {
      const int bh = u / tiles_per_bh, b = bh / heads, h = bh - b * heads;
      const int seg_end = min(end, (bh + 1) * tiles_per_bh);
      mbar_wait(k_full, gen & 1);
      for (int w = u + (((u - begin) & 1) != wg); w < seg_end; w += 2, ++n) {
        const int st = n % kStages;
        mbar_wait(q_full(wg, st), (n / kStages) & 1);

        float s[KT * 8];
        const uint32_t q_tile = q_slot(wg, st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          // k-step kk: 16 columns of d, 32 bytes into each swizzled row
          const uint64_t da = smem_desc<D>(q_tile) + 2 * kk;
          const uint64_t db = smem_desc<D>(k_s) + 2 * kk;
          wgmma_ss_n256(s, da, db, kk);
          if constexpr (KT > 16)
            wgmma_ss_n32(s + 128, da, db + ((256 * kRow) >> 4), kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<KT * 8>(s);
        if (lane == 0) mbar_arrive(q_empty(wg, st));  // one per warp

        float m[2], inv_l[2];
        uint32_t p[KT * 4];
        softmax_turn_wait(wg);
        row_max<KT>(s, nk, scale_log2, t4, m);
        exp_rowsum<KT>(s, scale_log2, m, inv_l);
        normalize_pack<KT>(s, inv_l, p);
        if (wg == 0 ? n < tiles_wg1 : n + 1 < tiles_wg0)
          softmax_turn_give(1 - wg);

        float o[D / 2];
        mbar_wait(v_full, gen & 1);
        fence_regs<KT * 4>(p);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          wgmma_rs<D>(o, p + 4 * kk, smem_desc<D>(v_s + kk * 16 * kRow), kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<D / 2>(o);

        // o to the staging tile (swizzled as the output map reads it),
        // once the previous tile's store has read it; then one TMA store.
        if (ct == 0) tma_store_wait<true>();
        consumer_sync(wg);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t r = warp * 16 + g + 8 * half, c = 8 * j + 2 * t4;
            uint32_t off = r * kRow + c * sizeof(bf16);
            off ^= ((off >> 7) & ((1u << swizzle_bits<D>()) - 1)) << 4;
            *reinterpret_cast<uint32_t*>(stage_o + off) =
                sr_mma::pack(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
          }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumer_sync(wg);
        if (ct == 0)
          tma_store(&to, stage_o_s, h * D, (w - bh * tiles_per_bh) * kTileQ,
                    b);
      }
      // done with this segment's K and V (one arrival per warp)
      if (seg_end < end && lane == 0) mbar_arrive(kv_empty);
      u = seg_end;
    }
    if (ct == 0) tma_store_wait<false>();
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (no
// link against libcuda).
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
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

// The 3-D tensor map over a (B, N, C) bf16 tensor that the wgmma kernel
// reads or writes in boxes of (D columns, `rows` rows, 1 batch), swizzled
// for wgmma; out-of-bounds rows read as zero.
template <int D>
bool encode_map(CUtensorMap* map, const void* ptr, int b, int n, int c,
                int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
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

// The four maps of one launch (q, k, v, out).
template <int D>
bool encode_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                 const void* v, const void* out, int b, int nq, int nk,
                 int c) {
  return encode_map<D>(&m[0], q, b, nq, c, kTileQ) &&
         encode_map<D>(&m[1], k, b, nk, c, kKeyBox) &&
         encode_map<D>(&m[2], v, b, nk, c, kKeyBox) &&
         encode_map<D>(&m[3], out, b, nq, c, kTileQ);
}

// Opts the kernel into its shared memory (once per process) and returns
// how many of its CTAs fit an SM (cached after the first call).
template <int D, int KT>
cudaError_t wgmma_ctas_per_sm(int* ctas) {
  auto kernel = sr_attention_fwd_wgmma_kernel<D, KT>;
  static std::atomic<uint32_t> opted{0};
  static std::atomic<int> cached{0};
  cudaError_t err = sr_mma::opt_in_smem(kernel, opted);
  if (err != cudaSuccess) return err;
  int n = cached.load(std::memory_order_acquire);
  if (n == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, kWgThreads, WgLayout(D, KT).total);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    cached.store(n, std::memory_order_release);
  }
  *ctas = n;
  return cudaSuccess;
}

template <int D, int KT>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int b, int nq, int nk, int heads, cudaStream_t stream) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = wgmma_ctas_per_sm<D, KT>(&per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const int tiles = (nq + kTileQ - 1) / kTileQ;
  const int64_t total = int64_t(b) * heads * tiles;
  if (total > INT_MAX) return int(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  if (!encode_maps<D>(maps, q, k, v, out, b, nq, nk, heads * D))
    return int(cudaErrorInvalidValue);
  const int grid = int(total < int64_t(sms) * per_sm ? total
                                                      : int64_t(sms) * per_sm);
  sr_attention_fwd_wgmma_kernel<D, KT>
      <<<grid, kWgThreads, WgLayout(D, KT).total, stream>>>(
          maps[0], maps[1], maps[2], maps[3], nk, heads, tiles, int(total),
          1.4426950408889634f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

// The instantiation whose score row holds ceil(nk / 16) key tiles.
template <int D>
int dispatch_wgmma(const void* q, const void* k, const void* v, void* out,
                   int b, int nq, int nk, int heads, cudaStream_t stream) {
  if (nk <= 16 * 16)
    return launch_wgmma<D, 16>(q, k, v, out, b, nq, nk, heads, stream);
  return launch_wgmma<D, kMaxKeyTiles>(q, k, v, out, b, nq, nk, heads,
                                       stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (elem: 4 f32, 2 bf16; mma:
// the wgmma kernel, else the scalar one).
size_t sr_attention_fwd_smem_bytes(int nk, int d, int elem, int mma) {
  return mma ? WgLayout(d, nk <= 16 * 16 ? 16 : kMaxKeyTiles).total
             : Layout(nk, d, elem).total;
}

int sr_attention_fwd_max_nk() { return kMaxSlots * 32; }

// How many CTAs of the wgmma kernel for (nk, d) fit an SM of the current
// device; a negative cudaError_t if the query fails.
int sr_attention_fwd_wgmma_ctas_per_sm(int nk, int d) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 32)
    err = nk <= 256 ? wgmma_ctas_per_sm<32, 16>(&n)
                    : wgmma_ctas_per_sm<32, kMaxKeyTiles>(&n);
  else if (d == 64)
    err = nk <= 256 ? wgmma_ctas_per_sm<64, 16>(&n)
                    : wgmma_ctas_per_sm<64, kMaxKeyTiles>(&n);
  return err == cudaSuccess ? n : -int(err);
}

// Host nanoseconds to encode the four tensor maps of one wgmma launch,
// averaged over `iters` (the maps are made anew for every launch); -1 if
// an encoding fails.
double sr_attention_fwd_map_ns(const void* q, const void* k, const void* v,
                               const void* out, int b, int nq, int nk, int c,
                               int heads, int iters) {
  const int d = c / heads;
  CUtensorMap maps[4];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    const bool ok = d == 64 ? encode_maps<64>(maps, q, k, v, out, b, nq, nk, c)
                            : encode_maps<32>(maps, q, k, v, out, b, nq, nk, c);
    if (!ok) return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() /
         (iters > 0 ? iters : 1);
}

// dtype: 0 float32, 1 bfloat16. mma: 1 runs the wgmma kernel (bfloat16
// only; block_q is then unused), 0 the scalar one. q, k, v and out are
// 16-byte aligned. Returns a cudaError_t (0 on success); 1
// (cudaErrorInvalidValue) for a shape or type the kernel does not take.
int sr_attention_fwd(const void* q, const void* k, const void* v, void* out,
                     int b, int nq, int nk, int c, int heads, int dtype,
                     int block_q, int mma, void* stream) {
  const int d = c / heads;
  if (b < 1 || nq < 1 || nk < 1 || nk > kMaxSlots * 32 || d * heads != c ||
      block_q < 1 || (mma && dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 32)
    return launch<float, 32>(q, k, v, out, b, nq, nk, heads, block_q, s);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, out, b, nq, nk, heads, block_q, s);
  if (mma && d == 32)
    return dispatch_wgmma<32>(q, k, v, out, b, nq, nk, heads, s);
  if (mma && d == 64)
    return dispatch_wgmma<64>(q, k, v, out, b, nq, nk, heads, s);
  if (dtype == 1 && d == 32)
    return launch<__nv_bfloat16, 32>(q, k, v, out, b, nq, nk, heads,
                                     block_q, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, b, nq, nk, heads,
                                     block_q, s);
  return int(cudaErrorInvalidValue);
}

const char* sr_attention_fwd_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
