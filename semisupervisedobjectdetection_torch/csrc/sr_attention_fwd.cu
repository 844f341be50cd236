// SR-attention forward for Hopper (sm_90a): out = softmax(q k^T / sqrt(d)) v
// per (batch, head), with q of shape (B, Nq, C) and k, v of shape (B, Nk, C),
// C = heads * d, all row-major and contiguous.
//
// Replaces the Pallas TPU kernel semisupervisedobjectdetection_tpu/ops/
// sr_attention.py::_attn_kernel and computes the same function: scores and
// softmax in float32, the normalised probabilities rounded to v's type
// before P.V, float32 accumulation, output in q's type. Every kernel runs
// its products on wgmma with tiles brought in by TMA, and every dtype takes
// any Nk:
//
// bfloat16: sr_attention_fwd_wgmma_kernel, one full-row softmax over all of
// a (batch, head)'s keys held on chip (Nk <= 288); past 288 keys
// sr_attention_fwd_wgmma_stream_kernel (below) streams K and V.
//   Bound. At MiT-B5 512x512 shapes the function is bound by the bytes it
//   must move (q in, out back: 2*B*Nq*C elements) on the bf16 tensor-core
//   peak: 4*B*Nq*Nk*C flops over 2*B*(Nq+Nk)*C*2 bytes is ~250 flops a byte
//   at Nk = 256, d = 64, under the card's ~295. So the products must run on
//   the tensor cores at near their rate while q streams through at near the
//   memory rate; the softmax around them (one exp2 per score on the
//   special-function units, 16 a cycle an SM: at d = 64 as many cycles as
//   the products take on the tensor cores) is the next limit.
//   A CTA is two consumer warpgroups and a producer warpgroup, one CTA an
//   SM. A persistent grid of one CTA per SM walks the 64-row query tiles of
//   all (batch, head)s in order, each CTA a contiguous, equal range, so a
//   CTA takes many tiles of the same (batch, head) and loads its K and V
//   once for them (again only where its range crosses into the next
//   (batch, head)); its tiles alternate between the two consumers, which
//   share K and V. The producer thread loads K and V by TMA (boxes of 32
//   keys) into shared memory in the layout wgmma reads (128-byte swizzle at
//   d = 64, 64-byte at d = 32), K and V on separate mbarriers so that the
//   first product waits for K only, and keeps query tiles in flight in a
//   ring of 3 stages per consumer (3-D tensor maps over (C, N, B), box
//   (d, 64, 1) at column h*d: ragged query tails and keys past Nk are
//   zero-filled by the TMA unit, never read across a batch boundary). A
//   consumer warpgroup, per tile: s = q k^T by wgmma m64n256k16 (+ m64n32k16
//   for the keys past 256) from shared memory, both operands K-major; the
//   query stage released; the keys past Nk masked to -inf, the row max and
//   sum over the 4 lanes of a quad, p = 2^(s c - m) / l rounded to bf16 in
//   registers as the A operand (the accumulator layout of one product is
//   the register-A layout of the next), so the rounding point is the plain
//   version's; o = p v by wgmma m64n{d}k16 with V read MN-major (trans-b)
//   from shared memory; o through its swizzled staging tile to a TMA store,
//   which overlaps the next tile's products.
//   What bounds it, measured on the H100 (PERF.md): per 64-row tile at
//   Nk 256, d 64, the products take ~1,000 tensor-core cycles of an SM and
//   the softmax ~700 instructions a thread (a max, an FMA, an exp2 on the
//   special-function unit, an add, a multiply per score, a pack per pair)
//   on the issue slots of the same SM, about as long as the products and
//   the query/output bytes together. So the two consumers take turns at the
//   softmax (a pair of named barriers): one's softmax runs while the
//   other's products and store run. The result sits at 2.3-4x the byte
//   bound, about SDPA's time at Nk 256 and under it at Nk 257-288.
//   Resources per CTA: shared memory at d = 64 is 64 KB of K and V at
//   Nk <= 256 (72 KB at Nk <= 288), 48 KB of query rings, 16 KB of staging,
//   ~129-137 KB; 384 threads at 168 registers (setmaxnreg moves registers
//   from the producer, 24, to the consumers, 240; ptxas compiles the kernel
//   within the 168 a thread starts with, which the 144-float score row at
//   Nk <= 288 fits). One CTA fits an SM. Its sums run in the tensor cores'
//   order, so a bf16 output differs from the plain version's by an ulp or
//   two in ~0.07% of elements.
//
// float32: sr_attention_fwd_f32_kernel, every product on the TF32 tensor
// cores split three ways (3xTF32, sr_attention_wgmma.cuh): each float32
// operand x is hi = tf32(x) plus lo = tf32(x - hi), and a b is summed as
// a_lo b_hi + a_hi b_lo + a_hi b_hi in float32. The term dropped, a_lo b_lo,
// is ~2^-22 of the product: one such q k^T at MiT-B5's stage-1 shape is
// within 7.3e-7 of float64 as a share of its largest value, where torch's
// float32 matmul is within 3.5e-7 and one TF32 product within 3.9e-4
// (scripts/tf32_probe.py on the H100), far inside the float32 tolerance.
//   Bound: 3 TF32 products per float32 product, so the float32 operations
//   run at 495 / 3 = 165 TFLOP/s at best (against 67 TFLOP/s for float32
//   FMAs outside the tensor cores); 4*B*Nq*Nk*C flops over 2*B*(Nq+Nk)*C*4
//   bytes puts MiT-B5 far above the bytes line, so the products bound it.
//   Any Nk: K and V stream through shared memory in blocks of 32 keys with
//   an online softmax (a running row max and sum per query row, the output
//   rescaled when the max moves), so shared memory does not grow with Nk.
//   A CTA is two consumer warpgroups and a producer warpgroup. The grid
//   gives each (batch, head) `ctas_per_pair` CTAs (the launch plan in
//   ops/sr_attention.py, which fills the SMs), each a contiguous run of its
//   64-row query tiles; the run's tiles alternate between the consumers,
//   two at a time (a round), and both consumers read each K/V block of a
//   round. One producer thread loads q tiles (one slot per consumer) and K
//   and V blocks (a ring of 3 stages) by TMA, 3-D float32 maps over
//   (C, N, B) in boxes of 32 columns (one 128-byte-swizzled panel),
//   zero-filled past Nq and Nk. The producer warpgroup then splits each
//   block: K in place into hi and lo (K-major as s = q k^T reads it), and V
//   transposed into V^T hi and lo with the keys in kperm order, as o = p v
//   reads it (tf32 has no transpose bit). A consumer splits its q tile into
//   registers once (the A operand of s; its slot is then free for the next
//   round's tile) and, per block: s = q k^T (m64n32k8), the keys past Nk
//   masked, the online max and sum over the quad, p = 2^(s c - m) in
//   registers split as the A operand of o += p v (m64n{d}k8); at the end
//   o / l is stored from registers. 32-key blocks keep q's split, o and p
//   within the 168 registers ptxas compiles the kernel for (with 64-key
//   blocks it spilled at d = 64), and waste less of a ragged last block.
//   Resources per CTA at d = 64: 2 x 16 KB of q tiles and 3 x 40 KB of K/V
//   stages (K hi and lo, V^T hi and lo, V), 152 KB; 384 threads, the
//   producer at 56 registers and the consumers at 224 (setmaxnreg).
//
// bfloat16 past 288 keys. The on-chip kernel's score row (144 floats a
// thread at 288 keys) and K/V (72 KB at d = 64) grow with Nk. The plain
// version and the TPU kernel round the normalised p = e / l to bf16 before
// P.V, so an online softmax that rescales o (which would round an
// unnormalised p) is out. Two kernels, chosen by Nk on the host
// (ops/sr_attention.py's `fwd_stream_plan`), both over the on-chip
// kernel's persistent grid (CTA x of G = min(T, SMs) takes a contiguous,
// equal run of the T = B * heads * ceil(Nq / 64) query tiles, so every SM
// works):
//   sr_attention_fwd_wgmma_split_kernel, 288 < Nk <= 576: the on-chip
//   kernel's one-sweep softmax with the score row split over the two
//   consumers, each holding 12 or 18 of its 16-key tiles in registers (one
//   exponential and the four flops a score the function needs, where the
//   two-sweep kernel below spends two exponentials and six flops: on the
//   H100 1.2-2.2x faster than the two-sweep design at MiT-B5's Nk-356
//   shapes, PERF.md). K and V stay on chip, whole, per run of a (batch,
//   head)'s tiles. Shared memory at d = 64: 149,576 bytes at 12
//   key tiles a consumer (Nk <= 384), 198,728 at 18 (K/V, a 3-stage query
//   ring, the output staging, consumer 1's p v); 384 threads, setmaxnreg
//   24 / 240.
//   sr_attention_fwd_wgmma_stream_kernel, Nk > 576: two sweeps over
//   128-key blocks of K and V streamed through a ring of 4, twice per round
//   of two tiles (one per consumer): sweep 1 forms s = q k^T with an online
//   row max m and sum l; sweep 2 forms s again, p = 2^(s c - m) / l rounded
//   to bf16 as the register A operand (the plain version's rounding point)
//   and o += p v. One q k^T more than the function needs: 6 B Nq Nk C
//   flops where it needs 4. K and V come from L2 once per round: holding a
//   (batch, head)'s K/V in shared memory across its tiles instead (tried up
//   to 768 keys at d = 64) ran slower on the H100 at every shape tried
//   (PERF.md). Shared memory at d = 64: 165,056 bytes; setmaxnreg 56 / 224.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "sr_attention_wgmma.cuh"

namespace {

// The most keys the bf16 kernel holds on chip (its K/V and score row);
// past them the bf16 streaming kernel runs.
constexpr int kMaxNkBf16 = 288;

// ---- bfloat16: the wgmma + TMA kernel ----

using namespace sr_wgmma;

constexpr int kTileQ = 64;             // query rows of a tile: wgmma's M
constexpr int kKeyBox = 32;            // key rows of a TMA box of K or V
constexpr int kStages = 3;             // query tiles in flight per consumer
constexpr int kConsumers = 2;          // consumer warpgroups of a CTA
constexpr int kConsumerThreads = 128;  // one warpgroup
constexpr int kWgThreads = (kConsumers + 1) * kConsumerThreads;
constexpr int kProducerRegs = 24;      // setmaxnreg: 128 * 24 + 256 * 240
constexpr int kConsumerRegs = 240;     // = the 384 * 168 a CTA starts with
constexpr int kMaxKeyTiles = 18;       // 16-key tiles of a score row
static_assert(kMaxKeyTiles * 16 == kMaxNkBf16, "one Nk limit");

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
// in the 4 lanes of a quad). Keys past nk lie in elements First on.
template <int KT, int First = (KT > 16 ? 128 : 0)>
__device__ __forceinline__ void row_max(float (&s)[KT * 8], int nk,
                                        float scale_log2, int t4,
                                        float (&m)[2]) {
  // Keys past nk: at KT = 18 (256 < nk <= 288) only in the last two key
  // tiles; at KT = 16 only when nk < 256 (a branch on a uniform value
  // around straight-line code, which keeps s in registers).
  if (nk < KT * 16) {
#pragma unroll
    for (int i = First; i < KT * 8; ++i) {
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

// s = 2^(s c - m) in place; returns 1 / l of rows g and g + 8 (with
// Inverse false, l itself).
template <int KT, bool Inverse = true>
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
    s[i] = sr_wgmma::exp2_approx(fmaf(s[i], scale_log2, -m[(i >> 1) & 1]));
    part[(i >> 1) & 1][(i >> 3) & 3] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv_l[r] = Inverse ? 1.f / l : l;
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
    p[4 * kk + 0] = sr_wgmma::pack(t[0] * inv_l[0], t[1] * inv_l[0]);
    p[4 * kk + 1] = sr_wgmma::pack(t[2] * inv_l[1], t[3] * inv_l[1]);
    p[4 * kk + 2] = sr_wgmma::pack(t[4] * inv_l[0], t[5] * inv_l[0]);
    p[4 * kk + 3] = sr_wgmma::pack(t[6] * inv_l[1], t[7] * inv_l[1]);
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
                sr_wgmma::pack(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
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
  cudaError_t err = sr_wgmma::opt_in_smem(kernel, opted);
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

// ---- bfloat16 from 289 to 2 * 288 keys: one sweep, the score row split
// over the two consumers ----

constexpr int kSplitMaxKT = kMaxKeyTiles;  // 16-key tiles a consumer holds

// Shared memory of the split kernel, in bytes from a 1024-aligned base
// (KT key tiles a consumer, 2 KT * 16 keys in all):
//   k, v [2 KT * 16][D]          K and V, keys past Nk zero (TMA fill)
//   q    [kStages][kTileQ][D]    the query ring, read by both consumers
//   o    [kTileQ][D]             consumer 0's output staging
//   part [D / 2][128] float      consumer 1's p v, one column a thread
//   red  [2][2][64] float        each consumer's row max, then row sum
//   barriers                     q_full, q_empty [kStages], k_full,
//                                v_full, kv_empty
struct SplitLayout {
  size_t k, v, q, o, part, red, bar, total;
  __host__ __device__ SplitLayout(int d, int kt) {
    const size_t row = size_t(d) * sizeof(bf16);
    const size_t keys = size_t(2) * kt * 16;
    k = 0;
    v = k + keys * row;
    q = v + keys * row;
    o = q + size_t(kStages) * kTileQ * row;
    part = o + size_t(kTileQ) * row;
    red = part + size_t(d / 2) * kConsumerThreads * sizeof(float);
    bar = red + 2 * kConsumers * kTileQ * sizeof(float);
    total = bar + (2 * kStages + 3) * 8 + 1024;
  }
};

// The key tiles a split consumer holds at nk keys: 12 (nk <= 384) or 18.
__host__ __device__ constexpr int split_kt(int nk) {
  return nk <= 2 * 12 * 16 ? 12 : kSplitMaxKT;
}

// Both consumers' threads (named barrier 5; 1-4 are the on-chip kernel's).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 5, %0;\n" ::"n"(kConsumers * kConsumerThreads)
               : "memory");
}

// 288 < Nk <= 576 in bfloat16: the on-chip kernel's one-sweep softmax with
// the score row split over the two consumers. The grid and segments are
// the on-chip kernel's (CTA x of G takes the global 64-row query tiles
// [x T / G, (x + 1) T / G), G = min(T, SMs); a segment's K and V are loaded
// once, whole), but both consumers work on every tile: consumer w holds
// keys [w KT 16, (w + 1) KT 16). Per tile each forms s = q k^T for its keys
// (wgmma m64n64k16, and m64n32k16 at KT = 18) in registers; the two row
// maxima meet in shared memory (the row max m of all keys), each forms
// 2^(s c - m) and its row sum, the two sums meet (l = l0 + l1, the same
// order in both), and each forms p = 2^(s c - m) / l rounded to bf16 in
// registers, the plain version's rounding point, and o_w = p v over its
// keys (V MN-major). o = o0 + o1: consumer 1 hands its o to consumer 0
// through shared memory, which adds it and stores o through its swizzled
// staging tile by TMA. One exponential a score and the four flops a score
// the function needs; the consumers' three meetings a tile are the cost.
template <int D, int KT>
__global__ void __launch_bounds__(kWgThreads, 1)
sr_attention_fwd_wgmma_split_kernel(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    const __grid_constant__ CUtensorMap to,
                                    int nk, int heads, int tiles_per_bh,
                                    int total, float scale_log2) {
  static_assert(KT % 2 == 0 && KT <= kSplitMaxKT, "KT is 12 or 18");
  constexpr uint32_t kRow = D * sizeof(bf16);
  constexpr uint32_t kQBytes = kTileQ * kRow;
  constexpr uint32_t kKVBytes = 2 * KT * 16 * kRow;
  constexpr int kKeys = KT * 16;  // keys a consumer holds
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const SplitLayout lay(D, KT);
  const uint32_t base = smem_u32(smem);
  const uint32_t k_s = base + uint32_t(lay.k), v_s = base + uint32_t(lay.v);
  const uint32_t q_s = base + uint32_t(lay.q), o_s = base + uint32_t(lay.o);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  const uint32_t bars = base + uint32_t(lay.bar);
  auto q_full = [&](int st) { return bars + 8 * st; };
  auto q_empty = [&](int st) { return bars + 8 * (kStages + st); };
  const uint32_t k_full = bars + 16 * kStages, v_full = k_full + 8,
                 kv_empty = k_full + 16;

  const int tid = int(threadIdx.x);
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(q_full(st), 1);
      mbar_init(q_empty(st), kConsumers * kConsumerThreads / 32);
    }
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(kv_empty, kConsumers * kConsumerThreads / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int begin = int(int64_t(blockIdx.x) * total / gridDim.x);
  const int end = int(int64_t(blockIdx.x + 1) * total / gridDim.x);

  const int wg = __shfl_sync(0xffffffffu, tid / kConsumerThreads, 0);
  if (wg == kConsumers) {
    // ---- producer: K and V per segment, query tiles into the ring
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
        for (int j = 0; j < 2 * KT * 16 / kKeyBox; ++j)
          tma_load(k_s + j * kKeyBox * kRow, &tk, k_full, h * D, j * kKeyBox,
                   b);
        mbar_expect_tx(v_full, kKVBytes);
#pragma unroll 1
        for (int j = 0; j < 2 * KT * 16 / kKeyBox; ++j)
          tma_load(v_s + j * kKeyBox * kRow, &tv, v_full, h * D, j * kKeyBox,
                   b);
        for (; u < seg_end; ++u) {
          const int i = u - begin, st = i % kStages;
          mbar_wait(q_empty(st), ((i / kStages) & 1) ^ 1);
          mbar_expect_tx(q_full(st), kQBytes);
          tma_load(q_s + st * kQBytes, &tq, q_full(st), h * D,
                   (u - bh * tiles_per_bh) * kTileQ, b);
        }
      }
    }
    return;
  }

  // ---- consumers: the keys [wg KT 16, (wg + 1) KT 16) of every tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int ct = tid - wg * kConsumerThreads;
  const int warp = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = wg * kKeys;
  unsigned char* stage_o = smem + lay.o;
  // red[kind][consumer][row]: kind 0 the row max, 1 the row sum
  auto red_at = [&](int kind, int w, int r) {
    return red + (kind * kConsumers + w) * kTileQ + 16 * warp + g + 8 * r;
  };
  uint32_t gen = 0;
  for (int u = begin; u < end; ++gen) {
    const int bh = u / tiles_per_bh, b = bh / heads, h = bh - b * heads;
    const int seg_end = min(end, (bh + 1) * tiles_per_bh);
    mbar_wait(k_full, gen & 1);
    for (; u < seg_end; ++u) {
      const int i = u - begin, st = i % kStages;
      mbar_wait(q_full(st), (i / kStages) & 1);

      float s[KT * 8];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // k-step kk: 16 columns of d, 32 bytes into each swizzled row
        const uint64_t da = smem_desc<D>(q_s + st * kQBytes) + 2 * kk;
        const uint64_t db = smem_desc<D>(k_s + key0 * kRow) + 2 * kk;
        if constexpr (KT == 12) {
          wgmma_ss_n192(s, da, db, kk);
        } else {
          wgmma_ss_n256(s, da, db, kk);
          wgmma_ss_n32(s + 128, da, db + ((256 * kRow) >> 4), kk);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<KT * 8>(s);
      if (lane == 0) mbar_arrive(q_empty(st));  // one per warp

      // each consumer's e = 2^(s c - m_w) and l_w = sum e over its keys (m_w
      // its own row max); the two meet: m = max(m_0, m_1),
      // l = l_0 2^(m_0 - m) + l_1 2^(m_1 - m) (the same order in both), and
      // p = e 2^(m_w - m) / l = 2^(s c - m) / l
      float m[2], l[2], f[2];
      row_max<KT, 0>(s, nk - key0, scale_log2, t4, m);
      exp_rowsum<KT, false>(s, scale_log2, m, l);
      if (t4 == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *red_at(0, wg, r) = m[r];
          *red_at(1, wg, r) = l[r];
        }
      consumers_sync();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m0 = *red_at(0, 0, r), m1 = *red_at(0, 1, r);
        const float mm = fmaxf(m0, m1);
        const float lsum = *red_at(1, 0, r) * exp2_approx(m0 - mm) +
                           *red_at(1, 1, r) * exp2_approx(m1 - mm);
        f[r] = exp2_approx(m[r] - mm) / lsum;
      }
      uint32_t p[KT * 4];
      normalize_pack<KT>(s, f, p);

      float o[D / 2];
      mbar_wait(v_full, gen & 1);
      fence_regs<KT * 4>(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        wgmma_rs<D>(o, p + 4 * kk,
                    smem_desc<D>(v_s + (key0 + 16 * kk) * kRow), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(o);

      // o = consumer 0's p v + consumer 1's
      if (wg == 1)
#pragma unroll
        for (int j = 0; j < D / 2; ++j) part[j * kConsumerThreads + ct] = o[j];
      consumers_sync();
      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < D / 2; ++j) o[j] += part[j * kConsumerThreads + ct];
        // o to the staging tile once the previous tile's store has read
        // it; then one TMA store
        if (ct == 0) tma_store_wait<true>();
        consumer_sync(0);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t r = warp * 16 + g + 8 * half, c = 8 * j + 2 * t4;
            *reinterpret_cast<uint32_t*>(stage_o + swizzled<D>(r, c)) =
                sr_wgmma::pack(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
          }
        fence_proxy_async();
        consumer_sync(0);
        if (ct == 0)
          tma_store(&to, o_s, h * D, (u - bh * tiles_per_bh) * kTileQ, b);
      }
    }
    // done with this segment's K and V (one arrival per warp)
    if (seg_end < end && lane == 0) mbar_arrive(kv_empty);
  }
  if (wg == 0 && ct == 0) tma_store_wait<false>();
}

template <int D, int KT>
int launch_split(const void* q, const void* k, const void* v, void* out,
                 int b, int nq, int nk, int heads, int grid,
                 cudaStream_t stream) {
  auto kernel = sr_attention_fwd_wgmma_split_kernel<D, KT>;
  static std::atomic<uint32_t> opted{0};
  cudaError_t err = opt_in_smem(kernel, opted);
  if (err != cudaSuccess) return int(err);
  const int tiles = (nq + kTileQ - 1) / kTileQ;
  const int64_t total = int64_t(b) * heads * tiles;
  if (grid < 1 || grid > total || total > INT_MAX)
    return int(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  if (!encode_maps<D>(maps, q, k, v, out, b, nq, nk, heads * D))
    return int(cudaErrorInvalidValue);
  kernel<<<grid, kWgThreads, SplitLayout(D, KT).total, stream>>>(
      maps[0], maps[1], maps[2], maps[3], nk, heads, tiles, int(total),
      1.4426950408889634f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

template <int D>
int dispatch_split(const void* q, const void* k, const void* v, void* out,
                   int b, int nq, int nk, int heads, int grid,
                   cudaStream_t stream) {
  if (split_kt(nk) == 12)
    return launch_split<D, 12>(q, k, v, out, b, nq, nk, heads, grid, stream);
  return launch_split<D, kSplitMaxKT>(q, k, v, out, b, nq, nk, heads, grid,
                                      stream);
}

// ---- bfloat16 past 2 * kMaxNkBf16 keys: K and V streamed, two sweeps ----

constexpr int kStreamKeys = 128;       // keys of a K/V block
constexpr int kStreamStages = 4;       // K/V blocks in flight (streamed)
constexpr int kQRing = 2;              // query tiles in flight per consumer
constexpr int kStreamProducerRegs = 56;   // setmaxnreg: 128 * 56 + 256 * 224
constexpr int kStreamConsumerRegs = 224;
static_assert(2 * kStreamStages <= kStreamBars - 2 * kStreamTiles,
              "the streaming kernel's barriers");
static_assert(kConsumers * kQRing == kStreamTiles, "the layout's tiles");

// The row max of a 64-key block's scores s (the accumulator of a 64 x 64
// product: thread rows g and g + 8, keys 8 (i / 4) + 2 t4 + (i & 1) of the
// block), keys from key0 past nk masked to -inf in place; the max is the
// same in the 4 lanes of a quad.
__device__ __forceinline__ void block_max(float (&s)[kStreamKeys / 2],
                                          int key0, int nk, int t4,
                                          float (&mx)[2]) {
  if (key0 + kStreamKeys > nk) {
#pragma unroll
    for (int i = 0; i < kStreamKeys / 2; ++i) {
      const int key = key0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      s[i] = key < nk ? s[i] : -INFINITY;
    }
  }
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int i = 0; i < kStreamKeys / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// Nk > 2 * kMaxNkBf16 in bfloat16. The grid is the on-chip kernel's: CTA
// x of G takes the global 64-row query tiles [x T / G, (x + 1) T / G) of
// T = B * heads * tiles_per_bh in (batch, head, tile) order (G = min(T,
// SMs): every SM works, no CTA more than one tile over another); a run of
// them with one (batch, head) is a segment, whose tiles alternate between
// the two consumers (the segment's t-th tile goes to consumer t % 2).
// K/V stream through a ring of kStreamStages blocks twice per round of two
// tiles (one per consumer).
// Per tile the consumer takes two sweeps over the blocks: sweep 1 forms
// s = q k^T (wgmma m64n128k16) with an online row max m and sum l; sweep 2
// forms s again, p = 2^(s c - m) / l rounded to bf16 in registers, the
// plain version's rounding point, and o += p v (m64n{d}k16, V MN-major).
// Each block's products are waited on before its fold: issuing the next
// block's q k^T first (into a second accumulator) ran slower on the H100
// at every shape tried (PERF.md). o is stored from registers. One q k^T
// more than the function needs, paid only past 2 * kMaxNkBf16 keys.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
sr_attention_fwd_wgmma_stream_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     bf16* __restrict__ out, int nq, int nk,
                                     int heads, int tiles_per_bh, int total,
                                     float scale_log2) {
  constexpr uint32_t kRow = D * sizeof(bf16);
  constexpr uint32_t kQBytes = kTileQ * kRow;
  constexpr uint32_t kBlkBytes = kStreamKeys * kRow;
  constexpr int kS = kStreamKeys / 2;  // accumulator floats a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nb = (nk + kStreamKeys - 1) / kStreamKeys;
  const KVStreamLayout lay(D, kStreamStages * kStreamKeys);
  const uint32_t base = smem_u32(smem);
  const uint32_t k_s = base + uint32_t(lay.k), v_s = base + uint32_t(lay.v);
  auto q_slot = [&](int c, int st) {
    return base + uint32_t(lay.tiles) + (c * kQRing + st) * kQBytes;
  };
  const uint32_t bars = base + uint32_t(lay.bar);
  auto q_full = [&](int c, int st) { return bars + 8 * (c * kQRing + st); };
  auto q_empty = [&](int c, int st) {
    return bars + 8 * (kStreamTiles + c * kQRing + st);
  };
  auto full = [&](int st) { return bars + 8 * (2 * kStreamTiles + st); };
  auto empty = [&](int st) {
    return bars + 8 * (2 * kStreamTiles + kStreamStages + st);
  };

  const int tid = int(threadIdx.x);
  if (tid == 0) {
    for (int c = 0; c < kConsumers; ++c)
      for (int st = 0; st < kQRing; ++st) {
        mbar_init(q_full(c, st), 1);
        mbar_init(q_empty(c, st), kConsumerThreads / 32);
      }
    for (int st = 0; st < kStreamStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers * kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int begin = int(int64_t(blockIdx.x) * total / gridDim.x);
  const int end = int(int64_t(blockIdx.x + 1) * total / gridDim.x);

  const int wg = __shfl_sync(0xffffffffu, tid / kConsumerThreads, 0);
  if (wg == kConsumers) {
    // ---- producer: per round the query tiles, then the K/V blocks of
    // both sweeps
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kStreamProducerRegs));
    if (tid != kConsumers * kConsumerThreads) return;
    uint32_t kv = 0;     // blocks so far
    int n0 = 0, n1 = 0;  // each consumer's tiles so far
    for (int u = begin; u < end;) {
      const int bh = u / tiles_per_bh, b = bh / heads, h = bh - b * heads;
      const int seg_end = min(end, (bh + 1) * tiles_per_bh);
      const int ns = seg_end - u, t0 = u - bh * tiles_per_bh;
      auto load_q = [&](int t) {
        const int c = t & 1, nc = c ? n1 : n0, st = nc % kQRing;
        mbar_wait(q_empty(c, st), ((nc / kQRing) & 1) ^ 1);
        mbar_expect_tx(q_full(c, st), kQBytes);
        tma_load(q_slot(c, st), &tq, q_full(c, st), h * D, (t0 + t) * kTileQ,
                 b);
        if (c)
          ++n1;
        else
          ++n0;
      };
      for (int t = 0; t < ns; t += 2) {
        load_q(t);
        if (t + 1 < ns) load_q(t + 1);
        for (int sweep = 0; sweep < 2; ++sweep)
          for (int j = 0; j < nb; ++j, ++kv) {
            const int st = int(kv % kStreamStages);
            mbar_wait(empty(st), ((kv / kStreamStages) & 1) ^ 1);
            mbar_expect_tx(full(st), (sweep + 1) * kBlkBytes);
            tma_load(k_s + st * kBlkBytes, &tk, full(st), h * D,
                     j * kStreamKeys, b);
            if (sweep)
              tma_load(v_s + st * kBlkBytes, &tv, full(st), h * D,
                       j * kStreamKeys, b);
          }
      }
      u = seg_end;
    }
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kStreamConsumerRegs));
  const int ct = tid - wg * kConsumerThreads;
  const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  const int c = heads * D;
  uint32_t kv = 0;  // blocks so far
  int n = 0;        // this consumer's tiles so far
  // Block x of a tile's two sweeps (x < nb: sweep 1, else sweep 2, key
  // block x % nb) sits at stage (kv + x) % kStreamStages: `blk` is its byte
  // offset in the K (and V) region
  auto blk = [&](int x) -> uint32_t {
    return ((kv + x) % kStreamStages) * kBlkBytes;
  };
  auto acquire = [&](int x) {
    mbar_wait(full((kv + x) % kStreamStages), ((kv + x) / kStreamStages) & 1);
  };
  auto release = [&](int x) {  // one arrival per warp
    __syncwarp();
    if (lane == 0) mbar_arrive(empty((kv + x) % kStreamStages));
  };
  for (int u = begin; u < end;) {
    const int bh = u / tiles_per_bh, b = bh / heads, h = bh - b * heads;
    const int seg_end = min(end, (bh + 1) * tiles_per_bh);
    const int ns = seg_end - u, t0 = u - bh * tiles_per_bh;
    for (int t = wg; t - wg < ns; t += 2) {
      if (t >= ns) {
        // no tile of this round: pass its blocks on
        for (int x = 0; x < 2 * nb; ++x) {
          acquire(x);
          release(x);
        }
        kv += 2 * nb;
        break;
      }
      const int st_q = n % kQRing;
      mbar_wait(q_full(wg, st_q), (n / kQRing) & 1);
      const uint32_t qt = q_slot(wg, st_q);
      auto issue_s = [&](float (&s)[kS], int x) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kStreamKeys, 0, 0>(s, smem_desc<D>(qt) + 2 * kk,
                                      smem_desc<D>(k_s + blk(x)) + 2 * kk,
                                      kk);
        wgmma_commit();
      };
      float s[kS];

      // sweep 1: the online row max and sum
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      auto fold1 = [&](float (&s)[kS], int j) {
        fence_regs<kS>(s);
        float mx[2];
        block_max(s, j * kStreamKeys, nk, t4, mx);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          // the block holds a valid key, so the new max is finite
          const float mn = fmaxf(m[rr], mx[rr] * scale_log2);
          l[rr] *= exp2_approx(m[rr] - mn);
          m[rr] = mn;
        }
#pragma unroll
        for (int i = 0; i < kS; ++i)
          l[(i >> 1) & 1] +=
              exp2_approx(fmaf(s[i], scale_log2, -m[(i >> 1) & 1]));
        release(j);
      };
      for (int j = 0; j < nb; ++j) {
        acquire(j);
        issue_s(s, j);
        wgmma_wait_all();
        fold1(s, j);
      }
      float inv_l[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
        inv_l[rr] = 1.f / l[rr];
      }

      // sweep 2: p = 2^(s c - m) / l in bf16, o += p v
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      uint32_t p[kS / 2];
      auto fold2 = [&](float (&s)[kS], int j) {
        fence_regs<kS>(s);
        if ((j + 1) * kStreamKeys > nk) {
#pragma unroll
          for (int i = 0; i < kS; ++i) {
            const int key = j * kStreamKeys + 8 * (i >> 2) + 2 * t4 + (i & 1);
            s[i] = key < nk ? s[i] : -INFINITY;
          }
        }
#pragma unroll
        for (int i = 0; i < kS / 2; ++i) {
          const int rr = i & 1;
          p[i] = sr_wgmma::pack(
              exp2_approx(fmaf(s[2 * i], scale_log2, -m[rr])) * inv_l[rr],
              exp2_approx(fmaf(s[2 * i + 1], scale_log2, -m[rr])) *
                  inv_l[rr]);
        }
        fence_regs<kS / 2>(p);
        fence_regs<D / 2>(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kStreamKeys / 16; ++kk)
          wgmma_rs<D>(o, p + 4 * kk,
                      smem_desc<D>(v_s + blk(nb + j) + kk * 16 * kRow), 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<D / 2>(o);
        release(nb + j);
      };
      for (int j = 0; j < nb; ++j) {
        acquire(nb + j);
        issue_s(s, nb + j);
        wgmma_wait_all();
        fold2(s, j);
      }
      kv += 2 * nb;

      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty(wg, st_q));  // q read by both sweeps
      ++n;
      const int row0 = (t0 + t) * kTileQ + 16 * warp + g;
      bf16* ob = out + size_t(b) * nq * c + h * D;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + 8 * hf;
        if (row < nq) {
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj)
            *reinterpret_cast<uint32_t*>(ob + size_t(row) * c + 8 * jj +
                                         2 * t4) =
                sr_wgmma::pack(o[4 * jj + 2 * hf], o[4 * jj + 2 * hf + 1]);
        }
      }
    }
    u = seg_end;
  }
}

template <int D>
int launch_stream(const void* q, const void* k, const void* v, void* out,
                  int b, int nq, int nk, int heads, int grid,
                  cudaStream_t stream) {
  auto kernel = sr_attention_fwd_wgmma_stream_kernel<D>;
  static std::atomic<uint32_t> opted{0};
  cudaError_t err = opt_in_smem(kernel, opted);
  if (err != cudaSuccess) return int(err);
  const int tiles = (nq + kTileQ - 1) / kTileQ;
  const int64_t total = int64_t(b) * heads * tiles;
  if (grid < 1 || grid > total || total > INT_MAX)
    return int(cudaErrorInvalidValue);
  const int c = heads * D;
  CUtensorMap maps[3];
  if (!encode_map<D>(&maps[0], q, b, nq, c, kTileQ) ||
      !encode_map<D>(&maps[1], k, b, nk, c, kStreamKeys) ||
      !encode_map<D>(&maps[2], v, b, nk, c, kStreamKeys))
    return int(cudaErrorInvalidValue);
  kernel<<<grid, kWgThreads,
           KVStreamLayout(D, kStreamStages * kStreamKeys).total, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), nq, nk, heads,
      tiles, int(total), 1.4426950408889634f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

// ---- float32: the 3xTF32 wgmma + TMA kernel ----

constexpr int kF32Stages = 3;          // K/V blocks in flight
constexpr int kF32Keys = 32;           // keys of a K/V block
constexpr int kF32Rows = 64;           // query rows of a tile
constexpr int kF32ProducerRegs = 56;   // setmaxnreg: 128 * 56 + 256 * 224
constexpr int kF32ConsumerRegs = 224;  // = the 384 * 168 a CTA starts with

// Shared memory of the float32 kernel, in bytes from a 1024-aligned base;
// every tile a float32 panel tile (sr_attention_wgmma.cuh):
//   q  [kConsumers][64][D]      each consumer's query tile, as loaded
//   per stage st < kF32Stages, five tiles of 32 * D floats:
//     0 kh [32 keys][D]         K (TMA), then tf32(K) in place
//     1 kl [32 keys][D]         tf32(K - tf32(K))
//     2 vh [D][32 keys]         V^T hi, keys in kperm order
//     3 vl [D][32 keys]         V^T lo
//     4 vr [32 keys][D]         V (TMA)
//   barriers: q_full, q_empty [kConsumers]; raw_full, full, empty
//   [kF32Stages]
struct F32Layout {
  size_t tile, blk, q, stage, bar, total;
  __host__ __device__ explicit F32Layout(int d) {
    tile = size_t(kF32Rows) * d * sizeof(float);
    blk = size_t(kF32Keys) * d * sizeof(float);
    q = 0;
    stage = q + kConsumers * tile;
    bar = stage + kF32Stages * 5 * blk;
    total = bar + (2 * kConsumers + 3 * kF32Stages) * 8 + 1024;
  }
};

// The producer warpgroup's split of a K/V block in stage tiles kh .. vr:
// K in place into hi and lo; V^T hi and lo in kperm order (lane l of warp
// w writes key position l of columns w D / 4 .. + D / 4: 32 lanes on 32
// banks; a quarter-warp's float4 reads of V fall on 8 keys of distinct
// key % 8, so on 8 distinct swizzled chunks).
template <int D>
__device__ __forceinline__ void split_kv(unsigned char* kh, unsigned char* kl,
                                         unsigned char* vh, unsigned char* vl,
                                         const unsigned char* vr, int pt) {
#pragma unroll
  for (int i = pt; i < kF32Keys * D / 4; i += kConsumerThreads) {
    const float4 x = *reinterpret_cast<const float4*>(kh + 16 * i);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(kh + 16 * i) = hi;
    *reinterpret_cast<uint4*>(kl + 16 * i) = lo;
  }
  const int pos = pt & 31, key = kperm(pos), n0 = (pt >> 5) * (D / 4);
#pragma unroll
  for (int n4 = 0; n4 < D / 16; ++n4) {
    const int n = n0 + 4 * n4;
    const float4 x =
        *reinterpret_cast<const float4*>(vr + f32_off(key, n, kF32Keys));
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hi, lo;
      split_tf32(xs[e], hi, lo);
      *reinterpret_cast<uint32_t*>(vh + f32_off(n + e, pos, D)) = hi;
      *reinterpret_cast<uint32_t*>(vl + f32_off(n + e, pos, D)) = lo;
    }
  }
}

// Threads 0-255 are the two consumer warpgroups, 256-383 the producer
// (thread 256 issues every TMA load; all 128 split the K/V blocks). CTA x
// serves (batch, head) x / ctas_per_pair and its query tiles
// [j T / n, (j + 1) T / n) (j = x % ctas_per_pair, n = ctas_per_pair,
// T = tiles_per_bh); round r gives the run's tiles 2r and 2r + 1 to
// consumers 0 and 1, and streams the pair's ceil(Nk / 32) K/V blocks once
// for both (a consumer without a tile in the last round passes them on).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
sr_attention_fwd_f32_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            float* __restrict__ out, int nq, int nk,
                            int heads, int tiles_per_bh, int ctas_per_pair,
                            float scale_log2) {
  static_assert(D == 32 || D == 64, "head width 32 or 64");
  constexpr int KS = D / 8;  // k-steps of q k^T
  constexpr uint32_t kTileBytes = kF32Rows * D * sizeof(float);
  constexpr uint32_t kBlkBytes = kF32Keys * D * sizeof(float);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const F32Layout lay(D);
  const uint32_t base = smem_u32(smem);
  auto q_tile = [&](int c) { return uint32_t(lay.q) + c * kTileBytes; };
  auto kv_tile = [&](int st, int i) {
    return uint32_t(lay.stage) + (st * 5 + i) * kBlkBytes;
  };
  const uint32_t bars = base + uint32_t(lay.bar);
  auto q_full = [&](int c) { return bars + 8 * c; };
  auto q_empty = [&](int c) { return bars + 8 * (kConsumers + c); };
  auto raw_full = [&](int st) { return bars + 8 * (2 * kConsumers + st); };
  auto full = [&](int st) {
    return bars + 8 * (2 * kConsumers + kF32Stages + st);
  };
  auto empty = [&](int st) {
    return bars + 8 * (2 * kConsumers + 2 * kF32Stages + st);
  };

  const int tid = int(threadIdx.x);
  if (tid == 0) {
    for (int c = 0; c < kConsumers; ++c) {
      mbar_init(q_full(c), 1);
      mbar_init(q_empty(c), kConsumerThreads / 32);
    }
    for (int st = 0; st < kF32Stages; ++st) {
      mbar_init(raw_full(st), 1);
      mbar_init(full(st), kConsumerThreads / 32);
      mbar_init(empty(st), kConsumers * kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int pair = int(blockIdx.x) / ctas_per_pair;
  const int chunk = int(blockIdx.x) - pair * ctas_per_pair;
  const int b = pair / heads, h = pair - b * heads;
  const int t0 = int(int64_t(chunk) * tiles_per_bh / ctas_per_pair);
  const int ntiles =
      int(int64_t(chunk + 1) * tiles_per_bh / ctas_per_pair) - t0;
  const int rounds = (ntiles + 1) / 2;
  const int nb = (nk + kF32Keys - 1) / kF32Keys;

  const int wg = __shfl_sync(0xffffffffu, tid / kConsumerThreads, 0);
  if (wg == kConsumers) {
    // ---- producer: q tiles and K/V blocks by TMA; the K/V split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kF32ProducerRegs));
    const int pt = tid - kConsumers * kConsumerThreads;
    uint32_t kv = 0;  // K/V blocks so far
    for (int r = 0; r < rounds; ++r) {
      if (pt == 0)
        for (int c = 0; c < kConsumers && 2 * r + c < ntiles; ++c) {
          mbar_wait(q_empty(c), (r & 1) ^ 1);
          mbar_expect_tx(q_full(c), kTileBytes);
          for (int p = 0; p < D / 32; ++p)
            tma_load(base + q_tile(c) + p * kF32Rows * 128, &tq, q_full(c),
                     h * D + 32 * p, (t0 + 2 * r + c) * kF32Rows, b);
        }
      for (int j = 0; j < nb; ++j, ++kv) {
        const int st = int(kv % kF32Stages);
        const uint32_t par = (kv / kF32Stages) & 1;
        if (pt == 0) {
          mbar_wait(empty(st), par ^ 1);
          mbar_expect_tx(raw_full(st), 2 * kBlkBytes);
          for (int p = 0; p < D / 32; ++p) {
            tma_load(base + kv_tile(st, 0) + p * kF32Keys * 128, &tk,
                     raw_full(st), h * D + 32 * p, j * kF32Keys, b);
            tma_load(base + kv_tile(st, 4) + p * kF32Keys * 128, &tv,
                     raw_full(st), h * D + 32 * p, j * kF32Keys, b);
          }
        }
        mbar_wait(raw_full(st), par);
        split_kv<D>(smem + kv_tile(st, 0), smem + kv_tile(st, 1),
                    smem + kv_tile(st, 2), smem + kv_tile(st, 3),
                    smem + kv_tile(st, 4), pt);
        fence_proxy_async();
        __syncwarp();
        if ((pt & 31) == 0) mbar_arrive(full(st));
      }
    }
    return;
  }

  // ---- consumers: s = q k^T, online softmax, o += p v per K/V block
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kF32ConsumerRegs));
  const int ct = tid - wg * kConsumerThreads;
  const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  const int c = heads * D;
  uint32_t kv = 0;
  for (int r = 0; r < rounds; ++r) {
    const int tile = 2 * r + wg;
    const bool mine = tile < ntiles;
    uint32_t qh[4 * KS], ql[4 * KS];
    if (mine) {
      mbar_wait(q_full(wg), r & 1);
      load_a_tf32<KS>(smem + q_tile(wg), kF32Rows, warp, g, t4, qh, ql);
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty(wg));
    }
    float o[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    for (int j = 0; j < nb; ++j, ++kv) {
      const int st = int(kv % kF32Stages);
      mbar_wait(full(st), (kv / kF32Stages) & 1);
      if (mine) {
        float s[kF32Keys / 2];
        fence_regs<4 * KS>(qh);
        fence_regs<4 * KS>(ql);
        wgmma_fence();
        wgmma_3xtf32<kF32Keys, KS>(s, qh, ql, base + kv_tile(st, 0),
                                   base + kv_tile(st, 1), kF32Keys, 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<kF32Keys / 2>(s);
        if ((j + 1) * kF32Keys > nk) {
#pragma unroll
          for (int i = 0; i < kF32Keys / 2; ++i) {
            const int key = j * kF32Keys + 8 * (i >> 2) + 2 * t4 + (i & 1);
            s[i] = key < nk ? s[i] : -INFINITY;
          }
        }
        // the online max (the block holds a valid key, so it is finite)
        float mx[2] = {-INFINITY, -INFINITY}, f[2];
#pragma unroll
        for (int i = 0; i < kF32Keys / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
          const float mn = fmaxf(m[rr], mx[rr] * scale_log2);
          f[rr] = exp2_approx(m[rr] - mn);
          l[rr] *= f[rr];
          m[rr] = mn;
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= f[(i >> 1) & 1];
#pragma unroll
        for (int i = 0; i < kF32Keys / 2; ++i) {
          s[i] = exp2_approx(fmaf(s[i], scale_log2, -m[(i >> 1) & 1]));
          l[(i >> 1) & 1] += s[i];
        }
        uint32_t ph[kF32Keys / 2], pl[kF32Keys / 2];
        acc_to_a_tf32<kF32Keys>(s, ph, pl);
        fence_regs<kF32Keys / 2>(ph);
        fence_regs<kF32Keys / 2>(pl);
        fence_regs<D / 2>(o);
        wgmma_fence();
        wgmma_3xtf32<D, kF32Keys / 8>(o, ph, pl, base + kv_tile(st, 2),
                                      base + kv_tile(st, 3), D, 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<D / 2>(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));  // one per warp
    }
    if (mine) {
      float inv[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
        inv[rr] = 1.f / l[rr];
      }
      const int row0 = (t0 + tile) * kF32Rows + 16 * warp + g;
      float* ob = out + size_t(b) * nq * c + h * D;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + 8 * hf;
        if (row < nq) {
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj)
            *reinterpret_cast<float2*>(ob + size_t(row) * c + 8 * jj +
                                       2 * t4) =
                make_float2(o[4 * jj + 2 * hf] * inv[hf],
                            o[4 * jj + 2 * hf + 1] * inv[hf]);
        }
      }
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int nq, int nk, int heads, int ctas_per_pair,
               cudaStream_t stream) {
  auto kernel = sr_attention_fwd_f32_kernel<D>;
  static std::atomic<uint32_t> opted{0};
  cudaError_t err = opt_in_smem(kernel, opted);
  if (err != cudaSuccess) return int(err);
  const int tiles = (nq + kF32Rows - 1) / kF32Rows;
  const int64_t grid = int64_t(b) * heads * ctas_per_pair;
  if (ctas_per_pair < 1 || ctas_per_pair > tiles || grid > INT_MAX)
    return int(cudaErrorInvalidValue);
  const int c = heads * D;
  CUtensorMap maps[3];
  if (!encode_map_f32(&maps[0], q, b, nq, c, kF32Rows) ||
      !encode_map_f32(&maps[1], k, b, nk, c, kF32Keys) ||
      !encode_map_f32(&maps[2], v, b, nk, c, kF32Keys))
    return int(cudaErrorInvalidValue);
  kernel<<<int(grid), kWgThreads, F32Layout(D).total, stream>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(out), nq, nk, heads,
      tiles, ctas_per_pair, 1.4426950408889634f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (elem: 4 the float32
// kernel; 2 the bfloat16 one, past kMaxNkBf16 keys the split kernel, past
// 2 * kMaxNkBf16 the two-sweep kernel). Every kernel takes any Nk within
// them.
size_t sr_attention_fwd_smem_bytes(int nk, int d, int elem) {
  if (elem == 4) return F32Layout(d).total;
  if (nk > 2 * kMaxNkBf16)
    return KVStreamLayout(d, kStreamStages * kStreamKeys).total;
  if (nk > kMaxNkBf16) return SplitLayout(d, split_kt(nk)).total;
  return WgLayout(d, nk <= 16 * 16 ? 16 : kMaxKeyTiles).total;
}

// How many CTAs of the bfloat16 kernel for (nk, d) fit an SM of the current
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

// dtype: 0 float32 (the 3xTF32 kernel over b * heads * ctas_per_pair CTAs,
// as ops/sr_attention.py's launch plan sets it), 1 bfloat16 up to
// kMaxNkBf16 keys (the bf16 kernel, one CTA an SM, ctas_per_pair unused;
// past them sr_attention_fwd_stream runs). q, k, v and out are 16-byte
// aligned. Returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue)
// for a shape or type the kernels do not take.
int sr_attention_fwd(const void* q, const void* k, const void* v, void* out,
                     int b, int nq, int nk, int c, int heads, int dtype,
                     int ctas_per_pair, void* stream) {
  const int d = c / heads;
  if (b < 1 || nq < 1 || nk < 1 || d * heads != c)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 32)
    return launch_f32<32>(q, k, v, out, b, nq, nk, heads, ctas_per_pair, s);
  if (dtype == 0 && d == 64)
    return launch_f32<64>(q, k, v, out, b, nq, nk, heads, ctas_per_pair, s);
  if (dtype == 1 && nk <= kMaxNkBf16 && d == 32)
    return dispatch_wgmma<32>(q, k, v, out, b, nq, nk, heads, s);
  if (dtype == 1 && nk <= kMaxNkBf16 && d == 64)
    return dispatch_wgmma<64>(q, k, v, out, b, nq, nk, heads, s);
  return int(cudaErrorInvalidValue);
}

// bfloat16 past kMaxNkBf16 keys over `grid` CTAs, as ops/sr_attention.py's
// `fwd_stream_plan` sets them: the split kernel (split != 0, Nk <= 576) or
// the two-sweep kernel. q, k, v and out are 16-byte aligned. Returns a
// cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for a shape, grid
// or kernel they do not take (the split kernel past 576 keys).
int sr_attention_fwd_stream(const void* q, const void* k, const void* v,
                            void* out, int b, int nq, int nk, int c,
                            int heads, int grid, int split, void* stream) {
  const int d = c / heads;
  if (b < 1 || nq < 1 || nk <= kMaxNkBf16 || d * heads != c ||
      (split && nk > 2 * kMaxNkBf16))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split && d == 32)
    return dispatch_split<32>(q, k, v, out, b, nq, nk, heads, grid, s);
  if (split && d == 64)
    return dispatch_split<64>(q, k, v, out, b, nq, nk, heads, grid, s);
  if (d == 32)
    return launch_stream<32>(q, k, v, out, b, nq, nk, heads, grid, s);
  if (d == 64)
    return launch_stream<64>(q, k, v, out, b, nq, nk, heads, grid, s);
  return int(cudaErrorInvalidValue);
}

const char* sr_attention_fwd_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
