// SR-attention backward for Hopper (sm_90a): the gradients dq, dk, dv of
// out = softmax(q k^T / sqrt(d)) v given the output gradient g, per
// (batch, head), with q, g, dq of shape (B, Nq, C) and k, v, dk, dv of shape
// (B, Nk, C), C = heads * d, all row-major and contiguous.
//
// Replaces the Pallas TPU kernel semisupervisedobjectdetection_tpu/ops/
// sr_attention.py::_bwd_kernel and computes the same function:
//   p  = softmax(q k^T * scale)            float32, recomputed
//   dv = p^T g                             float32 sums
//   dp = g v^T                             float32
//   ds = p * (dp - rowsum(dp * p)) * scale float32
//   dq = round(ds) k,  dk = round(ds)^T q  ds rounded to the input type,
//                                          float32 sums
// dq is written in q's type; dk and dv are summed in float32 and cast.
//
// Bound. Per launch the function does 10*B*Nq*Nk*C flops (five products)
// and moves q, g, dq (B*Nq*C each) and k, v, dk, dv (B*Nk*C each) once. At
// MiT-B5 512x512 at batch 16 in bf16 on the H100 the operations bound it at
// stages 1-3 (stage 1 43 us, stage 3 13.6 us against 12.5 us of bytes) and
// the bytes at stage 4 (8.8 us). Two designs, by dtype, both every product
// on wgmma with tiles brought in by TMA, both without atomics (two launches
// give the same bits):
//
// bfloat16: the Hopper kernel (sr_attention_bwd_wgmma_kernel), every product
// on wgmma, one launch (two where a (batch, head) is split over CTAs).
//   Grid. The 64-row query tiles of all (batch, head)s, T of them, in
//   (batch, head, tile) order; CTA x takes the contiguous range
//   [x T / G, (x + 1) T / G). The launch plan (ops/sr_attention.py,
//   `bwd_launch_plan`) sets G = min(T, SMs) where cutting (batch, head)s
//   over CTAs shortens the longest CTA (stage 1: 16 pairs of 256 tiles,
//   stage 3: 80 pairs of 16: every SM gets ~T / 132 tiles, a pair spans
//   several CTAs), else G = B * heads, one pair a CTA (stage 4: 128 pairs
//   of 4 tiles). A run of tiles of one pair in a CTA is a segment: its K
//   and V are loaded once, and dk and dv of its keys stay in registers
//   across its tiles.
//   CTA: two consumer warpgroups and a producer warpgroup (384 threads, one
//   CTA an SM; ptxas gives a wgmma kernel the registers of whole
//   warpgroups, so setmaxnreg moves the producer's to the consumers: 240
//   each). One producer thread loads a segment's K and V by TMA in 64-key
//   boxes and keeps q and g tiles in flight in a ring of two stages (3-D
//   tensor maps over (C, N, B), box (d, 64, 1) at column h*d, so ragged
//   query tails and keys past Nk are zero-filled by the TMA unit and never
//   read across a batch boundary). Both consumers work on every tile; the
//   keys are cut into 64-key M-tiles, and consumer w owns M-tiles w, w + 2
//   (and, for 256 < Nk <= 288, consumer 0 the fifth).
//   Per 64-row tile, seven products instead of the function's five:
//   1. Row statistics on chip: over a share of the keys in 32-key chunks
//      (the consumer that ran the previous tile's dq takes ~3/8 of them),
//      each consumer forms s = q k^T and dp = g v^T (wgmma m64n32, q and k
//      K-major) and keeps an online max m, sum l = sum 2^(s c - m) and
//      u = sum 2^(s c - m) dp per query row (c = scale log2(e)); every
//      warp merges the two consumers' (m, l, u) from shared memory in the
//      same fixed order: delta = u / l = rowsum(dp * p).
//   2. The main sweep, keys as wgmma's M: per owned M-tile and 32-row half
//      of the tile, s^T = k q^T and dp^T = v g^T (m64n32 from shared
//      memory), p = 2^(s c - m) / l and ds = p (dp - delta) scale in
//      float32 registers, both rounded to bf16 as register A operands
//      (the accumulator layout of one product is the A layout of the next),
//      then dv += p^T g and dk += ds^T q (wgmma m64n{d}, g and q read
//      MN-major from the same tiles: the transpose bit) into the
//      accumulators that stay in registers for the segment. ds^T goes to a
//      shared-memory tile in the swizzled layout wgmma reads.
//   3. dq = ds k over all keys by one consumer (the tiles alternate between
//      the two), both operands MN-major from shared memory (ds^T and K:
//      the transpose bits), through a swizzled staging tile to a TMA store.
//   Products 1 are the two the function does not need; the row statistics
//   never leave the chip. dv is formed from p rounded to bf16 (one product,
//   not the two of a p_hi + p_lo split): the error this adds is measured
//   against KERNEL_BWD_TOL in chip_smoke (PERF.md).
//   Cross-CTA sums, deterministic: a segment that covers its whole pair
//   writes dk and dv in bf16; a split one writes its float32 dk and dv to
//   its own workspace slot (CTA x, first or last segment of x), and a
//   second kernel (sr_attention_bwd_split_sum_kernel) sums a pair's slots
//   in CTA order and casts; the launch plan, which sets the grid, decides
//   whether it runs (it passes a workspace). No atomics: two launches give
//   the same bits.
//   Registers: a consumer holds dk and dv of two M-tiles (128 floats at
//   d = 64) and one product pair of 32 rows or keys (32 floats); the
//   fifth M-tile (256 < Nk <= 288) is summed per 32-row block into a
//   float32 tile in shared memory that only its owning thread reads and
//   writes, its dv and then its dk through one set of registers. Wider
//   products (64 rows or keys) or issuing the next product before the
//   previous one's softmax is folded spill or make ptxas serialise the
//   products; both were slower on the H100 (PERF.md).
//   Query rows past Nq are zero (TMA fill): their p is 1/Nk and their ds
//   0, so they add nothing to dv (g = 0) or dk (ds = 0, q = 0), and dq
//   rows past Nq are not stored. Keys past Nk are masked to -inf in the
//   row statistics and to p = ds = 0 in the main sweep.
//   What bounds it: per 64-row tile at Nk 256, d 64 the seven products are
//   ~3,600 tensor-core cycles of an SM at the peak rate and the two
//   exponentials per score (row statistics and main sweep) ~2,000 cycles
//   of its special-function units. Measured (clock64 on the H100), a tile
//   takes ~9,000 cycles: each consumer's products wait on their results
//   before its softmax runs (a serial chain of ~12 wgmma groups a tile),
//   and two consumers overlap only each other. The split sums move
//   2 * Nk * d floats per split segment through L2.
//   Lifting Nk <= 288: the main sweep already walks M-tiles and the row
//   statistics are online over 32-key chunks, so more keys are a longer
//   loop; what does not grow is where dk and dv live. A later design keeps
//   K and V per segment for up to 4 M-tiles and walks the keys past them
//   as a second pass over the segment's query tiles (the row statistics
//   kept per query row in shared memory or recomputed), each pass with its
//   own dk/dv registers, dq summed over the passes in a fixed order.
// float32: three kernels on the TF32 tensor cores, every product split
// three ways (3xTF32, sr_attention_wgmma.cuh: x = hi + lo, a b summed as
// a_lo b_hi + a_hi b_lo + a_hi b_hi in float32; the dropped a_lo b_lo is
// ~2^-22 of a b, so the products sit within ~1e-6 of float64, far inside
// the float32 tolerance). What bounds them: 3 TF32 products per float32
// product, at 495 / 3 = 165 TFLOP/s at best. Any Nk: K and V stream through
// shared memory in blocks, so shared memory does not grow with Nk. The
// launch plan (ops/sr_attention.py, `bwd_f32_plan`) sets both grids and
// the key pass's split count; the launcher takes them as given.
//   1. Row pass (sr_attention_bwd_f32_rows_kernel), 64-row query tiles, the
//      CTA layout of the float32 forward: `row_ctas_per_pair` CTAs per
//      (batch, head), each a run of its tiles, two at a time over two
//      consumer warpgroups, with 32-key K/V blocks streamed by TMA through
//      a ring of 2 stages that the producer warpgroup splits (K and V in
//      place into hi and lo, and K^T hi and lo in kperm order). Sweep 1:
//      s = q k^T and dp = g v^T (m64n32k8, q and g split into registers
//      from their tiles) per block, an online max m, sum l and
//      u = sum 2^(s c - m) dp per query row; then delta = u / l, and
//      (m, 1 / l, delta) of each row to a float32 workspace. Sweep 2: the
//      same two products by the same code, p = 2^(s c - m) / l and
//      ds = p (dp - delta) scale in registers, split as the A operand of
//      dq += ds k (m64n{d}k8 over K^T); dq stored from registers.
//   2. Key pass (sr_attention_bwd_f32_keys_kernel), keys as wgmma's M: a CTA
//      holds two 64-key blocks (one per consumer) of a (batch, head) and
//      walks a range of its 32-row query tiles (the plan's `splits` ranges
//      per (batch, head)); per tile the producer splits q and g (in place,
//      and transposed in kperm order). A consumer forms s^T = k q^T and
//      dp^T = v g^T (m64n32k8, k and v split into registers) with the cross
//      terms in swapped order, so each score and dp is the row pass's to
//      the bit, rebuilds p and ds from the row statistics by the same code,
//      and adds dv += p^T g and dk += ds^T q (m64n{d}k8 over g^T and q^T)
//      into registers held across the range.
//   3. Split sum (sr_attention_bwd_f32_sum_kernel), where splits > 1: each
//      key-pass CTA wrote its float32 dk and dv to its split's slot; the
//      slots are summed in split order.
//   Products: five the function needs, plus s and dp once more in the row
//   pass's sweep 1 and again in the key pass: nine in all.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sr_attention_wgmma.cuh"

namespace {

constexpr int kThreads = 256;      // threads of a split-sum block
constexpr int kMaxNkBf16 = 288;    // the bf16 kernel's K/V and registers

// The error of the launch just made; one more in *launched if none.
int launched_ok(int* launched) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return int(err);
}

// ---- bfloat16: the wgmma + TMA kernel ----

using namespace sr_wgmma;

constexpr int kRowTile = 64;           // query rows of a tile
constexpr int kKeyTile = 64;           // keys of an M-tile: wgmma's M
constexpr int kHalf = 32;              // query rows of a main-sweep product
constexpr int kChunk = 32;             // keys of a row-statistics product
constexpr int kRing = 2;               // q/g tiles in flight
constexpr int kCons = 2;               // consumer warpgroups
constexpr int kWgThreads = 128;        // one warpgroup
constexpr int kBwdThreads = (kCons + 1) * kWgThreads;  // + the producer's
constexpr int kProducerRegs = 24;      // setmaxnreg: 128 * 24 + 256 * 240
constexpr int kConsumerRegs = 240;     // = the 384 * 168 a CTA starts with
constexpr int kMaxMTiles = 5;          // Nk <= 288 < 5 * 64
static_assert(kMaxMTiles * kKeyTile >= kMaxNkBf16, "one Nk limit");

// Shared memory of the wgmma kernel, in bytes from a 1024-aligned base
// (MT M-tiles of keys, rows of D bf16):
//   k, v  [MT * 64][D]          K and V, keys past Nk zero (TMA fill)
//   q, g  [kRing][64][D]        the query-tile ring
//   dst   [MT * 64][64]         ds^T (bf16), 128-byte rows (64 query rows)
//   dq    [kCons][64][D]        each consumer's dq staging
//   tail  [2][D / 2][128] f32   dk, dv of the fifth M-tile (MT = 5 only),
//                               one column per consumer-0 thread
//   part  [kCons][64] float4    each consumer's (m, l, u) per query row
//   stats [kCons * 4][64] float4  each consumer warp's merged (m, 1 / l,
//                               delta)
//   barriers                    full, empty [kRing], kv_full, kv_empty
// Every tile starts on a multiple of 1024 bytes, as the swizzle needs;
// `total` includes the slack to align the dynamic buffer's base.
struct BwdLayout {
  size_t k, v, q, g, dst, dq, tail, part, stats, bar, total;
  __host__ __device__ BwdLayout(int d, int mt) {
    const size_t row = size_t(d) * sizeof(bf16);
    k = 0;
    v = k + size_t(mt) * kKeyTile * row;
    q = v + size_t(mt) * kKeyTile * row;
    g = q + size_t(kRing) * kRowTile * row;
    dst = g + size_t(kRing) * kRowTile * row;
    dq = dst + size_t(mt) * kKeyTile * kRowTile * sizeof(bf16);
    tail = dq + size_t(kCons) * kRowTile * row;
    part = tail + (mt > 4 ? size_t(d) * kWgThreads * sizeof(float) : 0);
    stats = part + size_t(kCons) * kRowTile * sizeof(float4);
    bar = stats + size_t(kCons) * 4 * kRowTile * sizeof(float4);
    total = bar + (2 * kRing + 2) * 8 + 1024;
  }
};

// The M-tiles of a kernel instantiation: 4 for Nk <= 256, 5 up to 288.
__host__ __device__ constexpr int bwd_mtiles(int nk) {
  return nk <= 4 * kKeyTile ? 4 : kMaxMTiles;
}

// Both consumers' threads (barrier 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCons * kWgThreads) : "memory");
}

// Consumer c's own threads (barrier 2 + c).
__device__ __forceinline__ void wg_sync(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + c), "n"(kWgThreads)
               : "memory");
}

// The first CTA of grid G whose range [x T / G, (x + 1) T / G) holds tile u.
__host__ __device__ __forceinline__ int cta_of(int64_t u, int64_t total,
                                               int64_t grid) {
  return int(((u + 1) * grid + total - 1) / total - 1);
}

__host__ __device__ __forceinline__ int range_begin(int64_t x, int64_t total,
                                                    int64_t grid) {
  return int(x * total / grid);
}

// The state one consumer warpgroup carries through a launch: where its
// tiles live and which thread of the warpgroup it is.
template <int D>
struct Consumer {
  uint32_t k_s, v_s, dst_s;
  unsigned char* dst;
  float4* stats;  // this warp's merged row statistics
  int nk, warp, g8, t4;
  float scale, scale_log2;
};

// The row statistics' products over one 32-key chunk from key0: s = q k^T
// and dp = g v^T for the tile's 64 query rows (thread rows 16 warp + g8 and
// + 8, keys key0 + 8 (i / 4) + 2 t4 + (i & 1)), folded into the online max
// m, sum l and u = sum p dp of rows r = 0, 1 (thread partials; m is the
// same in the 4 lanes of a quad).
template <int D>
__device__ __forceinline__ void stats_chunk(const Consumer<D>& cs,
                                            uint32_t qt, uint32_t gt,
                                            int key0, float (&m)[2],
                                            float (&l)[2], float (&u)[2]) {
  constexpr uint32_t kRow = D * sizeof(bf16);
  constexpr int kN = kChunk / 2;  // accumulator floats a thread
  float s[kN], dp[kN];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<kChunk, 0, 0>(s, smem_desc<D>(qt) + 2 * kk,
                           smem_desc<D>(cs.k_s + key0 * kRow) + 2 * kk, kk);
    wgmma_ss<kChunk, 0, 0>(dp, smem_desc<D>(gt) + 2 * kk,
                           smem_desc<D>(cs.v_s + key0 * kRow) + 2 * kk, kk);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<kN>(s);
  fence_regs<kN>(dp);
  if (key0 + kChunk > cs.nk) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int key = key0 + 8 * (i >> 2) + 2 * cs.t4 + (i & 1);
      s[i] = key < cs.nk ? s[i] : -INFINITY;
    }
  }
  float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kN; ++i)
    cm[(i >> 1) & 1] = fmaxf(cm[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 1));
    cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 2));
    // the chunk holds a valid key, so the new max is finite
    const float mn = fmaxf(m[r], cm[r] * cs.scale_log2);
    const float f = exp2_approx(m[r] - mn);
    l[r] *= f;
    u[r] *= f;
    m[r] = mn;
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int r = (i >> 1) & 1;
    const float e = exp2_approx(fmaf(s[i], cs.scale_log2, -m[r]));
    l[r] += e;
    u[r] += e * dp[i];
  }
}

// One owned M-tile (keys key0 .. key0 + 63) of the main sweep over the
// tile's 64 / H row blocks: s^T = k q^T, dp^T = v g^T (thread keys
// key0 + 16 warp + g8 and + 8, query rows H hf + 8 (i / 4) + 2 t4 +
// (i & 1)), p and ds, ds^T to the staging tile, and dv += p^T g,
// dk += ds^T q into av, ak. With `Tail` (the fifth M-tile) ak is scratch:
// each block's dv, then its dk, is formed in it and added by `fold(0)`
// (dk) and `fold(1)` (dv) to the M-tile's shared-memory sums; its blocks
// are 16 rows (H), which keeps that path within the registers the two
// register M-tiles leave.
template <int D, bool Tail, typename Fold, int H = Tail ? 16 : kHalf>
__device__ __forceinline__ void main_tile(const Consumer<D>& cs, uint32_t qt,
                                          uint32_t gt, int key0,
                                          float (&ak)[D / 2],
                                          float (&av)[D / 2], Fold fold) {
  constexpr uint32_t kRow = D * sizeof(bf16);
  const uint32_t km = cs.k_s + key0 * kRow, vm = cs.v_s + key0 * kRow;
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_ok[r] = key0 + 16 * cs.warp + cs.g8 + 8 * r < cs.nk;
#pragma unroll 1
  for (int hf = 0; hf < kRowTile / H; ++hf) {
    const uint32_t qh = qt + hf * H * kRow, gh = gt + hf * H * kRow;
    constexpr int kN = H / 2;  // accumulator floats a thread
    float s[kN], dp[kN];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<H, 0, 0>(s, smem_desc<D>(km) + 2 * kk,
                            smem_desc<D>(qh) + 2 * kk, kk);
      wgmma_ss<H, 0, 0>(dp, smem_desc<D>(vm) + 2 * kk,
                            smem_desc<D>(gh) + 2 * kk, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kN>(s);
    fence_regs<kN>(dp);
#pragma unroll
    for (int q4 = 0; q4 < H / 8; ++q4)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 st = cs.stats[hf * H + 8 * q4 + 2 * cs.t4 + e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * q4 + 2 * r + e;
          float p = exp2_approx(fmaf(s[i], cs.scale_log2, -st.x)) * st.y;
          p = key_ok[r] ? p : 0.f;
          dp[i] = p * (dp[i] - st.z) * cs.scale;
          s[i] = p;
        }
      }
    uint32_t pa[kN / 2], da[kN / 2];
    pack_a<kN>(s, pa);
    pack_a<kN>(dp, da);
    // ds^T (rows: keys, 128 bytes of query rows each) for dq = ds k
#pragma unroll
    for (int q4 = 0; q4 < H / 8; ++q4)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t key = key0 + 16 * cs.warp + cs.g8 + 8 * r;
        const uint32_t row = hf * H + 8 * q4 + 2 * cs.t4;
        *reinterpret_cast<uint32_t*>(cs.dst + swizzled<kRowTile>(key, row)) =
            da[2 * q4 + r];
      }
    if constexpr (Tail) {
      // dv, then dk, of this block through ak
#pragma unroll
      for (int kind = 1; kind >= 0; --kind) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < H / 16; ++kk)
          wgmma_rs<D>(ak, (kind ? pa : da) + 4 * kk,
                      smem_desc<D>((kind ? gt : qt) +
                                   (hf * H + 16 * kk) * kRow),
                      kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<D / 2>(ak);
        fold(kind);
      }
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        wgmma_rs<D>(av, pa + 4 * kk,
                    smem_desc<D>(gt + (hf * H + 16 * kk) * kRow), 1);
        wgmma_rs<D>(ak, da + 4 * kk,
                    smem_desc<D>(qt + (hf * H + 16 * kk) * kRow), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(ak);
      fence_regs<D / 2>(av);
    }
  }
}

// dk, dv of an owned M-tile (thread keys key0 + 16 warp + g8 and + 8,
// columns 8 (i / 4) + 2 t4 + (i & 1)) at the end of a segment: bf16 into
// dk, dv where the segment covers its whole (batch, head), else float32
// into the segment's workspace slot ([2][nk][D]: dk, then dv).
template <int D>
__device__ __forceinline__ void write_dkv(const Consumer<D>& cs,
                                          const float* ak, const float* av,
                                          int key0, bool whole, bf16* dk,
                                          bf16* dv, size_t at0, int c,
                                          float* slot) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 16 * cs.warp + cs.g8 + 8 * r;
    if (key >= cs.nk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * cs.t4, i = 4 * j + 2 * r;
      if (whole) {
        const size_t at = at0 + size_t(key) * c + col;
        *reinterpret_cast<uint32_t*>(dk + at) = pack(ak[i], ak[i + 1]);
        *reinterpret_cast<uint32_t*>(dv + at) = pack(av[i], av[i + 1]);
      } else {
        const size_t at = size_t(key) * D + col;
        *reinterpret_cast<float2*>(slot + at) = make_float2(ak[i], ak[i + 1]);
        *reinterpret_cast<float2*>(slot + size_t(cs.nk) * D + at) =
            make_float2(av[i], av[i + 1]);
      }
    }
  }
}

// MT: the M-tiles of K and V in shared memory (bwd_mtiles(nk)). Threads
// 0-255 are the two consumer warpgroups, 256-383 the producer warpgroup
// (thread 256 issues every TMA load). ptxas gives a wgmma kernel the
// registers of whole warpgroups, so the producer is one, and setmaxnreg
// moves its registers to the consumers. part: with split segments, a float32
// workspace of [grid][2][2][nk][D] (a CTA's first and last segment), else
// unused.
template <int D, int MT>
__global__ void __launch_bounds__(kBwdThreads, 1)
sr_attention_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tg,
                              const __grid_constant__ CUtensorMap tdq,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              float* __restrict__ part, int nk, int heads,
                              int tiles_per_bh, int total, float scale,
                              float scale_log2) {
  constexpr uint32_t kRow = D * sizeof(bf16);
  constexpr uint32_t kTileBytes = kRowTile * kRow;
  constexpr uint32_t kMBytes = kKeyTile * kRow;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const BwdLayout lay(D, MT);
  const uint32_t base = smem_u32(smem);
  const uint32_t k_s = base + uint32_t(lay.k), v_s = base + uint32_t(lay.v);
  const uint32_t q_s = base + uint32_t(lay.q), g_s = base + uint32_t(lay.g);
  const uint32_t bars = base + uint32_t(lay.bar);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kRing + st); };
  const uint32_t kv_full = bars + 16 * kRing, kv_empty = kv_full + 8;

  const int tid = int(threadIdx.x);
  if (tid == 0) {
    for (int st = 0; st < kRing; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kCons * kWgThreads / 32);
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kCons * kWgThreads / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int begin = range_begin(blockIdx.x, total, gridDim.x);
  const int end = range_begin(blockIdx.x + 1, total, gridDim.x);
  const int nmt = (nk + kKeyTile - 1) / kKeyTile;  // M-tiles holding keys

  const int wg = __shfl_sync(0xffffffffu, tid / kWgThreads, 0);
  if (wg == kCons) {
    // ---- producer: K and V per segment, q and g tiles into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kCons * kWgThreads) {
      uint32_t gen = 0;
      int i = 0;  // the CTA's tiles so far
      for (int u = begin; u < end; ++gen) {
        const int bh = u / tiles_per_bh, b = bh / heads, h = bh - b * heads;
        const int seg_end = min(end, (bh + 1) * tiles_per_bh);
        // both consumers are done with the previous segment's K and V
        if (gen) mbar_wait(kv_empty, (gen - 1) & 1);
        mbar_expect_tx(kv_full, 2 * nmt * kMBytes);
        for (int m = 0; m < nmt; ++m) {
          tma_load(k_s + m * kMBytes, &tk, kv_full, h * D, m * kKeyTile, b);
          tma_load(v_s + m * kMBytes, &tv, kv_full, h * D, m * kKeyTile, b);
        }
        for (; u < seg_end; ++u, ++i) {
          const int st = i % kRing, row0 = (u - bh * tiles_per_bh) * kRowTile;
          mbar_wait(empty(st), ((i / kRing) & 1) ^ 1);
          mbar_expect_tx(full(st), 2 * kTileBytes);
          tma_load(q_s + st * kTileBytes, &tq, full(st), h * D, row0, b);
          tma_load(g_s + st * kTileBytes, &tg, full(st), h * D, row0, b);
        }
      }
    }
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int ct = tid - wg * kWgThreads;
  const int lane = ct & 31;
  Consumer<D> cs;
  cs.k_s = k_s;
  cs.v_s = v_s;
  cs.dst_s = base + uint32_t(lay.dst);
  cs.dst = smem + lay.dst;
  cs.stats = reinterpret_cast<float4*>(smem + lay.stats) +
             ((ct >> 5) + 4 * wg) * kRowTile;
  cs.nk = nk;
  cs.warp = ct >> 5;
  cs.g8 = lane >> 2;
  cs.t4 = lane & 3;
  cs.scale = scale;
  cs.scale_log2 = scale_log2;
  float4* part_s = reinterpret_cast<float4*>(smem + lay.part);
  float* tail = reinterpret_cast<float*>(smem + lay.tail) + ct;
  unsigned char* stage_dq = smem + lay.dq + wg * kTileBytes;
  const uint32_t stage_dq_s = base + uint32_t(lay.dq) + wg * kTileBytes;
  const int c = heads * D;
  // the fifth M-tile (256 < nk <= 288) is consumer 0's, summed in `tail`
  const bool has_tail = MT > 4 && wg == 0 && nmt > 4;

  float ak0[D / 2], av0[D / 2], ak1[D / 2], av1[D / 2];
  int i = 0;  // the CTA's tiles so far
  uint32_t gen = 0;
  for (int u = begin; u < end; ++gen) {
    const int bh = u / tiles_per_bh, b = bh / heads, h = bh - b * heads;
    const int seg_begin = u, seg_end = min(end, (bh + 1) * tiles_per_bh);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) ak0[j] = av0[j] = ak1[j] = av1[j] = 0.f;
    if (has_tail)
      for (int j = 0; j < D; ++j) tail[j * kWgThreads] = 0.f;
    mbar_wait(kv_full, gen & 1);
    for (; u < seg_end; ++u, ++i) {
      const int st = i % kRing;
      mbar_wait(full(st), (i / kRing) & 1);
      const uint32_t qt = q_s + st * kTileBytes, gt = g_s + st * kTileBytes;

      // 1. row statistics over a share of the keys, merged with the other
      // consumer's: the one that ran the previous tile's dq takes ~3/8 of
      // the 32-key chunks (the two then reach the merge together)
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
            us[2] = {0.f, 0.f};
      const int nch = (nk + kChunk - 1) / kChunk;
      const int light = i == 0 ? nch / 2 : (3 * nch) / 8;
      const int cut = (i == 0 || (i & 1) == 1) ? light : nch - light;
#pragma unroll 1
      for (int ch = wg == 0 ? 0 : cut; ch < (wg == 0 ? cut : nch); ++ch)
        stats_chunk<D>(cs, qt, gt, ch * kChunk, m, l, us);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        us[r] += __shfl_xor_sync(0xffffffffu, us[r], 1);
        us[r] += __shfl_xor_sync(0xffffffffu, us[r], 2);
      }
      if (cs.t4 == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          part_s[wg * kRowTile + 16 * cs.warp + cs.g8 + 8 * r] =
              make_float4(m[r], l[r], us[r], 0.f);
      consumers_sync();
      // every warp merges the same two partials in the same order, rows
      // lane and lane + 32, into its own copy
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = lane + 32 * r;
        const float4 a = part_s[row], o = part_s[kRowTile + row];
        const float mm = fmaxf(a.x, o.x);
        const float fa = exp2_approx(a.x - mm), fo = exp2_approx(o.x - mm);
        const float inv_l = rcp_approx(a.y * fa + o.y * fo);
        cs.stats[row] =
            make_float4(mm, inv_l, (a.z * fa + o.z * fo) * inv_l, 0.f);
      }
      __syncwarp();

      // 2. the main sweep over this consumer's M-tiles
      auto none = [](int) {};
      if (wg < nmt)
        main_tile<D, false>(cs, qt, gt, wg * kKeyTile, ak0, av0, none);
      if (wg + kCons < nmt)
        main_tile<D, false>(cs, qt, gt, (wg + kCons) * kKeyTile, ak1, av1,
                            none);
      if (has_tail) {
        float t[D / 2];
        main_tile<D, true>(cs, qt, gt, 4 * kKeyTile, t, t, [&](int kind) {
#pragma unroll
          for (int j = 0; j < D / 2; ++j)
            tail[(kind * D / 2 + j) * kWgThreads] += t[j];
        });
      }
      // q and g of this stage are read (one arrival per warp); ds^T is
      // written for the async proxy
      if (lane == 0) mbar_arrive(empty(st));
      fence_proxy_async();
      consumers_sync();

      // 3. dq = ds k by consumer i % 2
      if ((i & 1) == wg) {
        float dq[D / 2];
        wgmma_fence();
#pragma unroll 1
        for (int kk = 0; kk < (nk + 15) / 16; ++kk)
          wgmma_ss<D, 1, 1>(dq, smem_desc<kRowTile>(cs.dst_s + kk * 16 * 128),
                            smem_desc<D>(k_s + kk * 16 * kRow), kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<D / 2>(dq);
        // dq to this consumer's staging tile once its previous store has
        // read it; then one TMA store (rows past Nq are not written)
        if (ct == 0) tma_store_wait<true>();
        wg_sync(wg);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t r = cs.warp * 16 + cs.g8 + 8 * half;
            *reinterpret_cast<uint32_t*>(
                stage_dq + swizzled<D>(r, 8 * j + 2 * cs.t4)) =
                pack(dq[4 * j + 2 * half], dq[4 * j + 2 * half + 1]);
          }
        fence_proxy_async();
        wg_sync(wg);
        if (ct == 0)
          tma_store(&tdq, stage_dq_s, h * D,
                    (u - bh * tiles_per_bh) * kRowTile, b);
      }
    }

    // dk and dv of this segment's keys
    const bool whole = seg_begin == bh * tiles_per_bh &&
                       seg_end == (bh + 1) * tiles_per_bh;
    const size_t pos = size_t(blockIdx.x) * 2 + (seg_begin == begin ? 0 : 1);
    float* slot = whole ? nullptr : part + pos * 2 * size_t(nk) * D;
    const size_t at0 = size_t(b) * nk * c + h * D;
    if (wg < nmt)
      write_dkv<D>(cs, ak0, av0, wg * kKeyTile, whole, dk, dv, at0, c, slot);
    if (wg + kCons < nmt)
      write_dkv<D>(cs, ak1, av1, (wg + kCons) * kKeyTile, whole, dk, dv, at0,
                   c, slot);
    if (has_tail) {
      float tk[D / 2], tv[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) {
        tk[j] = tail[j * kWgThreads];
        tv[j] = tail[(D / 2 + j) * kWgThreads];
      }
      write_dkv<D>(cs, tk, tv, 4 * kKeyTile, whole, dk, dv, at0, c, slot);
    }
    // done with this segment's K and V, dq included (one arrival per warp)
    if (seg_end < end && lane == 0) mbar_arrive(kv_empty);
    u = seg_end;
  }
  if (ct == 0) tma_store_wait<false>();
}

// dk, dv of every (batch, head) whose query tiles were split over CTAs:
// the float32 slots of its CTAs, first to last, summed and cast. Block
// (x, y) takes elements [x * Per * kThreads, (x + 1) * Per * kThreads) of
// (batch, head) y's nk * d, Per a thread (4, or 1 where there are few
// (batch, head)s); a pair held whole by one CTA was written by the wgmma
// kernel and is skipped.
template <int kSumPer>
__global__ void __launch_bounds__(kThreads)
sr_attention_bwd_split_sum_kernel(const float* __restrict__ part,
                                  bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, int nk, int heads,
                                  int d, int tiles_per_bh, int total,
                                  int grid) {
  const int bh = int(blockIdx.y);
  const int64_t first_tile = int64_t(bh) * tiles_per_bh;
  const int first = cta_of(first_tile, total, grid);
  const int last = cta_of(first_tile + tiles_per_bh - 1, total, grid);
  if (first == last) return;
  const int per = nk * d;
  const int e0 = int(blockIdx.x) * kSumPer * kThreads + threadIdx.x;
  float sk[kSumPer] = {}, sv[kSumPer] = {};
  for (int x = first; x <= last; ++x) {
    const int pos = range_begin(x, total, grid) >= first_tile ? 0 : 1;
    const float* slot = part + (size_t(x) * 2 + pos) * 2 * per;
#pragma unroll
    for (int j = 0; j < kSumPer; ++j) {
      const int e = e0 + j * kThreads;
      if (e < per) {
        sk[j] += __ldcg(slot + e);
        sv[j] += __ldcg(slot + per + e);
      }
    }
  }
  const int b = bh / heads, h = bh - b * heads;
#pragma unroll
  for (int j = 0; j < kSumPer; ++j) {
    const int e = e0 + j * kThreads;
    if (e < per) {
      const int key = e / d, col = e - key * d;
      const size_t at = (size_t(b) * nk + key) * heads * d + h * d + col;
      dk[at] = __float2bfloat16(sk[j]);
      dv[at] = __float2bfloat16(sv[j]);
    }
  }
}

// The five maps of one launch (q, k, v, g, dq).
template <int D>
bool encode_bwd_maps(CUtensorMap (&m)[5], const void* q, const void* k,
                     const void* v, const void* g, const void* dq, int b,
                     int nq, int nk, int c) {
  return encode_map<D>(&m[0], q, b, nq, c, kRowTile) &&
         encode_map<D>(&m[1], k, b, nk, c, kKeyTile) &&
         encode_map<D>(&m[2], v, b, nk, c, kKeyTile) &&
         encode_map<D>(&m[3], g, b, nq, c, kRowTile) &&
         encode_map<D>(&m[4], dq, b, nq, c, kRowTile);
}

template <int D, int MT>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* g, void* dq, void* dk, void* dv, void* part,
                     int b, int nq, int nk, int heads, int grid,
                     cudaStream_t stream, int* launched) {
  auto kernel = sr_attention_bwd_wgmma_kernel<D, MT>;
  static std::atomic<uint32_t> opted{0};
  cudaError_t err = opt_in_smem(kernel, opted);
  if (err != cudaSuccess) return int(err);
  const int tiles = (nq + kRowTile - 1) / kRowTile;
  const int64_t pairs = int64_t(b) * heads, total = pairs * tiles;
  if (total > INT_MAX || grid < 1 || grid > total)
    return int(cudaErrorInvalidValue);
  CUtensorMap maps[5];
  if (!encode_bwd_maps<D>(maps, q, k, v, g, dq, b, nq, nk, heads * D))
    return int(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(float(D));
  kernel<<<grid, kBwdThreads, BwdLayout(D, MT).total, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(part), nk, heads, tiles,
      int(total), scale, 1.4426950408889634f * scale);
  if (const int e = launched_ok(launched); e || part == nullptr) return e;
  // four elements a thread where that still gives ~2 blocks an SM
  const bool four = pairs * ((nk * D + 4 * kThreads - 1) / (4 * kThreads)) >=
                    2 * grid;
  const int per_block = (four ? 4 : 1) * kThreads;
  const dim3 sum_grid((nk * D + per_block - 1) / per_block, unsigned(pairs));
  auto sum = four ? sr_attention_bwd_split_sum_kernel<4>
                  : sr_attention_bwd_split_sum_kernel<1>;
  sum<<<sum_grid, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), nk, heads, D, tiles, int(total), grid);
  return launched_ok(launched);
}

template <int D>
int dispatch_bwd_wgmma(const void* q, const void* k, const void* v,
                       const void* g, void* dq, void* dk, void* dv,
                       void* part, int b, int nq, int nk, int heads, int grid,
                       cudaStream_t stream, int* launched) {
  if (bwd_mtiles(nk) == 4)
    return launch_bwd_wgmma<D, 4>(q, k, v, g, dq, dk, dv, part, b, nq, nk,
                                  heads, grid, stream, launched);
  return launch_bwd_wgmma<D, kMaxMTiles>(q, k, v, g, dq, dk, dv, part, b, nq,
                                         nk, heads, grid, stream, launched);
}


// ---- float32: the 3xTF32 row pass, key pass and split sum ----

constexpr int kF32Rows = 64;          // query rows of a row-pass tile
constexpr int kF32RowKeys = 32;       // keys of a row-pass K/V block
constexpr int kF32Keys = 64;          // keys of a key-pass block (M)
constexpr int kF32KeyRows = 32;       // query rows of a key-pass tile
constexpr int kF32Stages = 2;         // blocks or tiles in flight
constexpr int kF32ProducerRegs = 56;  // setmaxnreg: 128 * 56 + 256 * 224
constexpr int kF32ConsumerRegs = 224;

// Row-pass shared memory, in bytes from a 1024-aligned base (float32 panel
// tiles):
//   q, g [kCons][64][D]            each consumer's q and g tiles, as loaded
//   per stage st, six tiles of 32 * D floats:
//     0 kh [32][D]   K (TMA), then tf32 hi in place;  1 kl [32][D]  K lo
//     2 vh [32][D]   V (TMA), then hi in place;        3 vl [32][D]  V lo
//     4 kth [D][32]  K^T hi, keys in kperm order;      5 ktl        K^T lo
//   barriers: qg_full, qg_empty [kCons]; raw_full, full, empty [kF32Stages]
struct F32RowLayout {
  size_t tile, blk, qg, stage, bar, total;
  __host__ __device__ explicit F32RowLayout(int d) {
    tile = size_t(kF32Rows) * d * sizeof(float);
    blk = size_t(kF32RowKeys) * d * sizeof(float);
    qg = 0;
    stage = qg + 2 * kCons * tile;
    bar = stage + kF32Stages * 6 * blk;
    total = bar + (2 * kCons + 3 * kF32Stages) * 8 + 1024;
  }
};

// Key-pass shared memory, in bytes from a 1024-aligned base:
//   k, v [kCons][64][D]            each consumer's K and V block, as loaded
//   per stage st, eight tiles of 32 * D floats and the tile's statistics:
//     0 qh [32][D] q (TMA), hi in place; 1 ql; 2 gh g (TMA), hi; 3 gl
//     4 qth [D][32] q^T hi, rows in kperm order; 5 qtl; 6 gth; 7 gtl
//     8 stats [32] float4 (m, 1 / l, delta, 0), padded to 1024 bytes
//   barriers: kv_full [kCons]; raw_full, full, empty [kF32Stages]
struct F32KeyLayout {
  size_t tile, blk, kv, stage, stage_bytes, bar, total;
  __host__ __device__ explicit F32KeyLayout(int d) {
    tile = size_t(kF32Keys) * d * sizeof(float);
    blk = size_t(kF32KeyRows) * d * sizeof(float);
    kv = 0;
    stage = kv + 2 * kCons * tile;
    stage_bytes = 8 * blk + 1024;
    bar = stage + kF32Stages * stage_bytes;
    total = bar + (kCons + 3 * kF32Stages) * 8 + 1024;
  }
};

// The producer warpgroup's split of a 32-row block x (rows of D floats, as
// TMA wrote it) into hi in place and lo in xl, and its transpose [D][32]
// into xth, xtl with the rows in kperm order: lane l of warp w takes row
// position l (row kperm(l)) and columns w D / 4 .. + D / 4, so each thread
// rewrites the 16-byte chunks it read, the transposed writes of a warp fall
// on 32 banks, and a quarter-warp's reads on 8 rows of distinct row % 8.
template <int D>
__device__ __forceinline__ void split_block_t(unsigned char* x,
                                              unsigned char* xl,
                                              unsigned char* xth,
                                              unsigned char* xtl, int pt) {
  const int w = pt >> 5, pos = pt & 31, row = kperm(pos);
#pragma unroll
  for (int n4 = 0; n4 < D / 16; ++n4) {
    const int n = w * (D / 4) + 4 * n4;
    const uint32_t off = f32_off(row, n, 32);
    const float4 v = *reinterpret_cast<const float4*>(x + off);
    const float vs[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_tf32(vs[e], hi[e], lo[e]);
      *reinterpret_cast<uint32_t*>(xth + f32_off(n + e, pos, D)) = hi[e];
      *reinterpret_cast<uint32_t*>(xtl + f32_off(n + e, pos, D)) = lo[e];
    }
    *reinterpret_cast<uint4*>(x + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(xl + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// A 32-row block x split into hi in place and lo in xl (any layout).
template <int D>
__device__ __forceinline__ void split_block(unsigned char* x,
                                            unsigned char* xl, int pt) {
#pragma unroll
  for (int i = pt; i < kF32RowKeys * D / 4; i += kWgThreads) {
    const float4 v = *reinterpret_cast<const float4*>(x + 16 * i);
    uint4 hi, lo;
    split_tf32(v.x, hi.x, lo.x);
    split_tf32(v.y, hi.y, lo.y);
    split_tf32(v.z, hi.z, lo.z);
    split_tf32(v.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(x + 16 * i) = hi;
    *reinterpret_cast<uint4*>(xl + 16 * i) = lo;
  }
}

// p and ds of one score, in both passes by this code: p = 2^(s c - m) / l
// (0 for a key past Nk), ds = p (dp - delta) scale. s c is rounded before
// m is taken off (m is the largest s c, rounded the same way), so the
// largest score's exponential is exactly 1: with one key, p = 1 and
// ds = 0 exactly, as in the plain version.
__device__ __forceinline__ void prob_ds(float s, float dp, float4 st,
                                        bool valid, float scale_log2,
                                        float scale, float& p, float& ds) {
  p = exp2_approx(__fsub_rn(__fmul_rn(s, scale_log2), st.x)) * st.y;
  p = valid ? p : 0.f;
  ds = p * (dp - st.z) * scale;
}

// The 64 x 32 products of a consumer, A split from the float32 tiles a1, a2
// (64 rows of D, as loaded), B the hi / lo tiles (32 rows) at b1h, b1l and
// b2h, b2l: d1 = a1 b1^T, then d2 = a2 b2^T. The row pass forms s and dp
// (q, g against k, v), the key pass s^T and dp^T (k, v against q, g, with
// Swap) by this code, so the two give the same bits.
template <int D, bool Swap>
__device__ __forceinline__ void pair_products(
    const unsigned char* a1, const unsigned char* a2, uint32_t b1h,
    uint32_t b1l, uint32_t b2h, uint32_t b2l, int warp, int g8, int t4,
    float (&d1)[16], float (&d2)[16]) {
  constexpr int KS = D / 8;
  uint32_t ah[4 * KS], al[4 * KS];
  load_a_tf32<KS>(a1, 64, warp, g8, t4, ah, al);
  fence_regs<4 * KS>(ah);
  fence_regs<4 * KS>(al);
  wgmma_fence();
  wgmma_3xtf32<32, KS, Swap>(d1, ah, al, b1h, b1l, 32, 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<16>(d1);
  load_a_tf32<KS>(a2, 64, warp, g8, t4, ah, al);
  fence_regs<4 * KS>(ah);
  fence_regs<4 * KS>(al);
  wgmma_fence();
  wgmma_3xtf32<32, KS, Swap>(d2, ah, al, b2h, b2l, 32, 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<16>(d2);
}

// Threads 0-255 are the two consumer warpgroups, 256-383 the producer
// (thread 256 issues every TMA load; all 128 split the blocks). CTA x
// serves (batch, head) x / ctas_per_pair and its 64-row query tiles
// [j T / n, (j + 1) T / n) (j = x % n, n = ctas_per_pair); round r gives
// the run's tiles 2r and 2r + 1 to consumers 0 and 1 and streams the
// pair's K/V blocks twice (sweeps 1 and 2) for both. stats: [B * heads][Nq]
// float4 (m, 1 / l, delta, 0).
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
sr_attention_bwd_f32_rows_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tg,
                                 float* __restrict__ dq,
                                 float4* __restrict__ stats, int nq, int nk,
                                 int heads, int tiles_per_bh,
                                 int ctas_per_pair, float scale,
                                 float scale_log2) {
  static_assert(D == 32 || D == 64, "head width 32 or 64");
  constexpr uint32_t kTile = kF32Rows * D * sizeof(float);
  constexpr uint32_t kBlk = kF32RowKeys * D * sizeof(float);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const F32RowLayout lay(D);
  const uint32_t base = smem_u32(smem);
  // q of consumer c at qg_tile(c, 0), g at qg_tile(c, 1); stage tiles
  auto qg_tile = [&](int c, int i) {
    return uint32_t(lay.qg) + (2 * c + i) * kTile;
  };
  auto st_tile = [&](int st, int i) {
    return uint32_t(lay.stage) + (st * 6 + i) * kBlk;
  };
  const uint32_t bars = base + uint32_t(lay.bar);
  auto qg_full = [&](int c) { return bars + 8 * c; };
  auto qg_empty = [&](int c) { return bars + 8 * (kCons + c); };
  auto raw_full = [&](int st) { return bars + 8 * (2 * kCons + st); };
  auto full = [&](int st) {
    return bars + 8 * (2 * kCons + kF32Stages + st);
  };
  auto empty = [&](int st) {
    return bars + 8 * (2 * kCons + 2 * kF32Stages + st);
  };

  const int tid = int(threadIdx.x);
  if (tid == 0) {
    for (int c = 0; c < kCons; ++c) {
      mbar_init(qg_full(c), 1);
      mbar_init(qg_empty(c), kWgThreads / 32);
    }
    for (int st = 0; st < kF32Stages; ++st) {
      mbar_init(raw_full(st), 1);
      mbar_init(full(st), kWgThreads / 32);
      mbar_init(empty(st), kCons * kWgThreads / 32);
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
  const int nb = (nk + kF32RowKeys - 1) / kF32RowKeys;

  const int wg = __shfl_sync(0xffffffffu, tid / kWgThreads, 0);
  if (wg == kCons) {
    // ---- producer: q and g tiles, K/V blocks twice a round, their split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kF32ProducerRegs));
    const int pt = tid - kCons * kWgThreads;
    uint32_t kv = 0;
    for (int r = 0; r < rounds; ++r) {
      if (pt == 0)
        for (int c = 0; c < kCons && 2 * r + c < ntiles; ++c) {
          mbar_wait(qg_empty(c), (r & 1) ^ 1);
          mbar_expect_tx(qg_full(c), 2 * kTile);
          for (int p = 0; p < D / 32; ++p) {
            const int row0 = (t0 + 2 * r + c) * kF32Rows;
            tma_load(base + qg_tile(c, 0) + p * kF32Rows * 128, &tq,
                     qg_full(c), h * D + 32 * p, row0, b);
            tma_load(base + qg_tile(c, 1) + p * kF32Rows * 128, &tg,
                     qg_full(c), h * D + 32 * p, row0, b);
          }
        }
      for (int j = 0; j < 2 * nb; ++j, ++kv) {
        const int st = int(kv % kF32Stages);
        const uint32_t par = (kv / kF32Stages) & 1;
        if (pt == 0) {
          mbar_wait(empty(st), par ^ 1);
          mbar_expect_tx(raw_full(st), 2 * kBlk);
          for (int p = 0; p < D / 32; ++p) {
            const int key0 = (j % nb) * kF32RowKeys;
            tma_load(base + st_tile(st, 0) + p * kF32RowKeys * 128, &tk,
                     raw_full(st), h * D + 32 * p, key0, b);
            tma_load(base + st_tile(st, 2) + p * kF32RowKeys * 128, &tv,
                     raw_full(st), h * D + 32 * p, key0, b);
          }
        }
        mbar_wait(raw_full(st), par);
        split_block_t<D>(smem + st_tile(st, 0), smem + st_tile(st, 1),
                         smem + st_tile(st, 4), smem + st_tile(st, 5), pt);
        split_block<D>(smem + st_tile(st, 2), smem + st_tile(st, 3), pt);
        fence_proxy_async();
        __syncwarp();
        if ((pt & 31) == 0) mbar_arrive(full(st));
      }
    }
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kF32ConsumerRegs));
  const int ct = tid - wg * kWgThreads;
  const int warp = ct >> 5, lane = ct & 31, g8 = lane >> 2, t4 = lane & 3;
  const int c = heads * D;
  uint32_t kv = 0;
  for (int r = 0; r < rounds; ++r) {
    const int tile = 2 * r + wg;
    const bool mine = tile < ntiles;
    const unsigned char* qt = smem + qg_tile(wg, 0);
    const unsigned char* gt = smem + qg_tile(wg, 1);
    if (mine) mbar_wait(qg_full(wg), r & 1);
    float4 rs[2];  // this thread's rows: (m, 1 / l, delta, 0)
    {
      // sweep 1: the online row statistics
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
            u[2] = {0.f, 0.f};
      for (int j = 0; j < nb; ++j, ++kv) {
        const int st = int(kv % kF32Stages);
        mbar_wait(full(st), (kv / kF32Stages) & 1);
        if (mine) {
          float s[16], dp[16];
          pair_products<D, false>(qt, gt, base + st_tile(st, 0),
                                  base + st_tile(st, 1),
                                  base + st_tile(st, 2),
                                  base + st_tile(st, 3), warp, g8, t4, s, dp);
          if ((j + 1) * kF32RowKeys > nk) {
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const int key = j * kF32RowKeys + 8 * (i >> 2) + 2 * t4 + (i & 1);
              s[i] = key < nk ? s[i] : -INFINITY;
            }
          }
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int i = 0; i < 16; ++i)
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
            mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
            // the block holds a valid key, so the new max is finite
            const float mn = fmaxf(m[rr], __fmul_rn(mx[rr], scale_log2));
            const float f = exp2_approx(m[rr] - mn);
            l[rr] *= f;
            u[rr] *= f;
            m[rr] = mn;
          }
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int rr = (i >> 1) & 1;
            const float e =
                exp2_approx(__fsub_rn(__fmul_rn(s[i], scale_log2), m[rr]));
            l[rr] += e;
            u[rr] += e * dp[i];
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
        u[rr] += __shfl_xor_sync(0xffffffffu, u[rr], 1);
        u[rr] += __shfl_xor_sync(0xffffffffu, u[rr], 2);
        const float inv_l = 1.f / l[rr];
        rs[rr] = make_float4(m[rr], inv_l, u[rr] * inv_l, 0.f);
      }
    }
    const int row0 = (t0 + tile) * kF32Rows + 16 * warp + g8;
    if (mine && t4 == 0)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        if (row0 + 8 * rr < nq)
          stats[size_t(pair) * nq + row0 + 8 * rr] = rs[rr];
    // sweep 2: p, ds and dq += ds k
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < nb; ++j, ++kv) {
      const int st = int(kv % kF32Stages);
      mbar_wait(full(st), (kv / kF32Stages) & 1);
      if (mine) {
        float s[16], dp[16];
        pair_products<D, false>(qt, gt, base + st_tile(st, 0),
                                base + st_tile(st, 1), base + st_tile(st, 2),
                                base + st_tile(st, 3), warp, g8, t4, s, dp);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int key = j * kF32RowKeys + 8 * (i >> 2) + 2 * t4 + (i & 1);
          float p;
          prob_ds(s[i], dp[i], rs[(i >> 1) & 1], key < nk, scale_log2, scale,
                  p, dp[i]);
        }
        uint32_t dh[16], dl[16];
        acc_to_a_tf32<32>(dp, dh, dl);
        fence_regs<16>(dh);
        fence_regs<16>(dl);
        fence_regs<D / 2>(acc);
        wgmma_fence();
        wgmma_3xtf32<D, kF32RowKeys / 8>(acc, dh, dl, base + st_tile(st, 4),
                                         base + st_tile(st, 5), D, 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<D / 2>(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
    if (mine) {
      float* out = dq + size_t(b) * nq * c + h * D;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + 8 * rr;
        if (row < nq)
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj)
            *reinterpret_cast<float2*>(out + size_t(row) * c + 8 * jj +
                                       2 * t4) =
                make_float2(acc[4 * jj + 2 * rr], acc[4 * jj + 2 * rr + 1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(qg_empty(wg));
    }
  }
}

// CTA x serves (batch, head) x / (key_groups * splits), key group
// (x / splits) % key_groups (key blocks 2 grp and 2 grp + 1 of 64 keys, one
// per consumer) and split x % splits: the 32-row query tiles
// [s T / S, (s + 1) T / S) of the pair (T = ceil(Nq / 32), S = splits).
// With splits > 1 it writes its float32 dk and dv to part[s] (dk, then dv,
// each B * Nk * C), else to dk and dv.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
sr_attention_bwd_f32_keys_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tg,
                                 const float4* __restrict__ stats,
                                 float* __restrict__ dk,
                                 float* __restrict__ dv,
                                 float* __restrict__ part, int b_total,
                                 int nq, int nk, int heads, int key_groups,
                                 int splits, float scale, float scale_log2) {
  static_assert(D == 32 || D == 64, "head width 32 or 64");
  constexpr uint32_t kTile = kF32Keys * D * sizeof(float);
  constexpr uint32_t kBlk = kF32KeyRows * D * sizeof(float);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const F32KeyLayout lay(D);
  const uint32_t base = smem_u32(smem);
  // K of consumer c at kv_tile(c, 0), V at kv_tile(c, 1); stage tiles
  auto kv_tile = [&](int c, int i) {
    return uint32_t(lay.kv) + (2 * c + i) * kTile;
  };
  auto st_tile = [&](int st, int i) {
    return uint32_t(lay.stage + st * lay.stage_bytes) + i * kBlk;
  };
  const uint32_t bars = base + uint32_t(lay.bar);
  auto kv_full = [&](int c) { return bars + 8 * c; };
  auto raw_full = [&](int st) { return bars + 8 * (kCons + st); };
  auto full = [&](int st) { return bars + 8 * (kCons + kF32Stages + st); };
  auto empty = [&](int st) {
    return bars + 8 * (kCons + 2 * kF32Stages + st);
  };

  const int tid = int(threadIdx.x);
  if (tid == 0) {
    for (int c = 0; c < kCons; ++c) mbar_init(kv_full(c), 1);
    for (int st = 0; st < kF32Stages; ++st) {
      mbar_init(raw_full(st), 1);
      mbar_init(full(st), kWgThreads / 32);
      mbar_init(empty(st), kCons * kWgThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int x = int(blockIdx.x);
  const int split = x % splits, grp = (x / splits) % key_groups;
  const int pair = x / (splits * key_groups);
  const int b = pair / heads, h = pair - b * heads;
  const int q_tiles = (nq + kF32KeyRows - 1) / kF32KeyRows;
  const int s0 = int(int64_t(split) * q_tiles / splits);
  const int nt = int(int64_t(split + 1) * q_tiles / splits) - s0;
  const int nkb = (nk + kF32Keys - 1) / kF32Keys;

  const int wg = __shfl_sync(0xffffffffu, tid / kWgThreads, 0);
  if (wg == kCons) {
    // ---- producer: both consumers' K and V, then q, g and statistics
    // tiles, split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kF32ProducerRegs));
    const int pt = tid - kCons * kWgThreads;
    if (pt == 0)
      for (int c = 0; c < kCons && 2 * grp + c < nkb; ++c) {
        mbar_expect_tx(kv_full(c), 2 * kTile);
        for (int p = 0; p < D / 32; ++p) {
          const int key0 = (2 * grp + c) * kF32Keys;
          tma_load(base + kv_tile(c, 0) + p * kF32Keys * 128, &tk,
                   kv_full(c), h * D + 32 * p, key0, b);
          tma_load(base + kv_tile(c, 1) + p * kF32Keys * 128, &tv,
                   kv_full(c), h * D + 32 * p, key0, b);
        }
      }
    for (int i = 0; i < nt; ++i) {
      const int st = i % kF32Stages;
      const uint32_t par = (i / kF32Stages) & 1;
      const int row0 = (s0 + i) * kF32KeyRows;
      if (pt == 0) {
        mbar_wait(empty(st), par ^ 1);
        mbar_expect_tx(raw_full(st), 2 * kBlk);
        for (int p = 0; p < D / 32; ++p) {
          tma_load(base + st_tile(st, 0) + p * kF32KeyRows * 128, &tq,
                   raw_full(st), h * D + 32 * p, row0, b);
          tma_load(base + st_tile(st, 2) + p * kF32KeyRows * 128, &tg,
                   raw_full(st), h * D + 32 * p, row0, b);
        }
      }
      mbar_wait(raw_full(st), par);
      if (pt < kF32KeyRows) {
        const int row = row0 + pt;
        reinterpret_cast<float4*>(smem + st_tile(st, 8))[pt] =
            row < nq ? stats[size_t(pair) * nq + row]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      split_block_t<D>(smem + st_tile(st, 0), smem + st_tile(st, 1),
                       smem + st_tile(st, 4), smem + st_tile(st, 5), pt);
      split_block_t<D>(smem + st_tile(st, 2), smem + st_tile(st, 3),
                       smem + st_tile(st, 6), smem + st_tile(st, 7), pt);
      fence_proxy_async();
      __syncwarp();
      if ((pt & 31) == 0) mbar_arrive(full(st));
    }
    return;
  }

  // ---- consumers: dk, dv of key block 2 grp + wg over the range
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kF32ConsumerRegs));
  const int ct = tid - wg * kWgThreads;
  const int warp = ct >> 5, lane = ct & 31, g8 = lane >> 2, t4 = lane & 3;
  const int kb = 2 * grp + wg;
  const bool active = kb < nkb;
  const unsigned char* kt = smem + kv_tile(wg, 0);
  const unsigned char* vt = smem + kv_tile(wg, 1);
  if (active) mbar_wait(kv_full(wg), 0);
  bool key_ok[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    key_ok[rr] = kb * kF32Keys + 16 * warp + g8 + 8 * rr < nk;
  float ak[D / 2], av[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) ak[i] = av[i] = 0.f;
  for (int i = 0; i < nt; ++i) {
    const int st = i % kF32Stages;
    mbar_wait(full(st), (i / kF32Stages) & 1);
    if (active) {
      float s[16], dp[16];
      pair_products<D, true>(kt, vt, base + st_tile(st, 0),
                             base + st_tile(st, 1), base + st_tile(st, 2),
                             base + st_tile(st, 3), warp, g8, t4, s, dp);
      const float4* sts =
          reinterpret_cast<const float4*>(smem + st_tile(st, 8));
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float4 rsq = sts[8 * (e >> 2) + 2 * t4 + (e & 1)];
        prob_ds(s[e], dp[e], rsq, key_ok[(e >> 1) & 1], scale_log2, scale,
                s[e], dp[e]);
      }
      uint32_t ph[16], pl[16], dh[16], dl[16];
      acc_to_a_tf32<32>(s, ph, pl);
      acc_to_a_tf32<32>(dp, dh, dl);
      fence_regs<16>(ph);
      fence_regs<16>(pl);
      fence_regs<16>(dh);
      fence_regs<16>(dl);
      fence_regs<D / 2>(av);
      fence_regs<D / 2>(ak);
      wgmma_fence();
      wgmma_3xtf32<D, kF32KeyRows / 8>(av, ph, pl, base + st_tile(st, 6),
                                       base + st_tile(st, 7), D, 1);
      wgmma_3xtf32<D, kF32KeyRows / 8>(ak, dh, dl, base + st_tile(st, 4),
                                       base + st_tile(st, 5), D, 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(av);
      fence_regs<D / 2>(ak);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }
  if (!active) return;
  const size_t n_out = size_t(b_total) * nk * heads * D;
  float* ok = part == nullptr ? dk : part + 2 * n_out * split;
  float* ov = part == nullptr ? dv : part + 2 * n_out * split + n_out;
  const size_t at0 = size_t(b) * nk * heads * D + h * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = kb * kF32Keys + 16 * warp + g8 + 8 * rr;
    if (key >= nk) continue;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const size_t at = at0 + size_t(key) * heads * D + 8 * jj + 2 * t4;
      const int e = 4 * jj + 2 * rr;
      *reinterpret_cast<float2*>(ok + at) = make_float2(ak[e], ak[e + 1]);
      *reinterpret_cast<float2*>(ov + at) = make_float2(av[e], av[e + 1]);
    }
  }
}

// dk, dv = the splits' float32 slots summed in split order (n4 float4s
// each).
__global__ void __launch_bounds__(kThreads)
sr_attention_bwd_f32_sum_kernel(const float4* __restrict__ part,
                                float4* __restrict__ dk,
                                float4* __restrict__ dv, size_t n4,
                                int splits) {
  for (size_t i = size_t(blockIdx.x) * kThreads + threadIdx.x; i < n4;
       i += size_t(gridDim.x) * kThreads) {
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int sp = 0; sp < splits; ++sp) {
      const float4 a = __ldcg(part + 2 * n4 * sp + i);
      const float4 o = __ldcg(part + 2 * n4 * sp + n4 + i);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += o.x; sv.y += o.y; sv.z += o.z; sv.w += o.w;
    }
    dk[i] = sk;
    dv[i] = sv;
  }
}

template <int D>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* g, void* dq, void* dk, void* dv, void* stats,
                   void* part, int b, int nq, int nk, int heads,
                   int row_ctas_per_pair, int key_groups, int splits,
                   cudaStream_t stream, int* launched) {
  auto rows = sr_attention_bwd_f32_rows_kernel<D>;
  auto keys = sr_attention_bwd_f32_keys_kernel<D>;
  static std::atomic<uint32_t> opted_rows{0}, opted_keys{0};
  cudaError_t err = opt_in_smem(rows, opted_rows);
  if (err == cudaSuccess) err = opt_in_smem(keys, opted_keys);
  if (err != cudaSuccess) return int(err);
  const int c = heads * D;
  const int64_t pairs = int64_t(b) * heads;
  const int tiles = (nq + kF32Rows - 1) / kF32Rows;
  const int q_tiles = (nq + kF32KeyRows - 1) / kF32KeyRows;
  const int nkb = (nk + kF32Keys - 1) / kF32Keys;
  const int64_t row_grid = pairs * row_ctas_per_pair;
  const int64_t key_grid = pairs * key_groups * splits;
  if (row_ctas_per_pair < 1 || row_ctas_per_pair > tiles ||
      key_groups != (nkb + 1) / 2 || splits < 1 || splits > q_tiles ||
      row_grid > INT_MAX || key_grid > INT_MAX ||
      (splits > 1) != (part != nullptr))
    return int(cudaErrorInvalidValue);
  CUtensorMap m[8];
  if (!encode_map_f32(&m[0], q, b, nq, c, kF32Rows) ||
      !encode_map_f32(&m[1], k, b, nk, c, kF32RowKeys) ||
      !encode_map_f32(&m[2], v, b, nk, c, kF32RowKeys) ||
      !encode_map_f32(&m[3], g, b, nq, c, kF32Rows) ||
      !encode_map_f32(&m[4], q, b, nq, c, kF32KeyRows) ||
      !encode_map_f32(&m[5], k, b, nk, c, kF32Keys) ||
      !encode_map_f32(&m[6], v, b, nk, c, kF32Keys) ||
      !encode_map_f32(&m[7], g, b, nq, c, kF32KeyRows))
    return int(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(float(D));
  rows<<<int(row_grid), kBwdThreads, F32RowLayout(D).total, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<float*>(dq),
      static_cast<float4*>(stats), nq, nk, heads, tiles, row_ctas_per_pair,
      scale, 1.4426950408889634f * scale);
  if (const int e = launched_ok(launched)) return e;
  keys<<<int(key_grid), kBwdThreads, F32KeyLayout(D).total, stream>>>(
      m[4], m[5], m[6], m[7], static_cast<const float4*>(stats),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(part), b, nq, nk, heads, key_groups, splits, scale,
      1.4426950408889634f * scale);
  if (const int e = launched_ok(launched); e || splits == 1) return e;
  const size_t n4 = size_t(b) * nk * c / 4;
  const size_t need = (n4 + kThreads - 1) / kThreads;
  sr_attention_bwd_f32_sum_kernel<<<int(need < 1056 ? need : 1056),
                                      kThreads, 0, stream>>>(
      static_cast<const float4*>(part), static_cast<float4*>(dk),
      static_cast<float4*>(dv), n4, splits);
  return launched_ok(launched);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (elem: 4 float32, the larger
// of the row and key passes, any Nk; 2 bf16, the wgmma kernel).
size_t sr_attention_bwd_smem_bytes(int nk, int d, int elem) {
  if (elem == 2) return BwdLayout(d, bwd_mtiles(nk)).total;
  const size_t r = F32RowLayout(d).total, k = F32KeyLayout(d).total;
  return r > k ? r : k;
}

// The most keys the kernels for `elem`-byte inputs take; 0: no limit (the
// float32 kernels stream K and V).
int sr_attention_bwd_max_nk(int elem) { return elem == 4 ? 0 : kMaxNkBf16; }

// float32 (the 3xTF32 row pass, key pass and split sum) over the grids of
// ops/sr_attention.py's `bwd_f32_plan`: row_ctas_per_pair CTAs per
// (batch, head) in the row pass; key_groups * splits in the key pass
// (key_groups = ceil(ceil(nk / 64) / 2)). q, k, v, g, dq, dk, dv are
// 16-byte aligned; stats is a float32 workspace of 4 * b * heads * nq
// values; part, with splits > 1 (else null), a float32 workspace of
// splits * 2 * b * nk * c values, and the split sum runs. *launched is set
// to the number of kernels launched without error (2, or 3 with the split
// sum). Returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for
// a shape or plan the kernels do not take.
int sr_attention_bwd(const void* q, const void* k, const void* v,
                     const void* g, void* dq, void* dk, void* dv, void* stats,
                     void* part, int b, int nq, int nk, int c, int heads,
                     int row_ctas_per_pair, int key_groups, int splits,
                     int* launched, void* stream) {
  const int d = c / heads;
  *launched = 0;
  if (b < 1 || nq < 1 || nk < 1 || d * heads != c)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32)
    return launch_bwd_f32<32>(q, k, v, g, dq, dk, dv, stats, part, b, nq, nk,
                              heads, row_ctas_per_pair, key_groups, splits, s,
                              launched);
  if (d == 64)
    return launch_bwd_f32<64>(q, k, v, g, dq, dk, dv, stats, part, b, nq, nk,
                              heads, row_ctas_per_pair, key_groups, splits, s,
                              launched);
  return int(cudaErrorInvalidValue);
}

// bfloat16 (the wgmma kernel) over `grid` CTAs, as ops/sr_attention.py's
// `bwd_launch_plan` sets them. q, k, v, g, dq, dk, dv are 16-byte aligned.
// part is the plan's float32 workspace of grid * 2 * 2 * nk * d values
// where the grid cuts a (batch, head)'s query tiles over CTAs, and null
// where it cuts none: a non-null part makes this launch the split sum after
// the kernel (the plan is the one owner of that choice; the kernel reads
// its slots only where its range cuts a pair). *launched is set to the
// number of kernels launched without error. Returns a cudaError_t (0 on
// success); 1 (cudaErrorInvalidValue) for a shape or grid the kernels do
// not take.
int sr_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                           const void* g, void* dq, void* dk, void* dv,
                           void* part, int b, int nq, int nk, int c,
                           int heads, int grid, int* launched,
                           void* stream) {
  const int d = c / heads;
  *launched = 0;
  if (b < 1 || nq < 1 || nk < 1 || nk > kMaxNkBf16 || d * heads != c)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32)
    return dispatch_bwd_wgmma<32>(q, k, v, g, dq, dk, dv, part, b, nq, nk,
                                  heads, grid, s, launched);
  if (d == 64)
    return dispatch_bwd_wgmma<64>(q, k, v, g, dq, dk, dv, part, b, nq, nk,
                                  heads, grid, s, launched);
  return int(cudaErrorInvalidValue);
}

const char* sr_attention_bwd_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
