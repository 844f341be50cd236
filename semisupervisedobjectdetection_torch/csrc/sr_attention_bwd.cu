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
// the bytes at stage 4 (8.8 us). Two designs, by dtype:
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
// float32: the scalar kernels, kept because TF32 tensor cores would not
// hold the float32 results to their tolerance. Two passes, launched in
// order on one stream, neither of which adds into another block's sums:
// a row pass (one block per (batch*head, block of query rows), K^T and V^T
// staged, lane l of a warp owning key columns l, l+32, ...) writes each
// row's max, sum l and delta = rowsum(dp * p) to a float32 workspace and
// writes dq; a key pass (32 keys a block, query rows in tiles of 32, split
// over `splits` blocks when the key blocks alone would not fill the card)
// recomputes s and dp with the same in-order FMA chains and rebuilds p and
// ds bit for bit, and a third kernel sums the splits' float32 partials in
// split order. Their products are scalar float32 FMAs, so the FMA pipes
// and shared-memory reads bound them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sr_attention_wgmma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;      // query rows a warp holds at once (row pass)
constexpr int kMaxSlots = 9;  // key columns per lane: Nk <= 288
constexpr int kKeys = 32;     // keys per block (key pass)
constexpr int kTile = 32;     // query rows per tile (key pass)

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// p of one score: both passes call this, with the explicitly rounded
// operations (no FMA contraction), so they get the same bits.
__device__ __forceinline__ float prob(float s, float scale, float m, float l) {
  return __fdiv_rn(expf(__fsub_rn(__fmul_rn(s, scale), m)), l);
}

__device__ __forceinline__ float dscore(float p, float dp, float delta,
                                        float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// Row-pass shared memory, in bytes from the start of the dynamic buffer:
//   kt [d][ldk] T   K transposed
//   vt [d][ldk] T   V transposed
//   qs [kWarps][kRows][d]   float   each warp's query rows
//   gs [kWarps][kRows][d]   float   each warp's output-gradient rows
//   ds [kWarps][kRows][nkp] float   each warp's rounded ds rows
// A row of kt holds an odd number of 32-bit words, so the lanes of the dq
// loop, each reading its own column of K^T, fall in different banks.
struct RowLayout {
  int nkp, ldk;
  size_t kt, vt, qs, gs, ds, total;
  __host__ __device__ RowLayout(int nk, int d, int elem) {
    nkp = (nk + 31) / 32 * 32;
    ldk = elem == 4 ? nkp + 1 : nkp + 2;
    kt = 0;
    vt = align16(kt + size_t(d) * ldk * elem);
    qs = align16(vt + size_t(d) * ldk * elem);
    gs = qs + size_t(kWarps) * kRows * d * sizeof(float);
    ds = gs + size_t(kWarps) * kRows * d * sizeof(float);
    total = ds + size_t(kWarps) * kRows * nkp * sizeof(float);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sr_attention_bwd_rows_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ g, T* __restrict__ dq,
                             float* __restrict__ stats, int nq, int nk,
                             int heads, int block_q, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RowLayout lay(nk, D, sizeof(T));
  const int nkp = lay.nkp, ldk = lay.ldk, nc = nkp / 32;
  T* kt = reinterpret_cast<T*>(smem + lay.kt);
  T* vt = reinterpret_cast<T*>(smem + lay.vt);
  const int c = heads * D;

  const int bh = int(blockIdx.y), b = bh / heads, h = bh % heads;
  const int tid = int(threadIdx.x), warp = tid >> 5, lane = tid & 31;
  float* qw = reinterpret_cast<float*>(smem + lay.qs) + warp * kRows * D;
  float* gw = reinterpret_cast<float*>(smem + lay.gs) + warp * kRows * D;
  float* dw = reinterpret_cast<float*>(smem + lay.ds) + warp * kRows * nkp;

  // Stage this (b, h)'s K^T and V^T in 16-byte loads; keys past nk are zero.
  constexpr int kVec = 16 / sizeof(T);
  const T* kb = k + size_t(b) * nk * c + h * D;
  const T* vb = v + size_t(b) * nk * c + h * D;
#pragma unroll 2
  for (int i = tid; i < nkp * (D / kVec); i += kThreads) {
    const int j = i / (D / kVec), e = (i % (D / kVec)) * kVec;
    uint4 kraw = make_uint4(0u, 0u, 0u, 0u), vraw = kraw;
    if (j < nk) {
      kraw = *reinterpret_cast<const uint4*>(kb + size_t(j) * c + e);
      vraw = *reinterpret_cast<const uint4*>(vb + size_t(j) * c + e);
    }
    const T* kv = reinterpret_cast<const T*>(&kraw);
    const T* vv = reinterpret_cast<const T*>(&vraw);
#pragma unroll
    for (int x = 0; x < kVec; ++x) {
      kt[(e + x) * ldk + j] = kv[x];
      vt[(e + x) * ldk + j] = vv[x];
    }
  }
  __syncthreads();

  const T* qb = q + size_t(b) * nq * c + h * D;
  const T* gb = g + size_t(b) * nq * c + h * D;
  T* dqb = dq + size_t(b) * nq * c + h * D;
  float* sb = stats + size_t(bh) * nq * 3;
  const int q0 = int(blockIdx.x) * block_q;
  const int q_end = min(q0 + block_q, nq);
  constexpr int kCols = D / 32;  // dq columns per lane

  for (int r0 = q0 + warp * kRows; r0 < q_end; r0 += kWarps * kRows) {
    // This warp's q and g rows as float32; rows past the end are zero.
    for (int i = lane; i < kRows * D; i += 32) {
      const int row = r0 + i / D;
      const bool ok = row < q_end;
      qw[i] = ok ? to_f(qb[size_t(row) * c + i % D]) : 0.f;
      gw[i] = ok ? to_f(gb[size_t(row) * c + i % D]) : 0.f;
    }
    __syncwarp();

    // s[r][t] = q_r . k_(32t + lane), dp[r][t] = g_r . v_(32t + lane), each
    // one FMA chain over the head dimension in order (the key pass repeats
    // exactly these chains).
    float s[kRows][kMaxSlots], dp[kRows][kMaxSlots];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < kMaxSlots; ++t) s[r][t] = dp[r][t] = 0.f;
#pragma unroll 2
    for (int e = 0; e < D; e += 4) {
      float4 qa[kRows], ga[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        qa[r] = *reinterpret_cast<const float4*>(qw + r * D + e);
        ga[r] = *reinterpret_cast<const float4*>(gw + r * D + e);
      }
#pragma unroll
      for (int t = 0; t < kMaxSlots; ++t) {
        if (t < nc) {
          const T* kp = kt + e * ldk + t * 32 + lane;
          const T* vp = vt + e * ldk + t * 32 + lane;
          const float k0 = to_f(kp[0]), k1 = to_f(kp[ldk]);
          const float k2 = to_f(kp[2 * ldk]), k3 = to_f(kp[3 * ldk]);
          const float v0 = to_f(vp[0]), v1 = to_f(vp[ldk]);
          const float v2 = to_f(vp[2 * ldk]), v3 = to_f(vp[3 * ldk]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float a = s[r][t];
            a = fmaf(qa[r].x, k0, a);
            a = fmaf(qa[r].y, k1, a);
            a = fmaf(qa[r].z, k2, a);
            a = fmaf(qa[r].w, k3, a);
            s[r][t] = a;
            float o = dp[r][t];
            o = fmaf(ga[r].x, v0, o);
            o = fmaf(ga[r].y, v1, o);
            o = fmaf(ga[r].z, v2, o);
            o = fmaf(ga[r].w, v3, o);
            dp[r][t] = o;
          }
        }
      }
    }

    // Per row: max, l = sum exp, p, delta = rowsum(dp * p), then ds rounded
    // to the input type into shared memory (zero in the padded tail). l and
    // delta are taken from lane 0 so every lane, and the key pass, use one
    // value.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < kMaxSlots; ++t) {
        const bool ok = t < nc && t * 32 + lane < nk;
        s[r][t] = ok ? __fmul_rn(s[r][t], scale) : -INFINITY;
        m = fmaxf(m, s[r][t]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float l = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxSlots; ++t) {
        const bool ok = t < nc && t * 32 + lane < nk;
        s[r][t] = ok ? expf(__fsub_rn(s[r][t], m)) : 0.f;
        l = __fadd_rn(l, s[r][t]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, o));
      l = __shfl_sync(0xffffffffu, l, 0);
      float delta = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxSlots; ++t) {
        const bool ok = t < nc && t * 32 + lane < nk;
        s[r][t] = __fdiv_rn(s[r][t], l);  // p (zero where masked)
        if (ok) delta = __fadd_rn(delta, __fmul_rn(dp[r][t], s[r][t]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        delta = __fadd_rn(delta, __shfl_xor_sync(0xffffffffu, delta, o));
      delta = __shfl_sync(0xffffffffu, delta, 0);
#pragma unroll
      for (int t = 0; t < kMaxSlots; ++t) {
        if (t < nc) {
          const bool ok = t * 32 + lane < nk;
          const float ds = ok ? dscore(s[r][t], dp[r][t], delta, scale) : 0.f;
          dw[r * nkp + t * 32 + lane] = to_f(from_f<T>(ds));
        }
      }
      const int row = r0 + r;
      if (lane == 0 && row < q_end) {
        sb[size_t(row) * 3 + 0] = m;
        sb[size_t(row) * 3 + 1] = l;
        sb[size_t(row) * 3 + 2] = delta;
      }
    }
    __syncwarp();

    // dq[r][u] = sum_j ds[r][j] * k[j][32u + lane]
    float acc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int u = 0; u < kCols; ++u) acc[r][u] = 0.f;
#pragma unroll 2
    for (int j = 0; j < nkp; j += 4) {
      float4 da[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        da[r] = *reinterpret_cast<const float4*>(dw + r * nkp + j);
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const T* kp = kt + (u * 32 + lane) * ldk + j;
        const float k0 = to_f(kp[0]), k1 = to_f(kp[1]);
        const float k2 = to_f(kp[2]), k3 = to_f(kp[3]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float a = acc[r][u];
          a = fmaf(da[r].x, k0, a);
          a = fmaf(da[r].y, k1, a);
          a = fmaf(da[r].z, k2, a);
          a = fmaf(da[r].w, k3, a);
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
          dqb[size_t(row) * c + u * 32 + lane] = from_f<T>(acc[r][u]);
      }
    }
    __syncwarp();  // qw/gw/dw are rewritten by the next row group
  }
}

// part: nullptr with one split, else [splits][2][B*nk*c] float32 partials
// of dk and dv.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sr_attention_bwd_keys_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ g,
                             const float* __restrict__ stats,
                             T* __restrict__ dk, T* __restrict__ dv,
                             float* __restrict__ part, int nq, int nk,
                             int heads, int rows_per_split, float scale) {
  // +1 columns: the lanes of a warp read one row each (ks, vs) or write one
  // column each (pt, dst) without bank conflicts.
  __shared__ float ks[kKeys][D + 1];
  __shared__ float vs[kKeys][D + 1];
  __shared__ float qt[kTile][D + 1];
  __shared__ float gt[kTile][D + 1];
  __shared__ float pt[kTile][kKeys + 1];
  __shared__ float dst[kTile][kKeys + 1];
  __shared__ float st[kTile][3];

  const int c = heads * D;
  const int bh = int(blockIdx.y), b = bh / heads, h = bh % heads;
  const int j0 = int(blockIdx.x) * kKeys;
  const int tid = int(threadIdx.x), warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < kKeys * D; i += kThreads) {
    const int j = i / D, e = i % D;
    const bool ok = j0 + j < nk;
    const size_t at = (size_t(b) * nk + j0 + j) * c + h * D + e;
    ks[j][e] = ok ? to_f(k[at]) : 0.f;
    vs[j][e] = ok ? to_f(v[at]) : 0.f;
  }

  // Thread tid owns column tid % D of keys grp, grp + kGroups, ... of dk, dv.
  constexpr int kGroups = kThreads / D;
  constexpr int kPer = kKeys / kGroups;
  const int col = tid % D, grp = tid / D;
  float acc_k[kPer], acc_v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc_k[i] = acc_v[i] = 0.f;

  const T* qb = q + size_t(b) * nq * c + h * D;
  const T* gb = g + size_t(b) * nq * c + h * D;
  const float* sb = stats + size_t(bh) * nq * 3;
  const bool key_ok = j0 + lane < nk;
  const int r_begin = int(blockIdx.z) * rows_per_split;
  const int r_end = min(nq, r_begin + rows_per_split);

  for (int r0 = r_begin; r0 < r_end; r0 += kTile) {
    __syncthreads();  // the previous tile is consumed; ks/vs are staged
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int r = i / D, e = i % D, row = r0 + r;
      const bool ok = row < r_end;
      qt[r][e] = ok ? to_f(qb[size_t(row) * c + e]) : 0.f;
      gt[r][e] = ok ? to_f(gb[size_t(row) * c + e]) : 0.f;
    }
    for (int i = tid; i < kTile * 3; i += kThreads) {
      const int row = r0 + i / 3;
      st[i / 3][i % 3] = row < r_end ? sb[size_t(row) * 3 + i % 3] : 0.f;
    }
    __syncthreads();

    // p and rounded ds of (row r, key lane), for rows warp, warp + 8, ...
    for (int r = warp; r < kTile; r += kWarps) {
      float s = 0.f, o = 0.f;
#pragma unroll 16
      for (int e = 0; e < D; ++e) {
        s = fmaf(qt[r][e], ks[lane][e], s);
        o = fmaf(gt[r][e], vs[lane][e], o);
      }
      float p = 0.f, ds = 0.f;
      if (key_ok && r0 + r < r_end) {
        p = prob(s, scale, st[r][0], st[r][1]);
        ds = to_f(from_f<T>(dscore(p, o, st[r][2], scale)));
      }
      pt[r][lane] = p;
      dst[r][lane] = ds;
    }
    __syncthreads();

    // dv[j][col] += sum_r p[r][j] g[r][col]; dk[j][col] += sum_r ds[r][j]
    // q[r][col], over the tile's rows in order.
    for (int r = 0; r < kTile; ++r) {
      const float gv = gt[r][col], qv = qt[r][col];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = grp + i * kGroups;
        acc_v[i] = fmaf(pt[r][j], gv, acc_v[i]);
        acc_k[i] = fmaf(dst[r][j], qv, acc_k[i]);
      }
    }
  }

  const size_t n_out = size_t(gridDim.y / heads) * nk * c;
  float* pk = part == nullptr ? nullptr : part + 2 * n_out * blockIdx.z;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = grp + i * kGroups;
    if (j0 + j < nk) {
      const size_t at = (size_t(b) * nk + j0 + j) * c + h * D + col;
      if (pk == nullptr) {
        dk[at] = from_f<T>(acc_k[i]);
        dv[at] = from_f<T>(acc_v[i]);
      } else {
        pk[at] = acc_k[i];
        pk[n_out + at] = acc_v[i];
      }
    }
  }
}

// dk, dv = the float32 partials of the splits summed in split order, cast.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sr_attention_bwd_sum_kernel(const float* __restrict__ part,
                            T* __restrict__ dk, T* __restrict__ dv,
                            size_t n, int splits) {
  for (size_t i = size_t(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += size_t(gridDim.x) * kThreads) {
    float sk = 0.f, sv = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      sk += part[2 * n * sp + i];
      sv += part[2 * n * sp + n + i];
    }
    dk[i] = from_f<T>(sk);
    dv[i] = from_f<T>(sv);
  }
}

// The error of the launch just made; one more in *launched if none.
int launched_ok(int* launched) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return int(err);
}

// dk, dv from the float32 partials of `splits` splits (n values each).
template <typename T>
int launch_sum(const void* part, void* dk, void* dv, size_t n, int splits,
               cudaStream_t stream, int* launched) {
  const size_t need = (n + kThreads - 1) / kThreads;
  const int blocks = int(need < 1056 ? need : 1056);  // 8 per SM
  sr_attention_bwd_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(dk),
      static_cast<T*>(dv), n, splits);
  return launched_ok(launched);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* g,
           void* dq, void* dk, void* dv, void* stats, void* part, int b,
           int nq, int nk, int heads, int block_q, int splits,
           cudaStream_t stream, int* launched) {
  const float scale = 1.0f / sqrtf(float(D));
  const RowLayout lay(nk, D, sizeof(T));
  auto rows = sr_attention_bwd_rows_kernel<T, D>;
  static std::atomic<uint32_t> opted{0};
  cudaError_t err = sr_wgmma::opt_in_smem(rows, opted);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_rows((nq + block_q - 1) / block_q, b * heads);
  rows<<<grid_rows, kThreads, lay.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), static_cast<T*>(dq),
      static_cast<float*>(stats), nq, nk, heads, block_q, scale);
  if (const int e = launched_ok(launched)) return e;
  // splits of whole row tiles, the last one possibly shorter
  const int rows_per_split =
      ((nq + splits - 1) / splits + kTile - 1) / kTile * kTile;
  const dim3 grid_keys((nk + kKeys - 1) / kKeys, b * heads, splits);
  sr_attention_bwd_keys_kernel<T, D><<<grid_keys, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(stats), static_cast<T*>(dk),
      static_cast<T*>(dv), splits > 1 ? static_cast<float*>(part) : nullptr,
      nq, nk, heads, rows_per_split, scale);
  if (const int e = launched_ok(launched); e || splits == 1) return e;
  return launch_sum<T>(part, dk, dv, size_t(b) * nk * heads * D, splits,
                       stream, launched);
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
static_assert(kMaxMTiles * kKeyTile >= kMaxSlots * 32, "one Nk limit");

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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (elem: 4 f32, the scalar
// row pass; 2 bf16, the wgmma kernel). The scalar key pass uses static
// shared memory only (42 KB at d = 64).
size_t sr_attention_bwd_smem_bytes(int nk, int d, int elem) {
  return elem == 2 ? BwdLayout(d, bwd_mtiles(nk)).total
                   : RowLayout(nk, d, elem).total;
}

int sr_attention_bwd_max_nk() { return kMaxSlots * 32; }

// float32 (the scalar kernels). q, k, v, g, dq, dk, dv are 16-byte
// aligned; stats is a float32 workspace of 3 * b * heads * nq values;
// splits divides the query rows of the key pass (in tiles of 32 rows);
// with splits > 1 part is a float32 workspace of splits * 2 * b * nk * c
// values (else it is not read). *launched is set to the number of kernels
// launched without error (2, or 3 with the split sum). Returns a
// cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for a shape the
// kernels do not take.
int sr_attention_bwd(const void* q, const void* k, const void* v,
                     const void* g, void* dq, void* dk, void* dv, void* stats,
                     void* part, int b, int nq, int nk, int c, int heads,
                     int block_q, int splits, int* launched, void* stream) {
  const int d = c / heads;
  *launched = 0;
  if (b < 1 || nq < 1 || nk < 1 || nk > kMaxSlots * 32 || d * heads != c ||
      block_q < 1 || splits < 1 || (splits > 1 && part == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32)
    return launch<float, 32>(q, k, v, g, dq, dk, dv, stats, part, b, nq, nk,
                             heads, block_q, splits, s, launched);
  if (d == 64)
    return launch<float, 64>(q, k, v, g, dq, dk, dv, stats, part, b, nq, nk,
                             heads, block_q, splits, s, launched);
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
  if (b < 1 || nq < 1 || nk < 1 || nk > kMaxSlots * 32 || d * heads != c)
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
