// SR-attention backward for Hopper (sm_90a): the gradients dq, dk, dv of
// out = softmax(q k^T / sqrt(d)) v given the output gradient g, per
// (batch, head), with q, g, dq of shape (B, Nq, C) and k, v, dk, dv of shape
// (B, Nk, C), C = heads * d, all row-major and contiguous.
//
// Replaces the Pallas TPU kernel semisupervisedobjectdetection_tpu/ops/
// sr_attention.py::_bwd_kernel and computes the same function:
//   p  = softmax(q k^T * scale)            float32, recomputed
//   dv = p^T g                             float32 p and g
//   dp = g v^T                             float32
//   ds = p * (dp - rowsum(dp * p)) * scale float32
//   dq = round(ds) k,  dk = round(ds)^T q  ds rounded to the input type,
//                                          float32 sums
// dq is written in q's type; dk and dv are summed in float32 and cast.
//
// Design. The Pallas kernel sums dk/dv over query blocks in output blocks
// that the TPU's sequential grid revisits; CUDA blocks run in parallel, and
// atomics would make the sums depend on the order blocks finish. So the
// work is split in two passes, launched in order on one stream, neither of
// which adds into another block's sums:
//
// 1. Row pass: one block per (batch*head, block of query rows), K and V of
//    the (batch, head) in shared memory. It computes each row's max, sum l
//    and delta = rowsum(dp * p), writes them to a float32 workspace of
//    B*heads*Nq*4 values, and writes dq.
// 2. Key pass: one block per (batch*head, block of keys, split of the
//    query rows). It walks its split's query rows in tiles, recomputes s
//    and dp of its keys, rebuilds p and ds from the row statistics, and
//    adds the tile to dk and dv held in registers. With one split it writes
//    dk and dv; with several (the caller splits the rows when the key
//    blocks alone would not fill the card, as at stage 1) each split writes
//    float32 partials to a workspace and a third kernel sums them in split
//    order. Every sum runs in a fixed order, so the result is the same from
//    run to run.
//
// Query rows past Nq are never loaded as rows (the NaN-safe select of the
// Pallas kernel has nothing to guard); keys past Nk are masked and
// zero-filled in shared memory.
//
// Bound. Per launch the function does 10*B*Nq*Nk*C flops (five products)
// and moves q, g, dq (B*Nq*C each) and k, v, dk, dv (B*Nk*C each) once; at
// MiT-B5 512x512 in bf16 the flops bound it on the tensor cores at stages
// 1-3 and the bytes at stage 4. Two designs, by dtype:
//
// bfloat16: the tensor-core kernels (*_mma_kernel), every product by
// mma.sync m16n8k16 with float32 accumulation (sr_attention_mma.cuh).
//   Row pass: 4 warps of 16 query rows at a time; K and V staged by
//   cp.async. A warp holds its rows' whole score row in registers: s = q k^T
//   by mma, the key tail masked, max and l by quad shuffles, p in float32;
//   then, walking the keys in tiles of 16, dp = g v^T by mma and delta
//   (float32 p and dp); then again dp, ds = p (dp - delta) scale rounded to
//   bf16 in registers as an A fragment, and dq += ds k by mma (K through
//   ldmatrix.trans). Recomputing dp costs one product of the ten; holding
//   both rows would not fit the registers.
//   Key pass: 4 warps of 16 keys, 64 keys a block, their K and V fragments
//   held in registers; the split's query rows in tiles of 64 with q, g and
//   the row statistics double-buffered by cp.async. Per 16 rows: s^T = k q^T
//   and dp^T = v g^T by mma, p and ds rebuilt from the statistics, and
//   dv += p^T g, dk += ds^T q by mma from the accumulator fragments. dv is
//   formed from float32 p, as the plain version does, by two bf16 products:
//   p_hi = bf16(p) and p_lo = bf16(p - p_hi).
// float32: the scalar kernels, kept because TF32 tensor cores would not
// hold the float32 results to their tolerance. The row pass (8 warps)
// stages K^T and V^T; lane l of a warp owns key columns l, l+32, ..., so
// each warp holds full rows of s and dp and takes the row sums by warp
// shuffles. The key pass (32 keys a block, rows in tiles of 32) recomputes
// s and dp with the same in-order FMA chains as the row pass and rebuilds p
// and ds bit for bit. Their products are scalar float32 FMAs, so the FMA
// pipes and shared-memory reads bound them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sr_attention_mma.cuh"

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// dk, dv from the float32 partials of `splits` splits (n values each).
template <typename T>
int launch_sum(const void* part, void* dk, void* dv, size_t n, int splits,
               cudaStream_t stream) {
  const size_t need = (n + kThreads - 1) / kThreads;
  const int blocks = int(need < 1056 ? need : 1056);  // 8 per SM
  sr_attention_bwd_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(dk),
      static_cast<T*>(dv), n, splits);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* g,
           void* dq, void* dk, void* dv, void* stats, void* part, int b,
           int nq, int nk, int heads, int block_q, int splits,
           cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(float(D));
  const RowLayout lay(nk, D, sizeof(T));
  auto rows = sr_attention_bwd_rows_kernel<T, D>;
  static std::atomic<uint32_t> opted{0};
  cudaError_t err = sr_mma::opt_in_smem(rows, opted);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_rows((nq + block_q - 1) / block_q, b * heads);
  rows<<<grid_rows, kThreads, lay.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), static_cast<T*>(dq),
      static_cast<float*>(stats), nq, nk, heads, block_q, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
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
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  return launch_sum<T>(part, dk, dv, size_t(b) * nk * heads * D, splits,
                       stream);
}

// ---- bfloat16: the tensor-core kernels ----

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaMaxTiles = 18;  // 16-key tiles a warp holds: Nk <= 288
constexpr int kMmaKeys = kMmaWarps * 16;  // keys per key-pass block
constexpr int kMmaTile = 64;              // query rows per key-pass tile
static_assert(kMmaMaxTiles * 16 == kMaxSlots * 32, "one Nk limit");

// The row statistics of one query row, as the tensor-core passes keep
// them: the max of x = s * scale * log2(e) (p = 2^(x - max) / l), 1 / l,
// delta.
using RowStats = float4;

// Row-pass shared memory, in bytes from the start of the dynamic buffer
// (rows of D + 8 bf16, see sr_attention_mma.cuh):
//   ks [nkp][D + 8]              K (keys past nk zero)
//   vs [nkp][D + 8]              V
//   qs [kMmaWarps][16][D + 8]    each warp's q rows, then its dq rows
//   gs [kMmaWarps][16][D + 8]    each warp's g rows
struct MmaRowLayout {
  int nkp;
  size_t ks, vs, qs, gs, total;
  __host__ __device__ MmaRowLayout(int nk, int d) {
    const size_t row = size_t(d + 8) * sizeof(__nv_bfloat16);
    nkp = (nk + 15) / 16 * 16;
    ks = 0;
    vs = ks + nkp * row;
    qs = vs + nkp * row;
    gs = qs + kMmaWarps * 16 * row;
    total = gs + kMmaWarps * 16 * row;
  }
};

// Key-pass shared memory, in bytes:
//   ks, vs [kMmaKeys][D + 8]        the block's keys of K and V
//   qt, gt [2][kMmaTile][D + 8]     double-buffered tiles of q and g rows
//   st     [2][kMmaTile] RowStats   and their row statistics
struct MmaKeyLayout {
  size_t ks, vs, qt, gt, st, total;
  __host__ __device__ explicit MmaKeyLayout(int d) {
    const size_t row = size_t(d + 8) * sizeof(__nv_bfloat16);
    ks = 0;
    vs = ks + kMmaKeys * row;
    qt = vs + kMmaKeys * row;
    gt = qt + 2 * kMmaTile * row;
    st = gt + 2 * kMmaTile * row;
    total = st + 2 * kMmaTile * sizeof(RowStats);
  }
};

// dp of one 16-key tile for the warp's 16 rows: g (A fragments) times the
// V rows of keys 16t.. (B operand, [key][d] in shared memory).
template <int D>
__device__ __forceinline__ void dp_tile(float (&dp)[2][4],
                                        const uint32_t (&ga)[D / 16][4],
                                        const __nv_bfloat16* vt, int lane) {
  using namespace sr_mma;
  constexpr int LD = row_stride<D>();
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dp[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t vf[4];
    ldmatrix_x4(vf, vt + b_offset_nk(lane, LD) + kk * 16);
    mma(dp[0], ga[kk], vf[0], vf[1]);
    mma(dp[1], ga[kk], vf[2], vf[3]);
  }
}

// KT: the 16-key tiles each warp's registers hold, at least ceil(nk / 16).
template <int D, int KT>
__global__ void __launch_bounds__(kMmaThreads, 2)
sr_attention_bwd_rows_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ g,
                                 __nv_bfloat16* __restrict__ dq,
                                 RowStats* __restrict__ stats, int nq, int nk,
                                 int heads, int block_q, float scale,
                                 float scale_log2) {
  using namespace sr_mma;
  constexpr int LD = row_stride<D>();
  constexpr int kVecs = D / 8;    // 16-byte pieces of a row
  constexpr int kSteps = D / 16;  // k-steps over the head dimension
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaRowLayout lay(nk, D);
  bf16* ks = reinterpret_cast<bf16*>(smem + lay.ks);
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.vs);
  const int nt = lay.nkp / 16;
  const int c = heads * D;
  const int bh = int(blockIdx.y), b = bh / heads, h = bh % heads;
  const int tid = int(threadIdx.x), warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3, gr = lane >> 2;
  bf16* qw = reinterpret_cast<bf16*>(smem + lay.qs) + warp * 16 * LD;
  bf16* gw = reinterpret_cast<bf16*>(smem + lay.gs) + warp * 16 * LD;

  const bf16* kb = k + size_t(b) * nk * c + h * D;
  const bf16* vb = v + size_t(b) * nk * c + h * D;
  for (int i = tid; i < lay.nkp * kVecs; i += kMmaThreads) {
    const int j = i / kVecs, e = (i % kVecs) * 8;
    const bool ok = j < nk;
    const size_t at = size_t(ok ? j : 0) * c + e;
    cp_async16(ks + j * LD + e, kb + at, ok);
    cp_async16(vs + j * LD + e, vb + at, ok);
  }

  const bf16* qb = q + size_t(b) * nq * c + h * D;
  const bf16* gb = g + size_t(b) * nq * c + h * D;
  bf16* dqb = dq + size_t(b) * nq * c + h * D;
  RowStats* sb = stats + size_t(bh) * nq;
  const int q0 = int(blockIdx.x) * block_q;
  const int q_end = min(q0 + block_q, nq);
  // this warp's 16 rows of q and g from r0; rows past the end are zero
  auto load_rows = [&](int r0) {
    for (int i = lane; i < 16 * kVecs; i += 32) {
      const int r = i / kVecs, e = (i % kVecs) * 8, row = r0 + r;
      const bool ok = row < q_end;
      const size_t at = size_t(ok ? row : 0) * c + e;
      cp_async16(qw + r * LD + e, qb + at, ok);
      cp_async16(gw + r * LD + e, gb + at, ok);
    }
  };
  const int first = q0 + warp * 16;
  if (first < q_end) load_rows(first);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // K and V are staged

  for (int r0 = first; r0 < q_end; r0 += kMmaWarps * 16) {
    if (r0 != first) {
      load_rows(r0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncwarp();

    uint32_t fa[kSteps][4];  // q's A fragments, later g's
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      ldmatrix_x4(fa[kk], qw + a_offset(lane, LD) + kk * 16);

    // s = q k^T over the whole key row, then p in place (float32; C tiles,
    // see softmax_rows)
    float s[KT][2][4];
#pragma unroll
    for (int t = 0; t < KT; ++t) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[t][n][i] = 0.f;
      if (t < nt) {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          uint32_t kf[4];
          ldmatrix_x4(kf, ks + t * 16 * LD + b_offset_nk(lane, LD) + kk * 16);
          mma(s[t][0], fa[kk], kf[0], kf[1]);
          mma(s[t][1], fa[kk], kf[2], kf[3]);
        }
      }
    }
    float m[2], l[2];  // the row max of s * scale * log2(e), and 1 / l
    softmax_rows<KT>(s, nk, scale_log2, lane, m, l);

#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      ldmatrix_x4(fa[kk], gw + a_offset(lane, LD) + kk * 16);

    // delta = rowsum(dp * p), float32, in 4 partial sums (by tile % 4)
    float part[2][4] = {};
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      if (t < nt) {
        float dp[2][4];
        dp_tile<D>(dp, fa, vs + t * 16 * LD, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            part[i >> 1][t & 3] += s[t][n][i] * dp[n][i];
      }
    }
    float delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    }

    // dq = bf16(ds) k, ds = p (dp - delta) scale with dp recomputed
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      if (t < nt) {
        float dp[2][4];
        dp_tile<D>(dp, fa, vs + t * 16 * LD, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dp[n][i] = s[t][n][i] * (dp[n][i] - delta[i >> 1]) * scale;
        uint32_t da[4];
        c_to_a(da, dp[0], dp[1]);
#pragma unroll
        for (int jj = 0; jj < D / 16; ++jj) {
          uint32_t kf[4];
          ldmatrix_x4_trans(kf,
                            ks + t * 16 * LD + b_offset_kn(lane, LD) + jj * 16);
          mma(acc[2 * jj], da, kf[0], kf[1]);
          mma(acc[2 * jj + 1], da, kf[2], kf[3]);
        }
      }
    }

    if (t4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + gr + 8 * r;
        if (row < q_end) sb[row] = make_float4(m[r], l[r], delta[r], 0.f);
      }
    }
    // dq through the warp's rows in shared memory to 16-byte stores
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(qw + gr * LD + j * 8 + 2 * t4) =
          pack(acc[j][0], acc[j][1]);
      *reinterpret_cast<uint32_t*>(qw + (gr + 8) * LD + j * 8 + 2 * t4) =
          pack(acc[j][2], acc[j][3]);
    }
    __syncwarp();
    for (int i = lane; i < 16 * kVecs; i += 32) {
      const int r = i / kVecs, e = (i % kVecs) * 8, row = r0 + r;
      if (row < q_end)
        *reinterpret_cast<uint4*>(dqb + size_t(row) * c + e) =
            *reinterpret_cast<const uint4*>(qw + r * LD + e);
    }
    __syncwarp();  // qw and gw are rewritten by the next row group
  }
}

// part: nullptr with one split, else [splits][2][B*nk*c] float32 partials
// of dk and dv.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
sr_attention_bwd_keys_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ g,
                                 const RowStats* __restrict__ stats,
                                 __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv,
                                 float* __restrict__ part, int nq, int nk,
                                 int heads, int rows_per_split, float scale,
                                 float scale_log2) {
  using namespace sr_mma;
  constexpr int LD = row_stride<D>();
  constexpr int kVecs = D / 8;
  constexpr int kSteps = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaKeyLayout lay(D);
  bf16* ks = reinterpret_cast<bf16*>(smem + lay.ks);
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.vs);
  bf16* qt = reinterpret_cast<bf16*>(smem + lay.qt);
  bf16* gt = reinterpret_cast<bf16*>(smem + lay.gt);
  RowStats* st = reinterpret_cast<RowStats*>(smem + lay.st);

  const int c = heads * D;
  const int bh = int(blockIdx.y), b = bh / heads, h = bh % heads;
  const int j0 = int(blockIdx.x) * kMmaKeys;
  const int tid = int(threadIdx.x), warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3, gr = lane >> 2;

  const bf16* kb = k + size_t(b) * nk * c + h * D;
  const bf16* vb = v + size_t(b) * nk * c + h * D;
  for (int i = tid; i < kMmaKeys * kVecs; i += kMmaThreads) {
    const int j = i / kVecs, e = (i % kVecs) * 8;
    const bool ok = j0 + j < nk;
    const size_t at = size_t(ok ? j0 + j : 0) * c + e;
    cp_async16(ks + j * LD + e, kb + at, ok);
    cp_async16(vs + j * LD + e, vb + at, ok);
  }

  const bf16* qb = q + size_t(b) * nq * c + h * D;
  const bf16* gb = g + size_t(b) * nq * c + h * D;
  const RowStats* sb = stats + size_t(bh) * nq;
  const int r_begin = int(blockIdx.z) * rows_per_split;
  const int r_end = min(nq, r_begin + rows_per_split);
  const int tiles = (r_end - r_begin + kMmaTile - 1) / kMmaTile;  // >= 1
  // Rows past the split are zero, statistics included, so their p and ds
  // are 0.
  auto load_tile = [&](int it, int buf) {
    const int r0 = r_begin + it * kMmaTile;
    for (int i = tid; i < kMmaTile * kVecs; i += kMmaThreads) {
      const int r = i / kVecs, e = (i % kVecs) * 8, row = r0 + r;
      const bool ok = row < r_end;
      const size_t at = size_t(ok ? row : 0) * c + e;
      cp_async16(qt + (buf * kMmaTile + r) * LD + e, qb + at, ok);
      cp_async16(gt + (buf * kMmaTile + r) * LD + e, gb + at, ok);
    }
    if (tid < kMmaTile) {
      const int row = r0 + tid;
      const bool ok = row < r_end;
      cp_async16(st + buf * kMmaTile + tid, sb + (ok ? row : 0), ok);
    }
  };
  if (tiles > 0) load_tile(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // This warp's 16 keys of K and V as A fragments, for the whole pass.
  uint32_t ka[kSteps][4], va[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    ldmatrix_x4(ka[kk], ks + warp * 16 * LD + a_offset(lane, LD) + kk * 16);
    ldmatrix_x4(va[kk], vs + warp * 16 * LD + a_offset(lane, LD) + kk * 16);
  }
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[j][i] = dva[j][i] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < tiles) load_tile(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it is staged

#pragma unroll 1
    for (int ch = 0; ch < kMmaTile / 16; ++ch) {
      const bf16* qr = qt + (buf * kMmaTile + ch * 16) * LD;
      const bf16* gq = gt + (buf * kMmaTile + ch * 16) * LD;
      const RowStats* sr = st + buf * kMmaTile + ch * 16;
      // s^T = k q^T and dp^T = v g^T for the warp's 16 keys and 16 rows:
      // element i of C tile n is key gr + 8 (i >> 1), row 8n + 2 t4 + (i & 1)
      float sT[2][4], dT[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sT[n][i] = dT[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t f[4];
        ldmatrix_x4(f, qr + b_offset_nk(lane, LD) + kk * 16);
        mma(sT[0], ka[kk], f[0], f[1]);
        mma(sT[1], ka[kk], f[2], f[3]);
        ldmatrix_x4(f, gq + b_offset_nk(lane, LD) + kk * 16);
        mma(dT[0], va[kk], f[0], f[1]);
        mma(dT[1], va[kk], f[2], f[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const RowStats rs = sr[8 * n + 2 * t4 + j];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 2 * hf + j;
            const float p =
                exp2_approx(fmaf(sT[n][i], scale_log2, -rs.x)) * rs.y;
            dT[n][i] = p * (dT[n][i] - rs.z) * scale;  // ds
            sT[n][i] = p;
          }
        }
      uint32_t ph[4], pl[4], da[4];
      c_to_a_split(ph, pl, sT[0], sT[1]);
      c_to_a(da, dT[0], dT[1]);
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, gq + b_offset_kn(lane, LD) + jj * 16);
        mma(dva[2 * jj], ph, f[0], f[1]);
        mma(dva[2 * jj + 1], ph, f[2], f[3]);
        mma(dva[2 * jj], pl, f[0], f[1]);
        mma(dva[2 * jj + 1], pl, f[2], f[3]);
        ldmatrix_x4_trans(f, qr + b_offset_kn(lane, LD) + jj * 16);
        mma(dka[2 * jj], da, f[0], f[1]);
        mma(dka[2 * jj + 1], da, f[2], f[3]);
      }
    }
    __syncthreads();  // buffer buf is free for tile it + 2
  }

  const size_t n_out = size_t(gridDim.y / heads) * nk * c;
  float* pk = part == nullptr ? nullptr : part + 2 * n_out * blockIdx.z;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = j0 + warp * 16 + gr + 8 * hf;
    if (key >= nk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = (size_t(b) * nk + key) * c + h * D + j * 8 + 2 * t4;
      const float k0 = dka[j][2 * hf], k1 = dka[j][2 * hf + 1];
      const float v0 = dva[j][2 * hf], v1 = dva[j][2 * hf + 1];
      if (pk == nullptr) {
        *reinterpret_cast<uint32_t*>(dk + at) = pack(k0, k1);
        *reinterpret_cast<uint32_t*>(dv + at) = pack(v0, v1);
      } else {
        *reinterpret_cast<float2*>(pk + at) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(pk + n_out + at) = make_float2(v0, v1);
      }
    }
  }
}

template <int D, int KT>
int launch_mma(const void* q, const void* k, const void* v, const void* g,
               void* dq, void* dk, void* dv, void* stats, void* part, int b,
               int nq, int nk, int heads, int block_q, int splits,
               cudaStream_t stream) {
  using sr_mma::bf16;
  const float scale = 1.0f / sqrtf(float(D));
  const float scale_log2 = 1.4426950408889634f * scale;
  auto rows = sr_attention_bwd_rows_mma_kernel<D, KT>;
  static std::atomic<uint32_t> rows_opted{0};
  cudaError_t err = sr_mma::opt_in_smem(rows, rows_opted);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_rows((nq + block_q - 1) / block_q, b * heads);
  rows<<<grid_rows, kMmaThreads, MmaRowLayout(nk, D).total, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<bf16*>(dq), static_cast<RowStats*>(stats), nq, nk, heads,
      block_q, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  auto keys = sr_attention_bwd_keys_mma_kernel<D>;
  static std::atomic<uint32_t> keys_opted{0};
  err = sr_mma::opt_in_smem(keys, keys_opted);
  if (err != cudaSuccess) return int(err);
  const int rows_per_split =
      ((nq + splits - 1) / splits + kMmaTile - 1) / kMmaTile * kMmaTile;
  const dim3 grid_keys((nk + kMmaKeys - 1) / kMmaKeys, b * heads, splits);
  keys<<<grid_keys, kMmaThreads, MmaKeyLayout(D).total, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const RowStats*>(stats), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), splits > 1 ? static_cast<float*>(part) : nullptr,
      nq, nk, heads, rows_per_split, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  return launch_sum<bf16>(part, dk, dv, size_t(b) * nk * heads * D, splits,
                          stream);
}

// The instantiation whose registers hold ceil(nk / 16) key tiles.
template <int D>
int dispatch_mma(const void* q, const void* k, const void* v, const void* g,
                 void* dq, void* dk, void* dv, void* stats, void* part, int b,
                 int nq, int nk, int heads, int block_q, int splits,
                 cudaStream_t stream) {
  if (nk <= 16 * 16)
    return launch_mma<D, 16>(q, k, v, g, dq, dk, dv, stats, part, b, nq, nk,
                             heads, block_q, splits, stream);
  return launch_mma<D, kMmaMaxTiles>(q, k, v, g, dq, dk, dv, stats, part, b,
                                     nq, nk, heads, block_q, splits, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one row-pass block needs (elem: 4 f32,
// the scalar kernels; 2 bf16, the tensor-core kernels). The scalar key pass
// uses static shared memory only (42 KB at d = 64); the tensor-core key
// pass a fixed 56 KB at d = 64.
size_t sr_attention_bwd_smem_bytes(int nk, int d, int elem) {
  return elem == 2 ? MmaRowLayout(nk, d).total : RowLayout(nk, d, elem).total;
}

int sr_attention_bwd_max_nk() { return kMaxSlots * 32; }

// dtype: 0 float32, 1 bfloat16. q, k, v, g, dq, dk, dv are 16-byte aligned;
// stats is a 16-byte aligned float32 workspace of b * heads * nq * 4
// values (the scalar kernels use the first 3 * b * heads * nq); splits
// divides the query rows of the key pass (in tiles of 32 rows for float32,
// 64 for bfloat16); with splits > 1
// part is a float32 workspace of splits * 2 * b * nk * c values (else it is
// not read). Returns a cudaError_t (0 on success); 1
// (cudaErrorInvalidValue) for a shape or type the kernel does not take.
int sr_attention_bwd(const void* q, const void* k, const void* v,
                     const void* g, void* dq, void* dk, void* dv, void* stats,
                     void* part, int b, int nq, int nk, int c, int heads,
                     int dtype, int block_q, int splits, void* stream) {
  const int d = c / heads;
  if (b < 1 || nq < 1 || nk < 1 || nk > kMaxSlots * 32 || d * heads != c ||
      block_q < 1 || splits < 1 || (splits > 1 && part == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 32)
    return launch<float, 32>(q, k, v, g, dq, dk, dv, stats, part, b, nq, nk,
                             heads, block_q, splits, s);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, g, dq, dk, dv, stats, part, b, nq, nk,
                             heads, block_q, splits, s);
  if (dtype == 1 && d == 32)
    return dispatch_mma<32>(q, k, v, g, dq, dk, dv, stats, part, b, nq, nk,
                          heads, block_q, splits, s);
  if (dtype == 1 && d == 64)
    return dispatch_mma<64>(q, k, v, g, dq, dk, dv, stats, part, b, nq, nk,
                          heads, block_q, splits, s);
  return int(cudaErrorInvalidValue);
}

const char* sr_attention_bwd_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
