// SR-attention forward for Hopper (sm_90a): out = softmax(q k^T / sqrt(d)) v
// per (batch, head), with q of shape (B, Nq, C) and k, v of shape (B, Nk, C),
// C = heads * d, all row-major and contiguous.
//
// Replaces the Pallas TPU kernel semisupervisedobjectdetection_tpu/ops/
// sr_attention.py::_attn_kernel and computes the same function: scores and
// softmax in float32, one full-row softmax (the key row is short: Nk is 256
// plus a few prompt/CLS tokens at MiT shapes), the normalised probabilities
// rounded to v's type before P.V, float32 accumulation, output in q's type.
//
// Bound. At MiT-B5 512x512 shapes the function is bound by the bytes it
// must move (q in, out back: 2*B*Nq*C elements) on the bf16 tensor-core
// peak: 4*B*Nq*Nk*C flops over 2*B*(Nq+Nk)*C*2 bytes is ~250 flops a byte
// at Nk = 256, d = 64, under the card's ~295. Two kernels:
//
// The tensor-core kernel (sr_attention_fwd_mma_kernel, bfloat16, taken when
// the caller asks for it). One CTA of 4 warps per (batch*head, block of
// query rows); K and V of the (batch, head) are staged once in shared
// memory by cp.async, read straight from the (B, N, C) layout through the
// head's column offset. Each warp takes 16 query rows at a time and holds
// their whole score row in registers (up to 18 tiles of 16 keys): s = q k^T
// by mma.sync m16n8k16 (K's rows are the B operand's columns, no
// transpose), the key tail masked to -inf, the row max and sum by quad
// shuffles, p = exp(s - m) / l rounded to bf16 in registers (the
// accumulator fragment becomes the A fragment of the next product), then
// o = p v by mma (V through ldmatrix.trans). A warp's query rows are
// double-buffered, so the next group's load overlaps this one's work; the
// output goes back through the warp's shared-memory rows for 16-byte
// stores. Two CTAs fit an SM at Nk <= 288 (~97 KB of shared memory each at
// Nk = 266, d = 64). Its sums run in the tensor cores' order, so a bf16
// output differs from the plain version's by an ulp or two in about 0.07%
// of elements.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---- bfloat16: the tensor-core kernel ----

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaMaxTiles = 18;  // 16-key tiles a warp holds: Nk <= 288
static_assert(kMmaMaxTiles * 16 == kMaxSlots * 32, "one Nk limit");

// Shared memory of the mma kernel, in bytes from the start of the dynamic
// buffer (rows of D + 8 bf16, see sr_attention_mma.cuh):
//   ks [nkp][D + 8]                 K (keys past nk zero)
//   vs [nkp][D + 8]                 V
//   qs [kMmaWarps][2][16][D + 8]    each warp's query rows, double-buffered
//                                   (the next group's arrive while this
//                                   one is computed), then its output
struct MmaLayout {
  int nkp;
  size_t ks, vs, qs, total;
  __host__ __device__ MmaLayout(int nk, int d) {
    const size_t row = size_t(d + 8) * sizeof(__nv_bfloat16);
    nkp = (nk + 15) / 16 * 16;
    ks = 0;
    vs = ks + nkp * row;
    qs = vs + nkp * row;
    total = qs + kMmaWarps * 2 * 16 * row;
  }
};

// KT: the 16-key tiles each warp's registers hold, at least ceil(nk / 16).
template <int D, int KT>
__global__ void __launch_bounds__(kMmaThreads, 2)
sr_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int nq, int nk,
                            int heads, int block_q, float scale_log2) {
  using namespace sr_mma;
  constexpr int LD = row_stride<D>();
  constexpr int kVecs = D / 8;    // 16-byte pieces of a row
  constexpr int kSteps = D / 16;  // k-steps of q k^T
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaLayout lay(nk, D);
  bf16* ks = reinterpret_cast<bf16*>(smem + lay.ks);
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.vs);
  const int nt = lay.nkp / 16;
  const int c = heads * D;
  const int bh = int(blockIdx.y), b = bh / heads, h = bh % heads;
  const int tid = int(threadIdx.x), warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3, g = lane >> 2;
  bf16* const qslots =
      reinterpret_cast<bf16*>(smem + lay.qs) + warp * 2 * 16 * LD;

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
  bf16* ob = out + size_t(b) * nq * c + h * D;
  const int q0 = int(blockIdx.x) * block_q;
  const int q_end = min(q0 + block_q, nq);
  constexpr int kStride = kMmaWarps * 16;  // between a warp's row groups
  // this warp's 16 query rows from r0 into slot buf; rows past the end are
  // zero
  auto load_rows = [&](int r0, int buf) {
    bf16* qw = qslots + buf * 16 * LD;
    for (int i = lane; i < 16 * kVecs; i += 32) {
      const int r = i / kVecs, e = (i % kVecs) * 8, row = r0 + r;
      const bool ok = row < q_end;
      cp_async16(qw + r * LD + e, qb + size_t(ok ? row : 0) * c + e, ok);
    }
  };
  const int first = q0 + warp * 16;
  if (first < q_end) load_rows(first, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // K and V are staged

  int buf = 0;
  for (int r0 = first; r0 < q_end; r0 += kStride, buf ^= 1) {
    // the next group's rows arrive while this one is computed
    if (r0 + kStride < q_end) load_rows(r0 + kStride, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    bf16* qw = qslots + buf * 16 * LD;

    uint32_t qa[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      ldmatrix_x4(qa[kk], qw + a_offset(lane, LD) + kk * 16);

    // s = q k^T over the whole key row (C tiles, see softmax_rows)
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
          mma(s[t][0], qa[kk], kf[0], kf[1]);
          mma(s[t][1], qa[kk], kf[2], kf[3]);
        }
      }
    }

    // p = softmax(s) in float32, then o = p v with p rounded to bf16 as
    // the A fragment
    float m[2], inv_l[2];
    softmax_rows<KT>(s, nk, scale_log2, lane, m, inv_l);
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      if (t < nt) {
        uint32_t pa[4];
        c_to_a(pa, s[t][0], s[t][1]);
#pragma unroll
        for (int jj = 0; jj < D / 16; ++jj) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf,
                            vs + t * 16 * LD + b_offset_kn(lane, LD) + jj * 16);
          mma(o[2 * jj], pa, vf[0], vf[1]);
          mma(o[2 * jj + 1], pa, vf[2], vf[3]);
        }
      }
    }

    // Through the warp's rows in shared memory to 16-byte stores.
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(qw + g * LD + j * 8 + 2 * t4) =
          pack(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(qw + (g + 8) * LD + j * 8 + 2 * t4) =
          pack(o[j][2], o[j][3]);
    }
    __syncwarp();
    for (int i = lane; i < 16 * kVecs; i += 32) {
      const int r = i / kVecs, e = (i % kVecs) * 8, row = r0 + r;
      if (row < q_end)
        *reinterpret_cast<uint4*>(ob + size_t(row) * c + e) =
            *reinterpret_cast<const uint4*>(qw + r * LD + e);
    }
    __syncwarp();  // qw takes the group after next
  }
}

template <int D, int KT>
int launch_mma(const void* q, const void* k, const void* v, void* out, int b,
               int nq, int nk, int heads, int block_q, cudaStream_t stream) {
  const MmaLayout lay(nk, D);
  auto kernel = sr_attention_fwd_mma_kernel<D, KT>;
  static std::atomic<uint32_t> opted{0};
  cudaError_t err = sr_mma::opt_in_smem(kernel, opted);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((nq + block_q - 1) / block_q, b * heads);
  kernel<<<grid, kMmaThreads, lay.total, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      nq, nk, heads, block_q, 1.4426950408889634f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

// The instantiation whose registers hold ceil(nk / 16) key tiles.
template <int D>
int dispatch_mma(const void* q, const void* k, const void* v, void* out, int b,
                 int nq, int nk, int heads, int block_q, cudaStream_t stream) {
  if (nk <= 16 * 16)
    return launch_mma<D, 16>(q, k, v, out, b, nq, nk, heads, block_q, stream);
  return launch_mma<D, kMmaMaxTiles>(q, k, v, out, b, nq, nk, heads, block_q,
                                     stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (elem: 4 f32, 2 bf16; mma:
// the tensor-core kernel, else the scalar one).
size_t sr_attention_fwd_smem_bytes(int nk, int d, int elem, int mma) {
  return mma ? MmaLayout(nk, d).total : Layout(nk, d, elem).total;
}

int sr_attention_fwd_max_nk() { return kMaxSlots * 32; }

// dtype: 0 float32, 1 bfloat16. mma: 1 runs the tensor-core kernel
// (bfloat16 only), 0 the scalar one. q, k, v and out are 16-byte aligned.
// Returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for a
// shape or type the kernel does not take.
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
    return dispatch_mma<32>(q, k, v, out, b, nq, nk, heads, block_q, s);
  if (mma && d == 64)
    return dispatch_mma<64>(q, k, v, out, b, nq, nk, heads, block_q, s);
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
