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
// Design. One CTA of 8 warps per (batch*head, block of query rows). The
// CTA stages the whole K (transposed) and V of its (batch, head) in dynamic
// shared memory, read straight from the (B, N, C) layout through the head's
// column offset, so no head split/merge copies are needed. A warp holds
// kRows query rows at once; lane l owns key columns l, l+32, ..., so the
// row max and row sum are warp shuffles and no score ever leaves the SM.
// The probabilities go to a per-warp shared-memory row, from which every
// lane reads them as broadcasts for P.V; lane l owns output columns l and
// l+32. The ragged key tail (Nk not a multiple of 32) is masked in the
// loop and zero-filled in shared memory; the query tail is masked on load
// and store.
//
// Bound. At MiT-B5 512x512 shapes the function is bound by the bytes it
// must move (q in, out back: 2*B*Nq*C elements) on the tensor-core peak,
// but this first kernel does its 4*B*Nq*Nk*C flops as scalar float32 FMAs,
// so it is bound by the FMA pipes and shared-memory reads instead; moving
// QK^T and PV onto mma/wgmma is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  // Above 48 KB the launch is refused unless the kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(lay.total));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((nq + block_q - 1) / block_q, b * heads);
  kernel<<<grid, kThreads, lay.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), nq, nk, heads, block_q,
      1.0f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (elem: 4 f32, 2 bf16).
size_t sr_attention_fwd_smem_bytes(int nk, int d, int elem) {
  return Layout(nk, d, elem).total;
}

int sr_attention_fwd_max_nk() { return kMaxSlots * 32; }

// dtype: 0 float32, 1 bfloat16. q, k, v and out are 16-byte aligned.
// Returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for a
// shape or type the kernel does not take.
int sr_attention_fwd(const void* q, const void* k, const void* v, void* out,
                     int b, int nq, int nk, int c, int heads, int dtype,
                     int block_q, void* stream) {
  const int d = c / heads;
  if (b < 1 || nq < 1 || nk < 1 || nk > kMaxSlots * 32 || d * heads != c ||
      block_q < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 32)
    return launch<float, 32>(q, k, v, out, b, nq, nk, heads, block_q, s);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, out, b, nq, nk, heads, block_q, s);
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
