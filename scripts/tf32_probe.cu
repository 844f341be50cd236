// One 3xTF32 product of the float32 SR-attention kernels, alone: the
// shared helpers of csrc/sr_attention_wgmma.cuh (float32 tensor maps, panel
// tiles, split register A operands, kperm-ordered B tiles) on one 64-row
// query tile x one 64-key block per CTA (one warpgroup):
//   s64  = q k^T     m64n64k8, A = q split in registers, B = k hi / lo
//   o    = s64 v     m64n64k8, A = the accumulator s64 split, B = v^T hi / lo
//   s32  = q k^T     m64n32k8 over the block's first 32 keys
//   st32 = k q^T     m64n32k8 over the tile's first 32 rows (roles swapped;
//                    with `swap`, the cross terms in swapped order)
// `terms` 3 is the 3xTF32 split, 1 one TF32 product of the hi parts.
// Built and run by scripts/tf32_probe.py.

#include "sr_attention_wgmma.cuh"

using namespace sr_wgmma;

namespace {

constexpr uint32_t kTile = 64 * 64 * 4;  // a 64 x 64 float32 panel tile

// raw 64 x 64 tile `src` -> hi / lo tiles of the same layout
__device__ void split_tile(const unsigned char* src, unsigned char* hi,
                           unsigned char* lo, int terms) {
  for (int i = threadIdx.x; i < 64 * 64; i += 128) {
    const uint32_t off = i * 4;  // any element: the swizzle moves 16 B chunks
    uint32_t h, l;
    split_tf32(*reinterpret_cast<const float*>(src + off), h, l);
    *reinterpret_cast<uint32_t*>(hi + off) = h;
    *reinterpret_cast<uint32_t*>(lo + off) = terms == 3 ? l : 0u;
  }
}

__global__ void __launch_bounds__(128, 1)
probe_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, float* s64, float* o,
             float* s32, float* st32, int nq, int nk, int terms,
             int swap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(sm);
  // q, k, v raw; q hi/lo, k hi/lo, v^T hi/lo
  unsigned char *q = sm, *k = sm + kTile, *v = sm + 2 * kTile;
  unsigned char *qh = sm + 3 * kTile, *ql = sm + 4 * kTile;
  unsigned char *kh = sm + 5 * kTile, *kl = sm + 6 * kTile;
  unsigned char *vh = sm + 7 * kTile, *vl = sm + 8 * kTile;
  const uint32_t bar = base + 9 * kTile;
  const int qt = blockIdx.x, kb = blockIdx.y, tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 3 * kTile);
    for (int p = 0; p < 2; ++p) {
      tma_load(base + p * 8192, &tq, bar, 32 * p, 64 * qt, 0);
      tma_load(base + kTile + p * 8192, &tk, bar, 32 * p, 64 * kb, 0);
      tma_load(base + 2 * kTile + p * 8192, &tv, bar, 32 * p, 64 * kb, 0);
    }
  }
  mbar_wait(bar, 0);
  split_tile(q, qh, ql, terms);
  split_tile(k, kh, kl, terms);
  for (int i = tid; i < 64 * 64; i += 128) {
    const int n = i >> 6, pos = i & 63;
    uint32_t h, l;
    split_tf32(*reinterpret_cast<const float*>(v + f32_off(kperm(pos), n, 64)),
               h, l);
    *reinterpret_cast<uint32_t*>(vh + f32_off(n, pos, 64)) = h;
    *reinterpret_cast<uint32_t*>(vl + f32_off(n, pos, 64)) = terms == 3 ? l : 0u;
  }
  fence_proxy_async();
  __syncthreads();

  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  uint32_t ah[32], al[32];
  load_a_tf32<8>(q, 64, warp, g, t, ah, al);
  if (terms != 3)
    for (int i = 0; i < 32; ++i) al[i] = 0u;
  float s[32];
  fence_regs<32>(ah);
  fence_regs<32>(al);
  wgmma_fence();
  wgmma_3xtf32<64, 8>(s, ah, al, base + 5 * kTile, base + 6 * kTile, 64, 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<32>(s);
  const int nkb = gridDim.y;
  for (int i = 0; i < 32; ++i) {
    const int r = 64 * qt + 16 * warp + g + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * t + (i & 1);
    s64[size_t(r) * nk + 64 * kb + c] = s[i];
  }
  uint32_t ph[32], pl[32];
  acc_to_a_tf32<64>(s, ph, pl);
  if (terms != 3)
    for (int i = 0; i < 32; ++i) pl[i] = 0u;
  float acc[32];
  fence_regs<32>(ph);
  fence_regs<32>(pl);
  wgmma_fence();
  wgmma_3xtf32<64, 8>(acc, ph, pl, base + 7 * kTile, base + 8 * kTile, 64, 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<32>(acc);
  for (int i = 0; i < 32; ++i) {
    const int r = 64 * qt + 16 * warp + g + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * t + (i & 1);
    o[(size_t(r) * nkb + kb) * 64 + c] = acc[i];
  }
  // the n32 products: q k^T over keys 0-31 of the block, k q^T over rows
  // 0-31 of the tile
  float sa[16], sb[16];
  wgmma_fence();
  wgmma_3xtf32<32, 8>(sa, ah, al, base + 5 * kTile, base + 6 * kTile, 64, 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<16>(sa);
  load_a_tf32<8>(k, 64, warp, g, t, ah, al);
  if (terms != 3)
    for (int i = 0; i < 32; ++i) al[i] = 0u;
  fence_regs<32>(ah);
  fence_regs<32>(al);
  wgmma_fence();
  if (swap)
    wgmma_3xtf32<32, 8, true>(sb, ah, al, base + 3 * kTile, base + 4 * kTile,
                              64, 0);
  else
    wgmma_3xtf32<32, 8>(sb, ah, al, base + 3 * kTile, base + 4 * kTile, 64,
                        0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<16>(sb);
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * t + (i & 1);
    s32[size_t(64 * qt + r) * (nkb * 32) + 32 * kb + c] = sa[i];
    st32[size_t(64 * kb + r) * (gridDim.x * 32) + 32 * qt + c] = sb[i];
  }
}

}  // namespace

extern "C" int tf32_probe(const void* q, const void* k, const void* v,
                          float* s64, float* o, float* s32, float* st32,
                          int nq, int nk, int terms, int swap,
                          void* stream) {
  if (nq % 64 || nk % 64) return int(cudaErrorInvalidValue);
  CUtensorMap m[3];
  if (!encode_map_f32(&m[0], q, 1, nq, 64, 64) ||
      !encode_map_f32(&m[1], k, 1, nk, 64, 64) ||
      !encode_map_f32(&m[2], v, 1, nk, 64, 64))
    return int(cudaErrorInvalidValue);
  const int smem = 9 * kTile + 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  probe_kernel<<<dim3(nq / 64, nk / 64), 128, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], s64, o, s32, st32, nq, nk, terms, swap);
  return int(cudaGetLastError());
}
