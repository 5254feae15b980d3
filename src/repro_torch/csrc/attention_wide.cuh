// Flash attention at wide heads, for sm_90a: q/k up to WIDE_QK = 576 and v
// up to WIDE_V = 512 wide.  These are MLA's absorbed-form widths at
// deepseek-v3 (kv_lora_rank + qk_rope_head_dim = 512 + 64 for q/k, the
// latent kv_lora_rank = 512 for v), MQA with one latent kv head shared by
// 128 query heads.  flash_attention.cu takes this route for any head over
// 128 wide; its other routes stop at 128.
//
// attention_tc.cuh's core does not fit here: at hdv 512 its 64 query rows a
// consumer warpgroup would hold 256 f32 accumulators a thread, and its
// 4-stage K+V ring at 576/512 wide would take 544 KB of shared memory.  f32
// inputs take flash_attention.cu's SIMT kernel, which chunks K and V at
// every width.
//
// This route (bf16, widths multiples of 8, 16-byte aligned): a block
// owns 64 query rows of one (batch, kv head), taken from the flattened
// (G x Sq) rows as the other routes do.  Q is staged once by TMA (9 boxes of
// 64 x 64, 72 KB); K and V each have one stage (72 KB and 64 KB), guarded
// by full/empty mbarriers, so that the producer loads K of tile j + 1 while
// the consumers multiply P V of tile j, and V of tile j + 1 while they
// multiply Q K^T.  Both consumer warpgroups compute the same S = Q K^T
// (wgmma with Q and K in shared memory) and the same online softmax, and
// each accumulates its half of the output columns (256 of hdv) with P as
// P_hi + P_lo, as attention_tc.cuh does: S is computed twice, the price of
// fitting 227 KB without sharing S through shared memory.  Live kv tiles
// only (live_kv_tiles), masks on the edge tiles.

#pragma once

#include "attention_tc.cuh"

namespace repro {

constexpr int WIDE_QK = 576;   // widest q/k head
constexpr int WIDE_V = 512;    // widest v head
constexpr int WROWS = 64;      // query rows per block

namespace tc {

constexpr int WIDE_KSTEPS = WIDE_QK / 16;   // k16 steps of Q K^T
constexpr int WIDE_QBOXES = WIDE_QK / 64;
constexpr int WIDE_VBOXES = WIDE_V / 64;

struct WideTcSmem {
  static constexpr int Q_BYTES = WIDE_QBOXES * BOX_BYTES;   // 72 KB
  static constexpr int K_BYTES = WIDE_QBOXES * BOX_BYTES;   // 72 KB
  static constexpr int V_BYTES = WIDE_VBOXES * BOX_BYTES;   // 64 KB
  static constexpr int BARS = Q_BYTES + K_BYTES + V_BYTES;
  static constexpr int BYTES = BARS + 5 * 8 + 1024;         // + align
};

// acc (64 x 128 accumulators of m64n128) *= alpha of its two rows
__device__ __forceinline__ void rescale(float (&acc)[64],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * i + 2 * h] *= alpha[h];
      acc[4 * i + 2 * h + 1] *= alpha[h];
    }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_wide_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     bf16* __restrict__ out, AttnShape sh) {
  using L = WideTcSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::Q_BYTES, v_s = k_s + L::K_BYTES;
  const uint32_t q_full = base + L::BARS, k_full = q_full + 8,
                 k_empty = q_full + 16, v_full = q_full + 24,
                 v_empty = q_full + 32;
  const int G = sh.Hq / sh.Hkv, nrows = G * sh.Sq;
  const int nrt = (nrows + WROWS - 1) / WROWS;
  // causal: the last row tiles (the longest live ranges) start first
  const int rt = sh.causal ? nrt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int t0 = rt * WROWS, kvh = blockIdx.y, b = blockIdx.z;
  const int bh = b * sh.Hkv + kvh;
  int qmin = 0, qmax = 0;
  const bool any = q_span(t0, min(t0 + WROWS, nrows), sh, qmin, qmax);
  const KvRange kv = live_kv_tiles(sh, any, qmin, qmax);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(k_empty, CONSUMERS);
    mbar_init(v_full, 1);
    mbar_init(v_empty, CONSUMERS);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {             // producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      const int qrow = (b * sh.Hq + kvh * G) * sh.Sq + t0;
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < WIDE_QBOXES; ++c)
        tma_load_2d(q_s + c * BOX_BYTES, &qmap, q_full, 64 * c, qrow);
      for (int j = kv.lo, it = 0; j < kv.hi; ++j, ++it) {
        if (it) mbar_wait(k_empty, (it - 1) & 1);
        mbar_expect_tx(k_full, L::K_BYTES);
        for (int c = 0; c < WIDE_QBOXES; ++c)
          tma_load_3d(k_s + c * BOX_BYTES, &kmap, k_full, 64 * c, j * BK, bh);
        if (it) mbar_wait(v_empty, (it - 1) & 1);
        mbar_expect_tx(v_full, L::V_BYTES);
        for (int c = 0; c < WIDE_VBOXES; ++c)
          tma_load_3d(v_s + c * BOX_BYTES, &vmap, v_full, 64 * c, j * BK, bh);
      }
    }
    return;
  }
  // consumer warpgroups: the same 64 rows; warpgroup wg owns the output
  // columns [256 wg, 256 wg + 256) as two m64n128 accumulators
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int w = (threadIdx.x / 32) % 4, t = lane % 4;
  float o[2][64];
  float m[2], l[2];
  int qpos[2], head[2], qi[2];
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = t0 + w * 16 + lane / 4 + 8 * h;
    valid[h] = r < nrows;
    head[h] = valid[h] ? kvh * G + r / sh.Sq : 0;
    qi[h] = valid[h] ? r % sh.Sq : 0;
    qpos[h] = qi[h] + sh.q_offset;
    m[h] = NEG_INF;
    l[h] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 64; ++i) o[n][i] = 0.f;
  mbar_wait(q_full, 0);

  for (int j = kv.lo, it = 0; j < kv.hi; ++j, ++it) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    mbar_wait(k_full, it & 1);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < WIDE_KSTEPS; ++ks)
      wgmma_ss<0>(s, desc_kmajor(q_s + (ks / 4) * BOX_BYTES + (ks % 4) * 32),
                  desc_kmajor(k_s + (ks / 4) * BOX_BYTES + (ks % 4) * 32), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    mbar_arrive(k_empty);

    float alpha[2];
    online_softmax(sh, j, qmin, qmax, t, qpos, s, m, l, alpha);
#pragma unroll
    for (int n = 0; n < 2; ++n)
      rescale(o[n], alpha);
    uint32_t p_hi[4][4], p_lo[4][4];
    split_p(s, p_hi, p_lo);

    mbar_wait(v_full, it & 1);
    fence_regs(o[0]);
    fence_regs(o[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        wgmma_rs<1>(o[n], p_hi[kk],
                    desc_mnmajor(v_s + (4 * wg + 2 * n) * BOX_BYTES + kk * 2048), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        wgmma_rs<1>(o[n], p_lo[kk],
                    desc_mnmajor(v_s + (4 * wg + 2 * n) * BOX_BYTES + kk * 2048), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o[0]);
    fence_regs(o[1]);
    fence_regs(p_hi);
    fence_regs(p_lo);
    mbar_arrive(v_empty);
  }

  // out = O / l; a row with no live key takes l = Sk (see attention_tc.cuh)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffff, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffff, l[h], 2);
    if (m[h] == NEG_INF) l[h] = (float)sh.Sk;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!valid[h]) continue;
    const float lh = l[h] == 0.f ? 1.f : l[h], inv = 1.f / lh;
    if (sh.lse && t == 0 && wg == 0)
      sh.lse[(size_t)(b * sh.Hq + head[h]) * sh.Sq + qi[h]] = m[h] + logf(lh);
    bf16* dst = out + ((size_t)(b * sh.Hq + head[h]) * sh.Sq + qi[h]) * sh.hdv;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 256 * wg + 128 * n + 8 * i + 2 * t;
        if (col < sh.hdv)
          *reinterpret_cast<uint32_t*>(dst + col) =
              pack_bf16(o[n][4 * i + 2 * h] * inv, o[n][4 * i + 2 * h + 1] * inv);
      }
  }
}

inline int launch_wide(const void* q, const void* k, const void* v, void* out,
                       const AttnShape& sh, cudaStream_t stream) {
  using L = WideTcSmem;
  CUtensorMap qmap, kmap, vmap;
  const uint64_t bh = (uint64_t)sh.B * sh.Hkv;
  int err = make_map_2d(&qmap, q, sh.hd, (uint64_t)sh.B * sh.Hq * sh.Sq,
                        (uint64_t)sh.hd * 2, WROWS);
  if (!err)
    err = make_map(&kmap, k, sh.hd, sh.Sk, bh, (uint64_t)sh.hd * 2,
                   (uint64_t)sh.Sk * sh.hd * 2, BK, 1);
  if (!err)
    err = make_map(&vmap, v, sh.hdv, sh.Sk, bh, (uint64_t)sh.hdv * 2,
                   (uint64_t)sh.Sk * sh.hdv * 2, BK, 1);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wide_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int G = sh.Hq / sh.Hkv;
  dim3 grid((G * sh.Sq + WROWS - 1) / WROWS, sh.Hkv, sh.B);
  note_launch(2, grid, WROWS, BK);
  flash_wide_tc_kernel<<<grid, THREADS, L::BYTES, stream>>>(
      qmap, kmap, vmap, (bf16*)out, sh);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace repro
