// The flash backward's wide route in bf16 (heads over 128: MLA's q/k 576,
// v 512), for sm_90a: the redesign of attention_bwd_wide.cuh's tensor-core
// kernels, which stay there (route 3 of the C interface, the parent, for
// timing) beside the f32 SIMT kernels (the f32 wide route).
//
// What bounds it on the H100: operations (369.7 GFLOP of the function at
// deepseek-v3's causal 1024, 0.374 ms at the bf16 peak; with P and dS
// taken as hi + lo in the dK, dV and dQ products, ~590 GFLOP of tensor
// products).  What the parent paid besides (6.78 ms):
//   * every 64-column block of dK, dV and dQ read its P or dS tile from f32
//     scratch and split it into hi + lo again (17 times for dK/dV, 9 for
//     dQ: up to ~7 GB of scratch reads a call);
//   * its dK/dV kernel ran 272 blocks a head group, and causality gave key
//     tile 0's blocks 16x tile 15's work: the launch lasted as long as tile
//     0's serial chain of 64 heads x 16 query spans;
//   * each step loaded, waited and computed (cp.async wait<0>, barrier).
// This design, four kernels a head group (wide_probs_wg, wide_dkv_wg,
// wide_dkv_sum, wide_dq_wg) plus the delta pass, one warpgroup a block:
//   * P and dS are written once, by wide_probs_wg (64 query rows x 128
//     keys a block, two blocks an SM), as bf16 hi and lo planes in the
//     form the products read (TMA boxes of 64 x 64, 128-byte swizzled), so
//     nothing splits them again;
//   * a dK/dV block (one warpgroup) owns 64 keys x 192 columns (three
//     boxes; dK's 576 in three blocks, dV's 512 in three) and a dQ block 64
//     rows x 192 columns: each P/dS tile is read 3 times a product, not 9
//     or 8;
//   * the dK/dV contraction over (head, query span) is split over
//     `splits` blocks a key tile (the group's heads cut in even slices),
//     whose f32 partials wide_dkv_sum adds in slice order (then the earlier
//     groups' sum): 16 x 16 x 6 = 1,536 blocks a group at deepseek-v3's
//     1024, key tile 0's chain 4 heads x 16 spans long;
//   * every product is a wgmma (m64nNk16, f32 accumulators; N = 64 a
//     box: one N = 192 product for three boxes measured slower) on TMA-fed
//     shared memory; each block keeps a ring of stages in flight (mbarrier
//     per stage), the next stage's loads issued as soon as a stage is
//     consumed;
//   * each query span's (dK/dV) or kv tile's (dQ) products are summed
//     apart in their own accumulators and then added to the running sum by
//     f32 adds: the tensor cores add into an accumulator without IEEE
//     rounding, and over dK's 128 heads x Sq rows of one accumulator that
//     bias reached 4x the bf16 limit on the card (attention_bwd_wide.cuh).
// Products: S = Q K^T and dP = dO V^T (K-major A and B), dK = dS^T Q and
// dV = P^T dO (A the [query][key] plane read MN-major, B Q or dO rows
// MN-major), dQ = dS K (A K-major, B K's rows MN-major).  No atomics: every
// element is written by one block a launch and the launches run in order,
// so two calls give bitwise-equal gradients.  A row with no live key keeps
// the rule of the other routes (P = 1 / Sk on the keys below Sk, dS = 0).
#pragma once

#include "attention_bwd_wide.cuh"

namespace repro {
namespace wbwd {

using tc::BOX_BYTES;
constexpr int WGT = 128;          // one warpgroup a block
constexpr int PROBS_STAGES = 4;   // wide_probs_wg: 64 rows and 128 keys
constexpr int PROBS_STAGE = 3 * BOX_BYTES;
constexpr int DKV_STAGES = 2;     // wide_dkv_wg, wide_dq_wg: A hi, lo + B boxes
constexpr int COL_BOXES = 3;      // 64-column boxes a dK/dV/dQ block owns
constexpr int MAX_SPLITS = 16;    // most dK/dV blocks a key tile
constexpr int SUM_NT = 256;
constexpr int PLANES = 4;         // P hi, P lo, dS hi, dS lo
constexpr int STAGE_BYTES = (2 + COL_BOXES) * BOX_BYTES;

__host__ __device__ inline int boxes(int width) { return (width + 63) / 64; }
__host__ __device__ inline int col_blocks(int width) {
  return (boxes(width) + COL_BOXES - 1) / COL_BOXES;
}
// The dK/dV blocks a key tile for a group of gc heads.
__host__ __device__ inline int dkv_splits(int gc) {
  return gc < MAX_SPLITS ? gc : MAX_SPLITS;
}

struct Planes {
  int zc;            // z slots of a plane (B * Hkv * gc of the call)
  int skp;           // keys padded to 64
};

__device__ __forceinline__ void stage_wait(uint32_t bar, int it, int stages) {
  tc::mbar_wait(bar + 8 * (it % stages), (it / stages) & 1);
}

// P and dS of 64 query rows of one head against 128 keys (kv tiles 2 jb
// and 2 jb + 1), one warpgroup, two blocks an SM (one's P/dS epilogue runs
// beside the other's products): S over q/k's boxes, then dP over v's, a
// stage holding the row box and the two key boxes; the products of one
// stage stay in flight while the next is issued.  Only the live 64 x 64
// sub-tiles are written, as the four bf16 planes.
__global__ void __launch_bounds__(WGT, 2)
wide_probs_wg(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap domap,
              const __grid_constant__ CUtensorMap vmap,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ planes, AttnShape sh, Group gr, Planes pl) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + PROBS_STAGES * PROBS_STAGE;
  __shared__ float lse_s[W], dl_s[W];
  const int q0 = blockIdx.x * W, jb = blockIdx.y, z = blockIdx.z;
  const int gi = z % gr.gc, bkv = z / gr.gc;
  const int kvh = bkv % sh.Hkv, b = bkv / sh.Hkv;
  const int G = sh.Hq / sh.Hkv, g = gr.g0 + gi, head = kvh * G + g;
  const int kt = (sh.Sk + W - 1) / W;
  const tc::KvRange kv = bwd::span_tiles(sh, g, q0);
  bool live[2];
#pragma unroll
  for (int wk = 0; wk < 2; ++wk) {
    const int jt = 2 * jb + wk;
    live[wk] = jt < kt && jt >= kv.lo && jt < kv.hi;
  }
  if (!live[0] && !live[1]) return;
  const int tid = threadIdx.x, bq = b * sh.Hq + head;
  const size_t row0 = (size_t)bq * sh.Sq;
  const int nk = boxes(sh.hd), nch = nk + boxes(sh.hdv);
  auto issue = [&](int c) {
    const int st = c % PROBS_STAGES;
    const uint32_t bar = full + 8 * st, a = base + st * PROBS_STAGE;
    const bool qk = c < nk;
    const int col = 64 * (qk ? c : c - nk);
    const CUtensorMap* keys = qk ? &kmap : &vmap;
    tc::mbar_expect_tx(bar, 3 * BOX_BYTES);
    tc::tma_load_3d(a, qk ? &qmap : &domap, bar, col, q0, bq);
    tc::tma_load_3d(a + BOX_BYTES, keys, bar, col, 2 * W * jb, bkv);
    tc::tma_load_3d(a + 2 * BOX_BYTES, keys, bar, col, 2 * W * jb + W, bkv);
  };
  if (tid == 0) {
    for (int s = 0; s < PROBS_STAGES; ++s) tc::mbar_init(full + 8 * s, 1);
    tc::mbar_init_fence();
    for (int c = 0; c < PROBS_STAGES && c < nch; ++c) issue(c);
  }
  if (tid < W) {
    const int qi = q0 + tid;
    lse_s[tid] = qi < sh.Sq ? lse[row0 + qi] : 0.f;
    dl_s[tid] = qi < sh.Sq ? delta[row0 + qi] : 0.f;
  }
  __syncthreads();
  float s[64], dp[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = dp[i] = 0.f;
  for (int c = 0; c < nch; ++c) {
    stage_wait(full, c, PROBS_STAGES);
    const uint32_t a = base + (c % PROBS_STAGES) * PROBS_STAGE;
    const uint32_t kb = a + BOX_BYTES;
    tc::fence_regs(s);
    tc::fence_regs(dp);
    tc::wgmma_fence();
    if (c < nk) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        tc::wgmma_ss<0>(s, tc::desc_kmajor(a + ks * 32),
                        tc::desc_kmajor(kb + ks * 32), 1);
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        tc::wgmma_ss<0>(dp, tc::desc_kmajor(a + ks * 32),
                        tc::desc_kmajor(kb + ks * 32), 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();       // the stage before is consumed
    tc::fence_regs(s);
    tc::fence_regs(dp);
    __syncthreads();           // ... by every warp
    if (tid == 0 && c >= 1 && c - 1 + PROBS_STAGES < nch)
      issue(c - 1 + PROBS_STAGES);
  }
  tc::wgmma_wait_all();
  tc::fence_regs(s);
  tc::fence_regs(dp);
  const tc::Frag f;
  const size_t plane = (size_t)pl.zc * sh.Sq * pl.skp;
  const float inv_sk = sh.Sk > 0 ? 1.f / sh.Sk : 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = f.r0 + 8 * h, qi = q0 + row;
    if (qi >= sh.Sq) continue;
    const int qpos = qi + sh.q_offset;
    const float l = lse_s[row], dl = dl_s[row];
    const bool dead = l <= bwd::DEAD;
    bf16* out = planes + ((size_t)z * sh.Sq + qi) * pl.skp
                + (size_t)jb * 2 * W;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (!live[i / 8]) continue;
      float pv[2], dv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * f.t + e, kpos = jb * 2 * W + col;
        const int x = 4 * i + 2 * h + e;
        bool ok = kpos < sh.kv_len;
        if (sh.causal) ok = ok && kpos <= qpos;
        if (sh.window > 0) ok = ok && kpos > qpos - sh.window;
        float p = 0.f;
        if (dead)
          p = kpos < sh.Sk ? inv_sk : 0.f;
        else if (ok)
          p = expf(s[x] * sh.scale - l);
        pv[e] = p;
        dv[e] = ok && !dead ? p * (dp[x] - dl) * sh.scale : 0.f;
      }
      uint32_t ph, plo, dh, dlo;
      wm::split2(pv[0], pv[1], ph, plo);
      wm::split2(dv[0], dv[1], dh, dlo);
      const int col = 8 * i + 2 * f.t;
      *reinterpret_cast<uint32_t*>(out + col) = ph;
      *reinterpret_cast<uint32_t*>(out + plane + col) = plo;
      *reinterpret_cast<uint32_t*>(out + 2 * plane + col) = dh;
      *reinterpret_cast<uint32_t*>(out + 3 * plane + col) = dlo;
    }
  }
}

// The next live (head slot hg, query tile qt) of a dK/dV block for key tile
// j, from (hg, qt) on; false past the block's last head slot hg1.
__device__ __forceinline__ bool next_span(const AttnShape& sh, int g0, int j,
                                          int hg1, int& hg, int& qt) {
  const int nq = (sh.Sq + W - 1) / W;
  while (hg < hg1) {
    if (qt < nq) {
      const tc::KvRange kv = bwd::span_tiles(sh, g0 + hg, qt * W);
      if (j >= kv.lo && j < kv.hi) return true;
      ++qt;
    } else {
      qt = 0;
      ++hg;
    }
  }
  return false;
}

// One dK or dV block: kv tile j, 64 keys x up to COL_BOXES boxes of
// columns, summed over the group's head slots [hg0, hg1) of split s and
// their live query spans: dK += dS^T Q, dV += P^T dO, each span's
// products (hi and lo) summed apart, then added in f32.  Writes the f32
// partial (64 x (hd + hdv) a split) for wide_dkv_sum.
__global__ void __launch_bounds__(WGT, 2)
wide_dkv_wg(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap domap,
            const __grid_constant__ CUtensorMap smap,
            float* __restrict__ part, AttnShape sh, Group gr, Planes pl,
            int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + DKV_STAGES * STAGE_BYTES;
  const int kt = (sh.Sk + W - 1) / W;
  const int sp = blockIdx.x, cb = blockIdx.y;
  const int j = blockIdx.z % kt, bkv = blockIdx.z / kt;
  const int kvh = bkv % sh.Hkv, b = bkv / sh.Hkv, G = sh.Hq / sh.Hkv;
  const int cbk = col_blocks(sh.hd);
  const bool is_k = cb < cbk;
  const int box0 = (is_k ? cb : cb - cbk) * COL_BOXES;
  const int nbox = min(COL_BOXES, boxes(is_k ? sh.hd : sh.hdv) - box0);
  const int plane0 = is_k ? 2 : 0;            // dS or P, hi then lo
  const int hg0 = sp * gr.gc / splits, hg1 = (sp + 1) * gr.gc / splits;
  const CUtensorMap* rows = is_k ? &qmap : &domap;
  const int tid = threadIdx.x;
  int nsteps = 0;
  for (int hg = hg0, qt = 0; next_span(sh, gr.g0, j, hg1, hg, qt); ++qt)
    ++nsteps;
  int phg = hg0, pqt = 0;                     // thread 0's load cursor
  auto issue = [&](int it) {
    next_span(sh, gr.g0, j, hg1, phg, pqt);
    const int st = it % DKV_STAGES;
    const uint32_t bar = full + 8 * st, a = base + st * STAGE_BYTES;
    const int zs = bkv * gr.gc + phg, bq = b * sh.Hq + kvh * G + gr.g0 + phg;
    tc::mbar_expect_tx(bar, (2 + nbox) * BOX_BYTES);
    tc::tma_load_3d(a, &smap, bar, j * W, pqt * W, plane0 * pl.zc + zs);
    tc::tma_load_3d(a + BOX_BYTES, &smap, bar, j * W, pqt * W,
                    (plane0 + 1) * pl.zc + zs);
    for (int bx = 0; bx < nbox; ++bx)
      tc::tma_load_3d(a + (2 + bx) * BOX_BYTES, rows, bar,
                      64 * (box0 + bx), pqt * W, bq);
    ++pqt;
  };
  if (tid == 0) {
    for (int s = 0; s < DKV_STAGES; ++s) tc::mbar_init(full + 8 * s, 1);
    tc::mbar_init_fence();
    for (int it = 0; it < DKV_STAGES && it < nsteps; ++it) issue(it);
  }
  __syncthreads();
  float acc[COL_BOXES][32], pt[COL_BOXES][32];
#pragma unroll
  for (int bx = 0; bx < COL_BOXES; ++bx)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[bx][i] = pt[bx][i] = 0.f;
  for (int it = 0; it < nsteps; ++it) {
    stage_wait(full, it, DKV_STAGES);
    const uint32_t ahi = base + (it % DKV_STAGES) * STAGE_BYTES;
    const uint32_t alo = ahi + BOX_BYTES, xs = alo + BOX_BYTES;
#pragma unroll
    for (int bx = 0; bx < COL_BOXES; ++bx) tc::fence_regs(pt[bx]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t ah = tc::desc_mnmajor(ahi + kk * 2048);
      const uint64_t al = tc::desc_mnmajor(alo + kk * 2048);
#pragma unroll
      for (int bx = 0; bx < COL_BOXES; ++bx) {
        if (bx >= nbox) break;
        const uint64_t xb = tc::desc_mnmajor(xs + bx * BOX_BYTES + kk * 2048);
        tc::wgmma_ss_t<1, 1>(pt[bx], ah, xb, kk > 0);
        tc::wgmma_ss_t<1, 1>(pt[bx], al, xb, 1);
      }
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
#pragma unroll
    for (int bx = 0; bx < COL_BOXES; ++bx) {
      tc::fence_regs(pt[bx]);
      if (bx < nbox) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[bx][i] += pt[bx][i];
      }
    }
    __syncthreads();   // every warp is done with the stage
    if (tid == 0 && it + DKV_STAGES < nsteps) issue(it + DKV_STAGES);
  }
  const tc::Frag f;
  const int wtot = sh.hd + sh.hdv, col0 = (is_k ? 0 : sh.hd) + 64 * box0;
  const int width = is_k ? sh.hd : sh.hdv;
  float* out = part + (((size_t)bkv * kt + j) * splits + sp) * W * wtot;
#pragma unroll
  for (int bx = 0; bx < COL_BOXES; ++bx) {
    if (bx >= nbox) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = out + (size_t)(f.r0 + 8 * h) * wtot + col0 + 64 * bx;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 64 * (box0 + bx) + 8 * i + 2 * f.t;
        if (c < width)
          *reinterpret_cast<float2*>(row + 8 * i + 2 * f.t) =
              make_float2(acc[bx][4 * i + 2 * h], acc[bx][4 * i + 2 * h + 1]);
      }
    }
  }
}

// dK and dV of one group: each element's split partials added in split
// order, then to the earlier groups' f32 sum (unless first); the last
// group writes the bf16 gradient, the others the f32 sum.
__global__ void __launch_bounds__(SUM_NT)
wide_dkv_sum(const float* __restrict__ part, float* __restrict__ dk_acc,
             float* __restrict__ dv_acc, bf16* __restrict__ dk,
             bf16* __restrict__ dv, AttnShape sh, int splits, int first,
             int last) {
  const int kt = (sh.Sk + W - 1) / W, wtot = sh.hd + sh.hdv;
  const size_t total = (size_t)sh.B * sh.Hkv * sh.Sk * wtot;
  for (size_t e = blockIdx.x * (size_t)SUM_NT + threadIdx.x; e < total;
       e += (size_t)gridDim.x * SUM_NT) {
    const int col = (int)(e % wtot);
    const size_t key = e / wtot;               // bkv * Sk + kpos
    const int kpos = (int)(key % sh.Sk), bkv = (int)(key / sh.Sk);
    const int j = kpos / W, kl = kpos - j * W;
    const float* p = part + (((size_t)bkv * kt + j) * splits * W + kl) * wtot
                     + col;
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += p[(size_t)s * W * wtot];
    const bool is_k = col < sh.hd;
    const size_t idx = is_k ? key * sh.hd + col : key * sh.hdv + col - sh.hd;
    float* sum = is_k ? dk_acc : dv_acc;
    if (!first) v = sum[idx] + v;
    if (last)
      (is_k ? dk : dv)[idx] = __float2bfloat16(v);
    else
      sum[idx] = v;
  }
}

// dQ of 64 query rows of one head, up to COL_BOXES boxes of columns: over
// the span's live kv tiles, dQ += dS K (dS hi and lo), each tile's products
// summed apart, then added in f32.
__global__ void __launch_bounds__(WGT, 2)
wide_dq_wg(const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap smap, bf16* __restrict__ dq,
           AttnShape sh, Group gr, Planes pl) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + DKV_STAGES * STAGE_BYTES;
  const int q0 = blockIdx.x * W, cb = blockIdx.y, z = blockIdx.z;
  const int gi = z % gr.gc, bkv = z / gr.gc;
  const int kvh = bkv % sh.Hkv, b = bkv / sh.Hkv;
  const int G = sh.Hq / sh.Hkv, g = gr.g0 + gi, head = kvh * G + g;
  const tc::KvRange kv = bwd::span_tiles(sh, g, q0);
  const int box0 = cb * COL_BOXES;
  const int nbox = min(COL_BOXES, boxes(sh.hd) - box0);
  const int nsteps = kv.hi > kv.lo ? kv.hi - kv.lo : 0;
  const int tid = threadIdx.x;
  auto issue = [&](int it) {
    const int st = it % DKV_STAGES, jt = kv.lo + it;
    const uint32_t bar = full + 8 * st, a = base + st * STAGE_BYTES;
    tc::mbar_expect_tx(bar, (2 + nbox) * BOX_BYTES);
    tc::tma_load_3d(a, &smap, bar, jt * W, q0, 2 * pl.zc + z);
    tc::tma_load_3d(a + BOX_BYTES, &smap, bar, jt * W, q0, 3 * pl.zc + z);
    for (int bx = 0; bx < nbox; ++bx)
      tc::tma_load_3d(a + (2 + bx) * BOX_BYTES, &kmap, bar, 64 * (box0 + bx),
                      jt * W, bkv);
  };
  if (tid == 0) {
    for (int s = 0; s < DKV_STAGES; ++s) tc::mbar_init(full + 8 * s, 1);
    tc::mbar_init_fence();
    for (int it = 0; it < DKV_STAGES && it < nsteps; ++it) issue(it);
  }
  __syncthreads();
  float acc[COL_BOXES][32], pt[COL_BOXES][32];
#pragma unroll
  for (int bx = 0; bx < COL_BOXES; ++bx)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[bx][i] = pt[bx][i] = 0.f;
  for (int it = 0; it < nsteps; ++it) {
    stage_wait(full, it, DKV_STAGES);
    const uint32_t ahi = base + (it % DKV_STAGES) * STAGE_BYTES;
    const uint32_t alo = ahi + BOX_BYTES, ks_ = alo + BOX_BYTES;
#pragma unroll
    for (int bx = 0; bx < COL_BOXES; ++bx) tc::fence_regs(pt[bx]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t ah = tc::desc_kmajor(ahi + kk * 32);
      const uint64_t al = tc::desc_kmajor(alo + kk * 32);
#pragma unroll
      for (int bx = 0; bx < COL_BOXES; ++bx) {
        if (bx >= nbox) break;
        const uint64_t kb = tc::desc_mnmajor(ks_ + bx * BOX_BYTES + kk * 2048);
        tc::wgmma_ss<1>(pt[bx], ah, kb, kk > 0);
        tc::wgmma_ss<1>(pt[bx], al, kb, 1);
      }
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
#pragma unroll
    for (int bx = 0; bx < COL_BOXES; ++bx) {
      tc::fence_regs(pt[bx]);
      if (bx < nbox) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[bx][i] += pt[bx][i];
      }
    }
    __syncthreads();   // every warp is done with the stage
    if (tid == 0 && it + DKV_STAGES < nsteps) issue(it + DKV_STAGES);
  }
  const tc::Frag f;
  const size_t row0 = (size_t)(b * sh.Hq + head) * sh.Sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + f.r0 + 8 * h;
    if (qi >= sh.Sq) continue;
#pragma unroll
    for (int bx = 0; bx < COL_BOXES; ++bx) {
      if (bx >= nbox) break;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * (box0 + bx) + 8 * i + 2 * f.t;
        if (col < sh.hd)
          *reinterpret_cast<__nv_bfloat162*>(dq + (row0 + qi) * sh.hd + col) =
              __floats2bfloat162_rn(acc[bx][4 * i + 2 * h],
                                    acc[bx][4 * i + 2 * h + 1]);
      }
    }
  }
}

// Scratch of the bf16 route, in floats: the four bf16 planes of P and dS
// for gc heads of every (batch, kv head) (the bytes of f32 P and dS), the
// dK/dV split partials, and, when the heads take more than one group, the
// f32 sums of dK and dV.
inline size_t wg_scratch_floats(const AttnShape& sh, int gc) {
  const size_t skp = (size_t)(sh.Sk + W - 1) / W * W;
  const size_t kt = (sh.Sk + W - 1) / W;
  const size_t planes = 2 * (size_t)sh.B * sh.Hkv * gc * sh.Sq * skp;
  const size_t parts = (size_t)sh.B * sh.Hkv * kt * dkv_splits(gc) * W
                       * (sh.hd + sh.hdv);
  const int G = sh.Hq / sh.Hkv;
  const size_t sums = gc < G ? (size_t)sh.B * sh.Hkv * sh.Sk * (sh.hd + sh.hdv)
                             : 0;
  return planes + parts + sums;
}

constexpr int PROBS_SMEM = PROBS_STAGES * PROBS_STAGE + 8 * PROBS_STAGES + 1024;
constexpr int DKV_SMEM = DKV_STAGES * STAGE_BYTES + 8 * DKV_STAGES + 1024;

inline int launch_wg(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv,
                     float* scratch, int gc, const AttnShape& sh,
                     cudaStream_t stream) {
  int err = bwd::launch_delta<bf16>(out, dout, delta, sh.B * sh.Hq * sh.Sq,
                                    sh.hdv, stream);
  if (err || sh.Sq == 0 || sh.Sk == 0) return err;
  const int G = sh.Hq / sh.Hkv;
  const int skp = (sh.Sk + W - 1) / W * W;
  const int qt = (sh.Sq + W - 1) / W, kt = (sh.Sk + W - 1) / W;
  const Planes pl{sh.B * sh.Hkv * gc, skp};
  bf16* planes = reinterpret_cast<bf16*>(scratch);
  float* part = scratch + 2 * (size_t)pl.zc * sh.Sq * skp;
  float* dk_acc = part + (size_t)sh.B * sh.Hkv * kt * dkv_splits(gc) * W
                         * (sh.hd + sh.hdv);
  float* dv_acc = dk_acc + (size_t)sh.B * sh.Hkv * sh.Sk * sh.hd;
  const uint64_t bq = (uint64_t)sh.B * sh.Hq, bkv = (uint64_t)sh.B * sh.Hkv;
  CUtensorMap qmap, kmap, vmap, domap, smap;
  if ((err = tc::make_map(&qmap, q, sh.hd, sh.Sq, bq, (uint64_t)sh.hd * 2,
                          (uint64_t)sh.Sq * sh.hd * 2, 64, 1)) ||
      (err = tc::make_map(&domap, dout, sh.hdv, sh.Sq, bq, (uint64_t)sh.hdv * 2,
                          (uint64_t)sh.Sq * sh.hdv * 2, 64, 1)) ||
      (err = tc::make_map(&kmap, k, sh.hd, sh.Sk, bkv, (uint64_t)sh.hd * 2,
                          (uint64_t)sh.Sk * sh.hd * 2, 64, 1)) ||
      (err = tc::make_map(&vmap, v, sh.hdv, sh.Sk, bkv, (uint64_t)sh.hdv * 2,
                          (uint64_t)sh.Sk * sh.hdv * 2, 64, 1)) ||
      (err = tc::make_map(&smap, planes, skp, sh.Sq, (uint64_t)PLANES * pl.zc,
                          (uint64_t)skp * 2, (uint64_t)sh.Sq * skp * 2, 64, 1)))
    return err;
  static unsigned long long done_p = 0, done_kv = 0, done_q = 0;
  if ((err = bwd::set_smem(wide_probs_wg, PROBS_SMEM, done_p)) ||
      (err = bwd::set_smem(wide_dkv_wg, DKV_SMEM, done_kv)) ||
      (err = bwd::set_smem(wide_dq_wg, DKV_SMEM, done_q)))
    return err;
  const int ncb = col_blocks(sh.hd) + col_blocks(sh.hdv);
  const size_t elems = (size_t)sh.B * sh.Hkv * sh.Sk * (sh.hd + sh.hdv);
  const size_t sum_blocks = (elems + SUM_NT - 1) / SUM_NT;
  for (int g0 = 0; g0 < G; g0 += gc) {
    const Group gr{g0, gc < G - g0 ? gc : G - g0};
    const unsigned zc = (unsigned)(sh.B * sh.Hkv * gr.gc);
    const int splits = dkv_splits(gr.gc);
    wide_probs_wg<<<dim3(qt, (kt + 1) / 2, zc), WGT, PROBS_SMEM,
                    stream>>>(
        qmap, kmap, domap, vmap, lse, delta, planes, sh, gr, pl);
    wide_dkv_wg<<<dim3(splits, ncb, kt * (unsigned)bkv), WGT, DKV_SMEM,
                  stream>>>(qmap, domap, smap, part, sh, gr, pl, splits);
    wide_dkv_sum<<<(unsigned)(sum_blocks < 8192 ? sum_blocks : 8192), SUM_NT,
                   0, stream>>>(part, dk_acc, dv_acc, (bf16*)dk, (bf16*)dv,
                                sh, splits, g0 == 0, g0 + gr.gc >= G);
    wide_dq_wg<<<dim3(qt, col_blocks(sh.hd), zc), WGT, DKV_SMEM, stream>>>(
        kmap, smap, (bf16*)dq, sh, gr, pl);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

}  // namespace wbwd
}  // namespace repro
