// The flash backward at wide heads, for sm_90a: q/k up to 576 and v up to
// 512 wide, both dtypes.  These are MLA's absorbed-form widths at
// deepseek-v3: 128 query heads over one latent kv head, q/k =
// kv_lora_rank + qk_rope_head_dim = 576, v = 512.  flash_attention_bwd.cu
// takes this route ("wide") for any head over 128; its tc and simt routes
// stop at 128.
//
// Replaces, with the other routes: src/repro/kernels/flash_vjp.py:114
// (_flash_bwd), which the JAX training path runs at these widths through
// jnp_blocked.flash_attention_jnp (ops.mla_latent_attention).
//
// What bounds it on the H100: operations, 2.5x the forward's over the live
// pairs (369.7 GFLOP at deepseek-v3's causal 1024, 0.374 ms at the bf16
// peak).
//
// What is hard at these widths: a block that owned 64 keys would hold
// dK (64 x 576) and dV (64 x 512) in f32, 278 KB, more than a block's
// registers or shared memory; and with one kv head, the keys' gradients
// sum over 128 heads x Sq query rows while only Sk / 64 key tiles run in
// parallel.  So the route splits the work into three kernels on 64 x 64
// tiles, over the query heads of each kv head in groups of `gc` (the
// wrapper's blocked.flash_bwd_wide_heads, which bounds the scratch):
//   wide_probs  per (64 query rows, kv tile, head of the group): S = Q K^T
//               and dP = dO V^T over the full widths in 64-column chunks,
//               then P and dS = P (dP - delta) scale, written to f32
//               scratch (only the live tiles are computed and read);
//   wide_dkv    per (kv tile, 64 columns of [dK | dV], kv head): dK = dS^T Q
//               or dV = P^T dO over the group's heads and live query spans;
//               each group adds to the f32 sum of the groups before it, in
//               group order, and the last writes the gradient;
//   wide_dq     per (64 query rows, 64 columns of dQ, head): dQ = dS K over
//               the row span's live kv tiles.
// bf16 inputs (widths multiples of 8, tensors 16-byte aligned: tc_ok; the
// launch fails otherwise) run the redesign of attention_bwd_wide_tc.cuh;
// the first tensor-core kernels (the *_tc kernels below, on mma.sync) stay
// reachable as route 3 of the C interface, the parent, for timing.  f32
// inputs run these three kernels on SIMT f32 FMAs (the thread (ty, tx) of a 16 x 16
// grid owning rows ty + 16i and columns tx + 16c, i, c < 4, of a tile).  Every gradient element is written by one block a launch, the
// launches run in order: no atomics, bitwise reproducible.  S and dP are
// computed once per live tile pair (five products of the function); what
// it pays is P and dS through device memory.  A row with no live key has
// P = 1 / Sk on the Sk keys and no score gradient, as in the other routes
// (attention_bwd.cuh).
#pragma once

#include "attention_bwd.cuh"   // span_tiles, DEAD, to_f, from_f
#include "warp_mma.cuh"        // cp.async, ldmatrix, mma.sync, split2

#include <type_traits>

namespace repro {
namespace wbwd {

constexpr int W = 64;          // rows, keys and columns of a tile
constexpr int NT = bwd::NT;    // 256 threads, a 16 x 16 grid
constexpr int T16 = 16;
constexpr int MAX_QK = 576;    // widest q/k head
constexpr int MAX_V = 512;     // widest v head
constexpr int WS = W + 1;      // padded row stride of the tiles

// Heads g of the group [g0, g0 + gc) of kv head kvh of batch row b: blockIdx
// z = (b * Hkv + kvh) * gc + (g - g0).
struct Group {
  int g0, gc;
};

// acc += rows (64 query rows from row0 + q0) times keys (kv tile j from
// kb)^T over `width` columns, staged 64 columns at a time.
template <typename T>
__device__ __forceinline__ void chunk_products(
    const T* __restrict__ rows, const T* __restrict__ keys, int width,
    size_t row0, size_t kb, int q0, int j, const AttnShape& sh, float* a_s,
    float* b_s, float (&acc)[4][4]) {
  const int tid = threadIdx.x, tx = tid % T16, ty = tid / T16;
  for (int d0 = 0; d0 < width; d0 += W) {
    __syncthreads();   // the previous chunk's products are done
    for (int idx = tid; idx < W * W; idx += NT) {
      const int r = idx / W, d = idx % W, col = d0 + d;
      const int qi = q0 + r, kpos = j * W + r;
      a_s[r * WS + d] = qi < sh.Sq && col < width
                            ? to_f(rows[(row0 + qi) * width + col]) : 0.f;
      b_s[r * WS + d] = kpos < sh.Sk && col < width
                            ? to_f(keys[(kb + kpos) * width + col]) : 0.f;
    }
    __syncthreads();
    for (int d = 0; d < W; ++d) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = a_s[(ty + T16 * i) * WS + d];
        bv[i] = b_s[(tx + T16 * i) * WS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
  }
}

// P and dS of 64 query rows of one head against kv tile j.
template <typename T>
__global__ void __launch_bounds__(NT)
wide_probs(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ pbuf, float* __restrict__ dsbuf, AttnShape sh,
           Group gr) {
  __shared__ float a_s[W * WS], b_s[W * WS];
  __shared__ float lse_s[W], dl_s[W];
  __shared__ int qpos_s[W], valid_s[W];
  const int q0 = blockIdx.x * W, j = blockIdx.y, z = blockIdx.z;
  const int gi = z % gr.gc, bkv = z / gr.gc;
  const int kvh = bkv % sh.Hkv, b = bkv / sh.Hkv;
  const int G = sh.Hq / sh.Hkv, g = gr.g0 + gi, head = kvh * G + g;
  const tc::KvRange kv = bwd::span_tiles(sh, g, q0);
  if (j < kv.lo || j >= kv.hi) return;
  const int tid = threadIdx.x, tx = tid % T16, ty = tid / T16;
  const size_t row0 = (size_t)(b * sh.Hq + head) * sh.Sq;
  const size_t kb = (size_t)bkv * sh.Sk;
  if (tid < W) {
    const int qi = q0 + tid;
    const bool in = qi < sh.Sq;
    valid_s[tid] = in;
    qpos_s[tid] = qi + sh.q_offset;
    lse_s[tid] = in ? lse[row0 + qi] : 0.f;
    dl_s[tid] = in ? delta[row0 + qi] : 0.f;
  }
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
  // S over q/k's width, dP over v's
  chunk_products(q, k, sh.hd, row0, kb, q0, j, sh, a_s, b_s, s);
  chunk_products(dout, v, sh.hdv, row0, kb, q0, j, sh, a_s, b_s, dp);
  const int skp = (sh.Sk + W - 1) / W * W;
  const float inv_sk = sh.Sk > 0 ? 1.f / sh.Sk : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + T16 * i;
    if (!valid_s[r]) continue;
    const int qpos = qpos_s[r];
    const float l = lse_s[r], dl = dl_s[r];
    const bool dead = l <= bwd::DEAD;
    const size_t out = ((size_t)z * sh.Sq + q0 + r) * skp + (size_t)j * W;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tx + T16 * c, kpos = j * W + col;
      bool ok = kpos < sh.kv_len;
      if (sh.causal) ok = ok && kpos <= qpos;
      if (sh.window > 0) ok = ok && kpos > qpos - sh.window;
      float p = 0.f;
      if (dead)
        p = kpos < sh.Sk ? inv_sk : 0.f;
      else if (ok)
        p = expf(s[i][c] * sh.scale - l);
      pbuf[out + col] = p;
      dsbuf[out + col] = ok && !dead ? p * (dp[i][c] - dl) * sh.scale : 0.f;
    }
  }
}

// dK (blockIdx.y < the q/k column chunks) or dV of kv tile j, 64 columns,
// summed over the group's heads; dk_acc / dv_acc hold the earlier groups'
// f32 sum.
template <typename T>
__global__ void __launch_bounds__(NT)
wide_dkv(const T* __restrict__ q, const T* __restrict__ dout,
         const float* __restrict__ pbuf, const float* __restrict__ dsbuf,
         float* __restrict__ dk_acc, float* __restrict__ dv_acc,
         T* __restrict__ dk, T* __restrict__ dv, AttnShape sh, Group gr,
         int first, int last) {
  __shared__ float a_s[W * WS], x_s[W * WS];
  const int j = blockIdx.x, cc = blockIdx.y, bkv = blockIdx.z;
  const int kvh = bkv % sh.Hkv, b = bkv / sh.Hkv;
  const int G = sh.Hq / sh.Hkv, nkc = (sh.hd + W - 1) / W;
  const bool is_k = cc < nkc;
  const int col0 = (is_k ? cc : cc - nkc) * W;
  const int width = is_k ? sh.hd : sh.hdv;
  const float* buf = is_k ? dsbuf : pbuf;
  const T* src = is_k ? q : dout;
  const int tid = threadIdx.x, tx = tid % T16, ty = tid / T16;
  const int skp = (sh.Sk + W - 1) / W * W;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  for (int gi = 0; gi < gr.gc; ++gi) {
    const int g = gr.g0 + gi, head = kvh * G + g;
    const size_t z = (size_t)bkv * gr.gc + gi;
    const size_t row0 = (size_t)(b * sh.Hq + head) * sh.Sq;
    for (int q0 = 0; q0 < sh.Sq; q0 += W) {
      const tc::KvRange kv = bwd::span_tiles(sh, g, q0);
      if (j < kv.lo || j >= kv.hi) continue;
      __syncthreads();   // the previous span's products are done
      for (int idx = tid; idx < W * W; idx += NT) {
        const int r = idx / W, c = idx % W, qi = q0 + r;
        const bool in = qi < sh.Sq;
        a_s[r * WS + c] = in ? buf[(z * sh.Sq + qi) * skp + (size_t)j * W + c]
                             : 0.f;
        x_s[r * WS + c] = in && col0 + c < width
                              ? to_f(src[(row0 + qi) * width + col0 + c])
                              : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < W; ++r) {
        float av[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = a_s[r * WS + ty + T16 * i];
          xv[i] = x_s[r * WS + tx + T16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], xv[c], acc[i][c]);
      }
    }
  }
  float* sum = is_k ? dk_acc : dv_acc;
  T* out = is_k ? dk : dv;
  const size_t kb = (size_t)bkv * sh.Sk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = j * W + ty + T16 * i;
    if (kpos >= sh.Sk) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + tx + T16 * c;
      if (col >= width) continue;
      const size_t e = (kb + kpos) * width + col;
      const float val = first ? acc[i][c] : sum[e] + acc[i][c];
      if (last)
        out[e] = from_f<T>(val);
      else
        sum[e] = val;
    }
  }
}

// dQ of 64 query rows of one head, 64 columns, over the span's live tiles.
template <typename T>
__global__ void __launch_bounds__(NT)
wide_dq(const T* __restrict__ k, const float* __restrict__ dsbuf,
        T* __restrict__ dq, AttnShape sh, Group gr) {
  __shared__ float d_s[W * WS], k_s[W * WS];
  const int q0 = blockIdx.x * W, col0 = blockIdx.y * W, z = blockIdx.z;
  const int gi = z % gr.gc, bkv = z / gr.gc;
  const int kvh = bkv % sh.Hkv, b = bkv / sh.Hkv;
  const int G = sh.Hq / sh.Hkv, g = gr.g0 + gi, head = kvh * G + g;
  const tc::KvRange kv = bwd::span_tiles(sh, g, q0);
  const int tid = threadIdx.x, tx = tid % T16, ty = tid / T16;
  const int skp = (sh.Sk + W - 1) / W * W;
  const size_t kb = (size_t)bkv * sh.Sk;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  for (int j = kv.lo; j < kv.hi; ++j) {
    __syncthreads();   // the previous tile's products are done
    for (int idx = tid; idx < W * W; idx += NT) {
      const int r = idx / W, c = idx % W, qi = q0 + r, kpos = j * W + r;
      d_s[r * WS + c] = qi < sh.Sq
                            ? dsbuf[((size_t)z * sh.Sq + qi) * skp
                                    + (size_t)j * W + c]
                            : 0.f;
      k_s[r * WS + c] = kpos < sh.Sk && col0 + c < sh.hd
                            ? to_f(k[(kb + kpos) * sh.hd + col0 + c]) : 0.f;
    }
    __syncthreads();
    for (int key = 0; key < W; ++key) {
      float dv[4], kv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dv[i] = d_s[(ty + T16 * i) * WS + key];
        kv4[i] = k_s[key * WS + tx + T16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(dv[i], kv4[c], acc[i][c]);
    }
  }
  const size_t row0 = (size_t)(b * sh.Hq + head) * sh.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + T16 * i;
    if (qi >= sh.Sq) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + tx + T16 * c;
      if (col < sh.hd) dq[(row0 + qi) * sh.hd + col] = from_f<T>(acc[i][c]);
    }
  }
}

// ---- bf16 on the tensor cores: the same three kernels on mma.sync ----
//
// For bf16 inputs with q/k and v widths multiples of 8 and 16-byte aligned
// tensors (tc_ok), 4 warps a block, each warp 16 rows of the 64 x 64
// output tile (mma.sync m16n8k16, f32 accumulators; the fragment code of
// ssd_scan.cu's tc route): S = Q K^T and dP = dO V^T take the bf16 inputs
// as they are; dK = dS^T Q, dV = P^T dO and dQ = dS K take P and dS from
// the f32 scratch as bf16 hi + lo, two products each, as the tc route of
// the narrower heads does.  Tiles arrive by cp.async.  The tensor cores
// add a tile's products into their accumulators without IEEE rounding;
// over dK/dV's 128 heads x Sq rows that bias grew to 4x the bf16 limit
// at deepseek-v3's 1024 (on an H100), so each span's (dK/dV)
// or kv tile's (dQ) products are summed apart and added to the running
// sum by f32 adds.
constexpr int TCT = 128;       // threads of a tc block
constexpr int SD = W + 8;      // bf16 row stride: ldmatrix's rows in distinct banks
using wm::bf16;

inline bool tc_ok(const AttnShape& sh, const void* q, const void* k,
                  const void* v, const void* dout) {
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  return sh.hd % 8 == 0 && sh.hdv % 8 == 0 && aligned(q) && aligned(k) &&
         aligned(v) && aligned(dout);
}

// Rows r0 .. r0 + 63 (of nrows, from row0) and columns c0 .. c0 + 63 of a
// row-major bf16 matrix `width` wide into dst: 16-byte copies, zero past
// nrows and width (a multiple of 8).
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t row0, int r0, int nrows,
                                          int c0, int width) {
  for (int i = threadIdx.x; i < W * (W / 8); i += TCT) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool in = r0 + r < nrows && c0 + c < width;
    wm::cp_async16(dst + r * SD + c,
                   in ? src + (row0 + r0 + r) * width + c0 + c : src,
                   in ? 16 : 0);
  }
}

// A 64 x 64 f32 tile (row stride ld, rows past nrows zero) as bf16 hi and
// lo tiles.
__device__ __forceinline__ void split_tile(bf16* hi, bf16* lo,
                                           const float* src, size_t ld,
                                           int nrows) {
  for (int i = threadIdx.x; i < W * (W / 4); i += TCT) {
    const int r = i >> 4, c = (i & 15) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) v = *reinterpret_cast<const float4*>(src + r * ld + c);
    uint32_t h0, l0, h1, l1;
    wm::split2(v.x, v.y, h0, l0);
    wm::split2(v.z, v.w, h1, l1);
    *reinterpret_cast<uint2*>(hi + r * SD + c) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(lo + r * SD + c) = make_uint2(l0, l1);
  }
}

// acc (the warp's 16 query rows x 64 keys) += rows times keys^T over
// `width` columns, 64 at a time.
__device__ __forceinline__ void tc_products(const bf16* rows,
                                            const bf16* keys, int width,
                                            size_t row0, size_t kb, int q0,
                                            int j, const AttnShape& sh,
                                            bf16* a_s, bf16* b_s,
                                            float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d0 = 0; d0 < width; d0 += W) {
    __syncthreads();   // the previous chunk's products are done
    load_tile(a_s, rows, row0, q0, sh.Sq, d0, width);
    load_tile(b_s, keys, kb, j * W, sh.Sk, d0, width);
    wm::cp_async_commit();
    wm::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      uint32_t af[4];
      wm::ldsm_x4(af, a_s + (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7))
                                * SD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bfr[4];
        wm::ldsm_x4(bfr, b_s + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * SD
                             + kk * 16 + ((lane >> 3) & 1) * 8);
        wm::mma16816(acc[2 * jp], af, bfr[0], bfr[1]);
        wm::mma16816(acc[2 * jp + 1], af, bfr[2], bfr[3]);
      }
    }
  }
}

// P and dS of 64 query rows of one head against kv tile j (wide_probs).
__global__ void __launch_bounds__(TCT)
wide_probs_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ pbuf, float* __restrict__ dsbuf,
              AttnShape sh, Group gr) {
  __shared__ __align__(16) bf16 a_s[W * SD], b_s[W * SD];
  __shared__ float lse_s[W], dl_s[W];
  const int q0 = blockIdx.x * W, j = blockIdx.y, z = blockIdx.z;
  const int gi = z % gr.gc, bkv = z / gr.gc;
  const int kvh = bkv % sh.Hkv, b = bkv / sh.Hkv;
  const int G = sh.Hq / sh.Hkv, g = gr.g0 + gi, head = kvh * G + g;
  const tc::KvRange kv = bwd::span_tiles(sh, g, q0);
  if (j < kv.lo || j >= kv.hi) return;
  const size_t row0 = (size_t)(b * sh.Hq + head) * sh.Sq;
  const size_t kb = (size_t)bkv * sh.Sk;
  if (threadIdx.x < W) {
    const int qi = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < sh.Sq ? lse[row0 + qi] : 0.f;
    dl_s[threadIdx.x] = qi < sh.Sq ? delta[row0 + qi] : 0.f;
  }
  float s[8][4] = {}, dp[8][4] = {};
  tc_products(q, k, sh.hd, row0, kb, q0, j, sh, a_s, b_s, s);
  tc_products(dout, v, sh.hdv, row0, kb, q0, j, sh, a_s, b_s, dp);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t = lane & 3;
  const int skp = (sh.Sk + W - 1) / W * W;
  const float inv_sk = sh.Sk > 0 ? 1.f / sh.Sk : 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + g8 + 8 * h, qi = q0 + row;
    if (qi >= sh.Sq) continue;
    const int qpos = qi + sh.q_offset;
    const float l = lse_s[row], dl = dl_s[row];
    const bool dead = l <= bwd::DEAD;
    const size_t out = ((size_t)z * sh.Sq + qi) * skp + (size_t)j * W;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jn + 2 * t + e, kpos = j * W + col;
        bool ok = kpos < sh.kv_len;
        if (sh.causal) ok = ok && kpos <= qpos;
        if (sh.window > 0) ok = ok && kpos > qpos - sh.window;
        float p = 0.f;
        if (dead)
          p = kpos < sh.Sk ? inv_sk : 0.f;
        else if (ok)
          p = expf(s[jn][2 * h + e] * sh.scale - l);
        pbuf[out + col] = p;
        dsbuf[out + col] =
            ok && !dead ? p * (dp[jn][2 * h + e] - dl) * sh.scale : 0.f;
      }
  }
}

// dK or dV of kv tile j, 64 columns, over the group's heads (wide_dkv):
// the warp's 16 keys += P^T dO or dS^T Q of each live query span.
__global__ void __launch_bounds__(TCT)
wide_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ dout,
            const float* __restrict__ pbuf, const float* __restrict__ dsbuf,
            float* __restrict__ dk_acc, float* __restrict__ dv_acc,
            bf16* __restrict__ dk, bf16* __restrict__ dv, AttnShape sh,
            Group gr, int first, int last) {
  __shared__ __align__(16) bf16 ah[W * SD], al[W * SD], x_s[W * SD];
  const int j = blockIdx.x, cc = blockIdx.y, bkv = blockIdx.z;
  const int kvh = bkv % sh.Hkv, b = bkv / sh.Hkv;
  const int G = sh.Hq / sh.Hkv, nkc = (sh.hd + W - 1) / W;
  const bool is_k = cc < nkc;
  const int col0 = (is_k ? cc : cc - nkc) * W;
  const int width = is_k ? sh.hd : sh.hdv;
  const float* buf = is_k ? dsbuf : pbuf;
  const bf16* src = is_k ? q : dout;
  const int skp = (sh.Sk + W - 1) / W * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[8][4] = {};
  for (int hg = 0; hg < gr.gc; ++hg) {
    const int g = gr.g0 + hg, head = kvh * G + g;
    const size_t z = (size_t)bkv * gr.gc + hg;
    const size_t row0 = (size_t)(b * sh.Hq + head) * sh.Sq;
    for (int q0 = 0; q0 < sh.Sq; q0 += W) {
      const tc::KvRange kv = bwd::span_tiles(sh, g, q0);
      if (j < kv.lo || j >= kv.hi) continue;
      __syncthreads();   // the previous span's products are done
      load_tile(x_s, src, row0, q0, sh.Sq, col0, width);
      wm::cp_async_commit();
      split_tile(ah, al, buf + (z * sh.Sq + q0) * skp + (size_t)j * W, skp,
                 sh.Sq - q0);
      wm::cp_async_wait<0>();
      __syncthreads();
      float part[8][4] = {};
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        uint32_t a_hi[4], a_lo[4];
        const int off = (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * SD
                        + warp * 16 + ((lane >> 3) & 1) * 8;
        wm::ldsm_x4_trans(a_hi, ah + off);
        wm::ldsm_x4_trans(a_lo, al + off);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bfr[4];
          wm::ldsm_x4_trans(bfr, x_s + (kk * 16 + ((lane >> 3) & 1) * 8
                                        + (lane & 7)) * SD
                                     + jp * 16 + (lane >> 4) * 8);
          wm::mma16816(part[2 * jp], a_hi, bfr[0], bfr[1]);
          wm::mma16816(part[2 * jp], a_lo, bfr[0], bfr[1]);
          wm::mma16816(part[2 * jp + 1], a_hi, bfr[2], bfr[3]);
          wm::mma16816(part[2 * jp + 1], a_lo, bfr[2], bfr[3]);
        }
      }
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jn][e] += part[jn][e];
    }
  }
  float* sum = is_k ? dk_acc : dv_acc;
  bf16* out = is_k ? dk : dv;
  const size_t kb = (size_t)bkv * sh.Sk;
  const int g8 = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = j * W + warp * 16 + g8 + 8 * h;
    if (kpos >= sh.Sk) continue;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * jn + 2 * t + e;
        if (col >= width) continue;
        const size_t idx = (kb + kpos) * width + col;
        const float val = first ? acc[jn][2 * h + e]
                                : sum[idx] + acc[jn][2 * h + e];
        if (last)
          out[idx] = __float2bfloat16(val);
        else
          sum[idx] = val;
      }
  }
}

// dQ of 64 query rows of one head, 64 columns (wide_dq): the warp's 16
// rows += dS K over the span's live kv tiles.
__global__ void __launch_bounds__(TCT)
wide_dq_tc(const bf16* __restrict__ k, const float* __restrict__ dsbuf,
           bf16* __restrict__ dq, AttnShape sh, Group gr) {
  __shared__ __align__(16) bf16 dh[W * SD], dl[W * SD], k_s[W * SD];
  const int q0 = blockIdx.x * W, col0 = blockIdx.y * W, z = blockIdx.z;
  const int gi = z % gr.gc, bkv = z / gr.gc;
  const int kvh = bkv % sh.Hkv, b = bkv / sh.Hkv;
  const int G = sh.Hq / sh.Hkv, g = gr.g0 + gi, head = kvh * G + g;
  const tc::KvRange kv = bwd::span_tiles(sh, g, q0);
  const int skp = (sh.Sk + W - 1) / W * W;
  const size_t kb = (size_t)bkv * sh.Sk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[8][4] = {};
  for (int jt = kv.lo; jt < kv.hi; ++jt) {
    __syncthreads();   // the previous tile's products are done
    load_tile(k_s, k, kb, jt * W, sh.Sk, col0, sh.hd);
    wm::cp_async_commit();
    split_tile(dh, dl, dsbuf + ((size_t)z * sh.Sq + q0) * skp + (size_t)jt * W,
               skp, sh.Sq - q0);
    wm::cp_async_wait<0>();
    __syncthreads();
    float part[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      const int off = (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * SD
                      + kk * 16 + (lane >> 4) * 8;
      wm::ldsm_x4(a_hi, dh + off);
      wm::ldsm_x4(a_lo, dl + off);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bfr[4];
        wm::ldsm_x4_trans(bfr, k_s + (kk * 16 + ((lane >> 3) & 1) * 8
                                      + (lane & 7)) * SD
                                   + jp * 16 + (lane >> 4) * 8);
        wm::mma16816(part[2 * jp], a_hi, bfr[0], bfr[1]);
        wm::mma16816(part[2 * jp], a_lo, bfr[0], bfr[1]);
        wm::mma16816(part[2 * jp + 1], a_hi, bfr[2], bfr[3]);
        wm::mma16816(part[2 * jp + 1], a_lo, bfr[2], bfr[3]);
      }
    }
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jn][e] += part[jn][e];
  }
  const size_t row0 = (size_t)(b * sh.Hq + head) * sh.Sq;
  const int g8 = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + warp * 16 + g8 + 8 * h;
    if (qi >= sh.Sq) continue;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int col = col0 + 8 * jn + 2 * t;
      if (col < sh.hd)
        *reinterpret_cast<__nv_bfloat162*>(dq + (row0 + qi) * sh.hd + col) =
            __floats2bfloat162_rn(acc[jn][2 * h], acc[jn][2 * h + 1]);
    }
  }
}

// f32 scratch of one call, in floats: P and dS of gc heads of every
// (batch, kv head), and, when the heads take more than one group, the f32
// sums of dK and dV.
inline size_t scratch_floats(const AttnShape& sh, int gc) {
  const size_t skp = (size_t)(sh.Sk + W - 1) / W * W;
  const size_t probs = 2 * (size_t)sh.B * sh.Hkv * gc * sh.Sq * skp;
  const int G = sh.Hq / sh.Hkv;
  const size_t sums = gc < G ? (size_t)sh.B * sh.Hkv * sh.Sk * (sh.hd + sh.hdv)
                             : 0;
  return probs + sums;
}

// bf16 on the tensor-core kernels (the caller checks tc_ok), f32 on SIMT.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, float* scratch, int gc, const AttnShape& sh,
           cudaStream_t stream) {
  int err = bwd::launch_delta<T>(out, dout, delta, sh.B * sh.Hq * sh.Sq,
                                 sh.hdv, stream);
  if (err || sh.Sq == 0 || sh.Sk == 0) return err;
  const int G = sh.Hq / sh.Hkv;
  const size_t skp = (size_t)(sh.Sk + W - 1) / W * W;
  const size_t probs = (size_t)sh.B * sh.Hkv * gc * sh.Sq * skp;
  float* pbuf = scratch;
  float* dsbuf = pbuf + probs;
  float* dk_acc = dsbuf + probs;
  float* dv_acc = dk_acc + (size_t)sh.B * sh.Hkv * sh.Sk * sh.hd;
  const int qt = (sh.Sq + W - 1) / W, kt = (sh.Sk + W - 1) / W;
  const int nkc = (sh.hd + W - 1) / W, nvc = (sh.hdv + W - 1) / W;
  for (int g0 = 0; g0 < G; g0 += gc) {
    const Group gr{g0, gc < G - g0 ? gc : G - g0};
    const unsigned zc = (unsigned)(sh.B * sh.Hkv * gr.gc);
    const dim3 probs_grid(qt, kt, zc), dkv_grid(kt, nkc + nvc, sh.B * sh.Hkv),
        dq_grid(qt, nkc, zc);
    if constexpr (std::is_same<T, bf16>::value) {
      wide_probs_tc<<<probs_grid, TCT, 0, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
          lse, delta, pbuf, dsbuf, sh, gr);
      wide_dkv_tc<<<dkv_grid, TCT, 0, stream>>>(
          (const bf16*)q, (const bf16*)dout, pbuf, dsbuf, dk_acc, dv_acc,
          (bf16*)dk, (bf16*)dv, sh, gr, g0 == 0, g0 + gr.gc >= G);
      wide_dq_tc<<<dq_grid, TCT, 0, stream>>>((const bf16*)k, dsbuf,
                                               (bf16*)dq, sh, gr);
    } else {
      wide_probs<T><<<probs_grid, NT, 0, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
          pbuf, dsbuf, sh, gr);
      wide_dkv<T><<<dkv_grid, NT, 0, stream>>>(
          (const T*)q, (const T*)dout, pbuf, dsbuf, dk_acc, dv_acc, (T*)dk,
          (T*)dv, sh, gr, g0 == 0, g0 + gr.gc >= G);
      wide_dq<T><<<dq_grid, NT, 0, stream>>>((const T*)k, dsbuf, (T*)dq,
                                             sh, gr);
    }
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

inline bool takes(const AttnShape& sh) {
  return sh.hd <= MAX_QK && sh.hdv <= MAX_V &&
         (sh.hd > 128 || sh.hdv > 128);
}

}  // namespace wbwd
}  // namespace repro
