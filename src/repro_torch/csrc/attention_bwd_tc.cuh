// Tensor-core core of the attention backward kernels for bf16 inputs on
// sm_90a, shared by flash_attention_bwd.cu and stream_attention_bwd.cu: the
// backward's counterpart of attention_tc.cuh.  Their f32 route, and shapes
// TMA cannot read, keep the SIMT core of attention_bwd.cuh (the `simt`
// route).
//
// The function is that of attention_bwd.cuh: with lse and delta =
// rowsum(dO * O),
//   P  = exp(S * scale - lse)    dS = P (dP - delta) * scale
//   dV = P^T dO    dK = dS^T Q    dQ = dS K
// in two passes, each a block of three warpgroups: two consumer
// warpgroups run wgmma m64nNk16 (bf16 x bf16, f32 accumulators) on 64-row
// tiles, and one warp of the producer warpgroup keeps a ring of TMA stages
// in flight, guarded by mbarriers (setmaxnreg moves registers to the
// consumers).
//   dK/dV pass (DkvAcc): a block owns 64 keys; K and V stay in shared
//     memory and are the A operand of the transposed products
//     S^T = K Q^T and dP^T = V dO^T (rows are keys), so P^T and dS^T come
//     out in the accumulator layout that re-packs as the register A operand
//     of dV += P^T dO and dK += dS^T Q.  The live query spans of 64 rows
//     (span_tiles, the SIMT kernels' rule) alternate between the two
//     warpgroups.  The flash kernel adds each warpgroup's accumulators to
//     f32 totals in shared memory every few spans (flush, the two
//     warpgroups in turn: a fixed order); the stream kernel adds the two
//     warpgroups' partials once at the end (combine: a + b, fixed, and
//     commutative in IEEE arithmetic).  Each key's gradient is written
//     once, by its block.
//   dQ pass (DqRows): a block owns 128 of the flattened (G x Sq) query rows
//     of one (batch, kv head), as attention_tc.cuh does, so a GQA group
//     shares every K/V tile; Q is the register A operand, dO a shared-memory
//     one; per live kv tile S = Q K^T, dP = dO V^T, then dQ += dS K with K
//     read MN-major.
// Numerics (attention_tc.cuh's): Q, K, V and dO are bf16 and their products
// exact with f32 sums; every f32 operand goes in as two bf16 values
// hi + lo (split_bf16 in kernels/blocked.py): P and dS always, and in the
// stream kernel also the generated K and V, and dK and dV in its dx and dW
// products.  No TF32, no float atomics; kernels/blocked.py's
// flash_attention_bwd_split / stream_attention_bwd_split mirror the
// rounding.  Rows with no live key keep attention_bwd.cuh's rule (P = 1/Sk
// on the keys below Sk, dS = 0).
#pragma once

#include "attention_bwd.cuh"   // bwd::BQ, DEAD, span_tiles; tc:: PTX and rules
#include "stream_tc.cuh"       // tc::Frag, store_split

namespace repro {
namespace tcb {

using namespace tc;
using tc::BK;        // repro::BK (attention_tile.cuh) is the same 64
using tc::NEG_INF;

constexpr int CONSUMERS = 256;          // two consumer warpgroups
constexpr int THREADS = 384;            // + one producer warpgroup
constexpr int WGT = 128;                // threads of a warpgroup
constexpr int BAR_PAIR = 1;             // named barrier of the consumers
constexpr int BAR_WG0 = 2;              // named barrier of warpgroup 0
constexpr int LSE_BYTES = 1024;         // a span stage's lse[64], delta[64]

// Is the query span [q0, q0 + 64) of one head live for kv tile j?
__device__ __forceinline__ bool span_live(const AttnShape& sh, int g, int q0,
                                          int j) {
  const KvRange kv = bwd::span_tiles(sh, g, q0);
  return j >= kv.lo && j < kv.hi;
}

// 64 f32 accumulator columns as the register A operand of 4 k16 steps,
// hi + lo (lo = bf16(x - hi)).
__device__ __forceinline__ void split_a(const float (&s)[32],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float a = s[8 * kk + 2 * c], b = s[8 * kk + 2 * c + 1];
      const float ah = __bfloat162float(__float2bfloat16_rn(a));
      const float bh = __bfloat162float(__float2bfloat16_rn(b));
      hi[kk][c] = pack_bf16(ah, bh);
      lo[kk][c] = pack_bf16(a - ah, b - bh);
    }
}

// d += A B^T over KS k16 steps: A (64 rows) and B (N rows) K-major tiles.
template <int KS, int NR>
__device__ __forceinline__ void mma_kk(float (&d)[NR], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_ss<0>(d, desc_kmajor(a + (ks / 4) * BOX_BYTES + (ks % 4) * 32),
                desc_kmajor(b + (ks / 4) * BOX_BYTES + (ks % 4) * 32), 1);
}

// d += A B: A (64 x 64) in registers, B (64 rows of the reduction) MN-major.
template <int NR>
__device__ __forceinline__ void mma_rm(float (&d)[NR], const uint32_t (&a)[4][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(d, a[kk], desc_mnmajor(b + kk * 2048), 1);
}

// ---- the dK/dV pass: one warpgroup's share of a block's 64 keys ----

template <int HDP, int HDVP, bool SPLIT>
struct DkvAcc {
  float dk[HDP / 2], dv[HDVP / 2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HDVP / 2; ++i) dv[i] = 0.f;
  }

  // One span of 64 query rows [q0, q0 + 64) of a head against the block's
  // keys kpos0 ..: K at k_hi (+ k_lo), V at v_hi (+ v_lo), the span's Q at
  // qs and dO at dos (64-row tiles), its rows' lse and delta in lse_s[0..63],
  // lse_s[64..127].
  __device__ void span(const AttnShape& sh, int kpos0, int q0, uint32_t k_hi,
                       uint32_t k_lo, uint32_t v_hi, uint32_t v_lo,
                       uint32_t qs, uint32_t dos, const float* lse_s) {
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_kk<HDP / 16>(s, k_hi, qs);                // S^T = K Q^T
    if (SPLIT) mma_kk<HDP / 16>(s, k_lo, qs);
    mma_kk<HDVP / 16>(dp, v_hi, dos);             // dP^T = V dO^T
    if (SPLIT) mma_kk<HDVP / 16>(dp, v_lo, dos);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const Frag f;
    const float inv_sk = sh.Sk > 0 ? 1.f / sh.Sk : 0.f;
    const float sl = sh.scale * LOG2E;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * f.t + e, qi = q0 + col;
        const int qpos = qi + sh.q_offset;
        const bool valid = qi < sh.Sq;
        const float lse = lse_s[col], dl = lse_s[64 + col];
        const bool dead = lse <= bwd::DEAD;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kpos = kpos0 + f.r0 + 8 * h, x = 4 * i + 2 * h + e;
          bool ok = valid && kpos < sh.kv_len;
          if (sh.causal) ok = ok && kpos <= qpos;
          if (sh.window > 0) ok = ok && kpos > qpos - sh.window;
          float p = 0.f;
          if (valid && dead)
            p = kpos < sh.Sk ? inv_sk : 0.f;
          else if (ok)
            p = exp2f(s[x] * sl - lse * LOG2E);
          dp[x] = ok && !dead ? p * (dp[x] - dl) * sh.scale : 0.f;
          s[x] = p;
        }
      }
    uint32_t p_hi[4][4], p_lo[4][4], d_hi[4][4], d_lo[4][4];
    split_a(s, p_hi, p_lo);
    split_a(dp, d_hi, d_lo);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    mma_rm(dv, p_hi, dos);                        // dV += P^T dO
    mma_rm(dv, p_lo, dos);
    mma_rm(dk, d_hi, qs);                         // dK += dS^T Q
    mma_rm(dk, d_lo, qs);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(d_hi);
    fence_regs(d_lo);
  }

  // The accumulators added to the f32 totals `tot` (dK's HDP / 2, then
  // dV's HDVP / 2 values a thread, laid out [value][thread]) and zeroed.
  // The tensor cores add each product to an accumulator at the precision
  // of the running sum, truncated, so a sum carried over every span of a
  // long sequence drifts from the f32 sum by more than a bf16 ulp (dV at
  // 8 heads x 4096 rows a key); sums of a few spans added here in f32 do
  // not.
  __device__ void flush(float* tot) {
    const int tid = threadIdx.x % WGT;
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) {
      tot[i * WGT + tid] += dk[i];
      dk[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < HDVP / 2; ++i) {
      tot[(HDP / 2 + i) * WGT + tid] += dv[i];
      dv[i] = 0.f;
    }
  }

  // The two warpgroups' partials added through `buf` (2 x 64 x HDP f32 of
  // shared memory no warpgroup reads meanwhile): warpgroup 0 ends with the
  // sum of dK in dk, warpgroup 1 with the sum of dV in dv.
  __device__ void combine(float* buf, int wg) {
    const int tid = threadIdx.x % WGT;
    float* kbuf = buf;
    float* vbuf = buf + (HDP / 2) * WGT;
    named_sync(BAR_PAIR, CONSUMERS);          // both walks are done
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) kbuf[i * WGT + tid] = dk[i];
    } else {
#pragma unroll
      for (int i = 0; i < HDVP / 2; ++i) vbuf[i * WGT + tid] = dv[i];
    }
    named_sync(BAR_PAIR, CONSUMERS);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) dk[i] += kbuf[i * WGT + tid];
    } else {
#pragma unroll
      for (int i = 0; i < HDVP / 2; ++i) dv[i] += vbuf[i * WGT + tid];
    }
    named_sync(BAR_PAIR, CONSUMERS);          // buf is free again
  }
};

// ---- the dQ pass: one warpgroup's 64 flattened query rows ----

template <int HDP, int HDVP, bool SPLIT>
struct DqRows {
  static constexpr int KS = HDP / 16;
  uint32_t qa[KS][4];                     // Q as the A operand
  float dq[HDP / 2];
  float lse[2], dl[2];
  int qpos[2], head[2], qi[2];
  bool live[2];                           // a valid row with a live key
  int t;

  __device__ void init(const bf16* __restrict__ q, const float* __restrict__ lse_g,
                       const float* __restrict__ delta, const AttnShape& sh,
                       int b, int kvh, int row0) {
    const int G = sh.Hq / sh.Hkv, nrows = G * sh.Sq;
    const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
    t = lane % 4;
    bool valid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + w * 16 + lane / 4 + 8 * h;
      valid[h] = r < nrows;
      head[h] = valid[h] ? kvh * G + r / sh.Sq : 0;
      qi[h] = valid[h] ? r % sh.Sq : 0;
      qpos[h] = qi[h] + sh.q_offset;
      const size_t row = (size_t)(b * sh.Hq + head[h]) * sh.Sq + qi[h];
      lse[h] = valid[h] ? lse_g[row] : 0.f;
      dl[h] = valid[h] ? delta[row] : 0.f;
      live[h] = valid[h] && lse[h] > bwd::DEAD;   // dead rows: dS = 0
    }
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dq[i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c & 1, col = ks * 16 + (c >> 1) * 8 + 2 * t;
        uint32_t v = 0;
        if (valid[h] && col < sh.hd)
          v = *reinterpret_cast<const uint32_t*>(
              q + ((size_t)(b * sh.Hq + head[h]) * sh.Sq + qi[h]) * sh.hd + col);
        qa[ks][c] = v;
      }
  }

  // kv tile j: K at k_hi (+ k_lo), V at v_hi (+ v_lo), this warpgroup's
  // dO rows at dos (K-major, 64 rows).
  __device__ void tile(const AttnShape& sh, int j, uint32_t k_hi, uint32_t k_lo,
                       uint32_t v_hi, uint32_t v_lo, uint32_t dos) {
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)             // S = Q K^T
      wgmma_rs<0>(s, qa[ks], desc_kmajor(k_hi + (ks / 4) * BOX_BYTES + (ks % 4) * 32), 1);
    if (SPLIT) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_rs<0>(s, qa[ks], desc_kmajor(k_lo + (ks / 4) * BOX_BYTES + (ks % 4) * 32), 1);
    }
    mma_kk<HDVP / 16>(dp, dos, v_hi);            // dP = dO V^T
    if (SPLIT) mma_kk<HDVP / 16>(dp, dos, v_lo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(qa);

    const float sl = sh.scale * LOG2E;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = j * BK + 8 * i + 2 * t + e, x = 4 * i + 2 * h + e;
          bool ok = live[h] && kpos < sh.kv_len;
          if (sh.causal) ok = ok && kpos <= qpos[h];
          if (sh.window > 0) ok = ok && kpos > qpos[h] - sh.window;
          s[x] = ok ? exp2f(s[x] * sl - lse[h] * LOG2E) * (dp[x] - dl[h]) * sh.scale
                    : 0.f;
        }
    uint32_t d_hi[4][4], d_lo[4][4];
    split_a(s, d_hi, d_lo);
    fence_regs(dq);
    wgmma_fence();
    mma_rm(dq, d_hi, k_hi);                      // dQ += dS K
    mma_rm(dq, d_lo, k_hi);
    if (SPLIT) mma_rm(dq, d_hi, k_lo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    fence_regs(d_hi);
    fence_regs(d_lo);
  }

  // dq (B, Hq, Sq, hd) bf16; row0 as for init.
  __device__ void store(bf16* __restrict__ out, const AttnShape& sh, int b,
                        int row0) const {
    const int nrows = (sh.Hq / sh.Hkv) * sh.Sq;
    const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row0 + w * 16 + lane / 4 + 8 * h >= nrows) continue;
      bf16* row = out + ((size_t)(b * sh.Hq + head[h]) * sh.Sq + qi[h]) * sh.hd;
#pragma unroll
      for (int i = 0; i < HDP / 8; ++i) {
        const int col = 8 * i + 2 * t;
        if (col < sh.hd)
          *reinterpret_cast<uint32_t*>(row + col) =
              pack_bf16(dq[4 * i + 2 * h], dq[4 * i + 2 * h + 1]);
      }
    }
  }
};

// A span stage's lse and delta rows [q0, q0 + 64) of row block row0 (the
// head's first row in (B, Hq, Sq)), written by the 32 lanes of the producer
// warp (zero past Sq).
__device__ __forceinline__ void load_lse(float* dst, const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         size_t row0, int q0, int Sq, int lane) {
#pragma unroll
  for (int r = lane; r < 64; r += 32) {
    const bool in = q0 + r < Sq;
    dst[r] = in ? lse[row0 + q0 + r] : 0.f;
    dst[64 + r] = in ? delta[row0 + q0 + r] : 0.f;
  }
}

}  // namespace tcb
}  // namespace repro
