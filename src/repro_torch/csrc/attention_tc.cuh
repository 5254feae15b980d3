// Tensor-core attention core for bf16 inputs on sm_90a, shared by
// flash_attention.cu and stream_attention.cu (their f32 route keeps the
// SIMT core of attention_tile.cuh); flash's wide route (attention_wide.cuh)
// shares its online softmax and P split.
//
// A block has three warpgroups of 128 threads: two consumer warpgroups that
// each own 64 query rows, taken from the flattened (G query heads x Sq) rows
// of one (batch, kv head) so that a GQA group shares every K/V tile, and a
// producer warpgroup of which one thread issues the TMA loads of a ring of
// shared-memory stages guarded by mbarriers (setmaxnreg moves registers to
// the consumers).  Per kv tile of BK = 64 keys a consumer warpgroup runs
//   S = Q K^T        wgmma m64n64k16, Q the register A operand, K in shared
//                    memory (128-byte swizzle), f32 accumulators;
//   online softmax   on the accumulator registers: row max and sum within
//                    the quad of threads that holds a row;
//   O += P V         wgmma m64nNk16, P re-packed from the S accumulators as
//                    the register A operand, V in shared memory.
// Numerics.  Every product is a bf16 x bf16 product summed in f32, so an f32
// operand goes in as two bf16 values x = hi + lo, lo = bf16(x - hi), which
// keeps ~16 bits of it (no TF32 anywhere): P always (P V = P_hi V + P_lo V),
// and the stream kernel's generated K and V (Q K^T = Q K_hi^T + Q K_lo^T,
// P V = P_hi V_hi + P_hi V_lo + P_lo V_hi).  kernels/blocked.py mirrors this
// rounding (split_bf16) for the CPU tests.
// Live tiles only.  live_kv_tiles() gives the kv tiles [lo, hi) that hold a
// live key (kv_len, causal with q_offset, window) for any row of a span of
// flattened rows; masks are applied on the tiles that are not live for every
// row of a warpgroup.  A row with no live key at all takes the softmax of
// equal -1e30 scores, the mean of V over the Sk keys (as the plain versions
// and ref_attention do): a span that holds such a row walks every tile,
// and store() divides its sum by Sk.  The Python mirror is
// blocked.live_kv_tiles; flash_attention_live_tiles exports this one.
// Shared-memory tiles are TMA boxes of 64 rows x 64 bf16 (128 bytes, 8 KB),
// swizzled by 128 bytes; a tile of width 128 is two boxes 8 KB apart.
// The PTX building blocks (mbarriers, TMA, wgmma, descriptors, tensor maps)
// live in hopper.cuh, shared with the GEMM.
#pragma once

#include "attention_tile.cuh"   // AttnShape
#include "hopper.cuh"

namespace repro {
namespace tc {

constexpr int BK = 64;                    // keys per kv tile
constexpr int ROWS = 128;                 // query rows per block
constexpr int THREADS = 384;              // 2 consumer + 1 producer warpgroups
constexpr int CONSUMERS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---- the attention step of one consumer warpgroup ----

struct KvRange {
  int lo, hi;   // kv tiles [lo, hi)
};

// Query positions of the flattened rows [r0, r1): [qmin, qmax].  A span
// that crosses from one head's rows into the next holds both ends of the
// query range.  Returns false for an empty span.
__host__ __device__ __forceinline__ bool q_span(int r0, int r1,
                                                const AttnShape& sh,
                                                int& qmin, int& qmax) {
  if (r1 <= r0) return false;
  if (r0 / sh.Sq == (r1 - 1) / sh.Sq) {
    qmin = r0 % sh.Sq + sh.q_offset;
    qmax = (r1 - 1) % sh.Sq + sh.q_offset;
  } else {
    qmin = sh.q_offset;
    qmax = sh.Sq - 1 + sh.q_offset;
  }
  return true;
}

// The keys [beg, end) live for query position q; both ends grow with q.
__host__ __device__ __forceinline__ void live_keys(const AttnShape& sh, int q,
                                                   int& beg, int& end) {
  end = sh.causal && q + 1 < sh.kv_len ? q + 1 : sh.kv_len;
  beg = sh.window > 0 && q - sh.window + 1 > 0 ? q - sh.window + 1 : 0;
}

// The kv tiles that hold a live key for some query position in [qmin, qmax]:
// keys in [beg(qmin), end(qmax)).  The positions with no live key lie at
// the ends of the span; if one is there, every tile (see the note atop).
__host__ __device__ __forceinline__ KvRange live_kv_tiles(const AttnShape& sh,
                                                          bool any, int qmin,
                                                          int qmax) {
  if (!any) return {0, 0};
  int beg0, end0, beg1, end1;
  live_keys(sh, qmin, beg0, end0);
  live_keys(sh, qmax, beg1, end1);
  if (end0 <= beg0 || end1 <= beg1) return {0, (sh.Sk + BK - 1) / BK};
  return {beg0 / BK, (end1 + BK - 1) / BK};
}

// Does tile j need the mask for some query position in [qmin, qmax]?
__device__ __forceinline__ bool edge_tile(const AttnShape& sh, int j, int qmin,
                                          int qmax) {
  int k0 = j * BK, k1 = k0 + BK - 1;
  return k1 >= sh.kv_len || (sh.causal && k1 > qmin) ||
         (sh.window > 0 && k0 <= qmax - sh.window);
}

// Scale, mask (on an edge tile) and the online-softmax update of kv tile j's
// scores s (m64n64 accumulators: the thread's rows h = 0, 1 at query
// positions qpos[h], columns 8i + 2t + {0, 1}): m and l take the tile, alpha
// is the factor of the earlier sum and output, and s becomes P.
__device__ __forceinline__ void online_softmax(const AttnShape& sh, int j,
                                               int qmin, int qmax, int t,
                                               const int (&qpos)[2],
                                               float (&s)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2]) {
  const bool mask = edge_tile(sh, j, qmin, qmax);
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = s[4 * i + 2 * h + e] * sh.scale;
        if (mask) {
          int kpos = j * BK + 8 * i + 2 * t + e;
          bool ok = kpos < sh.kv_len;
          if (sh.causal) ok = ok && kpos <= qpos[h];
          if (sh.window > 0) ok = ok && kpos > qpos[h] - sh.window;
          v = ok ? v : NEG_INF;
        }
        s[4 * i + 2 * h + e] = v;
        mx[h] = fmaxf(mx[h], v);
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 2));
    float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = exp2f((m[h] - m_new) * LOG2E);
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = exp2f((s[4 * i + 2 * h + e] - m[h]) * LOG2E);
        s[4 * i + 2 * h + e] = p;
        l[h] += p;
      }
}

// P = P_hi + P_lo, re-packed from the accumulator layout of s to the A
// operand layout of P V.
__device__ __forceinline__ void split_p(const float (&s)[32],
                                        uint32_t (&p_hi)[4][4],
                                        uint32_t (&p_lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float a = s[8 * kk + 2 * c], b = s[8 * kk + 2 * c + 1];
      float ah = __bfloat162float(__float2bfloat16_rn(a));
      float bh = __bfloat162float(__float2bfloat16_rn(b));
      p_hi[kk][c] = pack_bf16(ah, bh);
      p_lo[kk][c] = pack_bf16(a - ah, b - bh);
    }
}

// One consumer warpgroup's 64 query rows.  Thread (warp w, lane l) holds rows
// w*16 + l/4 and that + 8 of the warpgroup, columns 8i + 2(l%4) + {0, 1}.
template <int HDP, int HDVP>
struct TcRows {
  static constexpr int KS = HDP / 16;     // k16 steps of Q K^T
  uint32_t qa[KS][4];                     // Q as the A operand
  float o[HDVP / 2];                      // output accumulators
  float m[2], l[2];                       // running max, partial sum per row
  int qpos[2], head[2], qi[2];
  bool valid[2];
  int qmin, qmax;                         // query span of the warpgroup
  bool any;
  int t;                                  // l % 4

  // rows: the warpgroup's first flattened row.
  __device__ void init(const bf16* __restrict__ q, const AttnShape& sh, int b,
                       int kvh, int row0) {
    const int G = sh.Hq / sh.Hkv, nrows = G * sh.Sq;
    const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
    t = lane % 4;
    any = q_span(row0, min(row0 + 64, nrows), sh, qmin, qmax);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r = row0 + w * 16 + lane / 4 + 8 * h;
      valid[h] = r < nrows;
      head[h] = valid[h] ? kvh * G + r / sh.Sq : 0;
      qi[h] = valid[h] ? r % sh.Sq : 0;
      qpos[h] = qi[h] + sh.q_offset;
      m[h] = NEG_INF;
      l[h] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < HDVP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int h = c & 1, col = ks * 16 + (c >> 1) * 8 + 2 * t;
        uint32_t v = 0;
        if (valid[h] && col < sh.hd)
          v = *reinterpret_cast<const uint32_t*>(
              q + ((size_t)(b * sh.Hq + head[h]) * sh.Sq + qi[h]) * sh.hd + col);
        qa[ks][c] = v;
      }
  }

  // One kv tile j: k_hi/k_lo and v_hi/v_lo are the shared-memory addresses
  // of its K and V (the _lo halves only with SPLIT, the stream kernel's f32
  // K and V as bf16 pairs).
  template <bool SPLIT>
  __device__ void tile(const AttnShape& sh, int j, uint32_t k_hi, uint32_t k_lo,
                       uint32_t v_hi, uint32_t v_lo) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_rs<0>(s, qa[ks], desc_kmajor(k_hi + (ks / 4) * BOX_BYTES + (ks % 4) * 32), 1);
    if (SPLIT) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_rs<0>(s, qa[ks], desc_kmajor(k_lo + (ks / 4) * BOX_BYTES + (ks % 4) * 32), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(qa);

    float alpha[2];
    online_softmax(sh, j, qmin, qmax, t, qpos, s, m, l, alpha);
#pragma unroll
    for (int i = 0; i < HDVP / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * i + 2 * h] *= alpha[h];
        o[4 * i + 2 * h + 1] *= alpha[h];
      }
    uint32_t p_hi[4][4], p_lo[4][4];
    split_p(s, p_hi, p_lo);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(o, p_hi[kk], desc_mnmajor(v_hi + kk * 2048), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(o, p_lo[kk], desc_mnmajor(v_hi + kk * 2048), 1);
    if (SPLIT) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(o, p_hi[kk], desc_mnmajor(v_lo + kk * 2048), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
  }

  // out (B, Hq, Sq, hdv) = O / l.  A row with no live key walked every
  // tile with weight 1 per key, and the keys past Sk hold V = 0 (TMA's
  // zero fill, or generated from zero rows of x_kv): its l becomes Sk.  A
  // row whose l is 0 (no tile: Sk = 0) gives 0.  With sh.lse set, m + log l
  // of each row goes there too.
  __device__ void store(bf16* __restrict__ out, const AttnShape& sh, int b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffff, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffff, l[h], 2);
      if (m[h] == NEG_INF) l[h] = (float)sh.Sk;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[h]) continue;
      float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
      if (sh.lse && t == 0)
        sh.lse[(size_t)(b * sh.Hq + head[h]) * sh.Sq + qi[h]] =
            m[h] + logf(l[h] == 0.f ? 1.f : l[h]);
      bf16* row = out + ((size_t)(b * sh.Hq + head[h]) * sh.Sq + qi[h]) * sh.hdv;
#pragma unroll
      for (int i = 0; i < HDVP / 8; ++i) {
        int col = 8 * i + 2 * t;
        if (col < sh.hdv)
          *reinterpret_cast<uint32_t*>(row + col) =
              pack_bf16(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv);
      }
    }
  }
};

}  // namespace tc
}  // namespace repro
