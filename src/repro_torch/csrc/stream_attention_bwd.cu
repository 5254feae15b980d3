// Backward of TILE_STREAM attention (fused K/V generation), for sm_90a.
//
// Replaces: src/repro/kernels/flash_vjp.py:267 (_stream_bwd), the JAX
// training path's custom VJP (jnp, not a Pallas kernel).  Same function:
// from q, x_kv, wk, wv, the optional qk-norm gain k_gamma and RoPE tables,
// the forward's out and lse = m + log l, and dout, it gives dq, dx_kv,
// dW_K, dW_V and dγ.  K and V are generated again from x_kv tile by tile,
// as in the forward: neither they nor their gradients ever exist for the
// whole sequence, so the cross-forwarding dataflow carries into the
// gradient.
//
// What bounds it on the H100: the FLOPs (the attention backward's five
// products over the live pairs, the K/V generation and its dx, dW
// products), at hundreds of operations per byte read at the training
// shapes.
//
// Two routes (the `route` argument; kernels/flash_vjp.py picks it):
// tc, bf16 (attention_bwd_tc.cuh, stream_tc.cuh; tcb:: below), four
// launches: delta; the dK/dV kernel stream_dkv_tc in clusters of C blocks
// over the kv heads (each rank NH = Hkv / C heads, 8 x 1 at vilbert's
// vision streams, 6 x 2 at its text ones), each block walking the kv
// tiles g, g + NG, ... of one batch row (NG = min(tiles, 16) tile
// groups): per tile and head it generates K_j and V_j on wgmma, walks the
// live query spans, goes back through RoPE and the qk-norm, and keeps dK
// and dV split in shared memory; per 64-wide D chunk the cluster adds the
// dx partials of its heads in rank order through distributed shared
// memory, and each block adds x_j^T dK, x_j^T dV to its own dW slot; the
// dQ kernel stream_dq_tc has the forward's dataflow (a block per 128
// flattened query rows, clusters of 8 that generate each K/V tile once
// and pass it around); reduce_slots then sums the B·NG dW slots in order.
// Every f32 operand (generated K and V, P, dS, dK and dV) goes in as bf16
// hi + lo.  The dW scratch is B·NG·D·Hkv·hd f32 each for dW_K and dW_V,
// whatever Sk is past 1024 keys: 134 MB each at vilbert's vision self
// 4096, 336 MB at qwen3-32b's widths (S = 4096).
// simt, f32 (and bf16 shapes the tc route does not take): the first
// port's kernels, f32 arithmetic on the SIMT core of attention_bwd.cuh,
// except that the K/V generation of bf16 inputs runs on mma.sync (exact
// bf16 products summed in f32: generate_tc):
//   delta_kernel   delta = rowsum(dO * O)
//   dkvgen_kernel  one block per (kv tile j of 64 keys, batch) reads
//                  x_kv[b, 64j : 64j + 64, :D] and, for each kv head in
//                  turn, generates K_j (projection, qk-norm, rotate-half
//                  RoPE) and V_j, walks the live query spans of the head's
//                  G query heads for dK_j and dV_j, goes back through RoPE
//                  and the qk-norm, and adds dK_j W_K^T + dV_j W_V^T to the
//                  block's rows of dx_kv (f32; the block owns them, heads in
//                  order).  It writes the tile's partials of dW_K = x_j^T dK_j,
//                  dW_V = x_j^T dV_j and dγ, one slot per tile (B·ceil(Sk/64)
//                  slots, 537 MB each at vision self 4096).
//   dq_kernel      one block per (64 query rows, query head, batch)
//                  generates K_j and V_j of its kv head for each live tile
//                  and accumulates dQ.
// Both routes sum their slots with reduce_slots in slot order and use no
// float atomics: two runs give bitwise-equal gradients.
#include <type_traits>

#include "attention_bwd.cuh"
#include "warp_mma.cuh"

namespace repro {
namespace bwd {

constexpr int DC = 32;   // D columns per generation chunk
constexpr int DX = 64;   // D columns per chunk of the dx / dW products

struct Side {
  const float *sin_t, *cos_t, *k_gamma;   // (Sk, hd/2), (Sk, hd/2), (hd,)
  int D, use_rope, use_knorm;
  float eps;
  int vec;   // x_kv and W load as 16-byte vectors (D, hd % 8 == 0, aligned)
};

// generate()'s bf16 route: the same products on the tensor cores
// (mma.sync m16n8k16, bf16 x bf16 into f32 accumulators).  x_kv and W are
// bf16, so every product is exact and only the order of the f32 sums
// differs from the SIMT route.  The chunks of x (64 x DC) and W (DC x
// HDT) are staged as bf16 in the same buffers, rows padded by 8 values
// so that ldmatrix's eight row addresses fall in distinct banks.  Warp w
// computes rows 16 (w % 4) .. + 16 and the column half w / 4 of K and V.
template <int HDT>
__device__ void generate_tc(Tiles<HDT>& t, const wm::bf16* __restrict__ x,
                            const wm::bf16* __restrict__ wk,
                            const wm::bf16* __restrict__ wv,
                            const AttnShape& sh, const Side& sd, int b,
                            int kvh, int j, void* xs_buf, void* wks_buf,
                            void* wvs_buf) {
  const int D = sd.D;
  constexpr int XS = DC + 8, WS = HDT + 8, NT8 = HDT / 16;
  constexpr int HS = Smem<HDT>::HS;
  static_assert(NT8 % 2 == 0, "n tiles are loaded in pairs");
  wm::bf16* xs = static_cast<wm::bf16*>(xs_buf);
  wm::bf16* wks = static_cast<wm::bf16*>(wks_buf);
  wm::bf16* wvs = static_cast<wm::bf16*>(wvs_buf);
  const int warp = t.tid / 32, lane = t.tid % 32;
  const int r0 = 16 * (warp % 4), c0 = (warp / 4) * (HDT / 2);
  float ka[NT8][4], va[NT8][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ka[n][e] = va[n][e] = 0.f;
  const wm::bf16* xb = x + (size_t)b * sh.Sk * D;
  const wm::bf16 zero = __float2bfloat16(0.f);
  for (int d0 = 0; d0 < D; d0 += DC) {
    __syncthreads();   // the staging buffers are free
    if (sd.vec) {      // 8 values a load; D and hd are multiples of 8
      const uint4 z4 = make_uint4(0, 0, 0, 0);
      for (int idx = t.tid; idx < 64 * (DC / 8); idx += NT) {
        const int c = idx / (DC / 8), dd = idx % (DC / 8) * 8;
        const int kpos = j * BKV + c, d = d0 + dd;
        *reinterpret_cast<uint4*>(xs + c * XS + dd) =
            kpos < sh.Sk && d < D
                ? *reinterpret_cast<const uint4*>(xb + (size_t)kpos * D + d)
                : z4;
      }
      for (int idx = t.tid; idx < DC * (HDT / 8); idx += NT) {
        const int dd = idx / (HDT / 8), e = idx % (HDT / 8) * 8, d = d0 + dd;
        const bool in = d < D && e < sh.hd;
        const size_t off = ((size_t)d * sh.Hkv + kvh) * sh.hd + e;
        *reinterpret_cast<uint4*>(wks + dd * WS + e) =
            in ? *reinterpret_cast<const uint4*>(wk + off) : z4;
        *reinterpret_cast<uint4*>(wvs + dd * WS + e) =
            in ? *reinterpret_cast<const uint4*>(wv + off) : z4;
      }
    } else {
      for (int idx = t.tid; idx < 64 * DC; idx += NT) {
        const int c = idx / DC, dd = idx % DC, kpos = j * BKV + c, d = d0 + dd;
        xs[c * XS + dd] =
            kpos < sh.Sk && d < D ? xb[(size_t)kpos * D + d] : zero;
      }
      for (int idx = t.tid; idx < DC * HDT; idx += NT) {
        const int dd = idx / HDT, e = idx % HDT, d = d0 + dd;
        const bool in = d < D && e < sh.hd;
        const size_t off = ((size_t)d * sh.Hkv + kvh) * sh.hd + e;
        wks[dd * WS + e] = in ? wk[off] : zero;
        wvs[dd * WS + e] = in ? wv[off] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < DC / 16; ++ks) {
      // A: rows r0 + 0..15 of the x chunk; B: rows (k) ks*16 + 0..15 of
      // the W chunks, two n tiles of 8 columns per ldmatrix.x4.trans
      const int m = lane / 8, row = lane % 8 + (m % 2) * 8;
      uint32_t a[4];
      wm::ldsm_x4(a, xs + (r0 + row) * XS + ks * 16 + (m / 2) * 8);
#pragma unroll
      for (int n = 0; n < NT8; n += 2) {
        const int off = (ks * 16 + row) * WS + c0 + (n + m / 2) * 8;
        uint32_t bk[4], bv[4];
        wm::ldsm_x4_trans(bk, wks + off);
        wm::ldsm_x4_trans(bv, wvs + off);
        wm::mma16816(ka[n], a, bk[0], bk[1]);
        wm::mma16816(ka[n + 1], a, bk[2], bk[3]);
        wm::mma16816(va[n], a, bv[0], bv[1]);
        wm::mma16816(va[n + 1], a, bv[2], bv[3]);
      }
    }
  }
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int n = 0; n < NT8; ++n) {
    const int col = c0 + n * 8 + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      t.k_s[r * HS + col] = ka[n][2 * h];
      t.k_s[r * HS + col + 1] = ka[n][2 * h + 1];
      t.v_s[r * HS + col] = va[n][2 * h];
      t.v_s[r * HS + col + 1] = va[n][2 * h + 1];
    }
  }
}

// generate()'s f32 route, SIMT.
template <typename T, int HDT>
__device__ void generate_simt(Tiles<HDT>& t, const T* __restrict__ x,
                              const T* __restrict__ wk,
                              const T* __restrict__ wv, const AttnShape& sh,
                              int D, int b, int kvh, int j, float* xs,
                              float* wks, float* wvs) {
  constexpr int CJ = Tiles<HDT>::CJ;
  float ka[4][CJ], va[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) ka[i][c] = va[i][c] = 0.f;
  const T* xb = x + (size_t)b * sh.Sk * D;
  for (int d0 = 0; d0 < D; d0 += DC) {
    __syncthreads();   // the staging buffers are free
    for (int idx = t.tid; idx < 64 * DC; idx += NT) {
      const int c = idx / DC, dd = idx % DC, kpos = j * BKV + c, d = d0 + dd;
      xs[c * (DC + 1) + dd] =
          kpos < sh.Sk && d < D ? to_f(xb[(size_t)kpos * D + d]) : 0.f;
    }
    for (int idx = t.tid; idx < DC * HDT; idx += NT) {
      const int dd = idx / HDT, e = idx % HDT, d = d0 + dd;
      const bool in = d < D && e < sh.hd;
      const size_t off = ((size_t)d * sh.Hkv + kvh) * sh.hd + e;
      wks[idx] = in ? to_f(wk[off]) : 0.f;
      wvs[idx] = in ? to_f(wv[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < DC; ++dd) {
      float xv[4], kw[CJ], vw[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[(t.ty + T16 * i) * (DC + 1) + dd];
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        kw[c] = wks[dd * HDT + t.tx + T16 * c];
        vw[c] = wvs[dd * HDT + t.tx + T16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          ka[i][c] = fmaf(xv[i], kw[c], ka[i][c]);
          va[i][c] = fmaf(xv[i], vw[c], va[i][c]);
        }
    }
  }
  constexpr int HS = Smem<HDT>::HS;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      t.k_s[(t.ty + T16 * i) * HS + t.tx + T16 * c] = ka[i][c];
      t.v_s[(t.ty + T16 * i) * HS + t.tx + T16 * c] = va[i][c];
    }
}

// K_j (before qk-norm and RoPE) into t.k_s and V_j into t.v_s, from
// x_kv[b, 64j : 64j + 64] and kv head kvh of wk/wv, through the staging
// buffers xs (64 x (DC + 1)), wks and wvs (DC x HDT) of floats: the tensor
// cores for bf16 inputs, SIMT f32 for f32 ones.
template <typename T, int HDT>
__device__ void generate(Tiles<HDT>& t, const T* __restrict__ x,
                         const T* __restrict__ wk, const T* __restrict__ wv,
                         const AttnShape& sh, const Side& sd, int b, int kvh,
                         int j, float* xs, float* wks, float* wvs) {
  if constexpr (std::is_same<T, wm::bf16>::value)
    generate_tc(t, x, wk, wv, sh, sd, b, kvh, j, xs, wks, wvs);
  else
    generate_simt(t, x, wk, wv, sh, sd.D, b, kvh, j, xs, wks, wvs);
}

// qk-norm and RoPE of the generated K_j in t.k_s, one warp per key row, as
// the forward kernel does them.  With kpre_s set, the rows before them go
// there and each row's 1 / rms to r_s (the backward of the norm needs both).
template <int HDT>
__device__ void finish_k(Tiles<HDT>& t, const AttnShape& sh, const Side& sd,
                         int j, float* kpre_s, float* r_s) {
  constexpr int HS = Smem<HDT>::HS;
  const int warp = t.tid / 32, lane = t.tid % 32, hd = sh.hd, half = hd / 2;
  for (int c = warp; c < BKV; c += NT / 32) {
    float* kr = t.k_s + c * HS;
    if (kpre_s)
      for (int e = lane; e < HDT; e += 32) kpre_s[c * HS + e] = kr[e];
    float inv = 1.f;
    if (sd.use_knorm) {
      float ss = 0.f;
      for (int e = lane; e < hd; e += 32) ss += kr[e] * kr[e];
      inv = rsqrtf(warp_sum(ss) / hd + sd.eps);
      if (r_s && lane == 0) r_s[c] = inv;
      if (!sd.use_rope)
        for (int e = lane; e < hd; e += 32) kr[e] = kr[e] * inv * sd.k_gamma[e];
    }
    if (sd.use_rope) {
      const int kpos = j * BKV + c;
      for (int e = lane; e < half; e += 32) {
        float k1 = kr[e], k2 = kr[e + half];
        if (sd.use_knorm) {
          k1 = k1 * inv * sd.k_gamma[e];
          k2 = k2 * inv * sd.k_gamma[e + half];
        }
        float sn = 0.f, cs = 0.f;
        if (kpos < sh.Sk) {
          sn = sd.sin_t[(size_t)kpos * half + e];
          cs = sd.cos_t[(size_t)kpos * half + e];
        }
        kr[e] = k1 * cs - k2 * sn;
        kr[e + half] = k2 * cs + k1 * sn;
      }
    }
  }
}

// dK of the rotated keys (t.k_s) -> dK before RoPE, in place, one warp per
// key row: the rotation by -angle.
template <int HDT>
__device__ void rope_back(Tiles<HDT>& t, const AttnShape& sh, const Side& sd,
                          int j) {
  constexpr int HS = Smem<HDT>::HS;
  const int warp = t.tid / 32, lane = t.tid % 32, half = sh.hd / 2;
  for (int c = warp; c < BKV; c += NT / 32) {
    float* kr = t.k_s + c * HS;
    const int kpos = j * BKV + c;
    for (int e = lane; e < half; e += 32) {
      const float g1 = kr[e], g2 = kr[e + half];
      float sn = 0.f, cs = 0.f;
      if (kpos < sh.Sk) {
        sn = sd.sin_t[(size_t)kpos * half + e];
        cs = sd.cos_t[(size_t)kpos * half + e];
      }
      kr[e] = g1 * cs + g2 * sn;
      kr[e + half] = g2 * cs - g1 * sn;
    }
  }
}

template <typename T, int HDT>
__global__ void __launch_bounds__(NT)
dkvgen_kernel(const T* __restrict__ q, const T* __restrict__ x,
              const T* __restrict__ wk, const T* __restrict__ wv,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dx,
              float* __restrict__ dwk, float* __restrict__ dwv,
              float* __restrict__ dg, AttnShape sh, Side sd) {
  extern __shared__ float smem[];
  Tiles<HDT> t(smem);
  using L = Smem<HDT>;
  constexpr int HS = L::HS, PS = L::PS, CJ = Tiles<HDT>::CJ;
  float* kpre_s = t.end();          // (64, HS) K_j before qk-norm and RoPE
  float* r_s = kpre_s + 64 * HS;    // (64) 1 / rms of each row of K_j
  const int j = blockIdx.x, b = blockIdx.y, blk = b * gridDim.x + j;
  const int G = sh.Hq / sh.Hkv, hd = sh.hd, D = sd.D, lane = t.tid % 32;
  const T* xb = x + (size_t)b * sh.Sk * D;
  float dga = 0.f;                  // dγ[tid] of this tile, tid < hd
  for (int kvh = 0; kvh < sh.Hkv; ++kvh) {
    // generation stages in P, Q and dO, which are free until the walk
    generate(t, x, wk, wv, sh, sd, b, kvh, j, t.p_s, t.q_s, t.do_s);
    __syncthreads();
    finish_k(t, sh, sd, j, kpre_s, r_s);
    float dka[4][CJ], dva[4][CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) dka[i][c] = dva[i][c] = 0.f;
    for (int g = 0; g < G; ++g) {
      for (int q0 = 0; q0 < sh.Sq; q0 += BQ) {
        const tc::KvRange kv = span_tiles(sh, g, q0);
        if (j < kv.lo || j >= kv.hi) continue;   // no live pair with tile j
        __syncthreads();
        t.load_rows(q, dout, lse, delta, sh, b, kvh * G + g, q0);
        __syncthreads();
        t.probs(sh, j);
        __syncthreads();
        t.acc_dkv(dka, dva);
      }
    }
    __syncthreads();   // K_j and V_j are read for the last time
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        t.k_s[(t.ty + T16 * i) * HS + t.tx + T16 * c] = dka[i][c];
        t.v_s[(t.ty + T16 * i) * HS + t.tx + T16 * c] = dva[i][c];
      }
    __syncthreads();
    if (sd.use_rope) {
      rope_back(t, sh, sd, j);
      __syncthreads();
    }
    if (sd.use_knorm) {
      // dγ[e] += sum over rows of dK_n[e] * K_pre[e] / rms
      if (t.tid < hd)
        for (int c = 0; c < BKV; ++c)
          dga = fmaf(t.k_s[c * HS + t.tid] * kpre_s[c * HS + t.tid], r_s[c], dga);
      __syncthreads();
      // dK_pre = r γ dK_n - r^3 K_pre (sum_e dK_n γ K_pre) / hd, warp per row
      for (int c = t.tid / 32; c < BKV; c += NT / 32) {
        float* kr = t.k_s + c * HS;
        const float* kp = kpre_s + c * HS;
        const float r = r_s[c];
        float dot = 0.f;
        for (int e = lane; e < hd; e += 32) dot += kr[e] * sd.k_gamma[e] * kp[e];
        dot = warp_sum(dot);
        for (int e = lane; e < hd; e += 32)
          kr[e] = r * sd.k_gamma[e] * kr[e] - r * r * r * kp[e] * dot / hd;
      }
      __syncthreads();
    }
    // t.k_s = dK before the norm, t.v_s = dV: the products with W and x_j
    float* xc = t.p_s;    // (64 keys, PS): x_j[:, d0 : d0 + 64]
    float* wkc = t.q_s;   // (64 rows of D, HS): wk[d0 : d0 + 64, kvh]
    float* wvc = t.do_s;
    for (int d0 = 0; d0 < D; d0 += DX) {
      __syncthreads();
      for (int idx = t.tid; idx < BKV * DX; idx += NT) {
        const int c = idx / DX, dd = idx % DX, kpos = j * BKV + c, d = d0 + dd;
        xc[c * PS + dd] =
            kpos < sh.Sk && d < D ? to_f(xb[(size_t)kpos * D + d]) : 0.f;
      }
      for (int idx = t.tid; idx < DX * HDT; idx += NT) {
        const int dd = idx / HDT, e = idx % HDT, d = d0 + dd;
        const bool in = d < D && e < hd;
        const size_t off = ((size_t)d * sh.Hkv + kvh) * hd + e;
        wkc[dd * HS + e] = in ? to_f(wk[off]) : 0.f;
        wvc[dd * HS + e] = in ? to_f(wv[off]) : 0.f;
      }
      __syncthreads();
      // dx[key, d] += dK_pre[key] . wk[d] + dV[key] . wv[d]
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
      for (int e = 0; e < HDT; ++e) {
        float gk[4], gv[4], ak[4], av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gk[i] = t.k_s[(t.ty + T16 * i) * HS + e];
          gv[i] = t.v_s[(t.ty + T16 * i) * HS + e];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ak[c] = wkc[(t.tx + T16 * c) * HS + e];
          av[c] = wvc[(t.tx + T16 * c) * HS + e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][c] = fmaf(gk[i], ak[c], fmaf(gv[i], av[c], acc[i][c]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = j * BKV + t.ty + T16 * i;
        if (kpos >= sh.Sk) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = d0 + t.tx + T16 * c;
          if (d >= D) continue;
          float* o = dx + ((size_t)b * sh.Sk + kpos) * D + d;
          *o = kvh == 0 ? acc[i][c] : *o + acc[i][c];
        }
      }
      // this tile's dW_K[d, kvh] = x_j[:, d]^T dK_pre, dW_V likewise
      float pk[4][CJ], pv[4][CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) pk[i][c] = pv[i][c] = 0.f;
      for (int key = 0; key < BKV; ++key) {
        float xv[4], gk[CJ], gv[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xc[key * PS + t.ty + T16 * i];
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          gk[c] = t.k_s[key * HS + t.tx + T16 * c];
          gv[c] = t.v_s[key * HS + t.tx + T16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CJ; ++c) {
            pk[i][c] = fmaf(xv[i], gk[c], pk[i][c]);
            pv[i][c] = fmaf(xv[i], gv[c], pv[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = d0 + t.ty + T16 * i;
        if (d >= D) continue;
        const size_t row = (((size_t)blk * D + d) * sh.Hkv + kvh) * hd;
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          const int e = t.tx + T16 * c;
          if (e < hd) {
            dwk[row + e] = pk[i][c];
            dwv[row + e] = pv[i][c];
          }
        }
      }
    }
    __syncthreads();   // the products are done with k_s, v_s and the chunks
  }
  if (sd.use_knorm && t.tid < hd) dg[(size_t)blk * hd + t.tid] = dga;
}

template <typename T, int HDT>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ x,
          const T* __restrict__ wk, const T* __restrict__ wv,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, AttnShape sh,
          Side sd) {
  extern __shared__ float smem[];
  Tiles<HDT> t(smem);
  constexpr int CJ = Tiles<HDT>::CJ;
  float* xs = t.end();              // (64, DC + 1)
  float* wks = xs + 64 * (DC + 1);  // (DC, HDT)
  float* wvs = wks + DC * HDT;
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const int G = sh.Hq / sh.Hkv, kvh = head / G;
  const tc::KvRange kv = span_tiles(sh, head % G, q0);
  t.load_rows(q, dout, lse, delta, sh, b, head, q0);
  float dqa[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dqa[i][c] = 0.f;
  for (int j = kv.lo; j < kv.hi; ++j) {
    __syncthreads();   // the previous tile's products are done
    generate(t, x, wk, wv, sh, sd, b, kvh, j, xs, wks, wvs);
    __syncthreads();
    finish_k(t, sh, sd, j, nullptr, nullptr);
    __syncthreads();
    t.probs(sh, j);
    __syncthreads();
    t.acc_dq(dqa);
  }
  const size_t row0 = (size_t)(b * sh.Hq + head) * sh.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + t.ty + T16 * i;
    if (qi >= sh.Sq) continue;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int col = t.tx + T16 * c;
      if (col < sh.hd) dq[(row0 + qi) * sh.hd + col] = from_f<T>(dqa[i][c]);
    }
  }
}

template <typename T, int HDT>
int launch(const void* q, const void* x, const void* wk, const void* wv,
           const void* out, const void* dout, const float* lse, float* delta,
           void* dq, float* dx, float* dwk, float* dwv, float* dg,
           float* dwk_out, float* dwv_out, float* dg_out,
           const AttnShape& sh, const Side& sd, cudaStream_t stream) {
  int err = launch_delta<T>(out, dout, delta, sh.B * sh.Hq * sh.Sq, sh.hd,
                            stream);
  if (err) return err;
  constexpr int HS = Smem<HDT>::HS;
  const size_t kv_smem = sizeof(float) * (Smem<HDT>::FLOATS + 64 * HS + 64);
  const size_t q_smem =
      sizeof(float) * (Smem<HDT>::FLOATS + 64 * (DC + 1) + 2 * DC * HDT);
  auto kkv = dkvgen_kernel<T, HDT>;
  auto kq = dq_kernel<T, HDT>;
  static unsigned long long done_kv = 0, done_q = 0;
  if ((err = set_smem(kkv, kv_smem, done_kv)) ||
      (err = set_smem(kq, q_smem, done_q)))
    return err;
  if (sh.Sk > 0) {
    kkv<<<dim3((sh.Sk + BKV - 1) / BKV, sh.B), NT, kv_smem, stream>>>(
        (const T*)q, (const T*)x, (const T*)wk, (const T*)wv, (const T*)dout,
        lse, delta, dx, dwk, dwv, dg, sh, sd);
    if ((err = (int)cudaGetLastError())) return err;
    // the per-tile partials, summed in tile order
    const int tiles = sh.B * ((sh.Sk + BKV - 1) / BKV);
    const long long nw = (long long)sd.D * sh.Hkv * sh.hd;
    if ((err = launch_reduce(dwk, dwk_out, nw, tiles, stream)) ||
        (err = launch_reduce(dwv, dwv_out, nw, tiles, stream)))
      return err;
    if (sd.use_knorm &&
        (err = launch_reduce(dg, dg_out, sh.hd, tiles, stream)))
      return err;
  } else {
    cudaMemsetAsync(dwk_out, 0, (size_t)sd.D * sh.Hkv * sh.hd * 4, stream);
    cudaMemsetAsync(dwv_out, 0, (size_t)sd.D * sh.Hkv * sh.hd * 4, stream);
    if (sd.use_knorm) cudaMemsetAsync(dg_out, 0, sh.hd * 4, stream);
  }
  if (sh.Sq > 0) {
    kq<<<dim3((sh.Sq + BQ - 1) / BQ, sh.Hq, sh.B), NT, q_smem, stream>>>(
        (const T*)q, (const T*)x, (const T*)wk, (const T*)wv, (const T*)dout,
        lse, delta, (T*)dq, sh, sd);
    err = (int)cudaGetLastError();
  }
  return err;
}

template <typename T>
int dispatch(const void* q, const void* x, const void* wk, const void* wv,
             const void* out, const void* dout, const float* lse,
             float* delta, void* dq, float* dx, float* dwk, float* dwv,
             float* dg, float* dwk_out, float* dwv_out, float* dg_out,
             const AttnShape& sh, const Side& sd, cudaStream_t stream) {
  if (sh.hd <= 32)
    return launch<T, 32>(q, x, wk, wv, out, dout, lse, delta, dq, dx, dwk,
                         dwv, dg, dwk_out, dwv_out, dg_out, sh, sd, stream);
  if (sh.hd <= 64)
    return launch<T, 64>(q, x, wk, wv, out, dout, lse, delta, dq, dx, dwk,
                         dwv, dg, dwk_out, dwv_out, dg_out, sh, sd, stream);
  return launch<T, 128>(q, x, wk, wv, out, dout, lse, delta, dq, dx, dwk,
                        dwv, dg, dwk_out, dwv_out, dg_out, sh, sd, stream);
}

}  // namespace bwd
}  // namespace repro

#include "attention_bwd_tc.cuh"

namespace repro {
namespace tcb {

// dK of the rotated, normed keys (warpgroup 0's accumulators) -> dK before
// the qk-norm, in place: the RoPE backward (rotation by -angle), then the
// norm's, dK_pre = r γ dK_n - r^3 K_pre (Σ dK_n γ K_pre) / hd.  The norm's
// dγ products of the tile go through kpre, and thread c < HD adds column
// c's 64 rows to dga in row order.
template <int HD, int HDP>
__device__ void k_back(float (&dk)[HDP / 2], int j, const AttnShape& sh,
                       const StreamSide& sd, float* kpre, float& dga) {
  const Frag f;
  if (sd.use_rope) {
    constexpr int HALF = HD / 2, NB = HALF / 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kpos = j * BK + f.r0 + 8 * h;
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + 2 * f.t + e;
          const int a = 4 * i + 2 * h + e, c = 4 * (i + NB) + 2 * h + e;
          float sn = 0.f, cs = 0.f;
          if (kpos < sh.Sk) {
            sn = sd.sin_t[(size_t)kpos * HALF + col];
            cs = sd.cos_t[(size_t)kpos * HALF + col];
          }
          const float g1 = dk[a], g2 = dk[c];
          dk[a] = g1 * cs + g2 * sn;
          dk[c] = g2 * cs - g1 * sn;
        }
    }
  }
  if (!sd.use_knorm) return;
  float r[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HDP / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * i + 2 * h + e, col = 8 * i + 2 * f.t + e;
        const float kp = kpre[x * WGT + f.tid];
        const float gm = col < HD ? sd.k_gamma[col] : 0.f;
        r[h] += kp * kp;
        dot[h] += dk[x] * gm * kp;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r[h] += __shfl_xor_sync(0xffffffff, r[h], 1);
    r[h] += __shfl_xor_sync(0xffffffff, r[h], 2);
    r[h] = rsqrtf(r[h] / HD + sd.eps);
    dot[h] += __shfl_xor_sync(0xffffffff, dot[h], 1);
    dot[h] += __shfl_xor_sync(0xffffffff, dot[h], 2);
  }
#pragma unroll
  for (int i = 0; i < HDP / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * i + 2 * h + e, col = 8 * i + 2 * f.t + e;
        const float kp = kpre[x * WGT + f.tid];
        const float gm = col < HD ? sd.k_gamma[col] : 0.f;
        kpre[x * WGT + f.tid] = dk[x] * kp * r[h];
        dk[x] = r[h] * gm * dk[x] - r[h] * r[h] * r[h] * kp * dot[h] / HD;
      }
  named_sync(BAR_WG0, WGT);
  if (f.tid < HD) {
    const int c = f.tid, i = c / 8, e = c % 2;
    for (int row = 0; row < 64; ++row) {
      const int h = (row % 16) / 8, lane = (row % 8) * 4 + (c % 8) / 2;
      dga += kpre[(4 * i + 2 * h + e) * WGT + (row / 16) * 32 + lane];
    }
  }
  named_sync(BAR_WG0, WGT);                    // kpre is free again
}

// dW[d0 .. d0 + 63, h, :] (+)= x_j[:, d0 ..]^T (dK_hi + dK_lo), at row
// stride Hkv * HD from w: the dW partial of a D chunk (x_j's box at xs, A
// MN-major) and one head's split dK_pre or dV at d (hi, then lo PART bytes
// on), added to the block's slot unless `first` is false.  The slot's
// values are loaded while the products run.  rows: D - d0.
template <int HD, int HDP>
__device__ __forceinline__ void add_dw(float* __restrict__ w, uint32_t xs,
                                       uint32_t d, bool add, int rows,
                                       int Hkv) {
  constexpr int PART = (HDP / 64) * BOX_BYTES;
  const Frag f;
  float acc[HDP / 2], old[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = old[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t xa = desc_mnmajor(xs + kk * 2048);
    wgmma_ss_t<1, 1>(acc, xa, desc_mnmajor(d + kk * 2048), 1);
    wgmma_ss_t<1, 1>(acc, xa, desc_mnmajor(d + PART + kk * 2048), 1);
  }
  wgmma_commit();
  if (add) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < HDP / 8; ++i) {
        const int row = f.r0 + 8 * h, col = 8 * i + 2 * f.t;
        if (row < rows && col < HD) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(
              w + (size_t)row * Hkv * HD + col));
          old[4 * i + 2 * h] = v.x;
          old[4 * i + 2 * h + 1] = v.y;
        }
      }
  }
  wgmma_wait_all();
  fence_regs(acc);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i) {
      const int row = f.r0 + 8 * h, col = 8 * i + 2 * f.t;
      if (row < rows && col < HD)
        __stcg(reinterpret_cast<float2*>(w + (size_t)row * Hkv * HD + col),
               make_float2(acc[4 * i + 2 * h] + old[4 * i + 2 * h],
                           acc[4 * i + 2 * h + 1] + old[4 * i + 2 * h + 1]));
    }
}

// ---- dK/dV, the generation's backward, dx and dW ----

template <int HDP, int NH>
struct StreamDkvSmem {
  static constexpr int PART = (HDP / 64) * BOX_BYTES;   // 64 rows x HDP
  static constexpr int KV = 4 * PART;          // K_hi, K_lo, V_hi, V_lo
  // dK_pre and dV as hi/lo per head of the block (the KV tiles when NH = 1)
  static constexpr int DKV = NH == 1 ? 0 : NH * 4 * PART;
  // K before the norm; in the dx pass the two exchange buffers (64 x 64 f32)
  static constexpr int KPRE = 64 * HDP * 4 > 2 * 64 * 64 * 4 ? 64 * HDP * 4
                                                             : 2 * 64 * 64 * 4;
  static constexpr int GEN = BOX_BYTES + 2 * PART;     // x, W_K, W_V chunks
  static constexpr int SPAN = 2 * PART + LSE_BYTES;    // Q, dO, lse, delta
  static constexpr int DX = BOX_BYTES + NH * 2 * PART; // x, NH x (W_K, W_V)
  static constexpr int M1 = GEN > SPAN ? GEN : SPAN;
  static constexpr int STAGE = (M1 > DX ? M1 : DX);
  static constexpr int FIXED = KV + DKV + KPRE;
  static constexpr int STAGES = FIXED + 3 * STAGE + 2048 <= 232448 ? 3 : 2;
  static constexpr int DKV_OFF = NH == 1 ? 0 : KV;
  static constexpr int KPRE_OFF = KV + DKV;
  static constexpr int RING = KPRE_OFF + KPRE;
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;
  static_assert(KV >= 64 * HDP * 2 * 4, "the combine buffer is the KV tiles");
  static_assert(BYTES <= 232448, "shared memory");
};

// One block per (kv head group, tile group g, batch), in clusters of C
// blocks over the kv heads: rank c owns heads c·NH .. c·NH + NH - 1 and
// walks the kv tiles j = g, g + NG, ... of its batch row.  Per tile and
// head: generate K_j, V_j (split), walk the live query spans of the head's
// G query heads (warpgroups alternating), add the two partials, go back
// through RoPE and the norm, keep dK_pre and dV split.  Then per 64-wide D
// chunk: warpgroup 0 forms the block's dx partial Σ_heads dK_pre W_K^T +
// dV W_V^T and the cluster adds the C partials in rank order through
// distributed shared memory (each rank adds 1/C of the chunk); warpgroup 1 forms
// dW_K = x_j^T dK_pre and dW_V = x_j^T dV and adds them to the block's
// slot in device memory (its own: no atomics).  reduce_slots then sums the
// B·NG slots in order.
template <int HD, int NH>
__global__ void __launch_bounds__(THREADS, 1)
stream_dkv_tc(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wkmap,
              const __grid_constant__ CUtensorMap wvmap,
              const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap domap,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dx, float* __restrict__ dwk_slots,
              float* __restrict__ dwv_slots, float* __restrict__ dg_slots,
              AttnShape sh, StreamSide sd, int NG) {
  constexpr int HDP = HD <= 64 ? 64 : 128;
  using L = StreamDkvSmem<HDP, NH>;
  constexpr int PART = L::PART;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full = base + L::BARS, empty = full + 8 * L::STAGES;
  const int C = cluster_size(), rank = cluster_rank();
  const int g = blockIdx.x / C, b = blockIdx.y;
  const int G = sh.Hq / sh.Hkv, D = sd.D;
  const int ntiles = (sh.Sk + BK - 1) / BK, nch = (D + 63) / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init_fence();
  }
  cluster_sync();

  if (threadIdx.x >= CONSUMERS) {             // producer warpgroup
    setmaxnreg_dec<24>();
    // The whole warpgroup follows the schedule (it joins the cluster
    // barriers); its first warp loads.  A cluster barrier closes each dx
    // chunk (and each tile) once the consumers are done with its stage:
    // the producer joins it before it needs a stage freed after it.
    const bool act = threadIdx.x < CONSUMERS + 32;
    const int lane = threadIdx.x % 32;
    int it = 0, pend[8], p0 = 0, p1 = 0;
    auto acquire = [&]() {
      while (p0 != p1 && pend[p0 & 7] < it - L::STAGES) {
        cluster_sync();
        ++p0;
      }
      const int st = it % L::STAGES;
      if (it >= L::STAGES) mbar_wait(empty + 8 * st, ((it / L::STAGES) & 1) ^ 1);
      return st;
    };
    for (int j = g; j < ntiles; j += NG) {
      for (int hb = 0; hb < NH; ++hb) {
        const int h = rank * NH + hb;
        for (int ci = 0; ci < nch; ++ci, ++it) {
          const int st = acquire();
          const uint32_t xs = base + L::RING + st * L::STAGE, bar = full + 8 * st;
          if (!act) continue;
          if (lane == 0) {
            mbar_expect_tx(bar, L::GEN);
            tma_load_3d(xs, &xmap, bar, 64 * ci, j * BK, b);
            for (int c = 0; c < HDP / 64; ++c) {
              tma_load_3d(xs + BOX_BYTES + c * BOX_BYTES, &wkmap, bar, 64 * c, h, 64 * ci);
              tma_load_3d(xs + BOX_BYTES + PART + c * BOX_BYTES, &wvmap, bar, 64 * c, h,
                          64 * ci);
            }
          } else {
            mbar_arrive(bar);
          }
        }
        for (int gq = 0; gq < G; ++gq)
          for (int q0 = 0; q0 < sh.Sq; q0 += bwd::BQ) {
            if (!span_live(sh, gq, q0, j)) continue;
            const int st = acquire();
            const uint32_t qs = base + L::RING + st * L::STAGE, bar = full + 8 * st;
            const int bh = b * sh.Hq + h * G + gq;
            ++it;
            if (!act) continue;
            load_lse(reinterpret_cast<float*>(gbase + (qs + 2 * PART - base)), lse,
                     delta, (size_t)bh * sh.Sq, q0, sh.Sq, lane);
            if (lane == 0) {
              mbar_expect_tx(bar, 2 * PART);
              for (int c = 0; c < HDP / 64; ++c) {
                tma_load_3d(qs + c * BOX_BYTES, &qmap, bar, 64 * c, q0, bh);
                tma_load_3d(qs + PART + c * BOX_BYTES, &domap, bar, 64 * c, q0, bh);
              }
            } else {
              mbar_arrive(bar);
            }
          }
      }
      for (int ci = 0; ci < nch; ++ci, ++it) {
        const int st = acquire();
        const uint32_t xs = base + L::RING + st * L::STAGE, bar = full + 8 * st;
        pend[p1++ & 7] = it;                  // closed by a cluster barrier
        if (!act) continue;
        if (lane == 0) {
          mbar_expect_tx(bar, L::DX);
          tma_load_3d(xs, &xmap, bar, 64 * ci, j * BK, b);
          for (int hb = 0; hb < NH; ++hb)
            for (int c = 0; c < HDP / 64; ++c) {
              const uint32_t w = xs + BOX_BYTES + hb * 2 * PART + c * BOX_BYTES;
              tma_load_3d(w, &wkmap, bar, 64 * c, rank * NH + hb, 64 * ci);
              tma_load_3d(w + PART, &wvmap, bar, 64 * c, rank * NH + hb, 64 * ci);
            }
        } else {
          mbar_arrive(bar);
        }
      }
      pend[p1++ & 7] = it - 1;                // the tile's closing barrier
    }
    for (; p0 != p1; ++p0) cluster_sync();
    return;
  }

  // consumer warpgroups
  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / WGT;
  const Frag f;
  Ring ring{base + L::RING, full, empty, L::STAGES, L::STAGE, 0};
  float* kpre = reinterpret_cast<float*>(gbase + L::KPRE_OFF);
  const uint32_t kv = base, dkv = base + L::DKV_OFF;
  const uint32_t xb = base + L::KPRE_OFF;   // dx exchange buffers (kpre's bytes)
  const size_t slot = (size_t)b * NG + g;
  float dga = 0.f;
  for (int j = g; j < ntiles; j += NG) {
    for (int hb = 0; hb < NH; ++hb) {
      gen_kv<HD, HDP>(j, wg, kv, ring, sh, sd, sd.use_knorm ? kpre : nullptr);
      named_sync(BAR_PAIR, CONSUMERS);        // K_j and V_j are complete
      DkvAcc<HDP, HDP, true> acc;
      acc.zero();
      int n = 0;
      for (int gq = 0; gq < G; ++gq)
        for (int q0 = 0; q0 < sh.Sq; q0 += bwd::BQ) {
          if (!span_live(sh, gq, q0, j)) continue;
          if (n++ % 2 != wg) {
            ring.skip();
            continue;
          }
          const uint32_t qs = ring.wait();
          acc.span(sh, j * BK, q0, kv, kv + PART, kv + 2 * PART, kv + 3 * PART, qs,
                   qs + PART,
                   reinterpret_cast<const float*>(gbase + (qs + 2 * PART - base)));
          ring.release(2);                     // for both warpgroups
        }
      acc.combine(reinterpret_cast<float*>(gbase), wg);
      const uint32_t dst = dkv + hb * 4 * PART;
      if (wg == 0) {
        k_back<HD, HDP>(acc.dk, j, sh, sd, kpre, dga);
        store_split<HDP / 2>(acc.dk, dst, dst + PART);
      } else {
        store_split<HDP / 2>(acc.dv, dst + 2 * PART, dst + 3 * PART);
      }
      named_sync(BAR_PAIR, CONSUMERS);        // dK_pre and dV are complete
    }
    for (int ci = 0; ci < nch; ++ci) {
      const uint32_t xs = ring.wait();
      if (wg == 0) {                           // dx partial of the block's heads
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        fence_regs(acc);
        wgmma_fence();
        for (int hb = 0; hb < NH; ++hb) {
          const uint32_t d = dkv + hb * 4 * PART;
          const uint32_t wks = xs + BOX_BYTES + hb * 2 * PART, wvs = wks + PART;
          mma_kk<HDP / 16>(acc, d, wks);
          mma_kk<HDP / 16>(acc, d + PART, wks);
          mma_kk<HDP / 16>(acc, d + 2 * PART, wvs);
          mma_kk<HDP / 16>(acc, d + 3 * PART, wvs);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        ring.release();
        // element i of thread tid at float (i / 4 * 128 + tid) * 4 + i % 4
        float4* buf = reinterpret_cast<float4*>(gbase + L::KPRE_OFF) +
                      (ci % 2) * 64 * 64 / 4;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          buf[i * WGT + f.tid] = make_float4(acc[4 * i], acc[4 * i + 1],
                                             acc[4 * i + 2], acc[4 * i + 3]);
      } else {                                 // dW of each head, into the slot
        for (int hb = 0; hb < NH; ++hb) {
          const uint32_t d = dkv + hb * 4 * PART;
          const size_t o = (slot * D + 64 * ci) * sh.Hkv + rank * NH + hb;
          add_dw<HD, HDP>(dwk_slots + o * HD, xs, d, j != g, D - 64 * ci, sh.Hkv);
          add_dw<HD, HDP>(dwv_slots + o * HD, xs, d + 2 * PART, j != g, D - 64 * ci,
                          sh.Hkv);
        }
        ring.release();
      }
      cluster_sync();                          // every block's partial is in
      if (wg == 0) {                           // rank r adds groups r, r + C, ..
        const uint32_t buf = xb + (ci % 2) * 64 * 64 * 4;
        for (int i = rank; i < 8; i += C) {
          // the C partials of elements 4i .. 4i + 3, added in rank order
          float4 p[MAX_CLUSTER];
#pragma unroll
          for (int r = 0; r < MAX_CLUSTER; ++r)
            if (r < C) p[r] = ld_cluster_f32x4(map_to_rank(buf + (i * WGT + f.tid) * 16, r));
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int r = 0; r < MAX_CLUSTER; ++r)
            if (r < C) {
              v.x += p[r].x;
              v.y += p[r].y;
              v.z += p[r].z;
              v.w += p[r].w;
            }
          // elements 4i .. 4i + 3: rows r0, r0 + 8; columns 8i + 2t, + 1
          const int col = 8 * i + 2 * f.t, d = 64 * ci + col;
          const float vals[2][2] = {{v.x, v.y}, {v.z, v.w}};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kpos = j * BK + f.r0 + 8 * h;
            if (kpos < sh.Sk && d < D)
              *reinterpret_cast<float2*>(dx + ((size_t)b * sh.Sk + kpos) * D + d) =
                  make_float2(vals[h][0], vals[h][1]);
          }
        }
      }
    }
    cluster_sync();                            // the peers are done reading
  }
  if (wg == 0 && sd.use_knorm && f.tid < HD)
    dg_slots[(slot * C + rank) * HD + f.tid] = dga;
}

// ---- dQ: K/V tiles generated once per cluster and forwarded ----

template <int HDP>
struct StreamDqSmem {
  static constexpr int PART = (HDP / 64) * BOX_BYTES;
  static constexpr int TILE = 4 * PART;                 // K_hi .. V_lo
  static constexpr int DO = 2 * PART;                   // dO of 128 rows
  static constexpr int STAGE = BOX_BYTES + 2 * PART;    // x, W_K, W_V chunks
  static constexpr int STAGES = HDP <= 64 ? 4 : 1;
  static constexpr int RING = 2 * TILE + DO;
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr int BYTES = BARS + (2 * STAGES + 3) * 8 + 1024;
  static_assert(BYTES <= 232448, "shared memory");
};

// The forward kernel's dataflow (stream_attention.cu) with the dQ step in
// place of the online softmax: a block owns 128 flattened query rows of one
// (batch, kv head), clusters of C consecutive row tiles; per round of C
// live kv tiles block c generates tile j0 + c once and the tiles travel
// around the cluster's ring of SMs, each used where it lands.  So each
// tile is generated G·Sq / (128·C) times (4 at vilbert's 4096), not once
// per 64 query rows.  dO of the block arrives by TMA once; Q is the
// register A operand.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
stream_dq_tc(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wkmap,
             const __grid_constant__ CUtensorMap wvmap,
             const __grid_constant__ CUtensorMap domap,
             const bf16* __restrict__ q, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dq,
             AttnShape sh, StreamSide sd) {
  constexpr int HDP = HD <= 64 ? 64 : 128;
  using L = StreamDqSmem<HDP>;
  constexpr int PART = L::PART;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + L::BARS, empty = full + 8 * L::STAGES;
  const uint32_t arrived = empty + 8 * L::STAGES, dobar = arrived + 16;
  const int C = cluster_size(), rank = cluster_rank();
  const int G = sh.Hq / sh.Hkv, nrows = G * sh.Sq;
  const int t0 = blockIdx.x * ROWS, kvh = blockIdx.y, b = blockIdx.z;
  // the cluster's rows decide its kv tiles: every block walks them all
  const int c0 = (blockIdx.x - rank) * ROWS;
  int qmin = 0, qmax = 0;
  bool any = q_span(c0, min(c0 + C * ROWS, nrows), sh, qmin, qmax);
  const KvRange kv = live_kv_tiles(sh, any, qmin, qmax);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init(arrived, 1);
    mbar_init(arrived + 8, 1);
    mbar_init(dobar, 1);
    mbar_init_fence();
  }
  cluster_sync();   // every peer's barriers exist before any push

  if (threadIdx.x >= CONSUMERS) {             // producer warpgroup
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      const int row0 = (b * sh.Hq + kvh * G) * sh.Sq + t0;
      mbar_expect_tx(dobar, L::DO);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < HDP / 64; ++c)
          tma_load_2d(base + 2 * L::TILE + w * PART + c * BOX_BYTES, &domap, dobar,
                      64 * c, row0 + 64 * w);
    }
    produce_rounds<HDP>(kv, b, kvh, sd.D, base, base + L::RING, L::STAGES,
                        L::STAGE, full, empty, arrived, &xmap, &wkmap, &wvmap);
  } else {                                    // consumer warpgroups
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / WGT;
    DqRows<HDP, HDP, true> rows;
    rows.init(q, lse, delta, sh, b, kvh, t0 + 64 * wg);
    const uint32_t dos = base + 2 * L::TILE + wg * PART;
    Ring ring{base + L::RING, full, empty, L::STAGES, L::STAGE, 0};
    mbar_wait(dobar, 0);
    consume_rounds<HD, HDP>(kv, wg, base, arrived, ring, sh, sd,
                            [&](int j, uint32_t tile) {
      rows.tile(sh, j, tile, tile + PART, tile + 2 * PART, tile + 3 * PART, dos);
    });
    rows.store(dq, sh, b, t0 + 64 * wg);
  }
}

// The dK/dV kernel's cluster over kv heads: the largest C <= 8 that divides
// Hkv with NH = Hkv / C heads a block, NH * HDP <= 128 (the dK/dV tiles of
// the block's heads fit beside the rest); 0 if none.
inline int dkv_cluster(int Hkv, int hd) {
  const int hdp = hd <= 64 ? 64 : 128;
  for (int c = MAX_CLUSTER; c >= 1; --c)
    if (Hkv % c == 0 && (Hkv / c) * hdp <= 128) return c;
  return 0;
}

constexpr int MAX_GROUPS = 16;   // tile groups of the dK/dV kernel

// Tile groups of the dK/dV kernel: at most MAX_GROUPS, so that the dW
// slots (B·NG of them) do not grow with Sk.
inline int dkv_groups(int Sk) {
  const int tiles = (Sk + BK - 1) / BK;
  return tiles < MAX_GROUPS ? tiles : MAX_GROUPS;
}

inline bool takes(const AttnShape& sh, int D, const void* q, const void* x,
                  const void* wk, const void* wv, const void* dout) {
  return (sh.hd == 32 || sh.hd == 64 || sh.hd == 96 || sh.hd == 128) &&
         D % 8 == 0 && dkv_cluster(sh.Hkv, sh.hd) > 0 && tma_ok(x, D) &&
         tma_ok(wk, sh.hd) && tma_ok(wv, sh.hd) && tma_ok(q, sh.hd) &&
         tma_ok(dout, sh.hd);
}

template <int HD, int NH>
int launch_dkv(const CUtensorMap& xmap, const CUtensorMap& wkmap,
               const CUtensorMap& wvmap, const CUtensorMap& qmap,
               const CUtensorMap& domap, const float* lse, const float* delta,
               float* dx, float* dwk_s, float* dwv_s, float* dg_s,
               AttnShape sh, StreamSide sd, int C, int NG, cudaStream_t stream) {
  constexpr int HDP = HD <= 64 ? 64 : 128;
  using L = StreamDkvSmem<HDP, NH>;
  auto kernel = stream_dkv_tc<HD, NH>;
  static unsigned long long done = 0;
  int err = bwd::set_smem(kernel, L::BYTES, done);
  if (err) return err;
  cudaError_t e = launch_cluster(kernel, dim3(C * NG, sh.B), C, L::BYTES,
                                 stream, xmap, wkmap, wvmap, qmap, domap, lse,
                                 delta, dx, dwk_s, dwv_s, dg_s, sh, sd, NG);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* x, const void* wk, const void* wv,
           const void* out, const void* dout, const float* lse, float* delta,
           void* dq, float* dx, float* dwk_s, float* dwv_s, float* dg_s,
           float* dwk, float* dwv, float* dg, const AttnShape& sh,
           const StreamSide& sd, cudaStream_t stream) {
  constexpr int HDP = HD <= 64 ? 64 : 128;
  int err = bwd::launch_delta<bf16>(out, dout, delta, sh.B * sh.Hq * sh.Sq,
                                    sh.hd, stream);
  if (err) return err;
  const int D = sd.D;
  const uint64_t bq = (uint64_t)sh.B * sh.Hq;
  CUtensorMap xmap, wkmap, wvmap, qmap, domap, do2;
  if ((err = make_map(&xmap, x, D, sh.Sk, sh.B, (uint64_t)D * 2,
                      (uint64_t)sh.Sk * D * 2, BK, 1)) ||
      (err = make_map(&wkmap, wk, sh.hd, sh.Hkv, D, (uint64_t)sh.hd * 2,
                      (uint64_t)sh.Hkv * sh.hd * 2, 1, 64)) ||
      (err = make_map(&wvmap, wv, sh.hd, sh.Hkv, D, (uint64_t)sh.hd * 2,
                      (uint64_t)sh.Hkv * sh.hd * 2, 1, 64)) ||
      (err = make_map(&qmap, q, sh.hd, sh.Sq, bq, (uint64_t)sh.hd * 2,
                      (uint64_t)sh.Sq * sh.hd * 2, 64, 1)) ||
      (err = make_map(&domap, dout, sh.hd, sh.Sq, bq, (uint64_t)sh.hd * 2,
                      (uint64_t)sh.Sq * sh.hd * 2, 64, 1)) ||
      (err = make_map_2d(&do2, dout, sh.hd, bq * sh.Sq, (uint64_t)sh.hd * 2, 64)))
    return err;
  const long long nw = (long long)D * sh.Hkv * sh.hd;
  if (sh.Sk > 0) {
    const int C = dkv_cluster(sh.Hkv, sh.hd), NG = dkv_groups(sh.Sk);
    if constexpr (HDP == 64) {
      if (sh.Hkv / C == 2)
        err = launch_dkv<HD, 2>(xmap, wkmap, wvmap, qmap, domap, lse, delta,
                                dx, dwk_s, dwv_s, dg_s, sh, sd, C, NG, stream);
      else
        err = launch_dkv<HD, 1>(xmap, wkmap, wvmap, qmap, domap, lse, delta,
                                dx, dwk_s, dwv_s, dg_s, sh, sd, C, NG, stream);
    } else {
      err = launch_dkv<HD, 1>(xmap, wkmap, wvmap, qmap, domap, lse, delta, dx,
                              dwk_s, dwv_s, dg_s, sh, sd, C, NG, stream);
    }
    if (err) return err;
    if ((err = bwd::launch_reduce(dwk_s, dwk, nw, sh.B * NG, stream)) ||
        (err = bwd::launch_reduce(dwv_s, dwv, nw, sh.B * NG, stream)))
      return err;
    if (sd.use_knorm &&
        (err = bwd::launch_reduce(dg_s, dg, sh.hd, sh.B * NG * C, stream)))
      return err;
  } else {
    cudaMemsetAsync(dwk, 0, nw * 4, stream);
    cudaMemsetAsync(dwv, 0, nw * 4, stream);
    if (sd.use_knorm) cudaMemsetAsync(dg, 0, sh.hd * 4, stream);
  }
  if (sh.Sq > 0) {
    using L = StreamDqSmem<HDP>;
    auto kernel = stream_dq_tc<HD>;
    static unsigned long long done = 0;
    if ((err = bwd::set_smem(kernel, L::BYTES, done))) return err;
    const int G = sh.Hq / sh.Hkv, row_tiles = (G * sh.Sq + ROWS - 1) / ROWS;
    const int C = cluster_for(row_tiles);
    cudaError_t e = launch_cluster(
        kernel, dim3((row_tiles + C - 1) / C * C, sh.Hkv, sh.B), C, L::BYTES,
        stream, xmap, wkmap, wvmap, do2, (const bf16*)q, lse,
        (const float*)delta, (bf16*)dq, sh, sd);
    if (e != cudaSuccess) return (int)e;
    err = (int)cudaGetLastError();
  }
  return err;
}

inline int dispatch(const void* q, const void* x, const void* wk, const void* wv,
                    const void* out, const void* dout, const float* lse,
                    float* delta, void* dq, float* dx, float* dwk_s,
                    float* dwv_s, float* dg_s, float* dwk, float* dwv,
                    float* dg, const AttnShape& sh, const StreamSide& sd,
                    cudaStream_t stream) {
  if (!takes(sh, sd.D, q, x, wk, wv, dout)) return (int)cudaErrorInvalidValue;
  switch (sh.hd) {
    case 32:
      return launch<32>(q, x, wk, wv, out, dout, lse, delta, dq, dx, dwk_s,
                        dwv_s, dg_s, dwk, dwv, dg, sh, sd, stream);
    case 64:
      return launch<64>(q, x, wk, wv, out, dout, lse, delta, dq, dx, dwk_s,
                        dwv_s, dg_s, dwk, dwv, dg, sh, sd, stream);
    case 96:
      return launch<96>(q, x, wk, wv, out, dout, lse, delta, dq, dx, dwk_s,
                        dwv_s, dg_s, dwk, dwv, dg, sh, sd, stream);
    default:
      return launch<128>(q, x, wk, wv, out, dout, lse, delta, dq, dx, dwk_s,
                         dwv_s, dg_s, dwk, dwv, dg, sh, sd, stream);
  }
}

}  // namespace tcb
}  // namespace repro

// route: 0 = simt (both dtypes), 1 = tc (bf16 where tcb::takes holds; the
// call fails with cudaErrorInvalidValue otherwise).  dtype: 0 = float32,
// 1 = bfloat16 (q, x_kv, wk, wv, out, dout and dq).  sin/cos (Sk, hd/2) and
// k_gamma (hd,) f32, null when unused; lse (B, Hq, Sq) f32 from the
// forward; delta (B, Hq, Sq) f32 scratch.  Outputs in f32: dx (B, Sk, D),
// dwk, dwv (D, Hkv, hd) and dg (hd,; only with the norm), each summed in a
// fixed order from the partials in the scratch slots dwk_s, dwv_s
// ((slots, D, Hkv, hd)) and dg_s ((dg slots, hd)), as many as
// stream_attention_bwd_slots gives.  All tensors contiguous; hd even and
// <= 128 (the Python wrapper checks).  Returns the CUDA error code of the
// launches.
extern "C" int stream_attention_bwd_launch(
    const void* q, const void* x, const void* wk, const void* wv,
    const void* sin_t, const void* cos_t, const void* k_gamma,
    const void* out, const void* dout, const float* lse, float* delta,
    void* dq, float* dx, float* dwk_s, float* dwv_s, float* dg_s, float* dwk,
    float* dwv, float* dg, int route, int dtype, int B, int Hq, int Hkv,
    int Sq, int Sk, int D, int hd, float scale, int causal, int window,
    int q_offset, int kv_len, int use_rope, int use_knorm, float eps,
    void* stream) {
  repro::AttnShape sh{B, Hq, Hkv, Sq, Sk, hd, hd, scale,
                      causal, window, q_offset, kv_len};
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    repro::tcb::StreamSide sd{(const float*)sin_t, (const float*)cos_t,
                          (const float*)k_gamma, D, use_rope, use_knorm, eps};
    return repro::tcb::dispatch(q, x, wk, wv, out, dout, lse, delta, dq, dx,
                                dwk_s, dwv_s, dg_s, dwk, dwv, dg, sh, sd, s);
  }
  const bool aligned =
      ((uintptr_t)x | (uintptr_t)wk | (uintptr_t)wv) % 16 == 0;
  repro::bwd::Side sd{(const float*)sin_t, (const float*)cos_t,
                      (const float*)k_gamma, D, use_rope, use_knorm, eps,
                      D % 8 == 0 && hd % 8 == 0 && aligned};
  if (dtype == 0)
    return repro::bwd::dispatch<float>(q, x, wk, wv, out, dout, lse, delta,
                                       dq, dx, dwk_s, dwv_s, dg_s, dwk, dwv,
                                       dg, sh, sd, s);
  return repro::bwd::dispatch<__nv_bfloat16>(q, x, wk, wv, out, dout, lse,
                                             delta, dq, dx, dwk_s, dwv_s,
                                             dg_s, dwk, dwv, dg, sh, sd, s);
}

// The tc route's rule for the shapes (1 = tc, 0 = simt), with every tensor
// 16-byte aligned: the rule blocked.stream_bwd_route mirrors.
extern "C" int stream_attention_bwd_route(int dtype, int hd, int D, int Hkv) {
  repro::AttnShape sh{1, Hkv, Hkv, 1, 1, hd, hd, 1.f, 0, 0, 0, 1};
  static const uint4 aligned[1] = {};
  return dtype == 1 &&
         repro::tcb::takes(sh, D, aligned, aligned, aligned, aligned, aligned);
}

// The partial slots of a route: *dw (of dwk_s and of dwv_s) and *dg (of
// dg_s), the dK/dV kernel's cluster over kv heads and its tile groups (tc;
// simt: one slot per kv tile of each batch row, cluster 1).  Returns 0.
extern "C" int stream_attention_bwd_slots(int route, int B, int Sk, int Hkv,
                                          int hd, int* dw, int* dg,
                                          int* cluster, int* groups) {
  const int tiles = (Sk + 63) / 64;
  if (route == 1) {
    *cluster = repro::tcb::dkv_cluster(Hkv, hd);
    *groups = repro::tcb::dkv_groups(Sk);
  } else {
    *cluster = 1;
    *groups = tiles;
  }
  *dw = B * *groups;
  *dg = B * *groups * *cluster;
  return 0;
}

// The tc route's dQ kernel for `nrows` flattened (G x Sq) query rows of a
// kv head: query rows per block and its cluster (each K/V tile generated
// once per cluster); and the clusters of 8 blocks at hd 128 resident at once
// of the dQ kernel and of the dK/dV kernel (cudaOccupancyMaxActiveClusters;
// -1 if the query fails).
extern "C" int stream_attention_bwd_config(int nrows, int* rows, int* cluster,
                                           int* dq_resident,
                                           int* dkv_resident) {
  using namespace repro::tcb;
  *rows = repro::tc::ROWS;
  *cluster = cluster_for((nrows + repro::tc::ROWS - 1) / repro::tc::ROWS);
  *dq_resident = max_clusters(stream_dq_tc<128>, MAX_CLUSTER,
                              StreamDqSmem<128>::BYTES);
  *dkv_resident = max_clusters(stream_dkv_tc<128, 1>, MAX_CLUSTER,
                               StreamDkvSmem<128, 1>::BYTES);
  return 0;
}
