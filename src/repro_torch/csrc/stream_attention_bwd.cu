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
// Three launches, f32 arithmetic on the SIMT core of attention_bwd.cuh,
// except that the K/V generation of bf16 inputs runs on the tensor cores
// (mma.sync, exact bf16 products summed in f32: generate_tc):
//   delta_kernel   delta = rowsum(dO * O)
//   dkvgen_kernel  one block per (kv tile j of 64 keys, batch) reads
//                  x_kv[b, 64j : 64j + 64, :D] and, for each kv head in
//                  turn, generates K_j (projection, qk-norm, rotate-half
//                  RoPE) and V_j, walks the live query spans of the head's
//                  G query heads for dK_j and dV_j, goes back through RoPE
//                  and the qk-norm, and adds dK_j W_K^T + dV_j W_V^T to the
//                  block's rows of dx_kv (f32; the block owns them, heads in
//                  order).  It writes the tile's partials of dW_K = x_j^T dK_j,
//                  dW_V = x_j^T dV_j and dγ, which the caller sums over the
//                  tiles in a fixed order: no float atomics anywhere, so two
//                  runs give bitwise-equal gradients.
//   dq_kernel      one block per (64 query rows, query head, batch)
//                  generates K_j and V_j of its kv head for each live tile
//                  and accumulates dQ.
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
  if ((err = set_smem(kkv, kv_smem)) || (err = set_smem(kq, q_smem))) return err;
  if (sh.Sk > 0) {
    kkv<<<dim3((sh.Sk + BKV - 1) / BKV, sh.B), NT, kv_smem, stream>>>(
        (const T*)q, (const T*)x, (const T*)wk, (const T*)wv, (const T*)dout,
        lse, delta, dx, dwk, dwv, dg, sh, sd);
    if ((err = (int)cudaGetLastError())) return err;
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
             float* dg, const AttnShape& sh, const Side& sd,
             cudaStream_t stream) {
  if (sh.hd <= 32)
    return launch<T, 32>(q, x, wk, wv, out, dout, lse, delta, dq, dx, dwk,
                         dwv, dg, sh, sd, stream);
  if (sh.hd <= 64)
    return launch<T, 64>(q, x, wk, wv, out, dout, lse, delta, dq, dx, dwk,
                         dwv, dg, sh, sd, stream);
  return launch<T, 128>(q, x, wk, wv, out, dout, lse, delta, dq, dx, dwk,
                        dwv, dg, sh, sd, stream);
}

}  // namespace bwd
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16 (q, x_kv, wk, wv, out, dout and dq).
// sin/cos (Sk, hd/2) and k_gamma (hd,) f32, null when unused; lse (B, Hq, Sq)
// f32 from the forward; delta (B, Hq, Sq) f32 scratch.  Outputs in f32:
// dx (B, Sk, D); per kv tile of each batch row (B * ceil(Sk / 64) tiles)
// the partials dwk, dwv (tiles, D, Hkv, hd) and dg (tiles, hd; written only
// with the norm).  All tensors contiguous; hd even and <= 128 (the Python
// wrapper checks).  Returns the CUDA error code of the launches.
extern "C" int stream_attention_bwd_launch(
    const void* q, const void* x, const void* wk, const void* wv,
    const void* sin_t, const void* cos_t, const void* k_gamma,
    const void* out, const void* dout, const float* lse, float* delta,
    void* dq, float* dx, float* dwk, float* dwv, float* dg, int dtype, int B,
    int Hq, int Hkv, int Sq, int Sk, int D, int hd, float scale, int causal,
    int window, int q_offset, int kv_len, int use_rope, int use_knorm,
    float eps, void* stream) {
  repro::AttnShape sh{B, Hq, Hkv, Sq, Sk, hd, hd, scale,
                      causal, window, q_offset, kv_len};
  const bool aligned =
      ((uintptr_t)x | (uintptr_t)wk | (uintptr_t)wv) % 16 == 0;
  repro::bwd::Side sd{(const float*)sin_t, (const float*)cos_t,
                      (const float*)k_gamma, D, use_rope, use_knorm, eps,
                      D % 8 == 0 && hd % 8 == 0 && aligned};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return repro::bwd::dispatch<float>(q, x, wk, wv, out, dout, lse, delta,
                                       dq, dx, dwk, dwv, dg, sh, sd, s);
  return repro::bwd::dispatch<__nv_bfloat16>(q, x, wk, wv, out, dout, lse,
                                             delta, dq, dx, dwk, dwv, dg, sh,
                                             sd, s);
}
