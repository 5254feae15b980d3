// TILE_STREAM fused K/V generation + attention, for sm_90a: the paper's
// mixed-stationary cross-forwarding dataflow.
//
// Replaces: src/repro/kernels/stream_attention.py:167 (stream_attention /
// _stream_kernel), the Pallas TPU kernel.  Same function: per kv tile,
// K_j = x_j·W_K and V_j = x_j·W_V are generated on chip, then optional
// qk-RMSNorm of K (k_gamma), rotate-half RoPE of K (sin/cos tables), GQA
// Q·K_j^T under the kv_len / causal(q_offset) / window mask, and online
// softmax with P·V_j.  K and V are never written to device memory: the only
// global store of this kernel is the output.
//
// What bounds it on the H100: the FLOPs.  Besides attention (4·Sq·Sk·hd per
// query head) every block regenerates its K/V tiles, so the generation work
// is (G·Sq / ROWS) times one projection of K/V: with ROWS = 128 query rows
// per block that is Sq/128 projections (32 at Sq = 4096), i.e. D/128 times
// the attention FLOPs for an MHA layer (8x at D = 1024, 6x at D = 768).
// This first version computes in SIMT f32 FMAs; tensor cores are a later PR.
//
// Design: the Pallas kernel keeps all of W_K/W_V resident in VMEM.  That is
// up to 2 MiB at vilbert-base, far over the 227 KB of shared memory of a
// Hopper block, so here a block owns (batch, 128 query rows, one kv head)
// and builds each (64 x hd) K_j/V_j tile in shared memory by streaming D in
// chunks of 32: a chunk of x_kv rows and the matching rows of that head's
// W_K[:, h, :] and W_V[:, h, :] (which stay hot in L2 across blocks).  ROWS
// is as large as the 227 KB allow (about 204 KB at hd = 128), to keep the
// regeneration factor low.
#include "attention_tile.cuh"

namespace repro {

constexpr int STREAM_ROWS = 128;   // read from Python: stream_attention_rows
constexpr int DC = 32;   // D chunk of the generation loop

template <int HDT>
constexpr int stream_smem_floats() {
  return AttnSmem<STREAM_ROWS, HDT>::FLOATS + BK * (DC + 1) + 2 * DC * HDT;
}

struct StreamArgs {
  int D, use_rope, use_knorm;
  float eps;
};

template <typename T, int HDT>
__global__ void __launch_bounds__(THREADS)
stream_kernel(const T* __restrict__ q, const T* __restrict__ x,
              const T* __restrict__ wk, const T* __restrict__ wv,
              const float* __restrict__ sin_t, const float* __restrict__ cos_t,
              const float* __restrict__ k_gamma, T* __restrict__ out,
              AttnShape sh, StreamArgs sa) {
  extern __shared__ float smem[];
  using Core = AttnCore<T, STREAM_ROWS, HDT>;
  using S = typename Core::S;
  constexpr int GI = BK / TX;         // generated K/V rows per thread
  constexpr int CJ = Core::CJ;        // generated K/V columns per thread
  Core core(smem, sh);
  float* x_s = core.end();            // (BK, DC + 1)
  float* wk_s = x_s + BK * (DC + 1);  // (DC, HDT)
  float* wv_s = wk_s + DC * HDT;      // (DC, HDT)
  const int tx = core.tx, ty = core.ty, tid = threadIdx.x;
  const int hd = sh.hd, D = sa.D, Hkv = sh.Hkv;
  const T* xb = x + (size_t)core.b * sh.Sk * D;
  core.load_q(q);

  int nkb = (sh.Sk + BK - 1) / BK;
  for (int j = 0; j < nkb; ++j) {
    // ---- cross-forwarding step 1: generate K_j, V_j on chip ----
    float ka[GI][CJ], va[GI][CJ];
#pragma unroll
    for (int i = 0; i < GI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) ka[i][c] = va[i][c] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // the previous chunk (and tile) is consumed
      for (int idx = tid; idx < BK * DC; idx += THREADS) {
        int c = idx / DC, dd = idx % DC, kpos = j * BK + c, d = d0 + dd;
        x_s[c * (DC + 1) + dd] =
            kpos < sh.Sk && d < D ? to_f(xb[(size_t)kpos * D + d]) : 0.f;
      }
      for (int idx = tid; idx < DC * HDT; idx += THREADS) {
        int dd = idx / HDT, e = idx % HDT, d = d0 + dd;
        bool in = d < D && e < hd;
        size_t off = ((size_t)d * Hkv + core.kvh) * hd + e;
        wk_s[idx] = in ? to_f(wk[off]) : 0.f;
        wv_s[idx] = in ? to_f(wv[off]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < DC; ++dd) {
        float xv[GI], kw[CJ], vw[CJ];
#pragma unroll
        for (int i = 0; i < GI; ++i) xv[i] = x_s[(ty + TX * i) * (DC + 1) + dd];
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          kw[c] = wk_s[dd * HDT + tx + TX * c];
          vw[c] = wv_s[dd * HDT + tx + TX * c];
        }
#pragma unroll
        for (int i = 0; i < GI; ++i)
#pragma unroll
          for (int c = 0; c < CJ; ++c) {
            ka[i][c] = fmaf(xv[i], kw[c], ka[i][c]);
            va[i][c] = fmaf(xv[i], vw[c], va[i][c]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < GI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        core.k_s[(ty + TX * i) * S::KS + tx + TX * c] = ka[i][c];
        core.v_s[(ty + TX * i) * S::KS + tx + TX * c] = va[i][c];
      }
    __syncthreads();

    // ---- qk-RMSNorm and RoPE of K_j, one warp per key row ----
    if (sa.use_knorm || sa.use_rope) {
      int warp = tid / 32, lane = tid % 32, half = hd / 2;
      for (int c = warp; c < BK; c += NWARPS) {
        float* kr = core.k_s + c * S::KS;
        float inv = 1.f;
        if (sa.use_knorm) {
          float ss = 0.f;
          for (int e = lane; e < hd; e += 32) ss += kr[e] * kr[e];
          inv = rsqrtf(warp_sum(ss) / hd + sa.eps);
          if (!sa.use_rope)
            for (int e = lane; e < hd; e += 32) kr[e] = kr[e] * inv * k_gamma[e];
        }
        if (sa.use_rope) {
          int kpos = j * BK + c;
          for (int e = lane; e < half; e += 32) {
            float k1 = kr[e], k2 = kr[e + half];
            if (sa.use_knorm) {
              k1 = k1 * inv * k_gamma[e];
              k2 = k2 * inv * k_gamma[e + half];
            }
            float sn = 0.f, cs = 0.f;
            if (kpos < sh.Sk) {
              sn = sin_t[(size_t)kpos * half + e];
              cs = cos_t[(size_t)kpos * half + e];
            }
            kr[e] = k1 * cs - k2 * sn;
            kr[e + half] = k2 * cs + k1 * sn;
          }
        }
      }
      __syncthreads();
    }

    // ---- cross-forwarding step 2: K_j, V_j feed Q·K^T and P·V at once ----
    core.scores(j);
    __syncthreads();
    core.softmax();
    __syncthreads();
    core.pv();
  }
  __syncthreads();
  core.store(out);
}

template <typename T, int HDT>
int launch(const void* q, const void* x, const void* wk, const void* wv,
           const float* sin_t, const float* cos_t, const float* k_gamma,
           void* out, const AttnShape& sh, const StreamArgs& sa,
           cudaStream_t stream) {
  size_t smem = sizeof(float) * stream_smem_floats<HDT>();
  return launch_attention(stream_kernel<T, HDT>, STREAM_ROWS, smem, sh,
                          stream, (const T*)q, (const T*)x, (const T*)wk,
                          (const T*)wv, sin_t, cos_t, k_gamma, (T*)out, sh,
                          sa);
}

template <typename T>
int dispatch(const void* q, const void* x, const void* wk, const void* wv,
             const float* sin_t, const float* cos_t, const float* k_gamma,
             void* out, const AttnShape& sh, const StreamArgs& sa,
             cudaStream_t stream) {
  if (sh.hd <= 32)
    return launch<T, 32>(q, x, wk, wv, sin_t, cos_t, k_gamma, out, sh, sa, stream);
  if (sh.hd <= 64)
    return launch<T, 64>(q, x, wk, wv, sin_t, cos_t, k_gamma, out, sh, sa, stream);
  return launch<T, 128>(q, x, wk, wv, sin_t, cos_t, k_gamma, out, sh, sa, stream);
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16 (q, x_kv, wk, wv and out).  sin/cos
// (Sk, hd/2) and k_gamma (hd,) are float32 and may be null when unused.
// All tensors contiguous; hd <= 128 (the Python wrapper checks).  Returns
// cudaGetLastError() of the launch.
extern "C" int stream_attention_launch(
    const void* q, const void* x, const void* wk, const void* wv,
    const void* sin_t, const void* cos_t, const void* k_gamma, void* out,
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D, int hd,
    float scale, int causal, int window, int q_offset, int kv_len,
    int use_rope, int use_knorm, float eps, void* stream) {
  repro::AttnShape sh{B, Hq, Hkv, Sq, Sk, hd, hd, scale,
                      causal, window, q_offset, kv_len};
  repro::StreamArgs sa{D, use_rope, use_knorm, eps};
  cudaStream_t s = (cudaStream_t)stream;
  const float *sn = (const float*)sin_t, *cs = (const float*)cos_t,
              *kg = (const float*)k_gamma;
  if (dtype == 0)
    return repro::dispatch<float>(q, x, wk, wv, sn, cs, kg, out, sh, sa, s);
  return repro::dispatch<__nv_bfloat16>(q, x, wk, wv, sn, cs, kg, out, sh, sa, s);
}

// Query rows (of the G x Sq rows of a kv head) per block: every block
// regenerates its K/V tiles, so the generation work is G·Sq / rows
// projections of K/V per kv head.
extern "C" int stream_attention_rows() { return repro::STREAM_ROWS; }
