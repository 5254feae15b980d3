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
// What bounds it on the H100: the FLOPs.  Attention is 4·Sq·Sk·hd per query
// head; every tile of K/V is generated once per group of query rows that
// consumes it, G·Sq / (rows per group) projections of K/V per kv head.
//
// Design, bf16 (attention_tc.cuh).  The Pallas kernel keeps W_K/W_V whole
// in VMEM (up to 2 MiB); a Hopper block has 227 KB.  A block of 384
// threads owns 128 query rows of one (batch, kv head): two consumer
// warpgroups of 64 rows and a producer warpgroup.  Blocks are launched in
// thread block clusters of C = 8 consecutive row tiles (fewer when the
// rows are fewer; cudaLaunchKernelEx with a cluster dimension).  Per round
// of C live kv tiles:
//   1. generation: block c of the cluster generates tile j0 + c once.  The
//      producer brings 64-wide D chunks of x_kv (64 keys) and of
//      W_K[:, h, :], W_V[:, h, :] (hot in L2 across blocks) by TMA through
//      a ring of 4 stages (2 at hd 128), running at most a ring of chunks
//      past the round's own; warpgroup 0 forms K_j, warpgroup 1 V_j, as wgmma
//      products with f32 sums.  qk-RMSNorm and RoPE run in f32 on the
//      accumulators (a row lies in one quad; RoPE's partner column in the
//      same thread), and the tile is stored split, K_hi/K_lo/V_hi/V_lo in
//      bf16, into the block's buf[0] (64 KB at hd 128).
//   2. cross-forwarding around the cluster's ring: in sub-step s = 0 ..
//      C - 1 every block attends to the tile in buf[s % 2] (its own at
//      s = 0, then the tile of rank - s) and, at the same time, pushes that
//      buffer into buf[(s + 1) % 2] of its right-hand peer over the SM-to-SM
//      network (one cp.async.bulk shared::cluster of the whole tile,
//      completing on the peer's mbarrier).  Every SM sends and receives one
//      tile per sub-step, overlapped with the products: Q·K_hi^T + Q·K_lo^T,
//      online softmax, P_hi·V_hi + P_hi·V_lo + P_lo·V_hi (wgmma reads only
//      its own block's shared memory, so a tile is used where it landed).
//      A cluster barrier closes each sub-step once the block's products are
//      done and the next tile has landed: C + 1 per round.
// So the regeneration factor is G·Sq / (128·C): 4 at vilbert-base's
// 4096 x 4096 vision self-attention, against 32 without the cluster.
// Budget at hd 128: buf[0] + buf[1] 2 x 64 KB + ring 2 x 40 KB = 208 KB of
// the 227 KB; Q lives in registers (the A operand of Q·K^T).  Clusters of
// 8 beat 4, 2 and 1 (no cluster) on the H100 at the timed shape (a one-off
// sweep, PERF.md), and 8 is the largest portable size.  A block past the
// last row still generates and forwards its tile and stores nothing.
// TMA needs hd and D multiples of 8; hd must be 32, 64, 96 or 128.  Other
// shapes, and f32 inputs, take the SIMT f32 core of attention_tile.cuh
// (one block per 128 rows, every block regenerates every tile).
#include "attention_tile.cuh"

namespace repro {

constexpr int STREAM_ROWS = 128;   // query rows per block of the SIMT core
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

#include "stream_tc.cuh"

namespace repro {
namespace tc {

// Stages of the generation ring: 4 at hd <= 64, 2 at hd 128 (the budget).
template <int HDP>
constexpr int stream_stages() { return HDP <= 64 ? 4 : 2; }

template <int HDP>
struct StreamSmem {
  static constexpr int PART = (HDP / 64) * BOX_BYTES;   // one of K_hi .. V_lo
  static constexpr int TILE = 4 * PART;
  static constexpr int RING = 2 * TILE;                  // after buf[0], buf[1]
  static constexpr int X_BYTES = BOX_BYTES;
  static constexpr int STAGE = X_BYTES + 2 * PART;      // x, W_K, W_V chunks
  static constexpr int STAGES = stream_stages<HDP>();
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr int BYTES = BARS + (2 * STAGES + 2) * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
stream_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wkmap,
                 const __grid_constant__ CUtensorMap wvmap,
                 const bf16* __restrict__ q, bf16* __restrict__ out,
                 AttnShape sh, StreamSide sd) {
  constexpr int HDP = HD <= 64 ? 64 : 128;
  using L = StreamSmem<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + L::BARS, empty = full + 8 * L::STAGES;
  // arrival of a forwarded tile in buf[0], buf[1]
  const uint32_t arrived = empty + 8 * L::STAGES;
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
    mbar_init_fence();
  }
  cluster_sync();   // every peer's barriers exist before any push

  if (threadIdx.x >= CONSUMERS) {             // producer warpgroup
    setmaxnreg_dec<40>();
    produce_rounds<HDP>(kv, b, kvh, sd.D, base, base + L::RING, L::STAGES,
                        L::STAGE, full, empty, arrived, &xmap, &wkmap, &wvmap);
  } else {                                    // consumer warpgroups
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    TcRows<HDP, HDP> rows;
    rows.init(q, sh, b, kvh, t0 + 64 * wg);
    Ring ring{base + L::RING, full, empty, L::STAGES, L::STAGE, 0};
    consume_rounds<HD, HDP>(kv, wg, base, arrived, ring, sh, sd,
                            [&](int j, uint32_t tile) {
      rows.template tile<true>(sh, j, tile, tile + L::PART,
                               tile + 2 * L::PART, tile + 3 * L::PART);
    });
    rows.store(out, sh, b);
  }
}

template <int HD>
int launch(const void* q, const void* x, const void* wk, const void* wv,
           const StreamSide& sd, void* out, const AttnShape& sh,
           cudaStream_t stream) {
  using L = StreamSmem<(HD <= 64 ? 64 : 128)>;
  CUtensorMap xmap, wkmap, wvmap;
  int err = make_map(&xmap, x, sd.D, sh.Sk, sh.B, (uint64_t)sd.D * 2,
                     (uint64_t)sh.Sk * sd.D * 2, BK, 1);
  if (!err)
    err = make_map(&wkmap, wk, sh.hd, sh.Hkv, sd.D, (uint64_t)sh.hd * 2,
                   (uint64_t)sh.Hkv * sh.hd * 2, 1, 64);
  if (!err)
    err = make_map(&wvmap, wv, sh.hd, sh.Hkv, sd.D, (uint64_t)sh.hd * 2,
                   (uint64_t)sh.Hkv * sh.hd * 2, 1, 64);
  if (err) return err;
  auto kernel = stream_tc_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int G = sh.Hq / sh.Hkv, row_tiles = (G * sh.Sq + ROWS - 1) / ROWS;
  const int C = cluster_for(row_tiles);
  const dim3 grid((row_tiles + C - 1) / C * C, sh.Hkv, sh.B);
  note_launch(1, grid, ROWS, BK);
  e = launch_cluster(kernel, grid, C, L::BYTES, stream, xmap, wkmap, wvmap, (const bf16*)q,
                     (bf16*)out, sh, sd);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

inline bool takes(const AttnShape& sh, int D, const void* x, const void* wk,
                  const void* wv) {
  return (sh.hd == 32 || sh.hd == 64 || sh.hd == 96 || sh.hd == 128) &&
         D % 8 == 0 && tma_ok(x, D) && tma_ok(wk, sh.hd) && tma_ok(wv, sh.hd);
}

// The tensor-core route, or -1 when the shapes need the SIMT core.
inline int dispatch(const void* q, const void* x, const void* wk, const void* wv,
                    const StreamSide& sd, void* out, const AttnShape& sh,
                    cudaStream_t stream) {
  if (!takes(sh, sd.D, x, wk, wv)) return -1;
  switch (sh.hd) {
    case 32: return launch<32>(q, x, wk, wv, sd, out, sh, stream);
    case 64: return launch<64>(q, x, wk, wv, sd, out, sh, stream);
    case 96: return launch<96>(q, x, wk, wv, sd, out, sh, stream);
    default: return launch<128>(q, x, wk, wv, sd, out, sh, stream);
  }
}

}  // namespace tc
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16 (q, x_kv, wk, wv and out).  sin/cos
// (Sk, hd/2) and k_gamma (hd,) are float32 and may be null when unused.
// All tensors contiguous; hd <= 128 (the Python wrapper checks).  bf16 takes
// the tensor-core kernel where TMA can read x_kv and W (see the header),
// else the SIMT core.  lse: null, or (B, Hq, Sq) f32 for m + log l of every
// query row.  Returns the launch's CUDA error code.
extern "C" int stream_attention_launch(
    const void* q, const void* x, const void* wk, const void* wv,
    const void* sin_t, const void* cos_t, const void* k_gamma, void* out,
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D, int hd,
    float scale, int causal, int window, int q_offset, int kv_len,
    int use_rope, int use_knorm, float eps, float* lse, void* stream) {
  repro::AttnShape sh{B, Hq, Hkv, Sq, Sk, hd, hd, scale,
                      causal, window, q_offset, kv_len, lse};
  repro::StreamArgs sa{D, use_rope, use_knorm, eps};
  cudaStream_t s = (cudaStream_t)stream;
  const float *sn = (const float*)sin_t, *cs = (const float*)cos_t,
              *kg = (const float*)k_gamma;
  if (dtype == 0)
    return repro::dispatch<float>(q, x, wk, wv, sn, cs, kg, out, sh, sa, s);
  repro::tc::StreamSide sd{sn, cs, kg, D, use_rope, use_knorm, eps};
  int rc = repro::tc::dispatch(q, x, wk, wv, sd, out, sh, s);
  if (rc >= 0) return rc;
  return repro::dispatch<__nv_bfloat16>(q, x, wk, wv, sn, cs, kg, out, sh, sa, s);
}

// How the bf16 tensor-core route regenerates K/V for `nrows` flattened
// (G x Sq) query rows of a kv head: query rows per block, and the cluster
// the launch takes for them; a tile is generated once per cluster of
// consecutive row tiles.  max_clusters: clusters of MAX_CLUSTER blocks
// (hd 128) resident at once, from cudaOccupancyMaxActiveClusters (-1 if
// the query fails).
extern "C" int stream_attention_config(int nrows, int* rows, int* cluster,
                                       int* max_clusters) {
  *rows = repro::tc::ROWS;
  *cluster = repro::tc::cluster_for((nrows + repro::tc::ROWS - 1) /
                                    repro::tc::ROWS);
  *max_clusters = repro::tc::max_clusters(repro::tc::stream_tc_kernel<128>,
                                          repro::tc::MAX_CLUSTER,
                                          repro::tc::StreamSmem<128>::BYTES);
  return 0;
}

// The route, grid and tile of this library's latest launch (launch_record.cuh).
extern "C" int stream_attention_last_launch(int* r) { return repro::read_launch(r); }
