// The cross-forwarding dataflow of the tensor-core TILE_STREAM kernels,
// shared by the forward (stream_attention.cu) and the backward's dQ and
// dK/dV passes (stream_attention_bwd.cu): K/V generation on the tensor
// cores from a ring of TMA stages, and the rounds in which the blocks of a
// cluster each generate one K/V tile and pass it around the cluster.
#pragma once

#include "attention_tc.cuh"

namespace repro {
namespace tc {

constexpr int MAX_CLUSTER = 8;   // the largest portable cluster

struct StreamSide {
  const float *sin_t, *cos_t, *k_gamma;   // (Sk, hd/2), (Sk, hd/2), (hd,)
  int D, use_rope, use_knorm;
  float eps;
};

// Cluster size for a row-tile count: MAX_CLUSTER, or the least power of
// two that covers the row tiles.
inline int cluster_for(int row_tiles) {
  int c = 1;
  while (c < MAX_CLUSTER && c < row_tiles) c *= 2;
  return c;
}

// Coordinates of this thread in a warpgroup's 64-row accumulator: rows r0
// and r0 + 8, columns 8i + 2t + e; element 4i + 2h + e.
struct Frag {
  int t, r0, tid;
  __device__ Frag()
      : t(threadIdx.x % 4),
        r0(((threadIdx.x / 32) % 4) * 16 + (threadIdx.x % 32) / 4),
        tid(threadIdx.x % 128) {}
};

// An f32 accumulator tile (64 x 2N columns) stored as hi and lo bf16 tiles
// in the swizzled layout TMA gives (K-major, 64-row boxes), then made
// visible to wgmma.
template <int N>
__device__ __forceinline__ void store_split(const float (&g)[N], uint32_t hi,
                                            uint32_t lo) {
  const Frag f;
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = f.r0 + 8 * h, col = 8 * i + 2 * f.t;
      const float a = g[4 * i + 2 * h], b = g[4 * i + 2 * h + 1];
      const float ah = __bfloat162float(__float2bfloat16_rn(a));
      const float bh = __bfloat162float(__float2bfloat16_rn(b));
      const uint32_t off = swz(row, col);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(hi + off),
                   "r"(pack_bf16(ah, bh))
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(lo + off),
                   "r"(pack_bf16(a - ah, b - bh))
                   : "memory");
    }
  fence_proxy_async();
}

// The consumers' view of a ring of TMA stages: wait() for the stage of the
// next iteration, release(n) it with n arrivals a thread, or skip() it (a
// stage the other warpgroup consumes).
struct Ring {
  uint32_t base, full, empty;
  int stages, stage_bytes, it;
  __device__ uint32_t wait() {
    const int st = it % stages;
    mbar_wait(full + 8 * st, (it / stages) & 1);
    return base + st * stage_bytes;
  }
  __device__ void release(uint32_t n = 1) {
    const uint32_t bar = empty + 8 * (it % stages);
    if (n == 1)
      mbar_arrive(bar);
    else
      mbar_arrive_cnt(bar, n);
    ++it;
  }
  __device__ void skip() { ++it; }
};

// Generate tile j (warpgroup 0: K, 1: V) from the ring's D chunks (x_j's
// 64 x 64 box at the stage's start, W_K's and W_V's 64 x HDP chunks after
// it) into the split tile at kv: K_hi, K_lo, V_hi, V_lo, PART bytes apart.
// K goes through the qk-RMSNorm and rotate-half RoPE in f32 on the
// accumulators (a row lies in one quad; RoPE's partner column in the same
// thread).  With kpre set, warpgroup 0 keeps K before them there (element
// i of thread tid at kpre[i * 128 + tid]).
template <int HD, int HDP>
__device__ void gen_kv(int j, int wg, uint32_t kv, Ring& ring,
                       const AttnShape& sh, const StreamSide& sd,
                       float* kpre) {
  constexpr int PART = (HDP / 64) * BOX_BYTES;
  float g[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) g[i] = 0.f;
  const int nch = (sd.D + 63) / 64;
  for (int ci = 0; ci < nch; ++ci) {
    const uint32_t xs = ring.wait();
    const uint32_t ws = xs + BOX_BYTES + wg * PART;
    fence_regs(g);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<1>(g, desc_kmajor(xs + ks * 32), desc_mnmajor(ws + ks * 2048), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(g);
    ring.release();
  }
  const Frag f;
  if (wg == 0 && kpre)
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) kpre[i * 128 + f.tid] = g[i];
  if (wg == 0 && sd.use_knorm) {               // qk-RMSNorm of K, f32
    float ss[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) ss[h] += g[4 * i + 2 * h + e] * g[4 * i + 2 * h + e];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ss[h] += __shfl_xor_sync(0xffffffff, ss[h], 1);
      ss[h] += __shfl_xor_sync(0xffffffff, ss[h], 2);
      ss[h] = rsqrtf(ss[h] / HD + sd.eps);
    }
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * f.t + e;
        const float gm = col < HD ? sd.k_gamma[col] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          g[4 * i + 2 * h + e] = g[4 * i + 2 * h + e] * ss[h] * gm;
      }
  }
  if (wg == 0 && sd.use_rope) {                // rotate-half RoPE of K, f32
    constexpr int HALF = HD / 2, NB = HALF / 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kpos = j * BK + f.r0 + 8 * h;
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + 2 * f.t + e;
          float sn = 0.f, cs = 0.f;
          if (kpos < sh.Sk) {
            sn = sd.sin_t[(size_t)kpos * HALF + col];
            cs = sd.cos_t[(size_t)kpos * HALF + col];
          }
          const float k1 = g[4 * i + 2 * h + e], k2 = g[4 * (i + NB) + 2 * h + e];
          g[4 * i + 2 * h + e] = k1 * cs - k2 * sn;
          g[4 * (i + NB) + 2 * h + e] = k2 * cs + k1 * sn;
        }
    }
  }
  store_split<HDP / 2>(g, kv + 2 * wg * PART, kv + (2 * wg + 1) * PART);
}

// The producer of the rounds (its whole warpgroup calls it; one thread
// loads).  The block's loads in order: the D chunks of its tile j0 + rank
// (x_j from xmap, W_K and W_V of kv head kvh), for every round that has
// one, into the ring of `stages` stages of `stage` bytes at ring.  A chunk
// is issued only once the chunk a ring before it is one that this round's
// generation consumes: at most `stages` chunks past the end of the round,
// so that the wait for a free stage never outlasts the round (the
// consumers free the stages of later rounds only after this round's
// cluster barriers).  After each round's generation it forwards buf[s % 2]
// (TILE bytes each at bufs) to the right-hand peer in sub-step s.
template <int HDP>
__device__ void produce_rounds(const KvRange& kv, int b, int kvh, int D,
                               uint32_t bufs, uint32_t ring, int stages,
                               int stage, uint32_t full, uint32_t empty,
                               uint32_t arrived, const CUtensorMap* xmap,
                               const CUtensorMap* wkmap,
                               const CUtensorMap* wvmap) {
  constexpr int PART = (HDP / 64) * BOX_BYTES, TILE = 4 * PART;
  const int C = cluster_size(), rank = cluster_rank();
  const bool lead = threadIdx.x % 128 == 0;
  const int nch = (D + 63) / 64;
  int next_j0 = kv.lo, next_d0 = 0, issued = 0, through = 0;
  for (int j0 = kv.lo; j0 < kv.hi; j0 += C) {
    if (j0 + rank < kv.hi) through += nch;   // chunks up to this round's end
    while (lead && issued < through + stages) {
      while (next_j0 < kv.hi && next_j0 + rank >= kv.hi) next_j0 += C;
      if (next_j0 >= kv.hi) break;
      const int st = issued % stages, ph = (issued / stages) & 1;
      if (issued >= stages) mbar_wait(empty + 8 * st, ph ^ 1);
      const uint32_t xs = ring + st * stage;
      const uint32_t wks = xs + BOX_BYTES, wvs = wks + PART;
      mbar_expect_tx(full + 8 * st, BOX_BYTES + 2 * PART);
      tma_load_3d(xs, xmap, full + 8 * st, next_d0, (next_j0 + rank) * BK, b);
      for (int c = 0; c < HDP / 64; ++c) {
        tma_load_3d(wks + c * BOX_BYTES, wkmap, full + 8 * st, 64 * c, kvh, next_d0);
        tma_load_3d(wvs + c * BOX_BYTES, wvmap, full + 8 * st, 64 * c, kvh, next_d0);
      }
      ++issued;
      next_d0 += 64;
      if (next_d0 >= D) {
        next_d0 = 0;
        next_j0 += C;
      }
    }
    __syncwarp();
    cluster_sync();                         // buf[0] holds the own tile
    for (int s = 0; s < C; ++s) {
      if (lead && s + 1 < C) {              // forward buf[s % 2] to the right
        const int right = (rank + 1) % C, nb = (s + 1) % 2;
        mbar_expect_tx(arrived + 8 * nb, TILE);
        bulk_push(map_to_rank(bufs + nb * TILE, right), bufs + (s % 2) * TILE,
                  TILE, map_to_rank(arrived + 8 * nb, right));
      }
      __syncwarp();
      cluster_sync();
    }
  }
}

// The consumers of the rounds: per round of C live kv tiles, generate the
// own tile j0 + rank into buf[0], then in sub-step s = 0 .. C - 1 run
// step(j, tile) on the tile of rank - s (forwarded s times to the right),
// which lies in buf[s % 2] (K_hi, K_lo, V_hi, V_lo, PART bytes apart),
// once the next one has landed; a cluster barrier closes each sub-step.
template <int HD, int HDP, typename Step>
__device__ void consume_rounds(const KvRange& kv, int wg, uint32_t bufs,
                               uint32_t arrived, Ring& ring,
                               const AttnShape& sh, const StreamSide& sd,
                               Step step) {
  constexpr int TILE = 4 * (HDP / 64) * BOX_BYTES;
  const int C = cluster_size(), rank = cluster_rank();
  int phases = 0;   // bit b: parity of buf[b]'s next arrival
  for (int j0 = kv.lo; j0 < kv.hi; j0 += C) {
    if (j0 + rank < kv.hi) gen_kv<HD, HDP>(j0 + rank, wg, bufs, ring, sh, sd, nullptr);
    cluster_sync();                         // buf[0] holds the own tile
    for (int s = 0; s < C; ++s) {
      const int j = j0 + (rank - s + C) % C;
      const uint32_t tile = bufs + (s % 2) * TILE;
      if (j < kv.hi) step(j, tile);
      if (s + 1 < C) {                      // the next tile has landed
        const int nb = (s + 1) % 2;
        mbar_wait_cluster(arrived + 8 * nb, (phases >> nb) & 1);
        phases ^= 1 << nb;
      }
      cluster_sync();
    }
  }
}

// A launch in clusters of `cluster` blocks along x.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, int cluster,
                           size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Clusters of `cluster` blocks of `kernel` resident at once (-1 if the
// query fails).
template <typename... KArgs>
int max_clusters(void (*kernel)(KArgs...), int cluster, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 16);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace tc
}  // namespace repro
