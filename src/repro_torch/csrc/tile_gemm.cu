// Matrix product with f32 accumulation, for sm_90a.
//
// Replaces: src/repro/kernels/tile_gemm.py:57 (tile_gemm / _gemm_kernel),
// the Pallas TPU kernel: (M, K) @ (K, N) accumulated in f32, output in x's
// dtype, weight-stationary grid order (n outer, m inner).  Unlike the
// Pallas kernel, which needs K to be a multiple of its K block and reads
// unmasked padding otherwise, every route here masks the ragged edge of M,
// N and K (vilbert-base's language stream has K = 768).
//
// Four routes in one library; tile_gemm_route() is the rule, and
// kernels/blocked.py's gemm_route mirrors it.
//
// splitk, M <= M_SMALL, both dtypes (decode).  Bound by W's bytes: 1..4
//   rows against a 5120 x 25600 weight do ~1 FLOP per byte read.  So every
//   weight byte is read once, in 16-byte loads with 8 rows in flight per
//   thread, and K is split so that the card's 132 SMs all stream: a block
//   owns a slab of 256 columns and one of S K ranges (S from
//   tile_gemm_splits(K, N), never from M), keeps its rows of x in shared
//   memory and sums in f32 FMAs.  Blocks write f32 partials; the last block
//   of a slab to arrive (a per-slab ticket it resets to 0) adds them in
//   split order 0..S-1 and writes the output.  Every row's arithmetic is
//   the same whatever M and the other rows: a row of a batched call equals
//   the M = 1 call bitwise.
// wgmma, bf16, M > M_SMALL, K and N multiples of 8, x and w 16-byte
//   aligned (the wrapper checks the pointers; prefill and vilbert).  Bound
//   by the FLOPs: M of 512..8192 rows do ~1000 FLOPs per byte, above the
//   card's ~295.  Warp-specialised: one producer thread brings 128 x 64
//   tiles of x (K-major) and 64 x 256 tiles of W (MN-major, W's own
//   layout) by TMA into a ring of four stages, two consumer warpgroups
//   each run wgmma m64n256k16 on 64 rows of the 128 x 256 output tile,
//   keeping one k-step of products in flight.  A persistent grid, one
//   block an SM, walks the tiles in n-major order, so that the blocks at
//   work share W's column block in L2 (the TPU kernel's weight-stationary
//   order), and the producer loads a tile's first stages while the
//   consumers store the last one.  TMA zero-fills past M, N and K; the
//   epilogue stores bf16 pairs masked on M and N.
// mma, any other bf16 shape: 128 x 128 x 32 tiles, mma.sync m16n8k16 (the
//   first port's kernel, kept as it was: right, but slow).
// simt, any other f32 shape: 64 x 64 x 16 tiles of SIMT f32 FMAs, so that
//   f32 results are full f32 (no TF32).
#include <type_traits>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---- f32: SIMT FMAs ----
constexpr int SBM = 64, SBN = 64, SBK = 16;

__global__ void __launch_bounds__(256)
gemm_f32(const float* __restrict__ x, const float* __restrict__ w,
         float* __restrict__ out, int M, int N, int K) {
  __shared__ float xs[SBK][SBM + 1];
  __shared__ float ws[SBK][SBN];
  const int m0 = blockIdx.x * SBM, n0 = blockIdx.y * SBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += SBK) {
    for (int idx = tid; idx < SBM * SBK; idx += 256) {
      int r = idx / SBK, kk = idx % SBK, m = m0 + r, k = k0 + kk;
      xs[kk][r] = m < M && k < K ? x[(size_t)m * K + k] : 0.f;
    }
    for (int idx = tid; idx < SBK * SBN; idx += 256) {
      int kk = idx / SBN, c = idx % SBN, n = n0 + c, k = k0 + kk;
      ws[kk][c] = k < K && n < N ? w[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// ---- bf16: mma.sync on the tensor cores ----
constexpr int TBM = 128, TBN = 128, TBK = 32, PAD = 8;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(256)
gemm_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
          bf16* __restrict__ out, int M, int N, int K) {
  // as: (m, k) row-major; bs: W's tile transposed to (n, k), so that the
  // k-pairs of one column that an mma B fragment takes are adjacent.
  __shared__ __align__(16) bf16 as[TBM][TBK + PAD];
  __shared__ __align__(16) bf16 bs[TBN][TBK + PAD];
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;  // warp's 64 x 32
  const int g = lane >> 2, t = lane & 3;
  const bf16 zero = __float2bfloat16(0.f);
  float acc[4][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TBK) {
    for (int idx = tid; idx < TBM * TBK; idx += 256) {
      int r = idx / TBK, kk = idx % TBK, m = m0 + r, k = k0 + kk;
      as[r][kk] = m < M && k < K ? x[(size_t)m * K + k] : zero;
    }
    for (int idx = tid; idx < TBK * TBN; idx += 256) {
      int kk = idx / TBN, c = idx % TBN, n = n0 + c, k = k0 + kk;
      bs[c][kk] = k < K && n < N ? w[(size_t)k * N + n] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TBK; ks += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + g, c = ks + t * 2;
        a[mi][0] = pair(&as[r][c]);
        a[mi][1] = pair(&as[r + 8][c]);
        a[mi][2] = pair(&as[r][c + 8]);
        a[mi][3] = pair(&as[r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g, c = ks + t * 2;
        b[ni][0] = pair(&bs[n][c]);
        b[ni][1] = pair(&bs[n][c + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {          // rows g and g + 8
        int m = m0 + wm + mi * 16 + g + 8 * h;
        int n = n0 + wn + ni * 8 + t * 2;
        if (m >= M) continue;
        if (n < N) out[(size_t)m * N + n] = __float2bfloat16(acc[mi][ni][2 * h]);
        if (n + 1 < N)
          out[(size_t)m * N + n + 1] = __float2bfloat16(acc[mi][ni][2 * h + 1]);
      }
}

}  // namespace

namespace repro {
namespace gemm {

using namespace tc;

enum Route { SIMT = 0, MMA = 1, WGMMA = 2, SPLITK = 3 };
constexpr int M_SMALL = 8;             // most rows of the splitk route

// ---- wgmma: TMA ring, two consumer warpgroups ----
constexpr int WBM = 128, WBN = 256, WBK = 64, WSTAGES = 4;
constexpr int WCONSUMERS = 256, WTHREADS = 384;
constexpr int A_BYTES = WBM * WBK * 2;       // x tile: one TMA box, 128 rows
constexpr int B_BYTES = WBK * WBN * 2;       // W tile: WBN / 64 boxes
constexpr int WSTAGE = A_BYTES + B_BYTES;
constexpr int WSMEM = WSTAGES * WSTAGE + 2 * WSTAGES * 8 + 1024;  // + align

__global__ void __launch_bounds__(WTHREADS, 1)
gemm_wgmma(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap wmap, bf16* __restrict__ out,
           int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + WSTAGES * WSTAGE, empty = full + 8 * WSTAGES;
  const int mtiles = (M + WBM - 1) / WBM;
  const int tiles = mtiles * ((N + WBN - 1) / WBN);
  const int ksteps = (K + WBK - 1) / WBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WCONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= WCONSUMERS) {            // producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == WCONSUMERS) {
      int it = 0;                               // k-steps over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % mtiles) * WBM, n0 = (tile / mtiles) * WBN;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int st = it % WSTAGES, ph = (it / WSTAGES) & 1;
          if (it >= WSTAGES) mbar_wait(empty + 8 * st, ph ^ 1);
          const uint32_t a = base + st * WSTAGE, b = a + A_BYTES;
          const uint32_t bar = full + 8 * st;
          mbar_expect_tx(bar, WSTAGE);
          tma_load_2d(a, &xmap, bar, ks * WBK, m0);
#pragma unroll
          for (int c = 0; c < WBN / 64; ++c)
            tma_load_2d(b + c * BOX_BYTES, &wmap, bar, n0 + 64 * c, ks * WBK);
        }
      }
    }
  } else {                                    // consumer warpgroups
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4, t = lane % 4;
    float acc[WBN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % mtiles) * WBM, n0 = (tile / mtiles) * WBN;
#pragma unroll
      for (int i = 0; i < WBN / 2; ++i) acc[i] = 0.f;
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int st = it % WSTAGES, ph = (it / WSTAGES) & 1;
        const uint32_t a = base + st * WSTAGE + wg * (A_BYTES / 2);
        const uint32_t b = base + st * WSTAGE + A_BYTES;
        mbar_wait(full + 8 * st, ph);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WBK / 16; ++kk)
          wgmma_ss<1>(acc, desc_kmajor(a + kk * 32), desc_mnmajor(b + kk * 2048), 1);
        wgmma_commit();
        wgmma_wait<1>();                      // k-step ks - 1 is done with
        fence_regs(acc);                      // its stage: release it
        if (ks > 0) mbar_arrive(empty + 8 * ((it - 1) % WSTAGES));
      }
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty + 8 * ((it - 1) % WSTAGES));
      // The producer loads the next tile's first stages meanwhile.  Thread
      // (warp w, lane l) of warpgroup wg holds rows wg*64 + w*16 + l/4 and
      // that + 8, columns 8i + 2(l%4) + {0, 1}.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wg * 64 + w * 16 + lane / 4 + 8 * h;
        if (m >= M) continue;
        bf16* row = out + (size_t)m * N;
#pragma unroll
        for (int i = 0; i < WBN / 8; ++i) {
          const int n = n0 + 8 * i + 2 * t;     // N % 8 == 0: n + 1 < N too
          if (n < N)
            *reinterpret_cast<uint32_t*>(row + n) =
                pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        }
      }
    }
  }
}

// The device's SMs: the wgmma route's persistent grid (one block an SM).
inline int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

int launch_wgmma(const void* x, const void* w, void* out, int M, int N, int K,
                 cudaStream_t stream) {
  if (K <= 0 || K % 8 || N % 8 || !tma_ok(x, K) || !tma_ok(w, N))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  int err = make_map_2d(&xmap, x, K, M, (uint64_t)K * 2, WBM);
  if (!err) err = make_map_2d(&wmap, w, N, K, (uint64_t)N * 2, WBK);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((M + WBM - 1) / WBM) * ((N + WBN - 1) / WBN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_wgmma<<<grid, WTHREADS, WSMEM, stream>>>(xmap, wmap, (bf16*)out, M, N, K);
  return (int)cudaGetLastError();
}

// ---- splitk: the weight stream ----
constexpr int SLAB = 256;           // N columns per block: 32 groups of 8
constexpr int KT = 64;              // a split's K range is a multiple of KT
constexpr int KMAX = 1024;          // most K rows per split (x in shared memory)
constexpr int SPLIT_BLOCKS = 1024;  // blocks a call aims at: ~8 per SM
constexpr int SK_THREADS = 256;     // 8 row lanes x 32 column groups
constexpr int UNROLL = 8;           // W rows in flight per thread

// S, the K splits of a (K, N) product: enough blocks to fill the card, at
// most KMAX rows a split, every split non-empty.  Never depends on M.
inline int splits_for(int K, int N) {
  const int slabs = (N + SLAB - 1) / SLAB, ktiles = (K + KT - 1) / KT;
  if (ktiles <= 1) return 1;
  int S = (SPLIT_BLOCKS + slabs - 1) / slabs;
  const int need = (ktiles + KMAX / KT - 1) / (KMAX / KT);
  if (S < need) S = need;
  if (S > ktiles) S = ktiles;
  const int per = (ktiles + S - 1) / S;
  return (ktiles + per - 1) / per;
}

// The K rows of each split: split s covers [s * rows, min(K, (s+1) * rows)).
inline int split_rows(int K, int S) {
  const int ktiles = (K + KT - 1) / KT;
  return (ktiles + S - 1) / S * KT;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, bf16* p) { *p = __float2bfloat16(v); }

// Eight consecutive columns of one row of W, loaded raw and widened to f32.
template <typename T>
struct Row8 {
  static constexpr int NV = sizeof(T) / 2;   // 16-byte loads: bf16 1, f32 2
  uint4 r[NV];
  // VEC: 16-byte aligned, all eight in range; else element by element,
  // the columns past `valid` zero.
  template <bool VEC>
  __device__ __forceinline__ void load(const T* p, int valid) {
    if (VEC) {
#pragma unroll
      for (int i = 0; i < NV; ++i) r[i] = __ldcs(reinterpret_cast<const uint4*>(p) + i);
    } else {
      using Bits = typename std::conditional<sizeof(T) == 2, uint16_t,
                                             uint32_t>::type;
      const Bits* q = reinterpret_cast<const Bits*>(p);
      Bits v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = c < valid ? q[c] : Bits(0);
      memcpy(r, v, sizeof(v));
    }
  }
  __device__ __forceinline__ void widen(float (&f)[8]) const {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(r);
    if (sizeof(T) == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(u[i] << 16);
        f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) f[c] = __uint_as_float(u[c]);
    }
  }
};

// Block (slab, split s): out[:, slab] (S == 1) or part[s, :, slab] (S > 1)
// = x[:, K range of s] @ W[K range of s, slab].  Thread (row lane rl,
// column group cg) sums rows rl, rl + 8, ... of the range over columns
// 8cg .. 8cg + 7 in MR x 8 f32 registers; the row lanes are then added in
// order 0..7.  MR >= M; x's rows past M are zero and their sums unused.
template <typename T, int MR, bool VEC>
__global__ void __launch_bounds__(SK_THREADS)
gemm_splitk(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ out, float* __restrict__ part,
            int* __restrict__ ticket, int M, int N, int K, int krows) {
  extern __shared__ float xs[];                 // [krows][MR], f32
  __shared__ __align__(16) float red[SK_THREADS / 32][SLAB];
  __shared__ int last;
  const int S = gridDim.y, s = blockIdx.y, slab = blockIdx.x;
  const int k_lo = s * krows, nk = min(K, k_lo + krows) - k_lo;
  for (int i = threadIdx.x; i < nk * MR; i += SK_THREADS) {
    const int kk = i / MR, m = i % MR;
    xs[i] = m < M ? to_f(x[(size_t)m * K + k_lo + kk]) : 0.f;
  }
  __syncthreads();
  const int cg = threadIdx.x % 32, rl = threadIdx.x / 32;
  const int n = slab * SLAB + cg * 8, valid = N - n;
  float acc[MR][8];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[m][c] = 0.f;
  if (valid > 0) {
    const T* wp = w + (size_t)k_lo * N + n;
    for (int k0 = rl; k0 < nk; k0 += 8 * UNROLL) {
      Row8<T> raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (k0 + 8 * u < nk) raw[u].template load<VEC>(wp + (size_t)(k0 + 8 * u) * N, valid);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = k0 + 8 * u;
        if (k >= nk) break;
        float f[8];
        raw[u].widen(f);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float xv = xs[k * MR + m];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[m][c] = fmaf(xv, f[c], acc[m][c]);
        }
      }
    }
  }
  const int col = slab * SLAB + threadIdx.x;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    if (m >= M) break;
    __syncthreads();                            // red is free
    float4* dst = reinterpret_cast<float4*>(&red[rl][cg * 8]);
    dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    __syncthreads();
    float v = red[0][threadIdx.x];
#pragma unroll
    for (int r = 1; r < SK_THREADS / 32; ++r) v += red[r][threadIdx.x];
    if (col < N) {
      if (S == 1) from_f(v, out + (size_t)m * N + col);
      else part[((size_t)s * M + m) * N + col] = v;
    }
  }
  if (S == 1) return;
  // The last block of the slab to finish adds the partials in split order.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket + slab, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (col < N) {
    for (int m = 0; m < M; ++m) {
      float v = __ldcg(part + (size_t)m * N + col);
      for (int r = 1; r < S; ++r) v += __ldcg(part + ((size_t)r * M + m) * N + col);
      from_f(v, out + (size_t)m * N + col);
    }
  }
  if (threadIdx.x == 0) ticket[slab] = 0;       // ready for the next call
}

template <typename T, int MR>
int launch_splitk_mr(const void* x, const void* w, void* out, void* part,
                     void* ticket, int M, int N, int K, cudaStream_t stream) {
  const int S = splits_for(K, N), krows = split_rows(K, S);
  const size_t smem = (size_t)krows * MR * sizeof(float);
  const bool vec = N % 8 == 0 && (uintptr_t)w % 16 == 0;
  auto kernel = vec ? gemm_splitk<T, MR, true> : gemm_splitk<T, MR, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + SLAB - 1) / SLAB, S);
  kernel<<<grid, SK_THREADS, smem, stream>>>(
      (const T*)x, (const T*)w, (T*)out, (float*)part, (int*)ticket, M, N, K,
      krows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_splitk(const void* x, const void* w, void* out, void* part,
                  void* ticket, int M, int N, int K, cudaStream_t s) {
  if (M <= 1) return launch_splitk_mr<T, 1>(x, w, out, part, ticket, M, N, K, s);
  if (M <= 2) return launch_splitk_mr<T, 2>(x, w, out, part, ticket, M, N, K, s);
  if (M <= 4) return launch_splitk_mr<T, 4>(x, w, out, part, ticket, M, N, K, s);
  if (M <= M_SMALL) return launch_splitk_mr<T, M_SMALL>(x, w, out, part, ticket, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gemm
}  // namespace repro

// The route tile_gemm_launch takes for (M, K, N) in dtype (0 = float32,
// 1 = bfloat16): 0 simt, 1 mma, 2 wgmma, 3 splitk.  The wgmma route also
// needs x and w 16-byte aligned, which the caller checks (else mma).
extern "C" int tile_gemm_route(int M, int K, int N, int dtype) {
  using namespace repro::gemm;
  if (M <= M_SMALL) return SPLITK;
  if (dtype == 0) return SIMT;
  return K > 0 && K % 8 == 0 && N % 8 == 0 ? WGMMA : MMA;
}

// S, the K splits of the splitk route at (K, N): each writes an f32
// partial of (M, N) when S > 1.
extern "C" int tile_gemm_splits(int K, int N) {
  return repro::gemm::splits_for(K, N);
}

// dtype: 0 = float32, 1 = bfloat16; route as tile_gemm_route.  x (M, K),
// w (K, N), out (M, N), all contiguous row-major.  part: S * M * N f32
// (splitk with S > 1, else unused); ticket: ceil(N / 256) int32, zero, left
// zero.  Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue
// for a route that cannot take the shape.
extern "C" int tile_gemm_launch(const void* x, const void* w, void* out,
                                int dtype, int route, int M, int N, int K,
                                void* part, void* ticket, void* stream) {
  using namespace repro::gemm;
  cudaStream_t s = (cudaStream_t)stream;
  switch (route) {
    case SPLITK:
      return dtype == 0
                 ? launch_splitk<float>(x, w, out, part, ticket, M, N, K, s)
                 : launch_splitk<__nv_bfloat16>(x, w, out, part, ticket, M, N, K, s);
    case WGMMA:
      if (dtype != 1) return (int)cudaErrorInvalidValue;
      return launch_wgmma(x, w, out, M, N, K, s);
    case SIMT: {
      if (dtype != 0) return (int)cudaErrorInvalidValue;
      dim3 grid((M + SBM - 1) / SBM, (N + SBN - 1) / SBN);
      gemm_f32<<<grid, 256, 0, s>>>((const float*)x, (const float*)w,
                                    (float*)out, M, N, K);
      return (int)cudaGetLastError();
    }
    case MMA: {
      if (dtype != 1) return (int)cudaErrorInvalidValue;
      dim3 grid((M + TBM - 1) / TBM, (N + TBN - 1) / TBN);
      gemm_bf16<<<grid, 256, 0, s>>>((const __nv_bfloat16*)x,
                                     (const __nv_bfloat16*)w,
                                     (__nv_bfloat16*)out, M, N, K);
      return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorInvalidValue;
}
