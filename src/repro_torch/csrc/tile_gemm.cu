// Tiled matrix product with f32 accumulation, for sm_90a.
//
// Replaces: src/repro/kernels/tile_gemm.py:57 (tile_gemm / _gemm_kernel),
// the Pallas TPU kernel: (M, K) @ (K, N) accumulated in f32, output in x's
// dtype, weight-stationary grid order (n outer, m inner).  Unlike the
// Pallas kernel, which needs K to be a multiple of its K block and reads
// unmasked padding otherwise, this kernel masks the ragged edge of M, N
// and K (vilbert-base's language stream has K = 768).
//
// What bounds it on the H100: at the main path's shapes (M = B·S up to
// 8192, K and N of 768..3072) the FLOPs: 2·M·N·K against (M·K + K·N + M·N)
// elements is ~1000 operations per byte, above the card's ~295 (bf16).
//
// Design: blockIdx.x walks m fastest, so the blocks resident at one time
// share a column block of W, which then stays in L2 (the TPU kernel's
// weight-stationary order).  bf16: 128 x 128 x 32 tiles in shared memory,
// 8 warps each computing 64 x 32 with mma.sync m16n8k16 (tensor cores, f32
// accumulators).  f32: 64 x 64 x 16 tiles with SIMT f32 FMAs, so that f32
// results are full f32 (no TF32).  wgmma and TMA are a later PR.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// dtype: 0 = float32, 1 = bfloat16.  x (M, K), w (K, N), out (M, N), all
// contiguous row-major.  Returns cudaGetLastError() of the launch.
extern "C" int tile_gemm_launch(const void* x, const void* w, void* out,
                                int dtype, int M, int N, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    dim3 grid((M + SBM - 1) / SBM, (N + SBN - 1) / SBN);
    gemm_f32<<<grid, 256, 0, s>>>((const float*)x, (const float*)w,
                                  (float*)out, M, N, K);
  } else {
    dim3 grid((M + TBM - 1) / TBM, (N + TBN - 1) / TBN);
    gemm_bf16<<<grid, 256, 0, s>>>((const bf16*)x, (const bf16*)w,
                                   (bf16*)out, M, N, K);
  }
  return (int)cudaGetLastError();
}
