// Mamba-2 SSD chunked scan, for sm_90a.
//
// Replaces: src/repro/kernels/ssd_scan.py:97 (ssd_scan / _ssd_kernel), the
// Pallas TPU kernel.  Same function: x (B, S, H, P), dt (B, S, H) f32,
// a (H,) f32, b/c (B, S, N) -> y (B, S, H, P) in x's dtype and the final
// state (B, H, P, N) f32, the state after position S - 1.  Per (b, h),
// with a (P, N) f32 state carried along the sequence, for each chunk:
//   LD    = cumsum(dt * a) inside the chunk,
//   y_t   = sum_{s <= t} exp(LD_t - LD_s) (C_t . B_s) dt_s x_s
//           + exp(LD_t) (C_t . state),
//   state = exp(LD_last) state + sum_s exp(LD_last - LD_s) dt_s x_s b_s^T.
// The recurrence is associative, so the chunk length changes only the
// order of the sums: the kernel walks 64-row chunks whatever chunk the
// caller names (the Pallas kernel's, 128 or 256 rows, needs a 256 x 256
// C.B^T tile and two 256 x N f32 tiles, more than a block's 227 KB).  The
// ragged last chunk is masked here (dt = 0, no input, decay 1 past S), so
// the caller pads nothing.  The exponential of LD_t - LD_s is taken only
// for s <= t: for s > t it may overflow, and inf * 0 would be NaN.
//
// What bounds it on the H100: operations.  At mamba2-780m's prefill
// (H 48, P 64, N 128) a 64-row chunk does 2.T^2.N (C.B^T) + 2.T^2.P (M.U)
// + 2.T.N.P (C.state) + 2.T.P.N (state update) = 3.7 MFLOP per head,
// against 64 rows of x and y per head and of b and c shared by 48 heads:
// ~200 FLOPs per byte in bf16, far above the card's f32 SIMT ridge
// (67 TFLOP/s over 3.35 TB/s, 20).  These are SIMT f32 FMAs, as the
// Pallas kernel's f32 tiles in f32 products.
//
// Design:
// * one block per (P slice of 32 columns, head, batch row); the block
//   walks the chunks in order and keeps the (N, 32) slice of the state in
//   shared memory.  The columns of x are independent given LD and C.B^T,
//   so P slices run in parallel, each recomputing the chunk's C.B^T and
//   LD: 96 blocks for mamba2 (48 heads x 2), 100 for hymba (25 x 4) at
//   B = 1;
// * a chunk's C and B are staged transposed, (N, 64), so that the
//   64 x 64 C.B^T product reads them as float4 rows; M = masked decay x
//   C.B^T x dt goes to shared memory, read by y's 64 x 32 tile;
// * y first takes the inter-chunk term (the state before the update),
//   then the block updates the state, 64 state rows per pass.
// Tensor cores, C.B^T shared across heads and the P slices, and TMA
// staging are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int T = 64;        // rows per chunk
constexpr int TS = T + 4;    // padded row stride of the (N, T) and (T, T) tiles
constexpr int PS = 32;       // columns of x per block (one per lane)
constexpr int NT = 64;       // state rows per pass of the update
constexpr int MAX_N = 256;
static_assert(T == 64, "the LD scan gives each lane two rows");
static_assert(T == 16 * 4, "C.B^T: 16 x 16 threads of 4 x 4 entries");
static_assert(THREADS == 256 && PS == 32 && T % NWARPS == 0,
              "y and the state update: a warp per row group, a lane per "
              "column");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename TT> __device__ __forceinline__ TT from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct SsdShape {
  int B, S, H, P, N;
};

// Shared memory in floats: cT, bT (N, TS); x (T, PS); M (T, TS); state
// (N, PS); LD, dt and the state-update weights (T each).
__host__ __device__ inline int smem_floats(int N) {
  return 2 * N * TS + T * PS + T * TS + N * PS + 3 * T;
}

template <typename TT>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const TT* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const TT* __restrict__ b,
           const TT* __restrict__ c, TT* __restrict__ y,
           float* __restrict__ state_out, SsdShape sh) {
  extern __shared__ __align__(16) float smem[];
  const int N = sh.N;
  float* cT = smem;             // (N, TS): the chunk's C, transposed
  float* bT = cT + N * TS;      // (N, TS): the chunk's B, transposed
  float* xs = bT + N * TS;      // (T, PS): the chunk's x slice
  float* m = xs + T * PS;       // (T, TS): M[t][s]
  float* st = m + T * TS;       // (N, PS): the carried state, transposed
  float* ld = st + N * PS;      // (T): inclusive cumsum of dt * a
  float* dts = ld + T;          // (T): dt, 0 past S
  float* wl = dts + T;          // (T): exp(LD_last - LD_s) * dt_s

  const int p0 = blockIdx.x * PS, h = blockIdx.y, bi = blockIdx.z;
  const int pw = min(PS, sh.P - p0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float ah = a[h];
  const size_t row0 = (size_t)bi * sh.S;

  for (int i = tid; i < N * PS; i += THREADS) st[i] = 0.f;

  for (int t0 = 0; t0 < sh.S; t0 += T) {
    const int tv = min(T, sh.S - t0);   // valid rows of this chunk
    __syncthreads();                    // the last chunk's readers are done

    // Stage C, B (transposed) and x; rows past S are zero.
    for (int i = tid; i < T * N; i += THREADS) {
      const int r = i / N, n = i - r * N;
      float cv = 0.f, bv = 0.f;
      if (r < tv) {
        const size_t g = (row0 + t0 + r) * N + n;
        cv = to_f(c[g]);
        bv = to_f(b[g]);
      }
      cT[n * TS + r] = cv;
      bT[n * TS + r] = bv;
    }
    for (int i = tid; i < T * PS; i += THREADS) {
      const int r = i / PS, p = i - r * PS;
      float xv = 0.f;
      if (r < tv && p < pw)
        xv = to_f(x[((row0 + t0 + r) * sh.H + h) * sh.P + p0 + p]);
      xs[i] = xv;
    }
    // LD: warp 0 scans dt * a over the 64 rows, two rows per lane.
    if (warp == 0) {
      const float d0 =
          lane < tv ? dt[(row0 + t0 + lane) * sh.H + h] : 0.f;
      const float d1 =
          lane + 32 < tv ? dt[(row0 + t0 + lane + 32) * sh.H + h] : 0.f;
      float s0 = d0 * ah, s1 = d1 * ah;
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffff, s0, o);
        const float u1 = __shfl_up_sync(0xffffffff, s1, o);
        if (lane >= o) {
          s0 += u0;
          s1 += u1;
        }
      }
      s1 += __shfl_sync(0xffffffff, s0, 31);
      ld[lane] = s0;
      ld[lane + 32] = s1;
      dts[lane] = d0;
      dts[lane + 32] = d1;
    }
    __syncthreads();
    const float ld_last = ld[T - 1];
    if (tid < T) wl[tid] = expf(ld_last - ld[tid]) * dts[tid];

    // M[t][s] = exp(LD_t - LD_s) (C_t . B_s) dt_s for s <= t, else 0:
    // thread (ty, tx) owns rows ty*4.. and columns tx*4.. of the 64 x 64
    // tile; a tile wholly above the diagonal is only zeroed.
    {
      const int ty = tid >> 4, tx = tid & 15;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (tx <= ty) {
        for (int n = 0; n < N; ++n) {
          const float4 cv =
              *reinterpret_cast<const float4*>(&cT[n * TS + ty * 4]);
          const float4 bv =
              *reinterpret_cast<const float4*>(&bT[n * TS + tx * 4]);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(cr[i], br[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty * 4 + i;
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx * 4 + j;
          o[j] = s <= t ? expf(ld[t] - ld[s]) * dts[s] * acc[i][j] : 0.f;
        }
        *reinterpret_cast<float4*>(&m[t * TS + tx * 4]) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();

    // y: lane = column, rows warp + 8 i.  The inter-chunk term reads the
    // state before this chunk's update.
    {
      const int p = lane;
      float acc[T / NWARPS];
#pragma unroll
      for (int i = 0; i < T / NWARPS; ++i) acc[i] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float sv = st[n * PS + p];
#pragma unroll
        for (int i = 0; i < T / NWARPS; ++i)
          acc[i] = fmaf(cT[n * TS + warp + NWARPS * i], sv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < T / NWARPS; ++i)
        acc[i] *= expf(ld[warp + NWARPS * i]);
      for (int s = 0; s < T; ++s) {
        const float xv = xs[s * PS + p];
#pragma unroll
        for (int i = 0; i < T / NWARPS; ++i)
          acc[i] = fmaf(m[(warp + NWARPS * i) * TS + s], xv, acc[i]);
      }
      if (p < pw) {
#pragma unroll
        for (int i = 0; i < T / NWARPS; ++i) {
          const int t = warp + NWARPS * i;
          if (t < tv)
            y[((row0 + t0 + t) * sh.H + h) * sh.P + p0 + p] =
                from_f<TT>(acc[i]);
        }
      }
    }
    __syncthreads();

    // State update: lane = column, state rows nb + warp + 8 j.
    {
      const int p = lane;
      const float decay = expf(ld_last);
      for (int nb = 0; nb < N; nb += NT) {
        float acc[NT / NWARPS];
#pragma unroll
        for (int j = 0; j < NT / NWARPS; ++j) acc[j] = 0.f;
        for (int s = 0; s < T; ++s) {
          const float xw = xs[s * PS + p] * wl[s];
#pragma unroll
          for (int j = 0; j < NT / NWARPS; ++j) {
            const int n = nb + warp + NWARPS * j;
            if (n < N) acc[j] = fmaf(xw, bT[n * TS + s], acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < NT / NWARPS; ++j) {
          const int n = nb + warp + NWARPS * j;
          if (n < N) st[n * PS + p] = fmaf(decay, st[n * PS + p], acc[j]);
        }
      }
    }
  }
  __syncthreads();

  // The final state, (B, H, P, N): n runs fastest in device memory.
  float* so = state_out + ((size_t)bi * sh.H + h) * sh.P * N;
  for (int i = tid; i < N * PS; i += THREADS) {
    const int p = i / N, n = i - p * N;
    if (p < pw) so[(size_t)(p0 + p) * N + n] = st[n * PS + p];
  }
}

template <typename TT>
int launch(const void* x, const float* dt, const float* a, const void* b,
           const void* c, void* y, float* state, const SsdShape& sh,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(sh.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.P + PS - 1) / PS, sh.H, sh.B);
  ssd_kernel<TT><<<grid, THREADS, smem, stream>>>(
      (const TT*)x, dt, a, (const TT*)b, (const TT*)c, (TT*)y, state, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest state width N the kernel's shared memory holds.
extern "C" int ssd_scan_max_state() { return MAX_N; }

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16.  x (B, S, H, P),
// dt (B, S, H) f32, a (H,) f32, b/c (B, S, N), y like x, state
// (B, H, P, N) f32, all contiguous; S >= 1 and N <= ssd_scan_max_state()
// (the Python wrapper checks).  Returns cudaGetLastError() of the launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, void* y,
                               void* state, int dtype, int B, int S, int H,
                               int P, int N, void* stream) {
  SsdShape sh{B, S, H, P, N};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, (const float*)dt, (const float*)a, b, c, y,
                         (float*)state, sh, s);
  return launch<__nv_bfloat16>(x, (const float*)dt, (const float*)a, b, c, y,
                               (float*)state, sh, s);
}
