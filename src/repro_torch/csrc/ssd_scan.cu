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
// order of the sums: the kernels walk 64-row chunks whatever chunk the
// caller names.  The ragged last chunk is masked here (dt = 0, no input,
// decay 1 past S), so the caller pads nothing.  The exponential of
// LD_t - LD_s is taken only for s <= t: for s > t it may overflow, and
// inf * 0 would be NaN.
//
// What bounds it on the H100: operations, then the chunk states' bytes.
// mamba2-780m's 2048-token prefill (H 48, P 64, N 128) needs ~3.4 GFLOP in
// its cheapest chunked form; at the bf16 tensor-core rate, with each f32
// operand taken as two bf16 halves (three products), that is ~10 us,
// about the 8 us its inputs and outputs take at 3.35 TB/s.
//
// Two routes, picked by the caller (the wrapper): tc for bf16 inputs with
// P and N multiples of 8, at most MAX_TC_WIDTH, and x, b, c 16-byte
// aligned; simt otherwise (f32, and the bf16 shapes tc does not take).
//
// tc (the bf16 route): the chunked SSD of Mamba-2 (arXiv:2405.21060, §6),
// four launches in one call, each stage parallel over the chunks but the
// third, on the tensor cores (mma.sync m16n8k16, f32 accumulators):
//   1. ssd_cb, per (row, chunk): CB = C B^T (64 x 64), once for all heads;
//   2. ssd_state, per (head, chunk, row): LD, the chunk's decay
//      exp(LD_last) and its own contribution to the state,
//      (exp(LD_last - LD_s) dt_s x_s)^T B (P x N);
//   3. ssd_pass, per (state element, head, row), along the chunks: the
//      state entering each chunk (written over its contribution) and the
//      final state, elementwise f32, loads batched ahead of the chain;
//   4. ssd_y, per (head x 64 columns of P, chunk, row):
//      y = (tril . exp(LD_t - LD_s) . CB)(dt x) + exp(LD_t) C state^T.
// b, c and x enter the products as the bf16 they are; every f32 operand
// (the decayed CB, dt x, exp(LD_last - LD_s) dt x, the state) enters as
// its bf16 hi + lo pair, which holds the f32 limit and the one-ulp bf16
// limit (products hi.hi + hi.lo + lo.hi; C and B exact).  At 2048 tokens
// mamba2 runs 1,536 (chunk, head) blocks in stages 2 and 4, where the
// first port's kernel ran 96 blocks along 32 dependent chunk steps.
//
// simt (f32; the first port's kernel, kept as it was): one block per
// (P slice of 32 columns, head, batch row) walking the chunks in order
// with the (N, 32) slice of the state in shared memory, SIMT f32 FMAs.
// Its bf16 instantiation is reachable through the C interface for timing
// the parent kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "warp_mma.cuh"

namespace {

// cudaFuncSetAttribute once per kernel instantiation and device.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1ull)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

// ============================ simt route ============================


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
int launch_simt(const void* x, const float* dt, const float* a, const void* b,
                const void* c, void* y, float* state, const SsdShape& sh,
                cudaStream_t stream) {
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(ssd_kernel<TT>,
                               sizeof(float) * smem_floats(MAX_N), done);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * smem_floats(sh.N);
  dim3 grid((sh.P + PS - 1) / PS, sh.H, sh.B);
  ssd_kernel<TT><<<grid, THREADS, smem, stream>>>(
      (const TT*)x, dt, a, (const TT*)b, (const TT*)c, (TT*)y, state, sh);
  return (int)cudaGetLastError();
}

// ============================ tc route (bf16) ============================

using repro::wm::bf16;
constexpr int TC_THREADS = 128;     // 4 warps, 16 rows of a 64-row tile each
constexpr int L = T;                // rows per chunk
constexpr int MAX_TC_WIDTH = 256;   // most P and N the tc route takes
constexpr int YP = 64;              // columns of P per ssd_y block
constexpr int PASS_THREADS = 256;
constexpr int PASS_BATCH = 8;       // chunk loads issued ahead of the chain
constexpr int STATE_BATCH = 8;      // ssd_y: state loads in flight a thread

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }
// Row stride (bf16) of a tile whose rows are n wide: 16 bytes of padding
// put ldmatrix's eight row addresses in distinct banks.
__host__ __device__ constexpr int stride16(int n) { return pad16(n) + 8; }

// Rows [r0, r0 + 64) of a (rows, cols) bf16 matrix with row stride `ld`
// elements into a (64, pad16(cols)) tile: 16-byte copies, rows past
// `rows` and columns past `cols` (a multiple of 8) zero-filled.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t ld, int r0, int rows,
                                          int cols) {
  const int chunks = pad16(cols) / 8, sd = stride16(cols);
  for (int i = threadIdx.x; i < L * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i - r * chunks;
    const bool in = r0 + r < rows && c * 8 < cols;
    repro::wm::cp_async16(dst + r * sd + c * 8,
                          in ? src + (size_t)(r0 + r) * ld + c * 8 : src,
                          in ? 16 : 0);
  }
}

// dt of one (row, chunk, head) and its LD = cumsum(dt * a), 0 past S:
// warp 0 scans, two rows a lane.
__device__ __forceinline__ void chunk_ld(const float* dt, float ah,
                                         size_t first, int stride, int tv,
                                         float* dts, float* ld) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  const float d0 = lane < tv ? dt[first + (size_t)lane * stride] : 0.f;
  const float d1 =
      lane + 32 < tv ? dt[first + (size_t)(lane + 32) * stride] : 0.f;
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

struct TcShape {
  int B, S, H, P, N, nc;
};

// Rows [0, 64) of x[b, t0 + r, h, p0 + p] (p < `cols`, a multiple of 8
// and of at most `width` columns), each scaled by wr[r], into the bf16 hi
// and lo tiles (64, width) of row stride `ld`: eight columns a thread,
// LOAD_BATCH 16-byte loads in flight before any is converted; zero past
// `rows` valid rows and past `cols`.
constexpr int LOAD_BATCH = 4;
__device__ __forceinline__ void scaled_split_rows(
    const bf16* __restrict__ x, size_t first, size_t row_stride, int rows,
    int cols, int width, const float* wr, bf16* hi, bf16* lo, int ld) {
  const int pc = width / 8, total = L * pc;
  for (int i0 = threadIdx.x; i0 < total; i0 += LOAD_BATCH * TC_THREADS) {
    uint4 raw[LOAD_BATCH];
#pragma unroll
    for (int j = 0; j < LOAD_BATCH; ++j) {
      const int i = i0 + j * TC_THREADS, r = i / pc, p = (i - r * pc) * 8;
      raw[j] = make_uint4(0, 0, 0, 0);
      if (i < total && r < rows && p < cols)
        raw[j] = *reinterpret_cast<const uint4*>(x + first + r * row_stride
                                                 + p);
    }
#pragma unroll
    for (int j = 0; j < LOAD_BATCH; ++j) {
      const int i = i0 + j * TC_THREADS, r = i / pc, p = (i - r * pc) * 8;
      if (i >= total) break;
      const bf16* e = reinterpret_cast<const bf16*>(&raw[j]);
      uint32_t h[4], l[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        repro::wm::split2(wr[r] * __bfloat162float(e[2 * k]),
                          wr[r] * __bfloat162float(e[2 * k + 1]), h[k], l[k]);
      *reinterpret_cast<uint4*>(hi + r * ld + p) = make_uint4(h[0], h[1], h[2],
                                                              h[3]);
      *reinterpret_cast<uint4*>(lo + r * ld + p) = make_uint4(l[0], l[1], l[2],
                                                              l[3]);
    }
  }
}

// 1. CB = C B^T of one (chunk, row), f32, (64, 64) row-major.
__global__ void __launch_bounds__(TC_THREADS)
ssd_cb(const bf16* __restrict__ b, const bf16* __restrict__ c,
       float* __restrict__ cb, TcShape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sd = stride16(sh.N);
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);   // (64, sd)
  bf16* bs = cs + L * sd;                         // (64, sd)
  const int ch = blockIdx.x, bi = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t first = (size_t)bi * sh.S * sh.N;
  load_rows(cs, c + first, sh.N, ch * L, sh.S, sh.N);
  load_rows(bs, b + first, sh.N, ch * L, sh.S, sh.N);
  repro::wm::cp_async_commit();
  repro::wm::cp_async_wait<0>();
  __syncthreads();
  float acc[8][4] = {};
  for (int kk = 0; kk < pad16(sh.N) / 16; ++kk) {
    uint32_t af[4];
    repro::wm::ldsm_x4(af, cs + (warp * 16 + ((lane >> 3) & 1) * 8
                                 + (lane & 7)) * sd
                               + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t bf[4];
      repro::wm::ldsm_x4(bf, bs + (jp * 16 + (lane >> 4) * 8 + (lane & 7))
                                      * sd
                                 + kk * 16 + ((lane >> 3) & 1) * 8);
      repro::wm::mma16816(acc[2 * jp], af, bf[0], bf[1]);
      repro::wm::mma16816(acc[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
  float* out = cb + ((size_t)bi * sh.nc + ch) * L * L;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (warp * 16 + g + 8 * r) * L + 8 * j
                                 + 2 * t) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
}

// 2. One (head, chunk, row): the chunk's decay exp(LD_last) and its own
// contribution to the state, sum_s w_s x_s b_s^T with w_s =
// exp(LD_last - LD_s) dt_s, (P, N) f32 into `st` at (row, head, chunk).
// w x enters as bf16 hi + lo (A, transposed from its (s, p) tile), b as it
// is; a warp owns 16 rows of P by 64 columns of N at a time.
__global__ void __launch_bounds__(TC_THREADS)
ssd_state(const bf16* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ a, const bf16* __restrict__ b,
          float* __restrict__ st, float* __restrict__ decay, TcShape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = stride16(sh.P), sn = stride16(sh.N);
  const int PP = pad16(sh.P), NP = pad16(sh.N);
  bf16* xh = reinterpret_cast<bf16*>(smem_raw);   // (64, sp): w x, hi
  bf16* xl = xh + L * sp;                         // (64, sp): w x, lo
  bf16* bs = xl + L * sp;                         // (64, sn)
  __shared__ float ld[L], dts[L], w[L];
  const int h = blockIdx.x, ch = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = ch * L, tv = min(L, sh.S - t0);
  load_rows(bs, b + (size_t)bi * sh.S * sh.N, sh.N, t0, sh.S, sh.N);
  repro::wm::cp_async_commit();
  chunk_ld(dt, a[h], ((size_t)bi * sh.S + t0) * sh.H + h, sh.H, tv, dts, ld);
  __syncthreads();
  const float ld_last = ld[L - 1];
  if (tid < L) w[tid] = expf(ld_last - ld[tid]) * dts[tid];
  if (tid == 0)
    decay[((size_t)bi * sh.H + h) * sh.nc + ch] = expf(ld_last);
  __syncthreads();
  // w x as hi + lo; zero past S and past P.
  scaled_split_rows(x, (((size_t)bi * sh.S + t0) * sh.H + h) * sh.P,
                    (size_t)sh.H * sh.P, tv, sh.P, PP, w, xh, xl, sp);
  repro::wm::cp_async_wait<0>();
  __syncthreads();

  float* out = st + (((size_t)bi * sh.H + h) * sh.nc + ch) * sh.P * sh.N;
  const int g = lane >> 2, t = lane & 3;
  const int nblk = (NP + 63) / 64;
  for (int job = warp; job < (PP / 16) * nblk; job += TC_THREADS / 32) {
    const int mt = job / nblk, n0 = (job - mt * nblk) * 64;
    const int npairs = min(4, (NP - n0) / 16);
    float acc[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      uint32_t ah[4], al[4];
      const int off = (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * sp
                      + mt * 16 + ((lane >> 3) & 1) * 8;
      repro::wm::ldsm_x4_trans(ah, xh + off);
      repro::wm::ldsm_x4_trans(al, xl + off);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (jp >= npairs) break;
        uint32_t bf[4];
        repro::wm::ldsm_x4_trans(
            bf, bs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * sn
                    + n0 + jp * 16 + (lane >> 4) * 8);
        repro::wm::mma16816(acc[2 * jp], ah, bf[0], bf[1]);
        repro::wm::mma16816(acc[2 * jp], al, bf[0], bf[1]);
        repro::wm::mma16816(acc[2 * jp + 1], ah, bf[2], bf[3]);
        repro::wm::mma16816(acc[2 * jp + 1], al, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = mt * 16 + g + 8 * r, n = n0 + 8 * j + 2 * t;
        if (j < 2 * npairs && p < sh.P && n < sh.N)
          *reinterpret_cast<float2*>(out + (size_t)p * sh.N + n) =
              make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
  }
}

// 3. Along the chunks of one (row, head), four state elements a thread:
// the state entering chunk c is written over chunk c's contribution, and
// the state after the last chunk is the final state.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_pass(float* __restrict__ st, const float* __restrict__ decay,
         float* __restrict__ state_out, TcShape sh) {
  const int h = blockIdx.y, bi = blockIdx.z;
  const size_t PN4 = (size_t)sh.P * sh.N / 4;
  const size_t e = (size_t)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= PN4) return;
  const size_t bh = (size_t)bi * sh.H + h;
  float4* s = reinterpret_cast<float4*>(st) + bh * sh.nc * PN4 + e;
  const float* dec = decay + bh * sh.nc;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < sh.nc; c0 += PASS_BATCH) {
    float4 v[PASS_BATCH];
    float d[PASS_BATCH];
#pragma unroll
    for (int i = 0; i < PASS_BATCH; ++i) {
      const bool in = c0 + i < sh.nc;
      v[i] = in ? s[(size_t)(c0 + i) * PN4] : make_float4(0.f, 0.f, 0.f, 0.f);
      d[i] = in ? dec[c0 + i] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < PASS_BATCH; ++i) {
      if (c0 + i >= sh.nc) break;
      s[(size_t)(c0 + i) * PN4] = run;
      run = make_float4(fmaf(d[i], run.x, v[i].x), fmaf(d[i], run.y, v[i].y),
                        fmaf(d[i], run.z, v[i].z), fmaf(d[i], run.w, v[i].w));
    }
  }
  reinterpret_cast<float4*>(state_out)[bh * PN4 + e] = run;
}

// 4. y of one (head, 64 columns of P, chunk, row): a warp owns 16 rows t.
// Intra-chunk: M U with M = tril . exp(LD_t - LD_s) . CB built in the
// A fragments from CB (f32, L2) and U = dt x from shared memory, both as
// hi + lo (three products); rows of a warp need only the k-steps s <= t.
// Inter-chunk: exp(LD_t) (C state^T), C as it is, the entering state as
// hi + lo (two products); the first chunk enters with state 0.
__global__ void __launch_bounds__(TC_THREADS)
ssd_y(const bf16* __restrict__ x, const float* __restrict__ dt,
      const float* __restrict__ a, const bf16* __restrict__ c,
      const float* __restrict__ cb, const float* __restrict__ st,
      bf16* __restrict__ y, TcShape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int su = stride16(YP);
  const int sn = stride16(sh.N), NP = pad16(sh.N);
  bf16* uh = reinterpret_cast<bf16*>(smem_raw);   // (64, su): dt x, hi
  bf16* ul = uh + L * su;                         // lo
  bf16* cs = ul + L * su;                         // (64, sn): C
  bf16* shi = cs + L * sn;                        // (YP, sn): state, hi
  bf16* slo = shi + YP * sn;                      // lo
  __shared__ float ld[L], dts[L];
  const int nps = (sh.P + YP - 1) / YP;
  const int h = blockIdx.x / nps, p0 = (blockIdx.x - h * nps) * YP;
  const int ch = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = ch * L, tv = min(L, sh.S - t0);
  const int pw = min(YP, sh.P - p0);
  load_rows(cs, c + (size_t)bi * sh.S * sh.N, sh.N, t0, sh.S, sh.N);
  repro::wm::cp_async_commit();
  chunk_ld(dt, a[h], ((size_t)bi * sh.S + t0) * sh.H + h, sh.H, tv, dts, ld);
  __syncthreads();
  // U = dt x as hi + lo; zero past S and past P.
  scaled_split_rows(x, (((size_t)bi * sh.S + t0) * sh.H + h) * sh.P + p0,
                    (size_t)sh.H * sh.P, tv, pw, YP, dts, uh, ul, su);
  // The entering state's rows p0.. as hi + lo, four columns a thread,
  // STATE_BATCH 16-byte loads in flight before any is converted.
  const bool carry = ch > 0;
  if (carry) {
    const float* s_in = st + (((size_t)bi * sh.H + h) * sh.nc + ch) * sh.P
                        * sh.N;
    const int n4 = NP / 4, total = YP * n4;
    for (int i0 = tid; i0 < total; i0 += STATE_BATCH * TC_THREADS) {
      float4 v[STATE_BATCH];
#pragma unroll
      for (int j = 0; j < STATE_BATCH; ++j) {
        const int i = i0 + j * TC_THREADS, r = i / n4, n = (i - r * n4) * 4;
        v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < total && r < pw && n < sh.N)
          v[j] = *reinterpret_cast<const float4*>(
              s_in + (size_t)(p0 + r) * sh.N + n);
      }
#pragma unroll
      for (int j = 0; j < STATE_BATCH; ++j) {
        const int i = i0 + j * TC_THREADS, r = i / n4, n = (i - r * n4) * 4;
        if (i >= total) break;
        uint32_t hi[2], lo[2];
        repro::wm::split2(v[j].x, v[j].y, hi[0], lo[0]);
        repro::wm::split2(v[j].z, v[j].w, hi[1], lo[1]);
        *reinterpret_cast<uint2*>(shi + r * sn + n) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(slo + r * sn + n) = make_uint2(lo[0], lo[1]);
      }
    }
  }
  repro::wm::cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};
  const float* cbt = cb + ((size_t)bi * sh.nc + ch) * L * L;
  float acc[8][4] = {};
  for (int kk = 0; kk <= warp; ++kk) {
    // M's A fragments, hi and lo: rows row[0], row[1]; columns
    // kk * 16 + 2t (+1) and + 8.
    uint32_t mh[4], ml[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int tr = row[q & 1], s0 = kk * 16 + 2 * t + 8 * (q >> 1);
      const float2 cv = *reinterpret_cast<const float2*>(cbt + tr * L + s0);
      const float m0 = s0 <= tr ? expf(ld[tr] - ld[s0]) * cv.x : 0.f;
      const float m1 = s0 + 1 <= tr ? expf(ld[tr] - ld[s0 + 1]) * cv.y : 0.f;
      repro::wm::split2(m0, m1, mh[q], ml[q]);
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t bh[4], bl[4];
      const int off = (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * su
                      + jp * 16 + (lane >> 4) * 8;
      repro::wm::ldsm_x4_trans(bh, uh + off);
      repro::wm::ldsm_x4_trans(bl, ul + off);
      repro::wm::mma16816(acc[2 * jp], mh, bh[0], bh[1]);
      repro::wm::mma16816(acc[2 * jp], mh, bl[0], bl[1]);
      repro::wm::mma16816(acc[2 * jp], ml, bh[0], bh[1]);
      repro::wm::mma16816(acc[2 * jp + 1], mh, bh[2], bh[3]);
      repro::wm::mma16816(acc[2 * jp + 1], mh, bl[2], bl[3]);
      repro::wm::mma16816(acc[2 * jp + 1], ml, bh[2], bh[3]);
    }
  }
  if (carry) {
    float acc2[8][4] = {};
    for (int kk = 0; kk < NP / 16; ++kk) {
      uint32_t af[4];
      repro::wm::ldsm_x4(af, cs + (warp * 16 + ((lane >> 3) & 1) * 8
                                   + (lane & 7)) * sn
                                 + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bh[4], bl[4];
        const int off = (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * sn
                        + kk * 16 + ((lane >> 3) & 1) * 8;
        repro::wm::ldsm_x4(bh, shi + off);
        repro::wm::ldsm_x4(bl, slo + off);
        repro::wm::mma16816(acc2[2 * jp], af, bh[0], bh[1]);
        repro::wm::mma16816(acc2[2 * jp], af, bl[0], bl[1]);
        repro::wm::mma16816(acc2[2 * jp + 1], af, bh[2], bh[3]);
        repro::wm::mma16816(acc2[2 * jp + 1], af, bl[2], bl[3]);
      }
    }
    const float e0 = expf(ld[row[0]]), e1 = expf(ld[row[1]]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] = fmaf(e0, acc2[j][0], acc[j][0]);
      acc[j][1] = fmaf(e0, acc2[j][1], acc[j][1]);
      acc[j][2] = fmaf(e1, acc2[j][2], acc[j][2]);
      acc[j][3] = fmaf(e1, acc2[j][3], acc[j][3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 8 * j + 2 * t;
      if (row[r] < tv && p < pw)
        *reinterpret_cast<__nv_bfloat162*>(
            y + (((size_t)bi * sh.S + t0 + row[r]) * sh.H + h) * sh.P + p0
            + p) = __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
    }
}

// Shared memory of the tc kernels, in bytes.
size_t cb_smem(int N) { return sizeof(bf16) * 2 * L * stride16(N); }
size_t state_smem(int P, int N) {
  return sizeof(bf16) * L * (2 * stride16(P) + stride16(N));
}
size_t y_smem(int N) {
  return sizeof(bf16) * (2 * L * stride16(YP) + (L + 2 * YP) * stride16(N));
}

// Scratch of the tc route, in floats: CB (B, nc, 64, 64), the chunk
// states (B, H, nc, P, N), the chunk decays (B, H, nc).
size_t tc_scratch(int B, int S, int H, int P, int N) {
  const size_t nc = (S + L - 1) / L;
  return (size_t)B * nc * L * L + (size_t)B * H * nc * P * N
         + (size_t)B * H * nc;
}

int launch_tc(const void* x, const float* dt, const float* a, const void* b,
              const void* c, void* y, float* state, float* scratch,
              const SsdShape& s, cudaStream_t stream) {
  static unsigned long long done[3] = {0, 0, 0};
  if (s.P % 8 || s.N % 8 || s.P > MAX_TC_WIDTH || s.N > MAX_TC_WIDTH)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ssd_cb, cb_smem(MAX_TC_WIDTH), done[0]);
  if (err == cudaSuccess)
    err = allow_smem(ssd_state, state_smem(MAX_TC_WIDTH, MAX_TC_WIDTH),
                     done[1]);
  if (err == cudaSuccess)
    err = allow_smem(ssd_y, y_smem(MAX_TC_WIDTH), done[2]);
  if (err != cudaSuccess) return (int)err;
  const TcShape sh{s.B, s.S, s.H, s.P, s.N, (s.S + L - 1) / L};
  float* cb = scratch;
  float* st = cb + (size_t)sh.B * sh.nc * L * L;
  float* decay = st + (size_t)sh.B * sh.H * sh.nc * sh.P * sh.N;
  const bf16 *xb = (const bf16*)x, *bb = (const bf16*)b, *cc = (const bf16*)c;
  ssd_cb<<<dim3(sh.nc, sh.B), TC_THREADS, cb_smem(sh.N), stream>>>(bb, cc, cb,
                                                                   sh);
  ssd_state<<<dim3(sh.H, sh.nc, sh.B), TC_THREADS, state_smem(sh.P, sh.N),
              stream>>>(xb, dt, a, bb, st, decay, sh);
  const int pn4 = sh.P * sh.N / 4;
  ssd_pass<<<dim3((pn4 + PASS_THREADS - 1) / PASS_THREADS, sh.H, sh.B),
             PASS_THREADS, 0, stream>>>(st, decay, state, sh);
  ssd_y<<<dim3(sh.H * ((sh.P + YP - 1) / YP), sh.nc, sh.B), TC_THREADS,
          y_smem(sh.N), stream>>>(xb, dt, a, cc, cb, st, (bf16*)y, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest state width N the kernels take.
extern "C" int ssd_scan_max_state() { return MAX_N; }
// The largest P and N of the tc route (both also multiples of 8).
extern "C" int ssd_scan_tc_width() { return MAX_TC_WIDTH; }
// f32 scratch the tc route needs for (B, S, H, P, N), in floats.
extern "C" long long ssd_scan_scratch(int B, int S, int H, int P, int N) {
  return (long long)tc_scratch(B, S, H, P, N);
}

// route: 0 = simt (f32 or bf16), 1 = tc (bf16 only).  dtype (of x, b, c
// and y): 0 = float32, 1 = bfloat16.  x (B, S, H, P), dt (B, S, H) f32,
// a (H,) f32, b/c (B, S, N), y like x, state (B, H, P, N) f32, all
// contiguous; S >= 1 and N <= ssd_scan_max_state(); tc also needs P and N
// multiples of 8 and at most ssd_scan_tc_width(), x, b and c 16-byte
// aligned, and scratch: ssd_scan_scratch(B, S, H, P, N) floats (the
// Python wrapper checks).  Returns cudaGetLastError() of the launches.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, void* y,
                               void* state, void* scratch, int route,
                               int dtype, int B, int S, int H, int P, int N,
                               void* stream) {
  SsdShape sh{B, S, H, P, N};
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_tc(x, (const float*)dt, (const float*)a, b, c, y,
                     (float*)state, (float*)scratch, sh, s);
  }
  if (dtype == 0)
    return launch_simt<float>(x, (const float*)dt, (const float*)a, b, c, y,
                              (float*)state, sh, s);
  return launch_simt<__nv_bfloat16>(x, (const float*)dt, (const float*)a, b,
                                    c, y, (float*)state, sh, s);
}
