// Backward of the Mamba-2 SSD chunked scan, for sm_90a.
//
// Replaces: the gradient the JAX training path takes of the SSD, XLA's
// autodiff of src/repro/kernels/jnp_blocked.py:261 (ssd_chunked_jnp, which
// ops.ssd runs with use_pallas=False, ops.py:190-196); the Pallas kernel
// src/repro/kernels/ssd_scan.py:97 has no backward.  Same function: from
// x (B, S, H, P), dt (B, S, H) f32, a (H,) f32, b/c (B, S, N), dy like x
// and d(final state) (B, H, P, N) f32 (null: zeros), the gradients dx, ddt
// (f32), da (f32), db and dc.  Per (b, h), in 64-row chunks, with
// LD = cumsum(dt a) inside the chunk, u = dt x, S_in the state entering the
// chunk and dS the gradient of the state leaving it:
//   dS_in  = exp(LD_last) dS + sum_t exp(LD_t) dy_t c_t^T
//   du_s   = sum_{t>=s} exp(LD_t - LD_s)(c_t . b_s) dy_t
//            + exp(LD_last - LD_s) dS b_s
//   dc_t  += sum_{s<=t} Q_ts b_s + exp(LD_t) S_in^T dy_t
//   db_s  += sum_{t>=s} Q_ts c_t + exp(LD_last - LD_s) dS^T u_s
// with Q_ts = exp(LD_t - LD_s)(dy_t . u_s) on t >= s (db and dc summed
// over the heads), dLD from the exponentials, then d(dt a) by the reverse
// cumsum of dLD, dx = du dt and ddt += sum_p du x.  exp(LD_t - LD_s) is
// taken only for s <= t (for s > t it may overflow, and inf * 0 is NaN);
// the ragged last chunk is masked here as in the forward (dt = 0, no input
// past S).
//
// What bounds it on the H100: bytes, barely.  At mamba2-780m's 2048 tokens
// (H 48, P 64, N 128, bf16) the function reads x, dy, dt, a, b, c and
// writes their gradients, 40.6 MB (0.0121 ms at 3.35 TB/s), and does
// ~9.7 GFLOP (0.0098 ms at the bf16 peak).  The kernels' own scratch (the
// chunk states, recomputed, and their gradients) moves ~0.3 GB more.
//
// Two routes, picked by the caller (the wrapper; blocked.ssd_bwd_route):
// tc for bf16 with P and N multiples of 8 up to 128 and x, b, c, dy
// 16-byte aligned (the tensor-core kernels of ssd_scan_bwd_tc.cuh, six
// launches; that file's comment), simt otherwise (f32, the parity path).
//
// simt (the first port's kernels, kept as they were; the bf16
// instantiation stays reachable through the C interface, route 0, for
// timing the parent): SIMT f32 for both dtypes (bf16 inputs are widened
// on load), five launches a call:
//   1. bwd_contrib, per (chunk, head, row): the chunk's own contribution
//      to the state, sum_s exp(LD_last - LD_s) u_s b_s^T, and to the state
//      gradient, sum_t exp(LD_t) dy_t c_t^T (P x N each), and its decay;
//   2. bwd_pass, per (state element, head, row): along the chunks, the
//      state entering each chunk (recomputed: the forward keeps none), and
//      in reverse the gradient of the state leaving each chunk, each
//      written over its contribution;
//   3. bwd_chunk, per (chunk, head, row): the chunk's tiles in shared
//      memory (x, dy, B, C, S_in, dS and three 64 x 64 tiles); dx, ddt and
//      this head's partials of db, dc and da;
//   4. bwd_reduce: db and dc, the partials summed over the heads in order;
//   5. bwd_da: da, summed over the rows and chunks in order.
// No float atomics: every sum runs in a fixed order, so two calls give
// bitwise-equal gradients.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;               // threads per block
constexpr int L = 64;                 // rows per chunk
constexpr int TS = L + 1;             // row stride of the 64 x 64 tiles
constexpr int MAX_P = 128;            // widest head bwd_chunk takes
constexpr int SMEM_LIMIT = 232448;    // dynamic shared memory of a block
constexpr int REGS = L * MAX_P / NT;  // (s, p) elements of du per thread
constexpr int BATCH = 8;              // chunks' loads ahead of the pass
static_assert(L * 4 == NT, "y2's partials: four threads a row");
static_assert(L == 64, "the LD scan gives each lane two rows");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Shape {
  int B, S, H, P, N, nc;
};

template <typename K>
cudaError_t allow_smem(K kernel, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1ull)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

// dt of one (row, chunk, head), 0 past S, and LD = cumsum(dt * a): warp 0
// scans, two rows a lane.
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

// Shared memory of the kernels, in floats.
__host__ __device__ inline size_t contrib_floats(int P, int N) {
  return 2 * (size_t)L * P + 2 * (size_t)L * N + 2 * L;
}
__host__ __device__ inline size_t chunk_floats(int P, int N) {
  return 2 * (size_t)L * (P + 1) + 2 * (size_t)L * (N + 1)
         + 2 * (size_t)P * (N + 1) + 3 * L * TS + 8 * L + 2 * NT;
}

// 1. One (chunk, head, row): the chunk's contribution to the state and to
// the state gradient, and its decay exp(LD_last).
template <typename T>
__global__ void __launch_bounds__(NT)
bwd_contrib(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ a, const T* __restrict__ b,
            const T* __restrict__ c, const T* __restrict__ dy,
            float* __restrict__ st, float* __restrict__ dst,
            float* __restrict__ decay, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const int P = sh.P, N = sh.N;
  float* xw = smem;              // (L, P): exp(LD_last - LD_s) dt_s x_s
  float* dyw = xw + L * P;       // (L, P): exp(LD_t) dy_t
  float* bs = dyw + L * P;       // (L, N)
  float* cs = bs + L * N;        // (L, N)
  float* ld = cs + L * N;        // (L)
  float* dts = ld + L;           // (L)
  const int ch = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = ch * L, tv = min(L, sh.S - t0);
  const size_t row0 = (size_t)bi * sh.S + t0;
  chunk_ld(dt, a[h], row0 * sh.H + h, sh.H, tv, dts, ld);
  __syncthreads();
  const float ld_last = ld[L - 1];
  for (int i = tid; i < L * P; i += NT) {
    const int r = i / P, p = i - r * P;
    float xv = 0.f, dv = 0.f;
    if (r < tv) {
      const size_t g = ((row0 + r) * sh.H + h) * P + p;
      xv = to_f(x[g]);
      dv = to_f(dy[g]);
    }
    xw[i] = expf(ld_last - ld[r]) * dts[r] * xv;
    dyw[i] = expf(ld[r]) * dv;
  }
  for (int i = tid; i < L * N; i += NT) {
    const int r = i / N, n = i - r * N;
    float bv = 0.f, cv = 0.f;
    if (r < tv) {
      const size_t g = (row0 + r) * N + n;
      bv = to_f(b[g]);
      cv = to_f(c[g]);
    }
    bs[i] = bv;
    cs[i] = cv;
  }
  __syncthreads();
  const size_t off = (((size_t)bi * sh.H + h) * sh.nc + ch) * P * N;
  for (int i = tid; i < P * N; i += NT) {
    const int p = i / N, n = i - p * N;
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < L; ++r) {
      s1 = fmaf(xw[r * P + p], bs[r * N + n], s1);
      s2 = fmaf(dyw[r * P + p], cs[r * N + n], s2);
    }
    st[off + i] = s1;
    dst[off + i] = s2;
  }
  if (tid == 0) decay[((size_t)bi * sh.H + h) * sh.nc + ch] = expf(ld_last);
}

// 2. One state element of one (head, row) along the chunks: the state
// entering each chunk over its contribution (forward), then the gradient
// of the state leaving each chunk over its contribution (reverse; the last
// chunk's is d(final state)).
__global__ void __launch_bounds__(NT)
bwd_pass(float* __restrict__ st, float* __restrict__ dst,
         const float* __restrict__ decay, const float* __restrict__ dstate,
         Shape sh) {
  const int h = blockIdx.y, bi = blockIdx.z;
  const size_t PN = (size_t)sh.P * sh.N;
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  if (e >= PN) return;
  const size_t bh = (size_t)bi * sh.H + h;
  float* s = st + bh * sh.nc * PN + e;
  float* d = dst + bh * sh.nc * PN + e;
  const float* dec = decay + bh * sh.nc;
  // BATCH chunks' loads ahead of each stretch of the chain
  float run = 0.f;
  for (int c0 = 0; c0 < sh.nc; c0 += BATCH) {
    float v[BATCH], dc[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const bool in = c0 + k < sh.nc;
      v[k] = in ? s[(c0 + k) * PN] : 0.f;
      dc[k] = in ? dec[c0 + k] : 1.f;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (c0 + k >= sh.nc) break;
      s[(c0 + k) * PN] = run;
      run = fmaf(dc[k], run, v[k]);
    }
  }
  float grad = dstate ? dstate[bh * PN + e] : 0.f;
  for (int c1 = sh.nc - 1; c1 >= 0; c1 -= BATCH) {
    float v[BATCH], dc[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const bool in = c1 - k >= 0;
      v[k] = in ? d[(c1 - k) * PN] : 0.f;
      dc[k] = in ? dec[c1 - k] : 1.f;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (c1 - k < 0) break;
      d[(c1 - k) * PN] = grad;
      grad = fmaf(dc[k], grad, v[k]);
    }
  }
}

// 3. One (chunk, head, row): dx and ddt of its rows, this head's partials
// of db and dc (L x N each) and of da.  The thread (ty, tx) of the 16 x 16
// grid owns rows ty*4.. and columns tx*4.. of the 64 x 64 tiles.
template <typename T>
__global__ void __launch_bounds__(NT)
bwd_chunk(const T* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ a, const T* __restrict__ b,
          const T* __restrict__ c, const T* __restrict__ dy,
          const float* __restrict__ st, const float* __restrict__ dst,
          T* __restrict__ dx, float* __restrict__ ddt,
          float* __restrict__ dbp, float* __restrict__ dcp,
          float* __restrict__ dap, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const int P = sh.P, N = sh.N, XS = P + 1, NS = N + 1;
  float* xs = smem;              // (L, XS): x
  float* dys = xs + L * XS;      // (L, XS): dy, then du . x
  float* bs = dys + L * XS;      // (L, NS)
  float* cs = bs + L * NS;       // (L, NS)
  float* s_in = cs + L * NS;     // (P, NS): the state entering the chunk
  float* d_out = s_in + P * NS;  // (P, NS): d(the state leaving it)
  float* cb = d_out + P * NS;    // (L, TS): C_t . B_s; then x . v2 (L, XS)
  float* w = cb + L * TS;        // (L, TS): exp(LD_t - LD_s) CB_ts, t >= s
  float* q = w + L * TS;         // (L, TS): exp(LD_t - LD_s) dy_t . u_s
  float* ld = q + L * TS;
  float* dts = ld + L;
  float* wl = dts + L;           // exp(LD_last - LD_s)
  float* el = wl + L;            // exp(LD_t)
  float* dla = el + L;           // dLD's sums over rows of Q . CB, then dLD
  float* dlb = dla + L;          // ... and over its columns
  float* kk = dlb + L;           // exp(LD_last - LD_s) u_s . dS b_s
  float* dd1 = kk + L;           // sum_p du_s x_s
  float* red = dd1 + L;          // (NT): y2's partials
  float* red2 = red + NT;        // (NT): <dS, S_in>'s partials
  const int ch = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = ch * L, tv = min(L, sh.S - t0);
  const size_t row0 = (size_t)bi * sh.S + t0;
  const float ah = a[h];

  chunk_ld(dt, ah, row0 * sh.H + h, sh.H, tv, dts, ld);
  for (int i = tid; i < L * P; i += NT) {
    const int r = i / P, p = i - r * P;
    float xv = 0.f, dv = 0.f;
    if (r < tv) {
      const size_t g = ((row0 + r) * sh.H + h) * P + p;
      xv = to_f(x[g]);
      dv = to_f(dy[g]);
    }
    xs[r * XS + p] = xv;
    dys[r * XS + p] = dv;
  }
  for (int i = tid; i < L * N; i += NT) {
    const int r = i / N, n = i - r * N;
    float bv = 0.f, cv = 0.f;
    if (r < tv) {
      const size_t g = (row0 + r) * N + n;
      bv = to_f(b[g]);
      cv = to_f(c[g]);
    }
    bs[r * NS + n] = bv;
    cs[r * NS + n] = cv;
  }
  const size_t off = (((size_t)bi * sh.H + h) * sh.nc + ch) * P * N;
  for (int i = tid; i < P * N; i += NT) {
    const int p = i / N, n = i - p * N;
    s_in[p * NS + n] = st[off + i];
    d_out[p * NS + n] = dst[off + i];
  }
  __syncthreads();
  if (tid < L) {
    wl[tid] = expf(ld[L - 1] - ld[tid]);
    el[tid] = expf(ld[tid]);
  }

  // The 64 x 64 tiles: CB, W = E . CB and Q = E . (dy_t . u_s), with
  // E = exp(LD_t - LD_s) on t >= s and 0 above the diagonal.
  {
    float acb[4][4], adu[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acb[i][j] = adu[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cr[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cr[i] = cs[(ty * 4 + i) * NS + n];
        br[i] = bs[(tx * 4 + i) * NS + n];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acb[i][j] = fmaf(cr[i], br[j], acb[i][j]);
    }
    for (int p = 0; p < P; ++p) {
      float dr[4], xr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dr[i] = dys[(ty * 4 + i) * XS + p];
        xr[i] = xs[(tx * 4 + i) * XS + p];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) adu[i][j] = fmaf(dr[i], xr[j], adu[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty * 4 + i, s = tx * 4 + j;
        const float e = s <= t ? expf(ld[t] - ld[s]) : 0.f;
        cb[t * TS + s] = acb[i][j];
        w[t * TS + s] = e * acb[i][j];
        q[t * TS + s] = e * dts[s] * adu[i][j];
      }
  }
  __syncthreads();

  // dLD's terms from y's intra-chunk part: + rows, - columns of Q . CB.
  if (tid < L) {
    float acc = 0.f;
    for (int s = 0; s <= tid; ++s)
      acc = fmaf(q[tid * TS + s], cb[tid * TS + s], acc);
    dla[tid] = acc;
  } else if (tid < 2 * L) {
    const int s = tid - L;
    float acc = 0.f;
    for (int t = s; t < L; ++t) acc = fmaf(q[t * TS + s], cb[t * TS + s], acc);
    dlb[s] = acc;
  }

  // du_s = sum_{t>=s} W_ts dy_t + exp(LD_last - LD_s) v2_s, v2_s = dS b_s;
  // dx = du dt.  du . x and x . v2 stay in registers for the row sums.
  float px1[REGS], px2[REGS];
#pragma unroll
  for (int r = 0; r < REGS; ++r) {
    const int i = tid + r * NT;
    px1[r] = px2[r] = 0.f;
    if (i < L * P) {
      const int s = i / P, p = i - s * P;
      float du = 0.f, v2 = 0.f;
      for (int t = s; t < L; ++t) du = fmaf(w[t * TS + s], dys[t * XS + p], du);
      for (int n = 0; n < N; ++n)
        v2 = fmaf(d_out[p * NS + n], bs[s * NS + n], v2);
      du = fmaf(wl[s], v2, du);
      const float xv = xs[s * XS + p];
      px1[r] = du * xv;
      px2[r] = xv * v2;
      if (s < tv) dx[((row0 + s) * sh.H + h) * P + p] = from_f<T>(du * dts[s]);
    }
  }

  // This head's dc_t = sum_{s<=t} Q_ts b_s + exp(LD_t) S_in^T dy_t and
  // db_s = sum_{t>=s} Q_ts c_t + exp(LD_last - LD_s) dt_s dS^T x_s.
  const size_t part = (((size_t)bi * sh.nc + ch) * sh.H + h) * L * N;
  for (int i = tid; i < L * N; i += NT) {
    const int t = i / N, n = i - t * N;
    float acc = 0.f, z = 0.f;
    for (int s = 0; s <= t; ++s) acc = fmaf(q[t * TS + s], bs[s * NS + n], acc);
    for (int p = 0; p < P; ++p) z = fmaf(s_in[p * NS + n], dys[t * XS + p], z);
    dcp[part + i] = fmaf(el[t], z, acc);
  }
  for (int i = tid; i < L * N; i += NT) {
    const int s = i / N, n = i - s * N;
    float acc = 0.f, z = 0.f;
    for (int t = s; t < L; ++t) acc = fmaf(q[t * TS + s], cs[t * NS + n], acc);
    for (int p = 0; p < P; ++p) z = fmaf(d_out[p * NS + n], xs[s * XS + p], z);
    dbp[part + i] = fmaf(wl[s] * dts[s], z, acc);
  }

  // y2_t = dy_t . (S_in c_t), four threads a row; <dS, S_in>.
  {
    const int t = tid >> 2, quarter = tid & 3;
    float acc = 0.f;
    for (int p = quarter; p < P; p += 4) {
      float sc = 0.f;
      for (int n = 0; n < N; ++n) sc = fmaf(s_in[p * NS + n], cs[t * NS + n], sc);
      acc = fmaf(dys[t * XS + p], sc, acc);
    }
    red[tid] = acc;
    float inner = 0.f;
    for (int i = tid; i < P * N; i += NT) {
      const int p = i / N, n = i - p * N;
      inner = fmaf(d_out[p * NS + n], s_in[p * NS + n], inner);
    }
    red2[tid] = inner;
  }
  __syncthreads();

  // The freed tiles take du . x (over dy) and x . v2 (over CB, W, Q).
#pragma unroll
  for (int r = 0; r < REGS; ++r) {
    const int i = tid + r * NT;
    if (i < L * P) {
      const int s = i / P, p = i - s * P;
      dys[s * XS + p] = px1[r];
      cb[s * XS + p] = px2[r];
    }
  }
  __syncthreads();
  if (tid < L) {
    const int t = tid;
    float s1 = 0.f, s2 = 0.f;
    for (int p = 0; p < P; ++p) {
      s1 += dys[t * XS + p];
      s2 += cb[t * XS + p];
    }
    dd1[t] = s1;
    kk[t] = wl[t] * dts[t] * s2;
    const float y2 =
        el[t] * (((red[4 * t] + red[4 * t + 1]) + red[4 * t + 2]) + red[4 * t + 3]);
    dla[t] = dla[t] - dlb[t] + y2 - kk[t];
  }
  __syncthreads();
  // The last row's dLD takes the state terms; then the reverse cumsum of
  // dLD gives d(dt a): ddt += a g, da += dt g.
  if (tid == 0) {
    float inner = 0.f, ksum = 0.f;
    for (int i = 0; i < NT; ++i) inner += red2[i];
    for (int t = 0; t < L; ++t) ksum += kk[t];
    dla[L - 1] += el[L - 1] * inner + ksum;
    float g = 0.f, dsum = 0.f;
    for (int t = L - 1; t >= 0; --t) {
      g += dla[t];
      dsum = fmaf(dts[t], g, dsum);
      if (t < tv) ddt[(row0 + t) * sh.H + h] = fmaf(ah, g, dd1[t]);
    }
    dap[((size_t)bi * sh.nc + ch) * sh.H + h] = dsum;
  }
}

// 4. db and dc: each element's partials summed over the heads in order.
template <typename T>
__global__ void __launch_bounds__(NT)
bwd_reduce(const float* __restrict__ dbp, const float* __restrict__ dcp,
           T* __restrict__ db, T* __restrict__ dc, Shape sh) {
  const size_t total = (size_t)sh.B * sh.S * sh.N;
  const size_t head = (size_t)L * sh.N;
  for (size_t i = blockIdx.x * (size_t)NT + threadIdx.x; i < total;
       i += (size_t)gridDim.x * NT) {
    const int n = (int)(i % sh.N);
    const size_t row = i / sh.N;
    const int t = (int)(row % sh.S), bi = (int)(row / sh.S);
    const int ch = t / L, tl = t - ch * L;
    const size_t base = ((size_t)bi * sh.nc + ch) * sh.H * head
                        + (size_t)tl * sh.N + n;
    float s1 = 0.f, s2 = 0.f;
    for (int h = 0; h < sh.H; ++h) {
      s1 += dbp[base + h * head];
      s2 += dcp[base + h * head];
    }
    db[i] = from_f<T>(s1);
    dc[i] = from_f<T>(s2);
  }
}

// 5. da: each head's partials summed over the rows and chunks in order.
__global__ void __launch_bounds__(NT)
bwd_da(const float* __restrict__ dap, float* __restrict__ da, Shape sh) {
  const int h = blockIdx.x * NT + threadIdx.x;
  if (h >= sh.H) return;
  float s = 0.f;
  for (int k = 0; k < sh.B * sh.nc; ++k) s += dap[(size_t)k * sh.H + h];
  da[h] = s;
}

}  // namespace

#include "ssd_scan_bwd_tc.cuh"   // the tc route (bf16): bwd_cb .. launch_tc

namespace {

bool takes(int P, int N) {
  return P >= 1 && N >= 1 && P <= MAX_P &&
         sizeof(float) * chunk_floats(P, N) <= (size_t)SMEM_LIMIT &&
         sizeof(float) * contrib_floats(P, N) <= (size_t)SMEM_LIMIT;
}

// f32 scratch in floats: the chunk states and their gradients, the
// decays, the per-head partials of db and dc, da's partials, and (the tc
// route) CB.
size_t scratch_floats(int B, int S, int H, int P, int N) {
  const size_t nc = (S + L - 1) / L;
  return 2 * (size_t)B * H * nc * P * N + (size_t)B * H * nc
         + 2 * (size_t)B * nc * H * L * N + (size_t)B * nc * H
         + tc_cb_floats(B, S);
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* b,
           const void* c, const void* dy, const float* dstate, void* dx,
           float* ddt, float* da, void* db, void* dc, float* scratch,
           const Shape& sh, cudaStream_t stream) {
  static unsigned long long done[2] = {0, 0};
  cudaError_t err = allow_smem(bwd_contrib<T>, done[0]);
  if (err == cudaSuccess) err = allow_smem(bwd_chunk<T>, done[1]);
  if (err != cudaSuccess) return (int)err;
  const size_t states = (size_t)sh.B * sh.H * sh.nc * sh.P * sh.N;
  float* st = scratch;
  float* dst = st + states;
  float* decay = dst + states;
  float* dbp = decay + (size_t)sh.B * sh.H * sh.nc;
  float* dcp = dbp + (size_t)sh.B * sh.nc * sh.H * L * sh.N;
  float* dap = dcp + (size_t)sh.B * sh.nc * sh.H * L * sh.N;
  const T *xt = (const T*)x, *bt = (const T*)b, *ct = (const T*)c,
          *dyt = (const T*)dy;
  const dim3 chunks(sh.nc, sh.H, sh.B);
  bwd_contrib<T><<<chunks, NT, sizeof(float) * contrib_floats(sh.P, sh.N),
                   stream>>>(xt, dt, a, bt, ct, dyt, st, dst, decay, sh);
  const int pn = sh.P * sh.N;
  bwd_pass<<<dim3((pn + NT - 1) / NT, sh.H, sh.B), NT, 0, stream>>>(
      st, dst, decay, dstate, sh);
  bwd_chunk<T><<<chunks, NT, sizeof(float) * chunk_floats(sh.P, sh.N),
                 stream>>>(xt, dt, a, bt, ct, dyt, st, dst, (T*)dx, ddt, dbp,
                           dcp, dap, sh);
  const size_t total = (size_t)sh.B * sh.S * sh.N;
  const size_t blocks = (total + NT - 1) / NT;
  bwd_reduce<T><<<(int)(blocks < 4096 ? blocks : 4096), NT, 0, stream>>>(
      dbp, dcp, (T*)db, (T*)dc, sh);
  bwd_da<<<(sh.H + NT - 1) / NT, NT, 0, stream>>>(dap, da, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// Whether the simt route takes head width P and state width N.
extern "C" int ssd_scan_bwd_takes(int P, int N) { return takes(P, N); }
// The route rule for 16-byte aligned tensors (1 = tc, 0 = simt): tc for
// bf16 with P and N multiples of 8 up to 128; blocked.ssd_bwd_route
// mirrors it.
extern "C" int ssd_scan_bwd_route(int dtype, int P, int N) {
  return dtype == 1 && tc_takes(P, N);
}
// f32 scratch the kernel needs for (B, S, H, P, N), in floats.
extern "C" long long ssd_scan_bwd_scratch(int B, int S, int H, int P, int N) {
  return (long long)scratch_floats(B, S, H, P, N);
}

// route: 0 = simt (either dtype), 1 = tc (bf16, where ssd_scan_bwd_route
// gives 1; x, b, c and dy 16-byte aligned: the call fails with
// cudaErrorInvalidValue otherwise).  dtype (of x, b, c, dy and dx, db,
// dc): 0 = float32, 1 = bfloat16.  x
// (B, S, H, P), dt (B, S, H) f32, a (H,) f32, b/c (B, S, N), dy like x,
// dstate (B, H, P, N) f32 or null (zeros); outputs dx like x, ddt like dt,
// da like a, db/dc like b; scratch: ssd_scan_bwd_scratch(...) floats.  All
// contiguous, S >= 1, ssd_scan_bwd_takes(P, N) (the Python wrapper
// checks).  Returns cudaGetLastError() of the launches.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt,
                                   const void* a, const void* b,
                                   const void* c, const void* dy,
                                   const void* dstate, void* dx, void* ddt,
                                   void* da, void* db, void* dc,
                                   void* scratch, int route, int dtype,
                                   int B, int S, int H, int P, int N,
                                   void* stream) {
  const Shape sh{B, S, H, P, N, (S + L - 1) / L};
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    const bool aligned = !(((uintptr_t)x | (uintptr_t)b | (uintptr_t)c |
                            (uintptr_t)dy) & 15);
    if (dtype != 1 || !tc_takes(P, N) || !aligned || S < 1)
      return (int)cudaErrorInvalidValue;
    return launch_tc(x, (const float*)dt, (const float*)a, b, c, dy,
                     (const float*)dstate, dx, (float*)ddt, (float*)da, db,
                     dc, (float*)scratch, sh, s);
  }
  if (!takes(P, N) || S < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, (const float*)dt, (const float*)a, b, c, dy,
                         (const float*)dstate, dx, (float*)ddt, (float*)da,
                         db, dc, (float*)scratch, sh, s);
  return launch<__nv_bfloat16>(x, (const float*)dt, (const float*)a, b, c, dy,
                               (const float*)dstate, dx, (float*)ddt,
                               (float*)da, db, dc, (float*)scratch, sh, s);
}
