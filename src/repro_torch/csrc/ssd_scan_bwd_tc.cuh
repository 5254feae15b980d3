// The SSD backward's tc route (bf16), for sm_90a: included by
// ssd_scan_bwd.cu after its SIMT kernels, whose chunk_ld, Shape, L, NT,
// BATCH, bwd_reduce and bwd_da it shares.  Same function and the same
// chunk algebra as the SIMT route (that file's comment); what differs is
// where the products run.
//
// What bounds it on the H100: the function's bytes (40.6 MB at mamba2's
// 2048 tokens, 0.0121 ms) and ~9.7 GFLOP of products (0.0098 ms at the
// bf16 peak); what the kernels move besides is the chunk states and their
// gradients (f32, recomputed: ~100 MB written, read back by the pass and
// by the chunk kernel) and db/dc's per-head partials (~100 MB), ~0.1 ms
// at 3.35 TB/s.  The SIMT parent ran every product on f32 FMAs with
// 219 KB of padded f32 tiles a block (one 256-thread block an SM, ~5
// TFLOP/s).  Here:
//   * every chunk product runs on the tensor cores (mma.sync m16n8k16,
//     f32 accumulators; warp_mma.cuh): b, c, x and dy enter as the bf16
//     they are, every f32 operand (the decays times dt x or dy, the chunk
//     states and their gradients, Q and the decayed C B^T) as its bf16
//     hi + lo pair, so the products keep ~16 bits of each and the one-ulp
//     bf16 limit holds (as the forward's tc route and the attention
//     kernels do);
//   * tiles stay in shared memory as bf16 (hi/lo where split), loaded
//     by cp.async ahead of the products: 106 KB a block at mamba2's widths,
//     two 128-thread blocks an SM;
//   * C B^T is computed once per (chunk, batch row) for all heads
//     (bwd_cb, the forward's ssd_cb) and read from L2 by every head;
//   * the pass walks four state elements a thread (float4).
// Six launches:
//   1. bwd_cb        per (chunk, row): CB = C B^T, f32 (64 x 64);
//   2. bwd_contrib_tc per (head, chunk, row): the chunk's own contribution
//      to the state, (wl dt x)^T B, and to its gradient, (el dy)^T C
//      (P x N each, f32), and its decay exp(LD_last);
//   3. bwd_pass_tc   per (4 state elements, head, row, direction): the
//      state entering each chunk forward, the gradient of the state
//      leaving it in reverse, the two chains in parallel;
//   4. bwd_chunk_tc  per (chunk, head, row), four warps of 16 rows:
//        Q  = E . dt_s . (dY X^T)                 (dY, X exact; Q kept hi/lo)
//        du = (E . CB)^T dY + wl . (B dS_out^T)   -> dx, sum_p du x, k
//        db = Q^T C + wl dt . (X dS_out)          (this head's partial)
//        dc = Q B + el . (dY S_in)                (this head's partial; y2)
//      with dLD's terms, ddt and this head's part of da (E = exp(LD_t - LD_s)
//      on t >= s, wl = exp(LD_last - LD_s), el = exp(LD_t));
//   5. bwd_reduce    db and dc summed over the heads in order (shared);
//   6. bwd_da        da summed over the rows and chunks in order (shared).
// No float atomics: every sum runs in a fixed order (the warps' column
// sums of dLD are combined in warp order), so two calls give bitwise-equal
// gradients.
#pragma once

#include "warp_mma.cuh"

namespace {

using repro::wm::bf16;
namespace wm = repro::wm;

constexpr int TC_NT = 128;         // four warps, 16 rows of a 64-row tile each
constexpr int TC_MAX = 128;        // widest P and N of the tc route
constexpr int TC_PASS_NT = 256;
constexpr int TC_BATCH = 8;        // f32 state loads in flight a thread
constexpr int LOAD_BATCH = 4;      // 16-byte bf16 loads in flight a thread
constexpr int QS = 72;             // row stride (bf16) of the 64 x 64 Q tiles

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }
// Row stride (bf16) of a tile whose rows are n wide: 16 bytes of padding
// put ldmatrix's eight row addresses in distinct banks.
__host__ __device__ constexpr int stride16(int n) { return pad16(n) + 8; }

// Rows [r0, r0 + 64) of a (rows, cols) bf16 matrix with row stride `ld`
// into a (64, pad16(cols)) tile: 16-byte cp.async copies, rows past
// `rows` and columns past `cols` (a multiple of 8) zero-filled.
__device__ __forceinline__ void tc_load_rows(bf16* dst, const bf16* src,
                                             size_t ld, int r0, int rows,
                                             int cols) {
  const int chunks = pad16(cols) / 8, sd = stride16(cols);
  for (int i = threadIdx.x; i < L * chunks; i += TC_NT) {
    const int r = i / chunks, c = i - r * chunks;
    const bool in = r0 + r < rows && c * 8 < cols;
    wm::cp_async16(dst + r * sd + c * 8,
                   in ? src + (size_t)(r0 + r) * ld + c * 8 : src,
                   in ? 16 : 0);
  }
}

// Rows [0, 64) of x[first + r * row_stride + p] (p < cols, a multiple of
// 8), each scaled by wr[r], into the bf16 hi and lo tiles (64, pad16(cols))
// of row stride `sd`; zero past `rows` and past cols.
__device__ __forceinline__ void tc_scaled_split(const bf16* __restrict__ x,
                                                size_t first,
                                                size_t row_stride, int rows,
                                                int cols, const float* wr,
                                                bf16* hi, bf16* lo, int sd) {
  const int pc = pad16(cols) / 8, total = L * pc;
  for (int i0 = threadIdx.x; i0 < total; i0 += LOAD_BATCH * TC_NT) {
    uint4 raw[LOAD_BATCH];
#pragma unroll
    for (int j = 0; j < LOAD_BATCH; ++j) {
      const int i = i0 + j * TC_NT, r = i / pc, p = (i - r * pc) * 8;
      raw[j] = make_uint4(0, 0, 0, 0);
      if (i < total && r < rows && p < cols)
        raw[j] = *reinterpret_cast<const uint4*>(x + first + r * row_stride
                                                 + p);
    }
#pragma unroll
    for (int j = 0; j < LOAD_BATCH; ++j) {
      const int i = i0 + j * TC_NT, r = i / pc, p = (i - r * pc) * 8;
      if (i >= total) break;
      const bf16* e = reinterpret_cast<const bf16*>(&raw[j]);
      uint32_t h[4], l[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wm::split2(wr[r] * __bfloat162float(e[2 * k]),
                   wr[r] * __bfloat162float(e[2 * k + 1]), h[k], l[k]);
      *reinterpret_cast<uint4*>(hi + r * sd + p) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + r * sd + p) =
          make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// A (P, N) f32 state as bf16 hi and lo tiles (pad16(P) rows of stride sd,
// zero past P and N), TC_BATCH float4 loads in flight a thread.  With
// `other` (a second (P, N) f32 matrix), returns this thread's share of
// sum(src * other) in a fixed order.
__device__ __forceinline__ float tc_split_state(const float* __restrict__ src,
                                                const float* __restrict__ other,
                                                int P, int N, bf16* hi,
                                                bf16* lo, int sd) {
  const int n4 = pad16(N) / 4, total = pad16(P) * n4;
  float dot = 0.f;
  for (int i0 = threadIdx.x; i0 < total; i0 += TC_BATCH * TC_NT) {
    float4 v[TC_BATCH], o[TC_BATCH];
#pragma unroll
    for (int j = 0; j < TC_BATCH; ++j) {
      const int i = i0 + j * TC_NT, r = i / n4, n = (i - r * n4) * 4;
      v[j] = o[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total && r < P && n < N) {
        v[j] = *reinterpret_cast<const float4*>(src + (size_t)r * N + n);
        if (other)
          o[j] = *reinterpret_cast<const float4*>(other + (size_t)r * N + n);
      }
    }
#pragma unroll
    for (int j = 0; j < TC_BATCH; ++j) {
      const int i = i0 + j * TC_NT, r = i / n4, n = (i - r * n4) * 4;
      if (i >= total) break;
      uint32_t h[2], l[2];
      wm::split2(v[j].x, v[j].y, h[0], l[0]);
      wm::split2(v[j].z, v[j].w, h[1], l[1]);
      *reinterpret_cast<uint2*>(hi + r * sd + n) = make_uint2(h[0], h[1]);
      *reinterpret_cast<uint2*>(lo + r * sd + n) = make_uint2(l[0], l[1]);
      dot = fmaf(v[j].x, o[j].x, dot);
      dot = fmaf(v[j].y, o[j].y, dot);
      dot = fmaf(v[j].z, o[j].z, dot);
      dot = fmaf(v[j].w, o[j].w, dot);
    }
  }
  return dot;
}

// ldmatrix addresses of the fragments (warp_mma.cuh) from padded tiles
// of row stride sd, for the 16 x 16 A block at (m0, k0) and the 16 x 16
// B block at (k0, n0):
//   A from a row-major (m, k) tile, ldsm_x4;
__device__ __forceinline__ const bf16* a_rows(const bf16* t, int sd, int m0,
                                              int k0) {
  const int lane = threadIdx.x & 31;
  return t + (m0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * sd + k0
         + (lane >> 4) * 8;
}
//   A from a (k, m) tile (A = its transpose), ldsm_x4_trans;
__device__ __forceinline__ const bf16* a_cols(const bf16* t, int sd, int m0,
                                              int k0) {
  const int lane = threadIdx.x & 31;
  return t + (k0 + (lane >> 4) * 8 + (lane & 7)) * sd + m0
         + ((lane >> 3) & 1) * 8;
}
//   B from an (n, k) tile, ldsm_x4: regs 0-1 the n tile n0, 2-3 n0 + 8;
__device__ __forceinline__ const bf16* b_rows(const bf16* t, int sd, int k0,
                                              int n0) {
  const int lane = threadIdx.x & 31;
  return t + (n0 + (lane >> 4) * 8 + (lane & 7)) * sd + k0
         + ((lane >> 3) & 1) * 8;
}
//   B from a (k, n) tile, ldsm_x4_trans: the same two n tiles.
__device__ __forceinline__ const bf16* b_cols(const bf16* t, int sd, int k0,
                                              int n0) {
  const int lane = threadIdx.x & 31;
  return t + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * sd + n0
         + (lane >> 4) * 8;
}

// acc[2 jp .. 2 jp + 1] += A (B_hi + B_lo) for jp < npairs.
__device__ __forceinline__ void mma_split_b(float (&acc)[8][4],
                                            const uint32_t (&af)[4],
                                            const uint32_t (&bh)[4],
                                            const uint32_t (&bl)[4], int jp) {
  wm::mma16816(acc[2 * jp], af, bh[0], bh[1]);
  wm::mma16816(acc[2 * jp], af, bl[0], bl[1]);
  wm::mma16816(acc[2 * jp + 1], af, bh[2], bh[3]);
  wm::mma16816(acc[2 * jp + 1], af, bl[2], bl[3]);
}
// acc[2 jp .. 2 jp + 1] += (A_hi + A_lo) B.
__device__ __forceinline__ void mma_split_a(float (&acc)[8][4],
                                            const uint32_t (&ah)[4],
                                            const uint32_t (&al)[4],
                                            const uint32_t (&bf)[4], int jp) {
  wm::mma16816(acc[2 * jp], ah, bf[0], bf[1]);
  wm::mma16816(acc[2 * jp], al, bf[0], bf[1]);
  wm::mma16816(acc[2 * jp + 1], ah, bf[2], bf[3]);
  wm::mma16816(acc[2 * jp + 1], al, bf[2], bf[3]);
}

// 1. CB = C B^T of one (chunk, row), f32 (64, 64) row-major.
__global__ void __launch_bounds__(TC_NT)
bwd_cb(const bf16* __restrict__ b, const bf16* __restrict__ c,
       float* __restrict__ cb, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sd = stride16(sh.N);
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);   // (64, sd)
  bf16* bs = cs + L * sd;                         // (64, sd)
  const int ch = blockIdx.x, bi = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t first = (size_t)bi * sh.S * sh.N;
  tc_load_rows(cs, c + first, sh.N, ch * L, sh.S, sh.N);
  tc_load_rows(bs, b + first, sh.N, ch * L, sh.S, sh.N);
  wm::cp_async_commit();
  wm::cp_async_wait<0>();
  __syncthreads();
  float acc[8][4] = {};
  for (int kk = 0; kk < pad16(sh.N) / 16; ++kk) {
    uint32_t af[4];
    wm::ldsm_x4(af, a_rows(cs, sd, warp * 16, kk * 16));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t bf[4];
      wm::ldsm_x4(bf, b_rows(bs, sd, kk * 16, jp * 16));
      wm::mma16816(acc[2 * jp], af, bf[0], bf[1]);
      wm::mma16816(acc[2 * jp + 1], af, bf[2], bf[3]);
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

// 2. One (head, chunk, row): the chunk's contribution to the state,
// sum_s (wl_s dt_s x_s) b_s^T, and to the state gradient, sum_t (el_t dy_t)
// c_t^T, (P, N) f32 each, and its decay exp(LD_last).  The scaled x and
// dy enter as hi + lo (A, transposed from their (s, p) tiles), b and c as
// they are; a warp owns 16 rows of P by 64 columns of N at a time.
__global__ void __launch_bounds__(TC_NT)
bwd_contrib_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const bf16* __restrict__ b,
               const bf16* __restrict__ c, const bf16* __restrict__ dy,
               float* __restrict__ st, float* __restrict__ dst,
               float* __restrict__ decay, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = stride16(sh.P), sn = stride16(sh.N);
  const int PP = pad16(sh.P), NP = pad16(sh.N);
  bf16* xh = reinterpret_cast<bf16*>(smem_raw);   // (64, sp): wl dt x, hi
  bf16* xl = xh + L * sp;                         // lo
  bf16* yh = xl + L * sp;                         // (64, sp): el dy, hi
  bf16* yl = yh + L * sp;                         // lo
  bf16* bs = yl + L * sp;                         // (64, sn)
  bf16* cs = bs + L * sn;                         // (64, sn)
  __shared__ float ld[L], dts[L], w1[L], w2[L];
  const int h = blockIdx.x, ch = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = ch * L, tv = min(L, sh.S - t0);
  const size_t first = (size_t)bi * sh.S * sh.N;
  tc_load_rows(bs, b + first, sh.N, t0, sh.S, sh.N);
  tc_load_rows(cs, c + first, sh.N, t0, sh.S, sh.N);
  wm::cp_async_commit();
  chunk_ld(dt, a[h], ((size_t)bi * sh.S + t0) * sh.H + h, sh.H, tv, dts, ld);
  __syncthreads();
  const float ld_last = ld[L - 1];
  if (tid < L) {
    w1[tid] = expf(ld_last - ld[tid]) * dts[tid];
    w2[tid] = expf(ld[tid]);
  }
  if (tid == 0)
    decay[((size_t)bi * sh.H + h) * sh.nc + ch] = expf(ld_last);
  __syncthreads();
  const size_t xf = (((size_t)bi * sh.S + t0) * sh.H + h) * sh.P;
  tc_scaled_split(x, xf, (size_t)sh.H * sh.P, tv, sh.P, w1, xh, xl, sp);
  tc_scaled_split(dy, xf, (size_t)sh.H * sh.P, tv, sh.P, w2, yh, yl, sp);
  wm::cp_async_wait<0>();
  __syncthreads();

  const size_t off = (((size_t)bi * sh.H + h) * sh.nc + ch) * sh.P * sh.N;
  const int g = lane >> 2, t = lane & 3;
  const int nblk = (NP + 63) / 64;
  for (int job = warp; job < (PP / 16) * nblk; job += TC_NT / 32) {
    const int mt = job / nblk, n0 = (job - mt * nblk) * 64;
    const int npairs = min(4, (NP - n0) / 16);
    float s1[8][4] = {}, s2[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      uint32_t ah[4], al[4], ch_[4], cl[4];
      wm::ldsm_x4_trans(ah, a_cols(xh, sp, mt * 16, kk * 16));
      wm::ldsm_x4_trans(al, a_cols(xl, sp, mt * 16, kk * 16));
      wm::ldsm_x4_trans(ch_, a_cols(yh, sp, mt * 16, kk * 16));
      wm::ldsm_x4_trans(cl, a_cols(yl, sp, mt * 16, kk * 16));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (jp >= npairs) break;
        uint32_t bf[4], cf[4];
        wm::ldsm_x4_trans(bf, b_cols(bs, sn, kk * 16, n0 + jp * 16));
        wm::ldsm_x4_trans(cf, b_cols(cs, sn, kk * 16, n0 + jp * 16));
        mma_split_a(s1, ah, al, bf, jp);
        mma_split_a(s2, ch_, cl, cf, jp);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = mt * 16 + g + 8 * r, n = n0 + 8 * j + 2 * t;
        if (j < 2 * npairs && p < sh.P && n < sh.N) {
          const size_t e = off + (size_t)p * sh.N + n;
          *reinterpret_cast<float2*>(st + e) =
              make_float2(s1[j][2 * r], s1[j][2 * r + 1]);
          *reinterpret_cast<float2*>(dst + e) =
              make_float2(s2[j][2 * r], s2[j][2 * r + 1]);
        }
      }
  }
}

// 3. Four state elements of one (head, row) along the chunks, one
// direction a thread (blockIdx.z = 2 row + direction): the state entering
// each chunk over its contribution (forward), or the gradient of the state
// leaving each chunk over its contribution (reverse; the last chunk's is
// d(final state)).  The SIMT pass's arithmetic, a float4 a thread, the two
// directions' chains side by side.
__device__ __forceinline__ float4 fma4(float d, float4 r, float4 v) {
  return make_float4(fmaf(d, r.x, v.x), fmaf(d, r.y, v.y), fmaf(d, r.z, v.z),
                     fmaf(d, r.w, v.w));
}

__global__ void __launch_bounds__(TC_PASS_NT)
bwd_pass_tc(float* __restrict__ st, float* __restrict__ dst,
            const float* __restrict__ decay, const float* __restrict__ dstate,
            Shape sh) {
  const int h = blockIdx.y, bi = blockIdx.z >> 1;
  const bool reverse = blockIdx.z & 1;
  const size_t PN4 = (size_t)sh.P * sh.N / 4;
  const size_t e = (size_t)blockIdx.x * TC_PASS_NT + threadIdx.x;
  if (e >= PN4) return;
  const size_t bh = (size_t)bi * sh.H + h;
  float4* s = reinterpret_cast<float4*>(reverse ? dst : st) + bh * sh.nc * PN4
              + e;
  const float* dec = decay + bh * sh.nc;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // forward: chunks 0, 1, ... from the zero state; reverse: chunks nc - 1,
  // nc - 2, ... from d(final state)
  float4 run = reverse && dstate
                   ? reinterpret_cast<const float4*>(dstate)[bh * PN4 + e]
                   : zero;
  const int step = reverse ? -1 : 1, first = reverse ? sh.nc - 1 : 0;
  for (int k0 = 0; k0 < sh.nc; k0 += BATCH) {
    float4 v[BATCH];
    float dc[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int c = first + step * (k0 + k);
      const bool in = k0 + k < sh.nc;
      v[k] = in ? s[(size_t)c * PN4] : zero;
      dc[k] = in ? dec[c] : 1.f;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (k0 + k >= sh.nc) break;
      s[(size_t)(first + step * (k0 + k)) * PN4] = run;
      run = fma4(dc[k], run, v[k]);
    }
  }
}

// Shared memory of the tc kernels, in bytes.
__host__ __device__ inline size_t tc_cb_smem(int N) {
  return sizeof(bf16) * 2 * L * stride16(N);
}
__host__ __device__ inline size_t tc_contrib_smem(int P, int N) {
  return sizeof(bf16) * L * (4 * stride16(P) + 2 * stride16(N));
}
__host__ __device__ inline size_t tc_chunk_smem(int P, int N) {
  return sizeof(bf16) * (2 * L * stride16(P) + 2 * L * stride16(N)
                         + 2 * pad16(P) * stride16(N) + 2 * L * QS);
}

// 4. One (chunk, head, row): dx and ddt of its rows, this head's partials
// of db and dc (64 x N each) and of da.  Warp w owns rows 16w .. 16w + 15
// of every 64-row output (t for Q and dc, s for du and db); a thread holds
// rows g and g + 8 of its warp's 16 (g = lane / 4) and columns 8j + 2t,
// +1 (t = lane % 4) of each 8-column tile (the mma.sync C layout).
__global__ void __launch_bounds__(TC_NT, 2)
bwd_chunk_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ a, const bf16* __restrict__ b,
             const bf16* __restrict__ c, const bf16* __restrict__ dy,
             const float* __restrict__ cbm, const float* __restrict__ st,
             const float* __restrict__ dst, bf16* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ dbp,
             float* __restrict__ dcp, float* __restrict__ dap, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = sh.P, N = sh.N, sp = stride16(P), sn = stride16(N);
  const int PP = pad16(P), NP = pad16(N);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);   // (64, sp): x
  bf16* dys = xs + L * sp;                        // (64, sp): dy
  bf16* bs = dys + L * sp;                        // (64, sn): B
  bf16* cs = bs + L * sn;                         // (64, sn): C
  bf16* sth = cs + L * sn;                        // (PP, sn): dS_out, then S_in, hi
  bf16* stl = sth + PP * sn;                      // lo
  bf16* qh = stl + PP * sn;                       // (64, QS): Q, hi
  bf16* ql = qh + L * QS;                         // lo
  __shared__ float ld[L], dts[L], wl[L], el[L];
  __shared__ float dla[L], colp[4][L], kks[L], dd1[L], y2s[L];
  __shared__ float red[TC_NT];
  const int ch = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int t0 = ch * L, tv = min(L, sh.S - t0);
  const size_t row0 = (size_t)bi * sh.S + t0;
  const float ah = a[h];
  const size_t xrow = ((size_t)bi * sh.S * sh.H + h) * P;
  tc_load_rows(xs, x + xrow, (size_t)sh.H * P, t0, sh.S, P);
  tc_load_rows(dys, dy + xrow, (size_t)sh.H * P, t0, sh.S, P);
  tc_load_rows(bs, b + (size_t)bi * sh.S * N, N, t0, sh.S, N);
  tc_load_rows(cs, c + (size_t)bi * sh.S * N, N, t0, sh.S, N);
  wm::cp_async_commit();
  chunk_ld(dt, ah, row0 * sh.H + h, sh.H, tv, dts, ld);
  const size_t off = (((size_t)bi * sh.H + h) * sh.nc + ch) * P * N;
  tc_split_state(dst + off, nullptr, P, N, sth, stl, sn);
  wm::cp_async_wait<0>();
  __syncthreads();
  if (tid < L) {
    wl[tid] = expf(ld[L - 1] - ld[tid]);
    el[tid] = expf(ld[tid]);
  }
  __syncthreads();
  const float* cbt = cbm + ((size_t)bi * sh.nc + ch) * L * L;
  const int r0 = warp * 16 + g;              // the thread's rows r0, r0 + 8

  // Q_ts = exp(LD_t - LD_s) dt_s (dy_t . x_s) on s <= t, kept hi/lo; dLD's
  // sums of G = Q . CB over each row (dla) and each column (colp per warp).
  {
    float m1[8][4] = {};
    for (int kk = 0; kk < PP / 16; ++kk) {
      uint32_t af[4];
      wm::ldsm_x4(af, a_rows(dys, sp, warp * 16, kk * 16));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (jp > warp) break;              // s <= t
        uint32_t bf[4];
        wm::ldsm_x4(bf, b_rows(xs, sp, kk * 16, jp * 16));
        wm::mma16816(m1[2 * jp], af, bf[0], bf[1]);
        wm::mma16816(m1[2 * jp + 1], af, bf[2], bf[3]);
      }
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float csum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int tr = r0 + 8 * hh;
        float q[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = 8 * j + 2 * t4 + e;
          q[e] = s <= tr ? expf(ld[tr] - ld[s]) * dts[s] * m1[j][2 * hh + e]
                         : 0.f;
          const float gv = q[e] * cbt[tr * L + s];
          rsum[hh] += gv;
          csum[e] += gv;
        }
        uint32_t hi, lo;
        wm::split2(q[0], q[1], hi, lo);
        *reinterpret_cast<uint32_t*>(qh + tr * QS + 8 * j + 2 * t4) = hi;
        *reinterpret_cast<uint32_t*>(ql + tr * QS + 8 * j + 2 * t4) = lo;
      }
      // the column sums over the warp's 16 rows: lanes of equal t4
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = csum[e];
        v += __shfl_xor_sync(0xffffffff, v, 4);
        v += __shfl_xor_sync(0xffffffff, v, 8);
        v += __shfl_xor_sync(0xffffffff, v, 16);
        if (g == 0) colp[warp][8 * j + 2 * t4 + e] = v;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = rsum[hh];
      v += __shfl_xor_sync(0xffffffff, v, 1);
      v += __shfl_xor_sync(0xffffffff, v, 2);
      if (t4 == 0) dla[r0 + 8 * hh] = v;
    }
  }
  __syncthreads();   // Q's tiles are complete

  // du_s = sum_{t>=s} W_ts dy_t + wl_s v2_s (W = E . CB, v2 = dS_out b_s),
  // dx = du dt; the row sums of du . x and x . v2.
  {
    float px1[2] = {0.f, 0.f}, px2[2] = {0.f, 0.f};
    for (int p0 = 0; p0 < PP; p0 += 64) {
      const int npairs = min(4, (PP - p0) / 16);
      float du[8][4] = {}, v2[8][4] = {};
      for (int kk = warp; kk < L / 16; ++kk) {   // t >= s
        uint32_t wh[4], wlo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = r0 + 8 * (q & 1), tt = kk * 16 + 2 * t4 + 8 * (q >> 1);
          const float w0 =
              s <= tt ? expf(ld[tt] - ld[s]) * cbt[tt * L + s] : 0.f;
          const float w1 = s <= tt + 1
                               ? expf(ld[tt + 1] - ld[s]) * cbt[(tt + 1) * L + s]
                               : 0.f;
          wm::split2(w0, w1, wh[q], wlo[q]);
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp >= npairs) break;
          uint32_t bf[4];
          wm::ldsm_x4_trans(bf, b_cols(dys, sp, kk * 16, p0 + jp * 16));
          mma_split_a(du, wh, wlo, bf, jp);
        }
      }
      for (int kk = 0; kk < NP / 16; ++kk) {
        uint32_t af[4];
        wm::ldsm_x4(af, a_rows(bs, sn, warp * 16, kk * 16));
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp >= npairs) break;
          uint32_t bh[4], bl[4];
          wm::ldsm_x4(bh, b_rows(sth, sn, kk * 16, p0 + jp * 16));
          wm::ldsm_x4(bl, b_rows(stl, sn, kk * 16, p0 + jp * 16));
          mma_split_b(v2, af, bh, bl, jp);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= 2 * npairs) break;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int s = r0 + 8 * hh, p = p0 + 8 * j + 2 * t4;
          const __nv_bfloat162 xv2 =
              *reinterpret_cast<const __nv_bfloat162*>(xs + s * sp + p);
          const float x0 = __bfloat162float(xv2.x), x1 = __bfloat162float(xv2.y);
          const float d0 = fmaf(wl[s], v2[j][2 * hh], du[j][2 * hh]);
          const float d1 = fmaf(wl[s], v2[j][2 * hh + 1], du[j][2 * hh + 1]);
          px1[hh] = fmaf(d1, x1, fmaf(d0, x0, px1[hh]));
          px2[hh] = fmaf(x1, v2[j][2 * hh + 1], fmaf(x0, v2[j][2 * hh], px2[hh]));
          if (s < tv && p < P)
            *reinterpret_cast<__nv_bfloat162*>(
                dx + ((row0 + s) * sh.H + h) * P + p) =
                __floats2bfloat162_rn(d0 * dts[s], d1 * dts[s]);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v1 = px1[hh], v2s = px2[hh];
      v1 += __shfl_xor_sync(0xffffffff, v1, 1);
      v1 += __shfl_xor_sync(0xffffffff, v1, 2);
      v2s += __shfl_xor_sync(0xffffffff, v2s, 1);
      v2s += __shfl_xor_sync(0xffffffff, v2s, 2);
      const int s = r0 + 8 * hh;
      if (t4 == 0) {
        dd1[s] = v1;
        kks[s] = wl[s] * dts[s] * v2s;
      }
    }
  }

  // This head's db_s = sum_{t>=s} Q_ts c_t + wl_s dt_s (dS_out^T x_s).
  const size_t part = (((size_t)bi * sh.nc + ch) * sh.H + h) * L * N;
  for (int n0 = 0; n0 < NP; n0 += 64) {
    const int npairs = min(4, (NP - n0) / 16);
    float a1[8][4] = {}, a2[8][4] = {};
    for (int kk = warp; kk < L / 16; ++kk) {   // t >= s
      uint32_t qa[4], qb[4];
      wm::ldsm_x4_trans(qa, a_cols(qh, QS, warp * 16, kk * 16));
      wm::ldsm_x4_trans(qb, a_cols(ql, QS, warp * 16, kk * 16));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (jp >= npairs) break;
        uint32_t bf[4];
        wm::ldsm_x4_trans(bf, b_cols(cs, sn, kk * 16, n0 + jp * 16));
        mma_split_a(a1, qa, qb, bf, jp);
      }
    }
    for (int kk = 0; kk < PP / 16; ++kk) {
      uint32_t af[4];
      wm::ldsm_x4(af, a_rows(xs, sp, warp * 16, kk * 16));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (jp >= npairs) break;
        uint32_t bh[4], bl[4];
        wm::ldsm_x4_trans(bh, b_cols(sth, sn, kk * 16, n0 + jp * 16));
        wm::ldsm_x4_trans(bl, b_cols(stl, sn, kk * 16, n0 + jp * 16));
        mma_split_b(a2, af, bh, bl, jp);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= 2 * npairs) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = r0 + 8 * hh, n = n0 + 8 * j + 2 * t4;
        const float w = wl[s] * dts[s];
        if (n < N)
          *reinterpret_cast<float2*>(dbp + part + (size_t)s * N + n) =
              make_float2(fmaf(w, a2[j][2 * hh], a1[j][2 * hh]),
                          fmaf(w, a2[j][2 * hh + 1], a1[j][2 * hh + 1]));
      }
    }
  }
  __syncthreads();   // every read of dS_out's tiles is done

  // S_in over dS_out's tiles; <dS_out, S_in> from the f32 values.
  red[tid] = tc_split_state(st + off, dst + off, P, N, sth, stl, sn);
  __syncthreads();

  // This head's dc_t = sum_{s<=t} Q_ts b_s + el_t (S_in^T dy_t), and
  // y2_t = dy_t . (S_in c_t).
  {
    float yv[2] = {0.f, 0.f};
    for (int n0 = 0; n0 < NP; n0 += 64) {
      const int npairs = min(4, (NP - n0) / 16);
      float a1[8][4] = {}, a2[8][4] = {};
      for (int kk = 0; kk <= warp; ++kk) {   // s <= t
        uint32_t qa[4], qb[4];
        wm::ldsm_x4(qa, a_rows(qh, QS, warp * 16, kk * 16));
        wm::ldsm_x4(qb, a_rows(ql, QS, warp * 16, kk * 16));
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp >= npairs) break;
          uint32_t bf[4];
          wm::ldsm_x4_trans(bf, b_cols(bs, sn, kk * 16, n0 + jp * 16));
          mma_split_a(a1, qa, qb, bf, jp);
        }
      }
      for (int kk = 0; kk < PP / 16; ++kk) {
        uint32_t af[4];
        wm::ldsm_x4(af, a_rows(dys, sp, warp * 16, kk * 16));
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp >= npairs) break;
          uint32_t bh[4], bl[4];
          wm::ldsm_x4_trans(bh, b_cols(sth, sn, kk * 16, n0 + jp * 16));
          wm::ldsm_x4_trans(bl, b_cols(stl, sn, kk * 16, n0 + jp * 16));
          mma_split_b(a2, af, bh, bl, jp);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= 2 * npairs) break;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int tr = r0 + 8 * hh, n = n0 + 8 * j + 2 * t4;
          const __nv_bfloat162 cv2 =
              *reinterpret_cast<const __nv_bfloat162*>(cs + tr * sn + n);
          yv[hh] = fmaf(a2[j][2 * hh + 1], __bfloat162float(cv2.y),
                        fmaf(a2[j][2 * hh], __bfloat162float(cv2.x), yv[hh]));
          if (n < N)
            *reinterpret_cast<float2*>(dcp + part + (size_t)tr * N + n) =
                make_float2(fmaf(el[tr], a2[j][2 * hh], a1[j][2 * hh]),
                            fmaf(el[tr], a2[j][2 * hh + 1], a1[j][2 * hh + 1]));
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = yv[hh];
      v += __shfl_xor_sync(0xffffffff, v, 1);
      v += __shfl_xor_sync(0xffffffff, v, 2);
      if (t4 == 0) y2s[r0 + 8 * hh] = v;
    }
  }
  __syncthreads();

  // dLD = rows - columns of G + el y2 - k; the last row also takes the
  // state terms; then the reverse cumsum of dLD gives d(dt a): ddt += a g,
  // da += dt g.
  if (tid < L) {
    const int t = tid;
    const float cols = ((colp[0][t] + colp[1][t]) + colp[2][t]) + colp[3][t];
    dla[t] = dla[t] - cols + el[t] * y2s[t] - kks[t];
  }
  __syncthreads();
  if (tid == 0) {
    float inner = 0.f, ksum = 0.f;
    for (int i = 0; i < TC_NT; ++i) inner += red[i];
    for (int t = 0; t < L; ++t) ksum += kks[t];
    dla[L - 1] += el[L - 1] * inner + ksum;
    float gs = 0.f, dsum = 0.f;
    for (int t = L - 1; t >= 0; --t) {
      gs += dla[t];
      dsum = fmaf(dts[t], gs, dsum);
      if (t < tv) ddt[(row0 + t) * sh.H + h] = fmaf(ah, gs, dd1[t]);
    }
    dap[((size_t)bi * sh.nc + ch) * sh.H + h] = dsum;
  }
}

bool tc_takes(int P, int N) {
  return P >= 8 && N >= 8 && P % 8 == 0 && N % 8 == 0 && P <= TC_MAX &&
         N <= TC_MAX;
}

// cudaFuncSetAttribute once per kernel and device, to the most dynamic
// shared memory the kernel takes at P = N = TC_MAX (the kernels also hold
// a few KB of static shared memory, so not SMEM_LIMIT).
template <typename K>
cudaError_t allow_tc(K kernel, size_t bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1ull)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

// f32 scratch of the tc route beyond the SIMT route's: CB (B, nc, 64, 64).
size_t tc_cb_floats(int B, int S) {
  return (size_t)B * ((S + L - 1) / L) * L * L;
}

int launch_tc(const void* x, const float* dt, const float* a, const void* b,
              const void* c, const void* dy, const float* dstate, void* dx,
              float* ddt, float* da, void* db, void* dc, float* scratch,
              const Shape& sh, cudaStream_t stream) {
  static unsigned long long done[3] = {0, 0, 0};
  if (!tc_takes(sh.P, sh.N)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_tc(bwd_cb, tc_cb_smem(TC_MAX), done[0]);
  if (err == cudaSuccess)
    err = allow_tc(bwd_contrib_tc, tc_contrib_smem(TC_MAX, TC_MAX), done[1]);
  if (err == cudaSuccess)
    err = allow_tc(bwd_chunk_tc, tc_chunk_smem(TC_MAX, TC_MAX), done[2]);
  if (err != cudaSuccess) return (int)err;
  const size_t states = (size_t)sh.B * sh.H * sh.nc * sh.P * sh.N;
  float* st = scratch;
  float* dst = st + states;
  float* decay = dst + states;
  float* dbp = decay + (size_t)sh.B * sh.H * sh.nc;
  float* dcp = dbp + (size_t)sh.B * sh.nc * sh.H * L * sh.N;
  float* dap = dcp + (size_t)sh.B * sh.nc * sh.H * L * sh.N;
  float* cbm = dap + (size_t)sh.B * sh.nc * sh.H;
  const bf16 *xb = (const bf16*)x, *bb = (const bf16*)b, *cc = (const bf16*)c,
             *dyb = (const bf16*)dy;
  bwd_cb<<<dim3(sh.nc, sh.B), TC_NT, tc_cb_smem(sh.N), stream>>>(bb, cc, cbm,
                                                                 sh);
  bwd_contrib_tc<<<dim3(sh.H, sh.nc, sh.B), TC_NT,
                   tc_contrib_smem(sh.P, sh.N), stream>>>(
      xb, dt, a, bb, cc, dyb, st, dst, decay, sh);
  const int pn4 = sh.P * sh.N / 4;
  bwd_pass_tc<<<dim3((pn4 + TC_PASS_NT - 1) / TC_PASS_NT, sh.H, 2 * sh.B),
                TC_PASS_NT, 0, stream>>>(st, dst, decay, dstate, sh);
  bwd_chunk_tc<<<dim3(sh.nc, sh.H, sh.B), TC_NT, tc_chunk_smem(sh.P, sh.N),
                 stream>>>(xb, dt, a, bb, cc, dyb, cbm, st, dst, (bf16*)dx,
                           ddt, dbp, dcp, dap, sh);
  const size_t total = (size_t)sh.B * sh.S * sh.N;
  const size_t blocks = (total + NT - 1) / NT;
  bwd_reduce<bf16><<<(int)(blocks < 4096 ? blocks : 4096), NT, 0, stream>>>(
      dbp, dcp, (bf16*)db, (bf16*)dc, sh);
  bwd_da<<<(sh.H + NT - 1) / NT, NT, 0, stream>>>(dap, da, sh);
  return (int)cudaGetLastError();
}

}  // namespace
