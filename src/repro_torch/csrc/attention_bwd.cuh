// SIMT f32 core of the attention backward kernels, shared by
// flash_attention_bwd.cu and stream_attention_bwd.cu.
//
// The function is the two-pass flash backward of flash_vjp.py (_flash_bwd,
// _stream_bwd): with lse = m + log l of the forward and
// delta = rowsum(dO * O),
//   P  = exp(S * scale - lse)       S = Q K^T, masked keys P = 0
//   dV = P^T dO        dP = dO V^T        dS = P (dP - delta) * scale
//   dK = dS^T Q        dQ = dS K
// per tile pair of BQ = 64 query rows and BKV = 64 keys.  A block of 256
// threads is a 16 x 16 grid (ty, tx); in a 64 x 64 tile thread (ty, tx)
// holds rows ty + 16i and columns tx + 16c (i, c < 4), in a 64 x HDT tile
// rows ty + 16i and columns tx + 16c (c < HDT / 16).  Every product is an
// f32 FMA on f32 copies of the inputs (bf16 inputs are widened on load), so
// the kernels hold chip_smoke.py's f32 limits and need no split operands.
//
// Rows with no live key.  The forward gives such a row the mean of V over
// the Sk keys (softmax of equal -1e30 scores) and stores lse = -1e30.  Its
// gradient is that of the mean: dV gets dO / Sk on every key below Sk and
// no score gets a gradient.  So here P of a row with lse <= -1e29 is 1 / Sk
// on those keys, and dS is 0 on every masked key (which also holds for the
// live rows, whose P is 0 there).
//
// Which tiles are walked: the live-tile rule of the forward kernels
// (attention_tc.cuh live_kv_tiles; blocked.live_kv_tiles mirrors it) for a
// span of 64 query rows of one head.  A key tile is walked by the dK/dV
// kernels for every query span whose live range holds it, and a query
// span walks its live range in the dQ kernels.
#pragma once

#include "attention_tc.cuh"   // AttnShape, q_span, live_kv_tiles

namespace repro {
namespace bwd {

constexpr int BQ = 64;     // query rows per chunk
constexpr int BKV = 64;    // keys per tile (the forward's tc::BK)
constexpr int NT = 256;    // threads per block
constexpr int T16 = 16;
constexpr float DEAD = -1e29f;   // lse at or below: a row with no live key
static_assert(BKV == tc::BK, "the live-tile rule counts tiles of tc::BK keys");

template <int HDT>
struct Smem {
  static constexpr int HS = HDT + 1;   // padded row stride of head-wide tiles
  static constexpr int PS = BKV + 1;   // padded row stride of P and dS
  // q, dO, k, v (64 x HS each), P, dS (64 x PS), lse, delta, qpos, valid
  static constexpr int FLOATS = 4 * 64 * HS + 2 * 64 * PS + 4 * 64;
};

// The shared-memory tiles and the per-thread coordinates of one block.
template <int HDT>
struct Tiles {
  using L = Smem<HDT>;
  static constexpr int CJ = HDT / T16;
  float *q_s, *do_s, *k_s, *v_s, *p_s, *ds_s, *lse_s, *dl_s;
  int *qpos_s, *valid_s;
  int tid, tx, ty;

  __device__ explicit Tiles(float* smem)
      : tid(threadIdx.x), tx(threadIdx.x % T16), ty(threadIdx.x / T16) {
    q_s = smem;
    do_s = q_s + 64 * L::HS;
    k_s = do_s + 64 * L::HS;
    v_s = k_s + 64 * L::HS;
    p_s = v_s + 64 * L::HS;
    ds_s = p_s + 64 * L::PS;
    lse_s = ds_s + 64 * L::PS;
    dl_s = lse_s + 64;
    qpos_s = reinterpret_cast<int*>(dl_s + 64);
    valid_s = qpos_s + 64;
  }

  // First float past the tiles (a kernel's own staging).
  __device__ float* end() const {
    return reinterpret_cast<float*>(valid_s + 64);
  }

  // Query rows q0 .. q0 + 63 of head `head`: Q, dO, lse, delta, positions.
  template <typename T>
  __device__ void load_rows(const T* __restrict__ q, const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const AttnShape& sh, int b, int head, int q0) {
    const size_t row0 = (size_t)(b * sh.Hq + head) * sh.Sq;
    for (int idx = tid; idx < 64 * HDT; idx += NT) {
      const int r = idx / HDT, d = idx % HDT, qi = q0 + r;
      const bool in = qi < sh.Sq;
      q_s[r * L::HS + d] = in && d < sh.hd ? to_f(q[(row0 + qi) * sh.hd + d]) : 0.f;
      do_s[r * L::HS + d] =
          in && d < sh.hdv ? to_f(dout[(row0 + qi) * sh.hdv + d]) : 0.f;
    }
    for (int r = tid; r < 64; r += NT) {
      const int qi = q0 + r;
      const bool in = qi < sh.Sq;
      valid_s[r] = in;
      qpos_s[r] = qi + sh.q_offset;
      lse_s[r] = in ? lse[row0 + qi] : 0.f;
      dl_s[r] = in ? delta[row0 + qi] : 0.f;
    }
  }

  // K and V rows of kv tile j of (b, kv head): from device memory.
  template <typename T>
  __device__ void load_kv(const T* __restrict__ k, const T* __restrict__ v,
                          const AttnShape& sh, int b, int kvh, int j) {
    const size_t kb = (size_t)(b * sh.Hkv + kvh) * sh.Sk;
    for (int idx = tid; idx < 64 * HDT; idx += NT) {
      const int c = idx / HDT, d = idx % HDT, kpos = j * BKV + c;
      const bool in = kpos < sh.Sk;
      k_s[c * L::HS + d] = in && d < sh.hd ? to_f(k[(kb + kpos) * sh.hd + d]) : 0.f;
      v_s[c * L::HS + d] = in && d < sh.hdv ? to_f(v[(kb + kpos) * sh.hdv + d]) : 0.f;
    }
  }

  // P and dS of the loaded rows against kv tile j, into p_s and ds_s.
  __device__ void probs(const AttnShape& sh, int j) {
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
    for (int d = 0; d < HDT; ++d) {
      float qv[4], dv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(ty + T16 * i) * L::HS + d];
        dv[i] = do_s[(ty + T16 * i) * L::HS + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = k_s[(tx + T16 * c) * L::HS + d];
        vv[c] = v_s[(tx + T16 * c) * L::HS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(dv[i], vv[c], dp[i][c]);
        }
    }
    const float inv_sk = sh.Sk > 0 ? 1.f / sh.Sk : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + T16 * i, qpos = qpos_s[r];
      const float lse = lse_s[r], dl = dl_s[r];
      const bool valid = valid_s[r], dead = lse <= DEAD;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + T16 * c, kpos = j * BKV + col;
        bool ok = valid && kpos < sh.kv_len;
        if (sh.causal) ok = ok && kpos <= qpos;
        if (sh.window > 0) ok = ok && kpos > qpos - sh.window;
        float p = 0.f;
        if (valid && dead)
          p = kpos < sh.Sk ? inv_sk : 0.f;
        else if (ok)
          p = expf(s[i][c] * sh.scale - lse);
        p_s[r * L::PS + col] = p;
        ds_s[r * L::PS + col] = ok && !dead ? p * (dp[i][c] - dl) * sh.scale : 0.f;
      }
    }
  }

  // dV += P^T dO and dK += dS^T Q: thread keys ty + 16i, columns tx + 16c.
  __device__ void acc_dkv(float (&dk)[4][CJ], float (&dv)[4][CJ]) const {
    for (int r = 0; r < BQ; ++r) {
      float pk[4], sk[4], dov[CJ], qv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = p_s[r * L::PS + ty + T16 * i];
        sk[i] = ds_s[r * L::PS + ty + T16 * i];
      }
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        dov[c] = do_s[r * L::HS + tx + T16 * c];
        qv[c] = q_s[r * L::HS + tx + T16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          dv[i][c] = fmaf(pk[i], dov[c], dv[i][c]);
          dk[i][c] = fmaf(sk[i], qv[c], dk[i][c]);
        }
    }
  }

  // dQ += dS K: thread rows ty + 16i, columns tx + 16c.
  __device__ void acc_dq(float (&dq)[4][CJ]) const {
    for (int key = 0; key < BKV; ++key) {
      float sr[4], kv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sr[i] = ds_s[(ty + T16 * i) * L::PS + key];
#pragma unroll
      for (int c = 0; c < CJ; ++c) kv[c] = k_s[key * L::HS + tx + T16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) dq[i][c] = fmaf(sr[i], kv[c], dq[i][c]);
    }
  }
};

// Live kv tiles [lo, hi) of query rows q0 .. q0 + 63 of one head (the
// span, clipped at Sq, is within that head's rows).
__device__ __forceinline__ tc::KvRange span_tiles(const AttnShape& sh, int g,
                                                  int q0) {
  int qmin = 0, qmax = 0;
  const int r0 = g * sh.Sq + q0, r1 = g * sh.Sq + min(q0 + BQ, sh.Sq);
  const bool any = tc::q_span(r0, r1, sh, qmin, qmax);
  return tc::live_kv_tiles(sh, any, qmin, qmax);
}

// delta = rowsum(dO * O) in f32, one warp per query row: (B, Hq, Sq).
template <typename T>
__global__ void __launch_bounds__(NT)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int rows, int hdv) {
  const int row = blockIdx.x * (NT / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < hdv; d += 32)
    s = fmaf(to_f(out[(size_t)row * hdv + d]), to_f(dout[(size_t)row * hdv + d]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

template <typename T>
int launch_delta(const void* out, const void* dout, float* delta, int rows,
                 int hdv, cudaStream_t stream) {
  if (rows == 0) return 0;
  delta_kernel<T><<<(rows + NT / 32 - 1) / (NT / 32), NT, 0, stream>>>(
      (const T*)out, (const T*)dout, delta, rows, hdv);
  return (int)cudaGetLastError();
}

// cudaFuncSetAttribute once per kernel instantiation and device (`done`:
// a bit per device, static at the call site).
template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1ull)) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done |= 1ull << dev;
  return (int)err;
}

// Fixed-order sum of `nslots` partials of n floats each: out[i] = ((s_0 +
// s_1) + s_2) + ..., one thread per element.
__global__ void reduce_slots(const float* __restrict__ slots,
                             float* __restrict__ out, long long n, int nslots) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = slots[i];
    for (int k = 1; k < nslots; ++k) s += slots[(long long)k * n + i];
    out[i] = s;
  }
}

inline int launch_reduce(const float* slots, float* out, long long n,
                         int nslots, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256;
  reduce_slots<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      slots, out, n, nslots);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace repro
