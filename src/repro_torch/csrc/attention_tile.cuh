// SIMT f32 online-softmax attention core of stream_attention.cu: its route
// for f32 inputs, and for bf16 shapes that the tensor-core core
// (attention_tc.cuh) does not take (hd or x_kv's width not a multiple of
// 8, which TMA cannot read; a head width other than 32, 64, 96 or 128).
// Its helpers (AttnShape, the conversions, warp reductions,
// launch_attention) also serve flash_attention.cu's SIMT kernel.
//
// A block of 256 threads owns ROWS query rows of one (batch, kv head): the
// rows are a slice of the flattened (G query heads x Sq) row space of that
// kv head, so every query head of a GQA group reuses one K/V tile.  Per kv
// tile of BK keys (every tile: no live-tile skipping here) the kernel fills
// k_s/v_s (loaded, or generated on chip by the stream kernel), then:
//   scores()  S = (Q K^T) * scale, masked (kv_len, causal/q_offset, window)
//   softmax() m_new = max(m, rowmax S); P = exp(S - m_new);
//             alpha = exp(m - m_new); l = l * alpha + rowsum P
//   pv()      acc = acc * alpha + P V
// and store() writes acc / l (l == 0 -> 1), and m + log l to sh.lse when
// that is set.  The arithmetic is the Pallas
// kernels' (flash_attention.py:41-73): f32 tiles, f32 dots, NEG_INF = -1e30
// for masked scores, every product an f32 FMA (no TF32), so it holds the
// f32 limits of chip_smoke.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace repro {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int TX = 16;      // threads form a 16 x 16 grid: (ty, tx)
constexpr int BK = 64;      // keys per kv tile
constexpr int NWARPS = THREADS / 32;
static_assert(BK == 64, "softmax() gives each lane two columns of a tile");

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

struct AttnShape {
  int B, Hq, Hkv, Sq, Sk, hd, hdv;
  float scale;
  int causal, window, q_offset, kv_len;
  // (B, Hq, Sq) f32: m + log l per query row, the backward's residual;
  // null where nothing needs it (the serving paths).
  float* lse = nullptr;
};

// Shared memory of the core, in floats.  Row strides are padded by one
// float so that threads of a warp reading a column hit distinct banks.
template <int ROWS, int HDT>
struct AttnSmem {
  static constexpr int QS = HDT + 1;
  static constexpr int KS = HDT + 1;
  static constexpr int PS = BK + 1;
  static constexpr int FLOATS =
      ROWS * QS + 2 * BK * KS + ROWS * PS + 4 * ROWS;  // + m, l, alpha, qpos
};

template <typename T, int ROWS, int HDT>
struct AttnCore {
  using S = AttnSmem<ROWS, HDT>;
  static constexpr int RI = ROWS / TX;  // query rows per thread
  static constexpr int CJ = HDT / TX;   // output columns per thread
  static constexpr int SJ = BK / TX;    // score columns per thread

  const AttnShape sh;
  int b, kvh, t0, G, tid, tx, ty;
  float *q_s, *k_s, *v_s, *p_s, *m_s, *l_s, *a_s;
  int* qpos_s;
  float acc[RI][CJ];

  __device__ AttnCore(float* smem, const AttnShape& shape)
      : sh(shape), b(blockIdx.z), kvh(blockIdx.y), t0(blockIdx.x * ROWS),
        G(shape.Hq / shape.Hkv), tid(threadIdx.x), tx(threadIdx.x % TX),
        ty(threadIdx.x / TX) {
    q_s = smem;
    k_s = q_s + ROWS * S::QS;
    v_s = k_s + BK * S::KS;
    p_s = v_s + BK * S::KS;
    m_s = p_s + ROWS * S::PS;
    l_s = m_s + ROWS;
    a_s = l_s + ROWS;
    qpos_s = reinterpret_cast<int*>(a_s + ROWS);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }

  // First float past the core's shared memory (the stream kernel's staging).
  __device__ float* end() const { return a_s + 2 * ROWS; }

  // Row r of this block -> (query head, query index); false past the end.
  __device__ bool row(int r, int& head, int& qi) const {
    int t = t0 + r;
    if (t >= G * sh.Sq) return false;
    head = kvh * G + t / sh.Sq;
    qi = t % sh.Sq;
    return true;
  }

  __device__ void load_q(const T* q) {
    for (int idx = tid; idx < ROWS * HDT; idx += THREADS) {
      int r = idx / HDT, d = idx % HDT, head, qi;
      float val = 0.f;
      if (row(r, head, qi) && d < sh.hd)
        val = to_f(q[((size_t)(b * sh.Hq + head) * sh.Sq + qi) * sh.hd + d]);
      q_s[r * S::QS + d] = val;
    }
    for (int r = tid; r < ROWS; r += THREADS) {
      int head, qi;
      m_s[r] = NEG_INF;
      l_s[r] = 0.f;
      qpos_s[r] = row(r, head, qi) ? qi + sh.q_offset : 0;
    }
  }

  // Scores of kv tile j into p_s (needs k_s filled and synchronised).
  __device__ void scores(int j) {
    float s[RI][SJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < SJ; ++c) s[i][c] = 0.f;
    for (int d = 0; d < sh.hd; ++d) {
      float qv[RI], kv[SJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = q_s[(ty + TX * i) * S::QS + d];
#pragma unroll
      for (int c = 0; c < SJ; ++c) kv[c] = k_s[(tx + TX * c) * S::KS + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < SJ; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      int r = ty + TX * i, qpos = qpos_s[r];
#pragma unroll
      for (int c = 0; c < SJ; ++c) {
        int col = tx + TX * c, kpos = j * BK + col;
        bool ok = kpos < sh.kv_len;
        if (sh.causal) ok = ok && kpos <= qpos;
        if (sh.window > 0) ok = ok && kpos > qpos - sh.window;
        p_s[r * S::PS + col] = ok ? s[i][c] * sh.scale : NEG_INF;
      }
    }
  }

  // Online-softmax update, one warp per row (needs p_s synchronised).
  __device__ void softmax() {
    int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < ROWS; r += NWARPS) {
      float* pr = p_s + r * S::PS;
      float s0 = pr[lane], s1 = pr[lane + 32];
      float m_prev = m_s[r];
      float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = warp_sum(p0 + p1);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      if (lane == 0) {
        float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
  }

  // acc = acc * alpha + P V (needs p_s, a_s and v_s synchronised).
  __device__ void pv() {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float alpha = a_s[ty + TX * i];
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] *= alpha;
    }
    for (int k = 0; k < BK; ++k) {
      float pk[RI], vk[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pk[i] = p_s[(ty + TX * i) * S::PS + k];
#pragma unroll
      for (int c = 0; c < CJ; ++c) vk[c] = v_s[k * S::KS + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(pk[i], vk[c], acc[i][c]);
    }
  }

  // out (B, Hq, Sq, hdv) = acc / l (needs l_s synchronised).
  __device__ void store(T* out) const {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      int r = ty + TX * i, head, qi;
      if (!row(r, head, qi)) continue;
      // A row with no live key weighed every key 1 and the keys past Sk
      // hold V = 0: its mean is over the Sk keys.
      float l = m_s[r] == NEG_INF ? (float)sh.Sk : l_s[r];
      float l_safe = l == 0.f ? 1.f : l;   // l == 0 only with no key at all
      if (sh.lse && tx == 0)
        sh.lse[(size_t)(b * sh.Hq + head) * sh.Sq + qi] = m_s[r] + logf(l_safe);
      T* o = out + ((size_t)(b * sh.Hq + head) * sh.Sq + qi) * sh.hdv;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        int col = tx + TX * c;
        if (col < sh.hdv) o[col] = from_f<T>(acc[i][c] / l_safe);
      }
    }
  }
};

// Launch `kernel` over (row tiles, kv heads, batch) with `smem_bytes` of
// dynamic shared memory; returns the launch's error code.
template <typename Kernel, typename... Args>
int launch_attention(Kernel kernel, int rows, size_t smem_bytes,
                     const AttnShape& sh, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int G = sh.Hq / sh.Hkv;
  dim3 grid((G * sh.Sq + rows - 1) / rows, sh.Hkv, sh.B);
  kernel<<<grid, THREADS, smem_bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace repro
