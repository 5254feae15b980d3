// Batched single-query decode attention over cached K/V, for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py:124 (decode_attention /
// _decode_kernel), the Pallas TPU kernel.  Same function: q (B, Hq, 1, hd)
// holds one query row per slot, k/v (B, Hkv, W, hd) the slots' caches,
// clen (B,) the valid entries of each row (and, with window > 0, keys at
// or before clen - 1 - window drop out); GQA, f32 online softmax, output
// in q's dtype.  Masked keys carry no weight, so a row with no valid key
// (clen == 0) gives 0.  The Pallas kernel's (8, 128) padding of the query
// rows and of the head width exists only for the TPU and is not copied.
//
// What bounds it on the H100: bytes.  Each (batch row, kv head) reads its
// valid K/V rows once and does 4·G·hd FLOPs per key row (G = Hq/Hkv query
// heads share a kv head): at G = 8, hd = 128 that is 8 FLOPs per byte of
// bf16 K/V, far below the card's ~295.  The bound is the K/V bytes of the
// valid keys over 3.35 TB/s.
//
// Design:
// * one block per (kv head, batch row, W split): the block holds the G
//   query rows of its kv head, so each K/V row is read once for all of
//   them (the Pallas index map re-reads K/V once per query head);
// * the block streams 64-key K/V tiles through shared memory and keeps an
//   f32 online softmax (m, l, acc) per query row;
// * it loads only tiles that hold a valid key (kpos < clen, and with a
//   window kpos > clen - 1 - window): masked keys carry no weight, so the
//   result is the same;
// * W is split into chunks of SPLIT keys, one block each, and a second
//   kernel merges the chunks' (m, l, acc).  The split depends on W only,
//   never on B, and every row's arithmetic is its own: a row's result is
//   bitwise independent of B and of the other rows.
// Products are SIMT f32 FMAs; wider loads, TMA and more splits are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int BK = 64;       // keys per tile
constexpr int SPLIT = 256;   // keys per W chunk (one block each)
static_assert(BK == 64, "the softmax gives each lane two keys of a tile");
static_assert(SPLIT % BK == 0, "a chunk is a whole number of tiles");

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
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

struct DecShape {
  int B, Hq, Hkv, W, hd, window, nsplit;
  float scale;
};

// Shared memory in floats.  K/V row strides are padded by one float so
// that the threads of a warp, which read neighbouring keys, hit distinct
// banks.
template <int HDT>
struct DecSmem {
  static constexpr int KS = HDT + 1;
  static constexpr int PS = BK + 1;
  static __host__ __device__ int floats(int G) {
    return G * HDT + 2 * BK * KS + G * PS + G * HDT + 3 * G;
  }
};

// Partial attention of one W chunk.  With nsplit == 1 the block writes the
// normalized output; otherwise its (m, l, acc) go to the scratch arrays,
// indexed ((b * Hq + head) * nsplit + split).
template <typename T, int HDT>
__global__ void __launch_bounds__(THREADS)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ clen,
               T* __restrict__ out, float* __restrict__ part_m,
               float* __restrict__ part_l, float* __restrict__ part_acc,
               DecShape sh) {
  using S = DecSmem<HDT>;
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = sh.Hq / sh.Hkv, tid = threadIdx.x;
  float* q_s = smem;                  // (G, HDT)
  float* k_s = q_s + G * HDT;         // (BK, KS)
  float* v_s = k_s + BK * S::KS;      // (BK, KS)
  float* p_s = v_s + BK * S::KS;      // (G, PS)
  float* acc_s = p_s + G * S::PS;     // (G, HDT)
  float* m_s = acc_s + G * HDT;       // (G)
  float* l_s = m_s + G;               // (G)
  float* a_s = l_s + G;               // (G)

  // Valid keys of this row: [lo, hi).
  const int len = clen[b];
  const int hi = min(len, sh.W);
  const int lo = sh.window > 0 ? max(0, len - sh.window) : 0;

  const T* qb = q + (size_t)(b * sh.Hq + kvh * G) * sh.hd;
  for (int idx = tid; idx < G * HDT; idx += THREADS) {
    int g = idx / HDT, d = idx % HDT;
    q_s[idx] = d < sh.hd ? to_f(qb[(size_t)g * sh.hd + d]) : 0.f;
    acc_s[idx] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  const size_t kv_off = (size_t)(b * sh.Hkv + kvh) * sh.W * sh.hd;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  // Tiles of this chunk that hold a valid key.
  const int c0 = split * SPLIT;
  const int t_lo = max(c0, (lo / BK) * BK);
  const int t_hi = min(min(c0 + SPLIT, sh.W), hi);
  for (int t0 = t_lo; t0 < t_hi; t0 += BK) {
    __syncthreads();  // the previous tile's P·V is done with k_s, v_s, p_s
    for (int idx = tid; idx < BK * HDT; idx += THREADS) {
      int c = idx / HDT, d = idx % HDT, kpos = t0 + c;
      bool in = kpos < sh.W && d < sh.hd;
      size_t off = (size_t)kpos * sh.hd + d;
      k_s[c * S::KS + d] = in ? to_f(kb[off]) : 0.f;
      v_s[c * S::KS + d] = in ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();
    // Scores S = (q K^T) * scale, one (row, key) pair per thread.
    for (int idx = tid; idx < G * BK; idx += THREADS) {
      int g = idx / BK, c = idx % BK;
      const float* qr = q_s + g * HDT;
      const float* kr = k_s + c * S::KS;
      float s = 0.f;
      for (int d = 0; d < sh.hd; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[g * S::PS + c] = s * sh.scale;
    }
    __syncthreads();
    // Online softmax, one warp per row; masked keys get p = 0.
    {
      int warp = tid / 32, lane = tid % 32;
      bool ok0 = t0 + lane >= lo && t0 + lane < hi;
      bool ok1 = t0 + lane + 32 >= lo && t0 + lane + 32 < hi;
      for (int g = warp; g < G; g += NWARPS) {
        float* pr = p_s + g * S::PS;
        float s0 = ok0 ? pr[lane] : NEG_INF;
        float s1 = ok1 ? pr[lane + 32] : NEG_INF;
        float m_prev = m_s[g];
        float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
        float p0 = ok0 ? expf(s0 - m_new) : 0.f;
        float p1 = ok1 ? expf(s1 - m_new) : 0.f;
        float sum = warp_sum(p0 + p1);
        pr[lane] = p0;
        pr[lane + 32] = p1;
        if (lane == 0) {
          float alpha = expf(m_prev - m_new);
          a_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
        }
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V; each thread owns fixed (row, column) pairs.
    for (int idx = tid; idx < G * HDT; idx += THREADS) {
      int g = idx / HDT, d = idx % HDT;
      const float* pr = p_s + g * S::PS;
      float a = acc_s[idx] * a_s[g];
#pragma unroll 8
      for (int c = 0; c < BK; ++c) a = fmaf(pr[c], v_s[c * S::KS + d], a);
      acc_s[idx] = a;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < G * HDT; idx += THREADS) {
    int g = idx / HDT, d = idx % HDT;
    if (d >= sh.hd) continue;
    size_t row = (size_t)b * sh.Hq + kvh * G + g;
    if (sh.nsplit == 1) {
      float l = l_s[g];
      out[row * sh.hd + d] = from_f<T>(acc_s[idx] / (l == 0.f ? 1.f : l));
    } else {
      size_t slot = row * sh.nsplit + split;
      part_acc[slot * sh.hd + d] = acc_s[idx];
      if (d == 0) {
        part_m[slot] = m_s[g];
        part_l[slot] = l_s[g];
      }
    }
  }
}

// Merge the chunks of one (batch row, query head): one block, thread d
// owns output column d.  A chunk with no valid key has m = NEG_INF and
// l = acc = 0 and drops out; a row with none at all gives 0.
template <typename T>
__global__ void decode_merge(const float* __restrict__ part_m,
                             const float* __restrict__ part_l,
                             const float* __restrict__ part_acc,
                             T* __restrict__ out, DecShape sh) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  if (d >= sh.hd) return;
  const float* m = part_m + row * sh.nsplit;
  const float* l = part_l + row * sh.nsplit;
  float m_all = NEG_INF;
  for (int s = 0; s < sh.nsplit; ++s) m_all = fmaxf(m_all, m[s]);
  float l_all = 0.f, acc = 0.f;
  for (int s = 0; s < sh.nsplit; ++s) {
    float w = expf(m[s] - m_all);
    l_all = fmaf(l[s], w, l_all);
    acc = fmaf(part_acc[(row * sh.nsplit + s) * sh.hd + d], w, acc);
  }
  out[row * sh.hd + d] = from_f<T>(acc / (l_all == 0.f ? 1.f : l_all));
}

template <typename T, int HDT>
int launch(const void* q, const void* k, const void* v, const int* clen,
           void* out, float* part, const DecShape& sh, cudaStream_t stream) {
  int G = sh.Hq / sh.Hkv;
  size_t smem = sizeof(float) * DecSmem<HDT>::floats(G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial<T, HDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  size_t rows = (size_t)sh.B * sh.Hq * sh.nsplit;
  float* part_m = part;
  float* part_l = part + rows;
  float* part_acc = part + 2 * rows;
  dim3 grid(sh.Hkv, sh.B, sh.nsplit);
  decode_partial<T, HDT><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, clen, (T*)out, part_m, part_l,
      part_acc, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess || sh.nsplit == 1) return (int)err;
  decode_merge<T><<<sh.B * sh.Hq, 128, 0, stream>>>(part_m, part_l, part_acc,
                                                    (T*)out, sh);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* clen,
             void* out, float* part, const DecShape& sh,
             cudaStream_t stream) {
  if (sh.hd <= 32) return launch<T, 32>(q, k, v, clen, out, part, sh, stream);
  if (sh.hd <= 64) return launch<T, 64>(q, k, v, clen, out, part, sh, stream);
  return launch<T, 128>(q, k, v, clen, out, part, sh, stream);
}

}  // namespace

// Number of W chunks the kernel splits a cache of width W into; the
// wrapper sizes the scratch from it: (2 + hd) floats per (row, head, chunk).
extern "C" int decode_attention_splits(int W) { return (W + SPLIT - 1) / SPLIT; }

// dtype: 0 = float32, 1 = bfloat16.  q (B, Hq, 1, hd), k/v (B, Hkv, W, hd),
// out like q, all contiguous; clen (B,) int32; part: B * Hq * splits *
// (2 + hd) f32 scratch (unused with one split).  hd <= 128 and a multiple
// of 8, Hq a multiple of Hkv (the Python wrapper checks).  Returns
// cudaGetLastError() of the launches.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* clen,
                                       void* out, void* part, int dtype,
                                       int B, int Hq, int Hkv, int W, int hd,
                                       float scale, int window,
                                       void* stream) {
  DecShape sh{B, Hq, Hkv, W, hd, window, decode_attention_splits(W), scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, (const int*)clen, out, (float*)part, sh, s);
  return dispatch<__nv_bfloat16>(q, k, v, (const int*)clen, out,
                                 (float*)part, sh, s);
}
