// Backward of LAYER_STREAM flash attention over materialized K/V, for sm_90a.
//
// Replaces: src/repro/kernels/flash_vjp.py:114 (_flash_bwd), the two-pass
// flash backward the JAX training path runs under jax.grad (a jnp custom
// VJP, not a Pallas kernel).  Same function: from q, k, v, the forward's
// out and lse = m + log l (B, Hq, Sq) f32, and dout, it gives dq, dk, dv;
// GQA (query head h reads kv head h / G; dk and dv sum over the G query
// heads of a kv head), keys at or past kv_len masked, causal with
// q_offset, sliding window, V width hdv that may differ from hd.
//
// Three launches, all f32 arithmetic on the SIMT core of attention_bwd.cuh:
//   delta_kernel  delta = rowsum(dO * O)                       (B, Hq, Sq)
//   dkv_kernel    one block per (kv tile of 64 keys, kv head, batch): K_j
//                 and V_j stay in shared memory while the block walks the
//                 live 64-row query spans of all G heads of the kv head,
//                 accumulating dK_j and dV_j in registers; each key's
//                 gradient is written once, by its block: no atomics.
//   dq_kernel     one block per (64 query rows, query head, batch) walks
//                 its live kv tiles, accumulating dQ in registers.
// S and dP are recomputed in both (the price of no atomics and no stored
// probabilities): 7 products of 2·64·64·hd per live tile pair against the
// function's 5.  What bounds it on the H100: the FLOPs, at f32 FMA rate.
#include "attention_bwd.cuh"

namespace repro {
namespace bwd {

template <typename T, int HDT>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, AttnShape sh) {
  extern __shared__ float smem[];
  Tiles<HDT> t(smem);
  constexpr int CJ = Tiles<HDT>::CJ;
  const int j = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = sh.Hq / sh.Hkv;
  t.load_kv(k, v, sh, b, kvh, j);
  float dka[4][CJ], dva[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dka[i][c] = dva[i][c] = 0.f;
  for (int g = 0; g < G; ++g) {
    for (int q0 = 0; q0 < sh.Sq; q0 += BQ) {
      const tc::KvRange kv = span_tiles(sh, g, q0);
      if (j < kv.lo || j >= kv.hi) continue;   // no live pair with tile j
      __syncthreads();   // the previous span's products are done
      t.load_rows(q, dout, lse, delta, sh, b, kvh * G + g, q0);
      __syncthreads();
      t.probs(sh, j);
      __syncthreads();
      t.acc_dkv(dka, dva);
    }
  }
  const size_t kb = (size_t)(b * sh.Hkv + kvh) * sh.Sk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = j * BKV + t.ty + T16 * i;
    if (kpos >= sh.Sk) continue;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int col = t.tx + T16 * c;
      if (col < sh.hd) dk[(kb + kpos) * sh.hd + col] = from_f<T>(dka[i][c]);
      if (col < sh.hdv) dv[(kb + kpos) * sh.hdv + col] = from_f<T>(dva[i][c]);
    }
  }
}

template <typename T, int HDT>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, AttnShape sh) {
  extern __shared__ float smem[];
  Tiles<HDT> t(smem);
  constexpr int CJ = Tiles<HDT>::CJ;
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const int G = sh.Hq / sh.Hkv, kvh = head / G;
  const tc::KvRange kv = span_tiles(sh, head % G, q0);
  t.load_rows(q, dout, lse, delta, sh, b, head, q0);
  float dqa[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dqa[i][c] = 0.f;
  for (int j = kv.lo; j < kv.hi; ++j) {
    __syncthreads();   // the previous tile's products are done
    t.load_kv(k, v, sh, b, kvh, j);
    __syncthreads();
    t.probs(sh, j);
    __syncthreads();
    t.acc_dq(dqa);
  }
  const size_t row0 = (size_t)(b * sh.Hq + head) * sh.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + t.ty + T16 * i;
    if (qi >= sh.Sq) continue;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int col = t.tx + T16 * c;
      if (col < sh.hd) dq[(row0 + qi) * sh.hd + col] = from_f<T>(dqa[i][c]);
    }
  }
}

template <typename T, int HDT>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const AttnShape& sh, cudaStream_t stream) {
  int err = launch_delta<T>(out, dout, delta, sh.B * sh.Hq * sh.Sq, sh.hdv,
                            stream);
  if (err) return err;
  const size_t smem = sizeof(float) * Smem<HDT>::FLOATS;
  auto kkv = dkv_kernel<T, HDT>;
  auto kq = dq_kernel<T, HDT>;
  if ((err = set_smem(kkv, smem)) || (err = set_smem(kq, smem))) return err;
  if (sh.Sk > 0) {
    kkv<<<dim3((sh.Sk + BKV - 1) / BKV, sh.Hkv, sh.B), NT, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, sh);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (sh.Sq > 0) {
    kq<<<dim3((sh.Sq + BQ - 1) / BQ, sh.Hq, sh.B), NT, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dq, sh);
    err = (int)cudaGetLastError();
  }
  return err;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, const AttnShape& sh, cudaStream_t stream) {
  const int w = sh.hd > sh.hdv ? sh.hd : sh.hdv;
  if (w <= 32)
    return launch<T, 32>(q, k, v, out, dout, lse, delta, dq, dk, dv, sh, stream);
  if (w <= 64)
    return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, sh, stream);
  return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, sh, stream);
}

}  // namespace bwd
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout and the gradients
// dq, dk, dv).  lse (B, Hq, Sq) f32 from the forward; delta (B, Hq, Sq) f32
// scratch.  All tensors contiguous; hd, hdv <= 128 (the Python wrapper
// checks).  Returns the CUDA error code of the launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int hd,
    int hdv, float scale, int causal, int window, int q_offset, int kv_len,
    void* stream) {
  repro::AttnShape sh{B, Hq, Hkv, Sq, Sk, hd, hdv, scale,
                      causal, window, q_offset, kv_len};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return repro::bwd::dispatch<float>(q, k, v, out, dout, lse, delta, dq, dk,
                                       dv, sh, s);
  return repro::bwd::dispatch<__nv_bfloat16>(q, k, v, out, dout, lse, delta,
                                             dq, dk, dv, sh, s);
}
