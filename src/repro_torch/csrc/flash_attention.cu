// LAYER_STREAM flash attention over materialized K/V, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py:105 (flash_attention /
// _flash_kernel), the Pallas TPU kernel.  Same function: GQA (query head h
// reads kv head h / G), keys at or past kv_len masked, causal with
// q_offset, sliding window, V width hdv that may differ from hd, f32
// arithmetic, output in q's dtype.
//
// What bounds it on the H100: at the main path's shapes (hd 64/128, S up
// to 4096) the FLOPs.  4·Sq·Sk·hd per head against reading Q, K, V once is
// hundreds of operations per byte, above the card's ~295 (bf16).  This
// first version computes in SIMT f32 FMAs (67 TFLOP/s peak) instead of the
// tensor cores, so it sits far above its bf16 bound; wgmma is a later PR.
//
// Design: one block = 64 query rows of one (batch, kv head), taken from the
// flattened (G x Sq) rows of that kv head, so a GQA group shares each K/V
// tile it loads.  Tiles of 64 keys are staged in shared memory; the online
// softmax and P·V run there (attention_tile.cuh).  Ragged Sq, Sk, hd and
// hdv are masked in the kernel: nothing is padded in device memory.
#include "attention_tile.cuh"

namespace repro {

constexpr int FLASH_ROWS = 64;

template <typename T, int HDT>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, AttnShape sh) {
  extern __shared__ float smem[];
  AttnCore<T, FLASH_ROWS, HDT> core(smem, sh);
  using S = typename AttnCore<T, FLASH_ROWS, HDT>::S;
  core.load_q(q);
  const T* kb = k + (size_t)(core.b * sh.Hkv + core.kvh) * sh.Sk * sh.hd;
  const T* vb = v + (size_t)(core.b * sh.Hkv + core.kvh) * sh.Sk * sh.hdv;
  int nkb = (sh.Sk + BK - 1) / BK;
  for (int j = 0; j < nkb; ++j) {
    __syncthreads();  // the previous tile's P·V is done with k_s, v_s, p_s
    for (int idx = threadIdx.x; idx < BK * HDT; idx += THREADS) {
      int c = idx / HDT, d = idx % HDT, kpos = j * BK + c;
      bool in = kpos < sh.Sk;
      core.k_s[c * S::KS + d] =
          in && d < sh.hd ? to_f(kb[(size_t)kpos * sh.hd + d]) : 0.f;
      core.v_s[c * S::KS + d] =
          in && d < sh.hdv ? to_f(vb[(size_t)kpos * sh.hdv + d]) : 0.f;
    }
    __syncthreads();
    core.scores(j);
    __syncthreads();
    core.softmax();
    __syncthreads();
    core.pv();
  }
  __syncthreads();
  core.store(out);
}

template <typename T, int HDT>
int launch(const void* q, const void* k, const void* v, void* out,
           const AttnShape& sh, cudaStream_t stream) {
  size_t smem = sizeof(float) * AttnSmem<FLASH_ROWS, HDT>::FLOATS;
  return launch_attention(flash_kernel<T, HDT>, FLASH_ROWS, smem, sh, stream,
                          (const T*)q, (const T*)k, (const T*)v, (T*)out, sh);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const AttnShape& sh, cudaStream_t stream) {
  int w = sh.hd > sh.hdv ? sh.hd : sh.hdv;
  if (w <= 32) return launch<T, 32>(q, k, v, out, sh, stream);
  if (w <= 64) return launch<T, 64>(q, k, v, out, sh, stream);
  return launch<T, 128>(q, k, v, out, sh, stream);
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous; hd, hdv <= 128
// (the Python wrapper checks).  Returns cudaGetLastError() of the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int Hq, int Hkv, int Sq, int Sk, int hd, int hdv, float scale, int causal,
    int window, int q_offset, int kv_len, void* stream) {
  repro::AttnShape sh{B, Hq, Hkv, Sq, Sk, hd, hdv, scale,
                      causal, window, q_offset, kv_len};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return repro::dispatch<float>(q, k, v, out, sh, s);
  return repro::dispatch<__nv_bfloat16>(q, k, v, out, sh, s);
}
