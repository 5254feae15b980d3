// LAYER_STREAM flash attention over materialized K/V, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py:105 (flash_attention /
// _flash_kernel), the Pallas TPU kernel.  Same function: GQA (query head h
// reads kv head h / G), keys at or past kv_len masked, causal with
// q_offset, sliding window, V width hdv that may differ from hd, f32
// arithmetic, output in q's dtype.
//
// What bounds it on the H100: the FLOPs.  4·Sq·Sk·hd per head against
// reading Q, K, V once is hundreds of operations per byte at the main
// path's shapes (hd 64/128, S up to 4096), above the card's ~295 (bf16).
//
// Design, bf16 (attention_tc.cuh): a block of 384 threads owns 128 query
// rows of one (batch, kv head), two consumer warpgroups of 64 rows, taken
// from the flattened (G x Sq) rows so that a GQA group shares each K/V
// tile.  One producer thread brings the live kv tiles of 64 keys by TMA
// (3-d maps over (hd, Sk, B·Hkv), zero past Sk and past hd) into a ring of
// four stages; Q·K^T and P·V run on the tensor cores (wgmma), P as
// P_hi + P_lo so that P·V keeps ~16 bits of the f32 P: the products are
// 1.5x the function's FLOPs.  Only the tiles [lo, hi) that hold a live key
// for some row of the block are loaded and computed (causal skips the upper
// triangle, a window everything outside it); causal blocks start with the
// longest ranges.  Ragged Sq, Sk, hd and hdv are masked in the kernel:
// nothing is padded in device memory.  TMA needs hd and hdv multiples of 8
// (16-byte rows); other widths, and f32 inputs, take the SIMT f32 core of
// attention_tile.cuh (one block per 64 rows, every kv tile).
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

#include "attention_tc.cuh"

namespace repro {
namespace tc {

constexpr int FLASH_STAGES = 4;

template <int HDP, int HDVP>
struct FlashSmem {
  static constexpr int K_BYTES = (HDP / 64) * BOX_BYTES;
  static constexpr int V_BYTES = (HDVP / 64) * BOX_BYTES;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int BARS = FLASH_STAGES * STAGE;   // full[], empty[]
  static constexpr int BYTES = BARS + 2 * FLASH_STAGES * 8 + 1024;  // + align
};

template <int HDP, int HDVP>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const bf16* __restrict__ q, bf16* __restrict__ out,
                AttnShape sh) {
  using L = FlashSmem<HDP, HDVP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + L::BARS, empty = full + 8 * FLASH_STAGES;
  const int G = sh.Hq / sh.Hkv, nrows = G * sh.Sq;
  const int nrt = (nrows + ROWS - 1) / ROWS;
  // causal: the last row tiles (the longest live ranges) start first
  const int rt = sh.causal ? nrt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int t0 = rt * ROWS, kvh = blockIdx.y, b = blockIdx.z;
  const int bh = b * sh.Hkv + kvh;
  int qmin = 0, qmax = 0;
  bool any = q_span(t0, min(t0 + ROWS, nrows), sh, qmin, qmax);
  const KvRange kv = live_kv_tiles(sh, any, qmin, qmax);
  if (threadIdx.x == 0) {
    for (int s = 0; s < FLASH_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {             // producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      for (int j = kv.lo, it = 0; j < kv.hi; ++j, ++it) {
        const int st = it % FLASH_STAGES, ph = (it / FLASH_STAGES) & 1;
        if (it >= FLASH_STAGES) mbar_wait(empty + 8 * st, ph ^ 1);
        const uint32_t kst = base + st * L::STAGE, vst = kst + L::K_BYTES;
        mbar_expect_tx(full + 8 * st, L::STAGE);
        for (int c = 0; c < HDP / 64; ++c)
          tma_load_3d(kst + c * BOX_BYTES, &kmap, full + 8 * st, 64 * c, j * BK, bh);
        for (int c = 0; c < HDVP / 64; ++c)
          tma_load_3d(vst + c * BOX_BYTES, &vmap, full + 8 * st, 64 * c, j * BK, bh);
      }
    }
  } else {                                    // consumer warpgroups
    setmaxnreg_inc<232>();
    TcRows<HDP, HDVP> rows;
    rows.init(q, sh, b, kvh, t0 + 64 * (threadIdx.x / 128));
    for (int j = kv.lo, it = 0; j < kv.hi; ++j, ++it) {
      const int st = it % FLASH_STAGES, ph = (it / FLASH_STAGES) & 1;
      const uint32_t kst = base + st * L::STAGE, vst = kst + L::K_BYTES;
      mbar_wait(full + 8 * st, ph);
      rows.template tile<false>(sh, j, kst, 0, vst, 0);
      mbar_arrive(empty + 8 * st);
    }
    rows.store(out, sh, b);
  }
}

template <int HDP, int HDVP>
int launch(const void* q, const void* k, const void* v, void* out,
           const AttnShape& sh, cudaStream_t stream) {
  using L = FlashSmem<HDP, HDVP>;
  CUtensorMap kmap, vmap;
  const uint64_t bh = (uint64_t)sh.B * sh.Hkv;
  int err = make_map(&kmap, k, sh.hd, sh.Sk, bh, (uint64_t)sh.hd * 2,
                     (uint64_t)sh.Sk * sh.hd * 2, BK, 1);
  if (!err)
    err = make_map(&vmap, v, sh.hdv, sh.Sk, bh, (uint64_t)sh.hdv * 2,
                   (uint64_t)sh.Sk * sh.hdv * 2, BK, 1);
  if (err) return err;
  auto kernel = flash_tc_kernel<HDP, HDVP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int G = sh.Hq / sh.Hkv;
  dim3 grid((G * sh.Sq + ROWS - 1) / ROWS, sh.Hkv, sh.B);
  kernel<<<grid, THREADS, L::BYTES, stream>>>(
      kmap, vmap, (const bf16*)q, (bf16*)out, sh);
  return (int)cudaGetLastError();
}

// The tensor-core route, or -1 when the shapes need the SIMT core.
inline int dispatch(const void* q, const void* k, const void* v, void* out,
                    const AttnShape& sh, cudaStream_t stream) {
  if (sh.hd % 8 || sh.hdv % 8 || !tma_ok(k, sh.hd) || !tma_ok(v, sh.hdv))
    return -1;
  const bool k64 = sh.hd <= 64, v64 = sh.hdv <= 64;
  if (k64 && v64) return launch<64, 64>(q, k, v, out, sh, stream);
  if (k64) return launch<64, 128>(q, k, v, out, sh, stream);
  if (v64) return launch<128, 64>(q, k, v, out, sh, stream);
  return launch<128, 128>(q, k, v, out, sh, stream);
}

}  // namespace tc
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous; hd, hdv <= 128
// (the Python wrapper checks).  bf16 takes the tensor-core kernel where TMA
// can read K and V, else the SIMT core.  lse: null, or (B, Hq, Sq) f32 that
// receives m + log l of every query row (the training path's residual).
// Returns cudaGetLastError() of the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int Hq, int Hkv, int Sq, int Sk, int hd, int hdv, float scale, int causal,
    int window, int q_offset, int kv_len, float* lse, void* stream) {
  repro::AttnShape sh{B, Hq, Hkv, Sq, Sk, hd, hdv, scale,
                      causal, window, q_offset, kv_len, lse};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return repro::dispatch<float>(q, k, v, out, sh, s);
  int rc = repro::tc::dispatch(q, k, v, out, sh, s);
  if (rc >= 0) return rc;
  return repro::dispatch<__nv_bfloat16>(q, k, v, out, sh, s);
}

// The kv tiles [*lo, *hi) of 64 keys that the bf16 tensor-core kernels walk
// for the flattened (G x Sq) query rows [r0, r1) of a kv head: the rule the
// Python mirror blocked.live_kv_tiles copies.
extern "C" int flash_attention_live_tiles(int r0, int r1, int Sq, int Sk,
                                          int kv_len, int causal, int window,
                                          int q_offset, int* lo, int* hi) {
  repro::AttnShape sh{1, 1, 1, Sq, Sk, 0, 0, 0.f,
                      causal, window, q_offset, kv_len};
  int qmin = 0, qmax = 0;
  const bool any = repro::tc::q_span(r0, r1, sh, qmin, qmax);
  const repro::tc::KvRange kv = repro::tc::live_kv_tiles(sh, any, qmin, qmax);
  *lo = kv.lo;
  *hi = kv.hi;
  return 0;
}
