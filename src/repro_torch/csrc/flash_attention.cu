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
// nothing is padded in device memory.  Heads over 128 wide (MLA's absorbed
// attention: q/k 576, v 512) take the tensor-core wide route of
// attention_wide.cuh.
//
// TMA needs hd and hdv multiples of 8 (16-byte rows); other widths, and f32
// inputs at every width up to q/k 576 and v 512, take the SIMT kernel below
// (one block per 64 rows, Q whole, K and V in 64-column chunks).
#include "attention_wide.cuh"   // attention_tc.cuh, attention_tile.cuh

namespace repro {

constexpr int FLASH_ROWS = 64;   // query rows per block of the SIMT kernel
constexpr int CS = BK + 1;        // row stride of a 64-column K or V chunk

// Shared memory of the SIMT kernel, in floats: Q whole (its width rounded up
// to 64 columns), one chunk of K and one of V, P, and m, l, alpha per row.
// Row strides are padded by one float so that threads of a warp reading a
// column hit distinct banks.
inline int simt_smem_floats(int hd) {
  const int qs = (hd + BK - 1) / BK * BK + 1;
  return FLASH_ROWS * qs + 2 * BK * CS + FLASH_ROWS * CS + 3 * FLASH_ROWS;
}

// The SIMT route: f32 inputs, and bf16 shapes the tensor-core kernels do not
// take.  256 threads own 64 query rows of one (batch, kv head); Q is staged
// whole in f32, K and V pass through 64-column chunks, S accumulates over
// the q/k chunks and each thread keeps 4 rows x VC * 4 output columns (VC:
// chunks of 64 v columns).  Every product is an f32 FMA (no TF32); live kv
// tiles only (live_kv_tiles).
template <typename T, int VC>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, AttnShape sh) {
  constexpr int RI = FLASH_ROWS / TX;       // query rows per thread
  extern __shared__ float smem[];
  const int qw = (sh.hd + BK - 1) / BK * BK, qs = qw + 1;
  float* q_s = smem;
  float* k_s = q_s + FLASH_ROWS * qs;
  float* v_s = k_s + BK * CS;
  float* p_s = v_s + BK * CS;
  float* m_s = p_s + FLASH_ROWS * CS;
  float* l_s = m_s + FLASH_ROWS;
  float* a_s = l_s + FLASH_ROWS;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int G = sh.Hq / sh.Hkv, nrows = G * sh.Sq;
  const int t0 = blockIdx.x * FLASH_ROWS, kvh = blockIdx.y, b = blockIdx.z;
  const T* kb = k + (size_t)(b * sh.Hkv + kvh) * sh.Sk * sh.hd;
  const T* vb = v + (size_t)(b * sh.Hkv + kvh) * sh.Sk * sh.hdv;

  // flattened row r of the block -> (query head, query index)
  auto row = [&](int r, int& head, int& qi) {
    const int t = t0 + r;
    head = kvh * G + t / sh.Sq;
    qi = t % sh.Sq;
    return t < nrows;
  };
  for (int idx = tid; idx < FLASH_ROWS * qw; idx += THREADS) {
    int r = idx / qw, d = idx % qw, head, qi;
    float val = 0.f;
    if (row(r, head, qi) && d < sh.hd)
      val = to_f(q[((size_t)(b * sh.Hq + head) * sh.Sq + qi) * sh.hd + d]);
    q_s[r * qs + d] = val;
  }
  for (int r = tid; r < FLASH_ROWS; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  int qpos[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    int head, qi;
    qpos[i] = (row(ty + TX * i, head, qi) ? qi : 0) + sh.q_offset;
  }
  int qmin = 0, qmax = 0;
  const bool any = tc::q_span(t0, min(t0 + FLASH_ROWS, nrows), sh, qmin, qmax);
  const tc::KvRange kv = tc::live_kv_tiles(sh, any, qmin, qmax);

  float acc[RI][VC * 4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < VC * 4; ++c) acc[i][c] = 0.f;

  for (int j = kv.lo; j < kv.hi; ++j) {
    // S = Q K^T over the q/k chunks of 64 columns
    float s[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    for (int d0 = 0; d0 < sh.hd; d0 += BK) {
      __syncthreads();  // the last chunk's products are done with k_s
      for (int idx = tid; idx < BK * BK; idx += THREADS) {
        int c = idx / BK, d = idx % BK, kpos = j * BK + c;
        k_s[c * CS + d] = kpos < sh.Sk && d0 + d < sh.hd
                              ? to_f(kb[(size_t)kpos * sh.hd + d0 + d])
                              : 0.f;
      }
      __syncthreads();
      for (int d = 0; d < BK; ++d) {
        float qv[RI], kk[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) qv[i] = q_s[(ty + TX * i) * qs + d0 + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kk[c] = k_s[(tx + TX * c) * CS + d];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kk[c], s[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int col = tx + TX * c, kpos = j * BK + col;
        bool ok = kpos < sh.kv_len;
        if (sh.causal) ok = ok && kpos <= qpos[i];
        if (sh.window > 0) ok = ok && kpos > qpos[i] - sh.window;
        p_s[(ty + TX * i) * CS + col] = ok ? s[i][c] * sh.scale : NEG_INF;
      }
    __syncthreads();
    // online softmax, one warp per row
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < FLASH_ROWS; r += NWARPS) {
      float* pr = p_s + r * CS;
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
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float alpha = a_s[ty + TX * i];
#pragma unroll
      for (int c = 0; c < VC * 4; ++c) acc[i][c] *= alpha;
    }
    // acc += P V over the v chunks of 64 columns
#pragma unroll
    for (int cv = 0; cv < VC; ++cv) {
      if (cv * BK >= sh.hdv) break;
      __syncthreads();  // the last chunk's products are done with v_s
      for (int idx = tid; idx < BK * BK; idx += THREADS) {
        int c = idx / BK, d = idx % BK, kpos = j * BK + c;
        v_s[c * CS + d] = kpos < sh.Sk && cv * BK + d < sh.hdv
                              ? to_f(vb[(size_t)kpos * sh.hdv + cv * BK + d])
                              : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < BK; ++kk) {
        float pk[RI], vk[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) pk[i] = p_s[(ty + TX * i) * CS + kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) vk[c] = v_s[kk * CS + tx + TX * c];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][cv * 4 + c] = fmaf(pk[i], vk[c], acc[i][cv * 4 + c]);
      }
    }
    __syncthreads();  // p_s and a_s are read before the next tile's scores
  }
  // out = acc / l.  A row with no live key weighed every one of the Sk keys
  // 1 (their V past Sk is 0): its mean is over the Sk keys; l == 0 only with
  // no key at all.
  __syncthreads();  // m_s and l_s, also when no tile was live
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    int r = ty + TX * i, head, qi;
    if (!row(r, head, qi)) continue;
    float l = m_s[r] == NEG_INF ? (float)sh.Sk : l_s[r];
    float l_safe = l == 0.f ? 1.f : l;
    if (sh.lse && tx == 0)
      sh.lse[(size_t)(b * sh.Hq + head) * sh.Sq + qi] = m_s[r] + logf(l_safe);
    T* o = out + ((size_t)(b * sh.Hq + head) * sh.Sq + qi) * sh.hdv;
#pragma unroll
    for (int cv = 0; cv < VC; ++cv)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int col = cv * BK + tx + TX * c;
        if (col < sh.hdv) o[col] = from_f<T>(acc[i][cv * 4 + c] / l_safe);
      }
  }
}

template <typename T, int VC>
int launch(const void* q, const void* k, const void* v, void* out,
           const AttnShape& sh, cudaStream_t stream) {
  return launch_attention(flash_kernel<T, VC>, FLASH_ROWS,
                          sizeof(float) * simt_smem_floats(sh.hd), sh, stream,
                          (const T*)q, (const T*)k, (const T*)v, (T*)out, sh);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const AttnShape& sh, cudaStream_t stream) {
  if (sh.hdv <= 64) return launch<T, 1>(q, k, v, out, sh, stream);
  if (sh.hdv <= 128) return launch<T, 2>(q, k, v, out, sh, stream);
  return launch<T, WIDE_V / BK>(q, k, v, out, sh, stream);
}

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

// The tensor-core route, or -1 when the shapes need the SIMT kernel.
inline int dispatch(const void* q, const void* k, const void* v, void* out,
                    const AttnShape& sh, cudaStream_t stream) {
  if (sh.hd % 8 || sh.hdv % 8 || !tma_ok(k, sh.hd) || !tma_ok(v, sh.hdv))
    return -1;
  if (sh.hd > 128 || sh.hdv > 128)
    return tma_ok(q, sh.hd) ? launch_wide(q, k, v, out, sh, stream) : -1;
  const bool k64 = sh.hd <= 64, v64 = sh.hdv <= 64;
  if (k64 && v64) return launch<64, 64>(q, k, v, out, sh, stream);
  if (k64) return launch<64, 128>(q, k, v, out, sh, stream);
  if (v64) return launch<128, 64>(q, k, v, out, sh, stream);
  return launch<128, 128>(q, k, v, out, sh, stream);
}

}  // namespace tc
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous; hd <= 576,
// hdv <= 512 (the Python wrapper checks).  bf16 takes the tensor-core kernel where TMA
// can read K and V, else the SIMT kernel.  lse: null, or (B, Hq, Sq) f32 that
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
