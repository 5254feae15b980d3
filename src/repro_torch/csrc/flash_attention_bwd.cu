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
// What bounds it on the H100: the FLOPs, five products of 2·Sq·Sk·hd per
// (batch, head) over the live pairs.
//
// Three routes (the `route` argument; kernels/flash_vjp.py picks it): tc
// and simt, three launches each, and wide (heads over 128, MLA's latent
// widths; bf16: attention_bwd_wide_tc.cuh, 1 + 4 launches per group of
// query heads; f32: attention_bwd_wide.cuh, 1 + 3; their own comments):
//   delta          delta = rowsum(dO * O)                       (B, Hq, Sq)
//   dK/dV kernel   one block per (kv tile of 64 keys, kv head, batch): K_j
//                  and V_j stay in shared memory while the block walks the
//                  live 64-row query spans of all G heads of the kv head,
//                  accumulating dK_j and dV_j; each key's gradient is
//                  written once, by its block: no atomics.
//   dQ kernel      tc: one block per 128 flattened (G x Sq) query rows of a
//                  kv head (a GQA group shares each K/V tile); simt: one
//                  block per (64 query rows, query head); each walks its
//                  live kv tiles, accumulating dQ.
// tc (bf16; attention_bwd_tc.cuh, tcb:: below): wgmma on TMA-fed tiles, P
// and dS as bf16 hi + lo; S and dP are computed in both passes (the split
// design runs 10 products of 64 x 64 x hd for the function's 5, and the
// lo halves on top).  simt (f32, and bf16 shapes TMA cannot read): the
// first port's kernels, f32 FMAs on the SIMT core of attention_bwd.cuh.
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
  static unsigned long long done_kv = 0, done_q = 0;
  if ((err = set_smem(kkv, smem, done_kv)) || (err = set_smem(kq, smem, done_q)))
    return err;
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

#include "attention_bwd_tc.cuh"

namespace repro {
namespace tcb {

constexpr int FLASH_STAGES = 4;
constexpr int FLUSH_SPANS = 4;     // dK/dV: a warpgroup's spans a flush
constexpr int BAR_TURN0 = 3;       // named barriers of the flushes' turns
constexpr int BAR_TURN1 = 4;

template <int HDP, int HDVP>
struct FlashBwdSmem {
  static constexpr int K_BYTES = (HDP / 64) * BOX_BYTES;   // 64 rows
  static constexpr int V_BYTES = (HDVP / 64) * BOX_BYTES;
  // dK/dV pass: the block's K and V, the ring of spans (Q, dO, lse, delta)
  // in as many stages (up to 4) as fit beside the f32 totals of dK and dV
  static constexpr int SPAN = K_BYTES + V_BYTES + LSE_BYTES;
  static constexpr int DKV_RING = K_BYTES + V_BYTES;
  static constexpr int TOT_BYTES = (HDP + HDVP) / 2 * WGT * 4;
  static constexpr int DKV_FIXED = DKV_RING + TOT_BYTES + 1024 + 128;
  static constexpr int DKV_STAGES =
      DKV_FIXED + 4 * SPAN <= 232448 ? 4 : DKV_FIXED + 3 * SPAN <= 232448 ? 3 : 2;
  static constexpr int DKV_TOT = DKV_RING + DKV_STAGES * SPAN;
  static constexpr int DKV_BARS = DKV_TOT + TOT_BYTES;
  static constexpr int DKV_BYTES = DKV_BARS + (2 * DKV_STAGES + 1) * 8 + 1024;
  static_assert(DKV_BYTES <= 232448, "dK/dV shared memory");
  // dQ pass: the block's dO (128 rows), then the ring of K/V tiles
  static constexpr int DO_BYTES = 2 * V_BYTES;
  static constexpr int KV = K_BYTES + V_BYTES;
  static constexpr int DQ_BARS = DO_BYTES + FLASH_STAGES * KV;
  static constexpr int DQ_BYTES = DQ_BARS + (2 * FLASH_STAGES + 1) * 8 + 1024;
};

// A warpgroup's turn at the dK/dV totals after a group of spans: warpgroup
// 0 adds its accumulators once warpgroup 1 added those of the group before
// (none before the first), warpgroup 1 once warpgroup 0 added this group's.
template <class Acc>
__device__ __forceinline__ void flush_turn(Acc& acc, float* tot, int wg,
                                           int done) {
  if (wg == 0) {
    if (done) named_sync(BAR_TURN1, CONSUMERS);
    acc.flush(tot);
    named_arrive(BAR_TURN0, CONSUMERS);
  } else {
    named_sync(BAR_TURN0, CONSUMERS);
    acc.flush(tot);
    named_arrive(BAR_TURN1, CONSUMERS);
  }
}

// dK/dV: one block per (kv tile j of 64 keys, kv head, batch).  K_j and V_j
// arrive by TMA once and stay; the producer warp brings each live query
// span of the G query heads (Q, dO by TMA; lse, delta by its lanes) into a
// ring of DKV_STAGES stages; span i goes to warpgroup i % 2.  After every
// 2 x FLUSH_SPANS spans (and after the last) warpgroup 0, then warpgroup
// 1, adds its accumulators to the block's f32 totals in shared memory
// (DkvAcc::flush), so no accumulator sums more than FLUSH_SPANS spans.
template <int HDP, int HDVP>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_tc(const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap domap,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk, bf16* __restrict__ dv, AttnShape sh) {
  using L = FlashBwdSmem<HDP, HDVP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full = base + L::DKV_BARS, empty = full + 8 * L::DKV_STAGES;
  const uint32_t kvbar = empty + 8 * L::DKV_STAGES;
  const int j = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = sh.Hq / sh.Hkv;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::DKV_STAGES; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, WGT);   // one warpgroup consumes a span
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {             // producer warpgroup
    setmaxnreg_dec<24>();
    if (threadIdx.x >= CONSUMERS + 32) return;
    const int lane = threadIdx.x % 32, bkv = b * sh.Hkv + kvh;
    if (lane == 0) {
      mbar_expect_tx(kvbar, L::K_BYTES + L::V_BYTES);
      for (int c = 0; c < HDP / 64; ++c)
        tma_load_3d(base + c * BOX_BYTES, &kmap, kvbar, 64 * c, j * BK, bkv);
      for (int c = 0; c < HDVP / 64; ++c)
        tma_load_3d(base + L::K_BYTES + c * BOX_BYTES, &vmap, kvbar, 64 * c,
                    j * BK, bkv);
    }
    int it = 0;
    for (int g = 0; g < G; ++g)
      for (int q0 = 0; q0 < sh.Sq; q0 += bwd::BQ) {
        if (!span_live(sh, g, q0, j)) continue;
        const int st = it % L::DKV_STAGES, ph = (it / L::DKV_STAGES) & 1;
        if (it >= L::DKV_STAGES) mbar_wait(empty + 8 * st, ph ^ 1);
        const uint32_t qs = base + L::DKV_RING + st * L::SPAN;
        const uint32_t dos = qs + L::K_BYTES, ls = dos + L::V_BYTES;
        const int bh = b * sh.Hq + kvh * G + g;
        load_lse(reinterpret_cast<float*>(gbase + (ls - base)), lse, delta,
                 (size_t)bh * sh.Sq, q0, sh.Sq, lane);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * st, L::K_BYTES + L::V_BYTES);
          for (int c = 0; c < HDP / 64; ++c)
            tma_load_3d(qs + c * BOX_BYTES, &qmap, full + 8 * st, 64 * c, q0, bh);
          for (int c = 0; c < HDVP / 64; ++c)
            tma_load_3d(dos + c * BOX_BYTES, &domap, full + 8 * st, 64 * c, q0, bh);
        } else {
          mbar_arrive(full + 8 * st);
        }
        ++it;
      }
  } else {                                    // consumer warpgroups
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / WGT;
    float* tot = reinterpret_cast<float*>(gbase + L::DKV_TOT);
    for (int i = threadIdx.x; i < L::TOT_BYTES / 4; i += CONSUMERS) tot[i] = 0.f;
    named_sync(BAR_PAIR, CONSUMERS);
    DkvAcc<HDP, HDVP, false> acc;
    acc.zero();
    int flushed = 0;
    mbar_wait(kvbar, 0);
    int it = 0;
    for (int g = 0; g < G; ++g)
      for (int q0 = 0; q0 < sh.Sq; q0 += bwd::BQ) {
        if (!span_live(sh, g, q0, j)) continue;
        if (it % 2 == wg) {
          const int st = it % L::DKV_STAGES, ph = (it / L::DKV_STAGES) & 1;
          const uint32_t qs = base + L::DKV_RING + st * L::SPAN;
          const uint32_t dos = qs + L::K_BYTES, ls = dos + L::V_BYTES;
          mbar_wait(full + 8 * st, ph);
          acc.span(sh, j * BK, q0, base, 0, base + L::K_BYTES, 0, qs, dos,
                   reinterpret_cast<const float*>(gbase + (ls - base)));
          mbar_arrive(empty + 8 * st);
        }
        if (++it % (2 * FLUSH_SPANS) == 0) flush_turn(acc, tot, wg, flushed++);
      }
    if (it % (2 * FLUSH_SPANS)) flush_turn(acc, tot, wg, flushed++);
    // warpgroup 0 waits for warpgroup 1's last flush; warpgroup 1's came
    // after every other
    if (wg == 0 && flushed) named_sync(BAR_TURN1, CONSUMERS);
    const int tid = threadIdx.x % WGT;
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc.dk[i] = tot[i * WGT + tid];
    } else {
#pragma unroll
      for (int i = 0; i < HDVP / 2; ++i) acc.dv[i] = tot[(HDP / 2 + i) * WGT + tid];
    }
    const Frag f;
    const size_t kb = (size_t)(b * sh.Hkv + kvh) * sh.Sk;
    // warpgroup 0 writes dK, warpgroup 1 dV
    bf16* dst = wg == 0 ? dk : dv;
    const int width = wg == 0 ? sh.hd : sh.hdv;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kpos = j * BK + f.r0 + 8 * h;
      if (kpos >= sh.Sk) continue;
      bf16* row = dst + (kb + kpos) * width;
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < HDP / 8; ++i) {
          const int col = 8 * i + 2 * f.t;
          if (col < width)
            *reinterpret_cast<uint32_t*>(row + col) =
                pack_bf16(acc.dk[4 * i + 2 * h], acc.dk[4 * i + 2 * h + 1]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < HDVP / 8; ++i) {
          const int col = 8 * i + 2 * f.t;
          if (col < width)
            *reinterpret_cast<uint32_t*>(row + col) =
                pack_bf16(acc.dv[4 * i + 2 * h], acc.dv[4 * i + 2 * h + 1]);
        }
      }
    }
  }
}

// dQ: one block per 128 flattened (G x Sq) query rows of one (kv head,
// batch), two warpgroups of 64; dO of the block by TMA once, the live kv
// tiles (the forward's rule for the block's rows) through a ring.
template <int HDP, int HDVP>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_tc(const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const __grid_constant__ CUtensorMap domap,
            const bf16* __restrict__ q, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dq,
            AttnShape sh) {
  using L = FlashBwdSmem<HDP, HDVP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + L::DQ_BARS, empty = full + 8 * FLASH_STAGES;
  const uint32_t dobar = empty + 8 * FLASH_STAGES;
  const int G = sh.Hq / sh.Hkv, nrows = G * sh.Sq;
  const int nrt = (nrows + ROWS - 1) / ROWS;
  // causal: the last row tiles (the longest live ranges) start first
  const int rt = sh.causal ? nrt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int t0 = rt * ROWS, kvh = blockIdx.y, b = blockIdx.z;
  int qmin = 0, qmax = 0;
  bool any = q_span(t0, min(t0 + ROWS, nrows), sh, qmin, qmax);
  const KvRange kv = live_kv_tiles(sh, any, qmin, qmax);
  if (threadIdx.x == 0) {
    for (int s = 0; s < FLASH_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init(dobar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {             // producer warpgroup
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      const int bh = b * sh.Hkv + kvh;
      const int row0 = (b * sh.Hq + kvh * G) * sh.Sq + t0;
      mbar_expect_tx(dobar, L::DO_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < HDVP / 64; ++c)
          tma_load_2d(base + (w * (HDVP / 64) + c) * BOX_BYTES, &domap, dobar,
                      64 * c, row0 + 64 * w);
      for (int j = kv.lo, it = 0; j < kv.hi; ++j, ++it) {
        const int st = it % FLASH_STAGES, ph = (it / FLASH_STAGES) & 1;
        if (it >= FLASH_STAGES) mbar_wait(empty + 8 * st, ph ^ 1);
        const uint32_t kst = base + L::DO_BYTES + st * L::KV;
        const uint32_t vst = kst + L::K_BYTES;
        mbar_expect_tx(full + 8 * st, L::KV);
        for (int c = 0; c < HDP / 64; ++c)
          tma_load_3d(kst + c * BOX_BYTES, &kmap, full + 8 * st, 64 * c, j * BK, bh);
        for (int c = 0; c < HDVP / 64; ++c)
          tma_load_3d(vst + c * BOX_BYTES, &vmap, full + 8 * st, 64 * c, j * BK, bh);
      }
    }
  } else {                                    // consumer warpgroups
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / WGT;
    DqRows<HDP, HDVP, false> rows;
    rows.init(q, lse, delta, sh, b, kvh, t0 + 64 * wg);
    const uint32_t dos = base + wg * (HDVP / 64) * BOX_BYTES;
    mbar_wait(dobar, 0);
    for (int j = kv.lo, it = 0; j < kv.hi; ++j, ++it) {
      const int st = it % FLASH_STAGES, ph = (it / FLASH_STAGES) & 1;
      const uint32_t kst = base + L::DO_BYTES + st * L::KV;
      mbar_wait(full + 8 * st, ph);
      rows.tile(sh, j, kst, 0, kst + L::K_BYTES, 0, dos);
      mbar_arrive(empty + 8 * st);
    }
    rows.store(dq, sh, b, t0 + 64 * wg);
  }
}

template <int HDP, int HDVP>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const AttnShape& sh, cudaStream_t stream) {
  using L = FlashBwdSmem<HDP, HDVP>;
  int err = bwd::launch_delta<bf16>(out, dout, delta, sh.B * sh.Hq * sh.Sq,
                                    sh.hdv, stream);
  if (err) return err;
  const uint64_t bkv = (uint64_t)sh.B * sh.Hkv, bq = (uint64_t)sh.B * sh.Hq;
  CUtensorMap kmap, vmap, qmap, domap, do2;
  if ((err = make_map(&kmap, k, sh.hd, sh.Sk, bkv, (uint64_t)sh.hd * 2,
                      (uint64_t)sh.Sk * sh.hd * 2, BK, 1)) ||
      (err = make_map(&vmap, v, sh.hdv, sh.Sk, bkv, (uint64_t)sh.hdv * 2,
                      (uint64_t)sh.Sk * sh.hdv * 2, BK, 1)) ||
      (err = make_map(&qmap, q, sh.hd, sh.Sq, bq, (uint64_t)sh.hd * 2,
                      (uint64_t)sh.Sq * sh.hd * 2, 64, 1)) ||
      (err = make_map(&domap, dout, sh.hdv, sh.Sq, bq, (uint64_t)sh.hdv * 2,
                      (uint64_t)sh.Sq * sh.hdv * 2, 64, 1)) ||
      (err = make_map_2d(&do2, dout, sh.hdv, bq * sh.Sq, (uint64_t)sh.hdv * 2,
                         64)))
    return err;
  auto kkv = flash_dkv_tc<HDP, HDVP>;
  auto kq = flash_dq_tc<HDP, HDVP>;
  static unsigned long long done_kv = 0, done_q = 0;
  if ((err = bwd::set_smem(kkv, L::DKV_BYTES, done_kv)) ||
      (err = bwd::set_smem(kq, L::DQ_BYTES, done_q)))
    return err;
  if (sh.Sk > 0) {
    kkv<<<dim3((sh.Sk + BK - 1) / BK, sh.Hkv, sh.B), THREADS, L::DKV_BYTES,
          stream>>>(kmap, vmap, qmap, domap, lse, delta, (bf16*)dk, (bf16*)dv,
                    sh);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (sh.Sq > 0) {
    const int G = sh.Hq / sh.Hkv;
    kq<<<dim3((G * sh.Sq + ROWS - 1) / ROWS, sh.Hkv, sh.B), THREADS,
         L::DQ_BYTES, stream>>>(kmap, vmap, do2, (const bf16*)q, lse, delta,
                                (bf16*)dq, sh);
    err = (int)cudaGetLastError();
  }
  return err;
}

// The tc route's rule: hd and hdv multiples of 8 up to 128 (the forward's
// tc core), every tensor 16-byte aligned for TMA.
inline bool takes(const AttnShape& sh, const void* q, const void* k,
                  const void* v, const void* dout) {
  return sh.hd % 8 == 0 && sh.hdv % 8 == 0 && sh.hd <= 128 && sh.hdv <= 128 &&
         tma_ok(q, sh.hd) && tma_ok(k, sh.hd) && tma_ok(v, sh.hdv) &&
         tma_ok(dout, sh.hdv);
}

inline int dispatch(const void* q, const void* k, const void* v,
                    const void* out, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv,
                    const AttnShape& sh, cudaStream_t stream) {
  if (!takes(sh, q, k, v, dout)) return (int)cudaErrorInvalidValue;
  const bool k64 = sh.hd <= 64, v64 = sh.hdv <= 64;
  if (k64 && v64)
    return launch<64, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, sh, stream);
  if (k64)
    return launch<64, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, sh, stream);
  if (v64)
    return launch<128, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, sh, stream);
  return launch<128, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, sh, stream);
}

}  // namespace tcb
}  // namespace repro

#include "attention_bwd_wide_tc.cuh"   // and attention_bwd_wide.cuh

// route: 0 = simt (both dtypes), 1 = tc (bf16, where tcb::takes holds: the
// call fails with cudaErrorInvalidValue otherwise), 2 = wide (both dtypes,
// a head over 128: q/k <= 576, v <= 512; bf16 where wbwd::tc_ok holds, the
// call fails with cudaErrorInvalidValue otherwise; `scratch` holds
// flash_attention_bwd_wide_scratch(..., gc) floats and the query heads of
// each kv head go in groups of gc; the other routes read neither; bf16 on
// attention_bwd_wide_tc.cuh's kernels, f32 on the SIMT ones), 3 = the wide
// route's first bf16 kernels (mma.sync, attention_bwd_wide.cuh: the
// parent, reachable only here, for timing).  dtype:
// 0 = float32, 1 = bfloat16 (q, k, v, out, dout and the gradients dq, dk,
// dv).  lse (B, Hq, Sq) f32 from the forward; delta (B, Hq, Sq) f32
// scratch.  All tensors contiguous; simt and tc take hd, hdv <= 128 (the
// Python wrapper checks).  Returns the CUDA error code of the launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, void* scratch, int route, int dtype, int B, int Hq, int Hkv,
    int Sq, int Sk, int hd, int hdv, float scale, int causal, int window,
    int q_offset, int kv_len, int gc, void* stream) {
  repro::AttnShape sh{B, Hq, Hkv, Sq, Sk, hd, hdv, scale,
                      causal, window, q_offset, kv_len};
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 2 || route == 3) {
    if (!repro::wbwd::takes(sh) || gc < 1) return (int)cudaErrorInvalidValue;
    float* scr = (float*)scratch;
    if (dtype == 0 && route == 2)
      return repro::wbwd::launch<float>(q, k, v, out, dout, lse, delta, dq,
                                        dk, dv, scr, gc, sh, s);
    if (dtype != 1 || !repro::wbwd::tc_ok(sh, q, k, v, dout))
      return (int)cudaErrorInvalidValue;
    if (route == 3)
      return repro::wbwd::launch<__nv_bfloat16>(q, k, v, out, dout, lse,
                                                delta, dq, dk, dv, scr, gc, sh,
                                                s);
    return repro::wbwd::launch_wg(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                  scr, gc, sh, s);
  }
  if (route == 1)
    return dtype == 1 ? repro::tcb::dispatch(q, k, v, out, dout, lse, delta,
                                             dq, dk, dv, sh, s)
                      : (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return repro::bwd::dispatch<float>(q, k, v, out, dout, lse, delta, dq, dk,
                                       dv, sh, s);
  return repro::bwd::dispatch<__nv_bfloat16>(q, k, v, out, dout, lse, delta,
                                             dq, dk, dv, sh, s);
}

// f32 scratch of the wide route, in floats, for groups of gc query heads
// (the most any of its kernels needs: the bf16 kernels' split partials on
// top of P and dS).
extern "C" long long flash_attention_bwd_wide_scratch(int B, int Hq, int Hkv,
                                                      int Sq, int Sk, int hd,
                                                      int hdv, int gc) {
  repro::AttnShape sh{B, Hq, Hkv, Sq, Sk, hd, hdv, 1.f, 0, 0, 0, Sk};
  const size_t a = repro::wbwd::scratch_floats(sh, gc);
  const size_t b = repro::wbwd::wg_scratch_floats(sh, gc);
  return (long long)(a > b ? a : b);
}

// The dK/dV blocks a key tile of the wide route's bf16 kernels for a group
// of gc query heads (blocked.flash_bwd_wide_splits mirrors it).
extern "C" int flash_attention_bwd_wide_splits(int gc) {
  return repro::wbwd::dkv_splits(gc);
}

// The route rule for the shapes (2 = wide, 1 = tc, 0 = simt), with every
// tensor 16-byte aligned: the rule blocked.flash_bwd_route mirrors.
extern "C" int flash_attention_bwd_route(int dtype, int hd, int hdv) {
  repro::AttnShape sh{1, 1, 1, 1, 1, hd, hdv, 1.f, 0, 0, 0, 1};
  static const uint4 aligned[1] = {};
  if (hd > 128 || hdv > 128) return 2;
  return dtype == 1 && repro::tcb::takes(sh, aligned, aligned, aligned, aligned);
}
