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
// valid keys over 3.35 TB/s.  At qwen3-32b's decode (B <= 4, 8 kv heads,
// ~1000-1500 valid keys) that is a few microseconds, so what a call costs
// is latency: how soon every SM has loads in flight, and how short the
// tail after the last load is.
//
// Two routes, picked by the caller (the wrapper): tc for bf16 with
// G <= 16 and 16-byte aligned q, k, v; simt otherwise (f32, and the bf16
// shapes tc does not take).
//
// tc (the bf16 route), one launch:
// * one block of 4 warps per (W split, kv head, batch row).  W is cut into
//   splits of whole 64-key tiles, decode_attention_splits(W, Hkv) of them:
//   enough that Hkv x splits fills the card's 132 SMs at B = 1 (qwen3-32b:
//   16 splits of two tiles; hymba-1.5b's ring: 16 of one).  The rule
//   never looks at B;
// * a block loads only the tiles of its split that hold a valid key, and
//   a split with none returns at once; the K/V tiles stay bf16 and come
//   through a ring of cp.async stages (16-byte copies, rows past W
//   zero-filled), K and V as separate groups so that the scores are
//   computed while V is still in flight;
// * products on the tensor cores, mma.sync m16n8k16: S = Q K^T with the
//   G query rows padded to 16 as the rows and the keys as the columns,
//   q and K entering as the bf16 they are; then O += P V with P split
//   into bf16 hi + lo (two products: P in bf16 alone misses the one-ulp
//   limit).  Every warp computes the scores of the whole tile and its own
//   quarter of the head width of O, so the softmax needs no exchange
//   between warps;
// * a split writes its (m, l, acc) partial; the last block of a (batch
//   row, kv head) to finish (a ticket it resets) merges the row's live
//   splits online in split order and writes the output.  A row with one live
//   split writes its output directly.  Everything a row computes depends
//   on that row alone: a row of a batched call equals the B = 1 call
//   bitwise.
//
// simt (f32; the first port's kernel, kept as it was): one block per
// (kv head, batch row, 256-key chunk) streaming 64-key tiles through
// shared memory as f32 with an online softmax in SIMT FMAs, then a second
// launch merging the chunks.  Its bf16 instantiation is reachable through
// the C interface for timing the parent kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "launch_record.cuh"
#include "warp_mma.cuh"

namespace {

using repro::wm::bf16;

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;       // keys per tile (both routes)

struct DecShape {
  int B, Hq, Hkv, W, hd, window, nsplit, per, clen0;
  float scale;
};

__device__ __forceinline__ int row_len(const int* clen, int b, int clen0) {
  return clen ? clen[b] : clen0;
}

// cudaFuncSetAttribute once per kernel instantiation and device.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1ull)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

// ============================ tc route (bf16) ============================

constexpr int TC_THREADS = 128;       // 4 warps
constexpr int TC_STAGES = 2;          // K/V tiles in flight per block
constexpr int QROWS = 16;             // query rows of the mma tile
constexpr int SPLIT_BLOCKS = 132;     // (kv head, split) blocks at B = 1
constexpr int MAX_TC_GROUP = QROWS;
constexpr int MERGE_BATCH = 8;        // splits a merging thread loads at once

// (splits, tiles per split) of a cache of width W with Hkv kv heads:
// enough splits that Hkv x splits reaches SPLIT_BLOCKS where the tiles
// allow it, whole tiles each, none empty.  Mirrored by
// kernels/blocked.py's decode_splits.
inline void tc_splits(int W, int Hkv, int& splits, int& per) {
  const int tiles = (W + BK - 1) / BK;
  int S = (SPLIT_BLOCKS + Hkv - 1) / Hkv;
  if (S > tiles) S = tiles;
  per = (tiles + S - 1) / S;
  splits = (tiles + per - 1) / per;
}

// Shared memory of a block, in bf16: q (QROWS, LD), then the ring of
// stages x (K tile, V tile), each (BK, LD).  Rows are padded by 16 bytes
// so that ldmatrix's eight row addresses fall in distinct banks.
template <int HDP>
struct TcSmem {
  static constexpr int LD = HDP + 8;
  static constexpr int TILE = BK * LD;
  static constexpr size_t bytes(int stages) {
    return sizeof(bf16) * (size_t)(QROWS * LD + 2 * stages * TILE);
  }
};

// Rows [r0, r0 + n) of a (rows, hd) bf16 matrix into an (n, HDP) tile:
// 16-byte copies, rows past `rows` and columns past hd zero-filled.
template <int HDP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int n, int rows, int hd) {
  constexpr int CH = HDP / 8;
  for (int i = threadIdx.x; i < n * CH; i += TC_THREADS) {
    const int r = i / CH, c = i - r * CH;
    const bool in = r0 + r < rows && c * 8 < hd;
    repro::wm::cp_async16(dst + r * TcSmem<HDP>::LD + c * 8,
                          in ? src + (size_t)(r0 + r) * hd + c * 8 : src,
                          in ? 16 : 0);
  }
}

template <int HDP>
__global__ void __launch_bounds__(TC_THREADS, 4)
decode_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const int* __restrict__ clen,
          bf16* __restrict__ out, float* __restrict__ part,
          int* __restrict__ ticket, DecShape sh, int stages) {
  using S = TcSmem<HDP>;
  constexpr int LD = S::LD, KSTEPS = HDP / 16, NTW = HDP / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + QROWS * LD;
  bf16* vs = ks + stages * S::TILE;
  __shared__ int last;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = sh.Hq / sh.Hkv, hd = sh.hd;
  const size_t row0 = (size_t)b * sh.Hq + (size_t)kvh * G;

  // The row's valid keys [lo, hi), its live tiles and live splits.
  const int len = row_len(clen, b, sh.clen0);
  const int hi = min(len, sh.W);
  const int lo = sh.window > 0 ? max(0, len - sh.window) : 0;
  if (hi <= lo) {                       // no valid key: split 0 writes 0
    if (split == 0)
      for (int i = tid; i < G * hd; i += TC_THREADS)
        out[row0 * hd + i] = __float2bfloat16(0.f);
    return;
  }
  const int t_lo = lo / BK, t_hi = (hi + BK - 1) / BK;
  const int s_lo = t_lo / sh.per, s_hi = (t_hi + sh.per - 1) / sh.per;
  if (split < s_lo || split >= s_hi) return;
  const int j0 = max(t_lo, split * sh.per);
  const int n = min(t_hi, (split + 1) * sh.per) - j0;   // tiles, >= 1

  const size_t kv_off = ((size_t)b * sh.Hkv + kvh) * sh.W * hd;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;
  // The q rows (zero past G) with the first K tile, then the first V
  // tile, and so on: a ring of `stages` tiles in flight.
  load_rows<HDP>(qs, q + row0 * hd, 0, QROWS, G, hd);
  const int nst = min(stages, n);
  int issued = 0;
  for (; issued < nst; ++issued) {
    load_rows<HDP>(ks + issued * S::TILE, kb, (j0 + issued) * BK, BK, sh.W,
                   hd);
    repro::wm::cp_async_commit();
    load_rows<HDP>(vs + issued * S::TILE, vb, (j0 + issued) * BK, BK, sh.W,
                   hd);
    repro::wm::cp_async_commit();
  }

  const int g = lane >> 2, t = lane & 3;
  const bf16* qa = qs + ((lane >> 3) & 1) * 8 * LD + (lane & 7) * LD
                   + (lane >> 4) * 8;       // this lane's A row, k-step 0

  float m_run[2] = {NEG_INF, NEG_INF};   // rows g and g + 8
  float l_run[2] = {0.f, 0.f};           // this lane's share of l
  float o[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  const int col0 = warp * (HDP / 4);     // this warp's columns of O

  for (int i = 0; i < n; ++i) {
    const bf16* kt = ks + (i % stages) * S::TILE;
    const bf16* vt = vs + (i % stages) * S::TILE;
    const int after = 2 * (issued - i - 1);   // groups issued after V_i
    repro::wm::cp_async_wait(after + 1);      // K_i has landed
    __syncthreads();
    // S = q K^T: 8 key columns per n tile, two n tiles per ldmatrix.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qf[4];
      repro::wm::ldsm_x4(qf, qa + kk * 16);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kf[4];
        repro::wm::ldsm_x4(kf, kt + (jp * 16 + (lane >> 4) * 8 + (lane & 7))
                                        * LD
                                   + kk * 16 + ((lane >> 3) & 1) * 8);
        repro::wm::mma16816(s[2 * jp], qf, kf[0], kf[1]);
        repro::wm::mma16816(s[2 * jp + 1], qf, kf[2], kf[3]);
      }
    }
    // Online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3); masked
    // keys get p = 0.
    const int kbase = (j0 + i) * BK;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kbase + 8 * j + 2 * t + (e & 1);
        const bool ok = kpos >= lo && kpos < hi;
        s[j][e] = ok ? s[j][e] * sh.scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kbase + 8 * j + 2 * t + (e & 1);
        const bool ok = kpos >= lo && kpos < hi;
        const float p = ok ? expf(s[j][e] - m_run[e >> 1]) : 0.f;
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    repro::wm::cp_async_wait(after);          // V_i has landed
    __syncthreads();
    // O += P V over 16 keys a step: P as the A operand (hi, then lo).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      repro::wm::split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      repro::wm::split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      repro::wm::split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      repro::wm::split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        uint32_t vf[2];
        repro::wm::ldsm_x2_trans(
            vf, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD
                    + col0 + nt * 8);
        repro::wm::mma16816(o[nt], ph, vf[0], vf[1]);
        repro::wm::mma16816(o[nt], pl, vf[0], vf[1]);
      }
    }
    __syncthreads();                           // the stage is free
    if (issued < n) {
      const int st = issued % stages;
      load_rows<HDP>(ks + st * S::TILE, kb, (j0 + issued) * BK, BK, sh.W, hd);
      repro::wm::cp_async_commit();
      load_rows<HDP>(vs + st * S::TILE, vb, (j0 + issued) * BK, BK, sh.W, hd);
      repro::wm::cp_async_commit();
      ++issued;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 2);
  }

  const int n_live = s_hi - s_lo;
  if (n_live == 1) {                     // the only live split: the output
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gr = g + 8 * r;
      if (gr >= G) continue;
      const float inv = 1.f / l_run[r];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int d = col0 + nt * 8 + 2 * t;
        if (d < hd)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + gr) * hd + d) =
              __floats2bfloat162_rn(o[nt][2 * r] * inv,
                                    o[nt][2 * r + 1] * inv);
      }
    }
    return;
  }
  // The split's partial: m, l, then acc (16-byte aligned), per (query
  // row, split).
  const size_t rows = (size_t)sh.B * sh.Hq * sh.nsplit;
  float* part_m = part;
  float* part_l = part + rows;
  float* part_acc = part + 2 * ((rows + 3) & ~(size_t)3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = g + 8 * r;
    if (gr >= G) continue;
    const size_t slot = (row0 + gr) * sh.nsplit + split;
    if (warp == 0 && t == 0) {
      part_m[slot] = m_run[r];
      part_l[slot] = l_run[r];
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int d = col0 + nt * 8 + 2 * t;
      if (d < hd)
        *reinterpret_cast<float2*>(part_acc + slot * hd + d) =
            make_float2(o[nt][2 * r], o[nt][2 * r + 1]);
    }
  }
  // The last live split of the (row, kv head) to finish merges them all.
  __threadfence();
  __syncthreads();
  int* tk = ticket + (size_t)b * sh.Hkv + kvh;
  if (tid == 0) last = atomicAdd(tk, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The merge, in split order, online: per item (four columns of a
  // row), m, l and acc start from split s_lo's and take in each next
  // split s as m' = max(m, m_s), l = l e^(m - m') + l_s e^(m_s - m'), acc
  // likewise; then out = acc / l.  A thread loads MERGE_BATCH splits of
  // (m_s, l_s, acc_s) before adding any.  Every thread of a row repeats
  // the same sums on m and l, so they agree bitwise.
  for (int i = tid; i < G * hd / 4; i += TC_THREADS) {
    const int gr = i / (hd / 4), d = (i - gr * (hd / 4)) * 4;
    const size_t base = (row0 + gr) * sh.nsplit + s_lo;
    float m = NEG_INF, l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_live; s0 += MERGE_BATCH) {
      float ms[MERGE_BATCH], ls[MERGE_BATCH];
      float4 as[MERGE_BATCH];
#pragma unroll
      for (int j = 0; j < MERGE_BATCH; ++j)
        if (s0 + j < n_live) {
          ms[j] = __ldcg(part_m + base + s0 + j);
          ls[j] = __ldcg(part_l + base + s0 + j);
          as[j] = __ldcg(reinterpret_cast<const float4*>(
              part_acc + (base + s0 + j) * hd + d));
        }
#pragma unroll
      for (int j = 0; j < MERGE_BATCH; ++j)
        if (s0 + j < n_live) {
          const float m_new = fmaxf(m, ms[j]);
          const float a = expf(m - m_new), w = expf(ms[j] - m_new);
          l = l * a + ls[j] * w;
          acc = make_float4(acc.x * a + as[j].x * w, acc.y * a + as[j].y * w,
                            acc.z * a + as[j].z * w, acc.w * a + as[j].w * w);
          m = m_new;
        }
    }
    __nv_bfloat162* o2 =
        reinterpret_cast<__nv_bfloat162*>(out + (row0 + gr) * hd + d);
    o2[0] = __floats2bfloat162_rn(acc.x / l, acc.y / l);
    o2[1] = __floats2bfloat162_rn(acc.z / l, acc.w / l);
  }
  if (tid == 0) *tk = 0;                   // ready for the next call
}

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, const int* clen,
              void* out, float* part, int* ticket, const DecShape& sh,
              cudaStream_t stream) {
  static unsigned long long done = 0;
  const int stages = sh.per < TC_STAGES ? sh.per : TC_STAGES;
  cudaError_t err = allow_smem(decode_tc<HDP>, TcSmem<HDP>::bytes(TC_STAGES),
                               done);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = TcSmem<HDP>::bytes(stages);
  dim3 grid(sh.nsplit, sh.Hkv, sh.B);
  repro::note_launch(1, grid, 1, BK);
  decode_tc<HDP><<<grid, TC_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, clen, (bf16*)out, part,
      ticket, sh, stages);
  return (int)cudaGetLastError();
}

// ============================ simt route ============================

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SPLIT = 256;   // keys per W chunk (one block each)
constexpr int MAX_SIMT_GROUP = 64;
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
  const int len = row_len(clen, b, sh.clen0);
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
int launch_simt(const void* q, const void* k, const void* v, const int* clen,
                void* out, float* part, const DecShape& sh,
                cudaStream_t stream) {
  static unsigned long long done = 0;
  int G = sh.Hq / sh.Hkv;
  size_t smem = sizeof(float) * DecSmem<HDT>::floats(G);
  cudaError_t err = allow_smem(
      decode_partial<T, HDT>,
      sizeof(float) * DecSmem<HDT>::floats(MAX_SIMT_GROUP), done);
  if (err != cudaSuccess) return (int)err;
  size_t rows = (size_t)sh.B * sh.Hq * sh.nsplit;
  float* part_m = part;
  float* part_l = part + rows;
  float* part_acc = part + 2 * rows;
  dim3 grid(sh.Hkv, sh.B, sh.nsplit);
  repro::note_launch(0, grid, 1, BK);
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
int dispatch_simt(const void* q, const void* k, const void* v,
                  const int* clen, void* out, float* part, const DecShape& sh,
                  cudaStream_t stream) {
  if (sh.hd <= 32)
    return launch_simt<T, 32>(q, k, v, clen, out, part, sh, stream);
  if (sh.hd <= 64)
    return launch_simt<T, 64>(q, k, v, clen, out, part, sh, stream);
  return launch_simt<T, 128>(q, k, v, clen, out, part, sh, stream);
}

int dispatch_tc(const void* q, const void* k, const void* v, const int* clen,
                void* out, float* part, int* ticket, const DecShape& sh,
                cudaStream_t stream) {
  if (sh.Hq / sh.Hkv > MAX_TC_GROUP) return (int)cudaErrorInvalidValue;
  if (sh.hd <= 32)
    return launch_tc<32>(q, k, v, clen, out, part, ticket, sh, stream);
  if (sh.hd <= 64)
    return launch_tc<64>(q, k, v, clen, out, part, ticket, sh, stream);
  if (sh.hd <= 96)
    return launch_tc<96>(q, k, v, clen, out, part, ticket, sh, stream);
  return launch_tc<128>(q, k, v, clen, out, part, ticket, sh, stream);
}

}  // namespace

// The tc route's split rule: splits of a cache of width W with Hkv kv
// heads, and whole 64-key tiles per split (kernels/blocked.py mirrors it
// as decode_splits).  Never depends on the batch.
extern "C" int decode_attention_splits(int W, int Hkv) {
  int splits, per;
  tc_splits(W, Hkv, splits, per);
  return splits;
}
extern "C" int decode_attention_split_tiles(int W, int Hkv) {
  int splits, per;
  tc_splits(W, Hkv, splits, per);
  return per;
}
// The simt route's W chunks (256 keys each).
extern "C" int decode_attention_simt_splits(int W) {
  return (W + SPLIT - 1) / SPLIT;
}
// The most query heads per kv head the tc route takes.
extern "C" int decode_attention_tc_group() { return MAX_TC_GROUP; }

// route: 0 = simt (f32 or bf16), 1 = tc (bf16 only).  dtype: 0 = float32,
// 1 = bfloat16.  q (B, Hq, 1, hd), k/v (B, Hkv, W, hd), out like q, all
// contiguous (tc: 16-byte aligned); clen (B,) int32, or NULL for every
// row at clen0.  part: B * Hq * splits * (2 + hd) + 8 f32 scratch, splits of
// the route (simt: unused with one split; tc: unused when no row has two
// live splits); ticket: B * Hkv int32, zero, left zero (tc only).
// hd <= 128 and a multiple of 8, Hq a multiple of Hkv, G = Hq / Hkv at
// most 64 (simt) or decode_attention_tc_group() (tc); the Python wrapper
// checks.  Returns cudaGetLastError() of the launches.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* clen,
                                       void* out, void* part, void* ticket,
                                       int route, int dtype, int B, int Hq,
                                       int Hkv, int W, int hd, float scale,
                                       int window, int clen0, void* stream) {
  DecShape sh{B, Hq, Hkv, W, hd, window, 0, 0, clen0, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const int* cl = (const int*)clen;
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    tc_splits(W, Hkv, sh.nsplit, sh.per);
    return dispatch_tc(q, k, v, cl, out, (float*)part, (int*)ticket, sh, s);
  }
  sh.nsplit = decode_attention_simt_splits(W);
  if (dtype == 0)
    return dispatch_simt<float>(q, k, v, cl, out, (float*)part, sh, s);
  return dispatch_simt<__nv_bfloat16>(q, k, v, cl, out, (float*)part, sh, s);
}

// The route, grid and tile of this library's latest launch (launch_record.cuh).
extern "C" int decode_attention_last_launch(int* r) { return repro::read_launch(r); }
