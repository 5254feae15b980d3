// Tensor-core attention core for bf16 inputs on sm_90a, shared by
// flash_attention.cu and stream_attention.cu (their f32 route keeps the
// SIMT core of attention_tile.cuh).
//
// A block has three warpgroups of 128 threads: two consumer warpgroups that
// each own 64 query rows, taken from the flattened (G query heads x Sq) rows
// of one (batch, kv head) so that a GQA group shares every K/V tile, and a
// producer warpgroup of which one thread issues the TMA loads of a ring of
// shared-memory stages guarded by mbarriers (setmaxnreg moves registers to
// the consumers).  Per kv tile of BK = 64 keys a consumer warpgroup runs
//   S = Q K^T        wgmma m64n64k16, Q the register A operand, K in shared
//                    memory (128-byte swizzle), f32 accumulators;
//   online softmax   on the accumulator registers: row max and sum within
//                    the quad of threads that holds a row;
//   O += P V         wgmma m64nNk16, P re-packed from the S accumulators as
//                    the register A operand, V in shared memory.
// Numerics.  Every product is a bf16 x bf16 product summed in f32, so an f32
// operand goes in as two bf16 values x = hi + lo, lo = bf16(x - hi), which
// keeps ~16 bits of it (no TF32 anywhere): P always (P V = P_hi V + P_lo V),
// and the stream kernel's generated K and V (Q K^T = Q K_hi^T + Q K_lo^T,
// P V = P_hi V_hi + P_hi V_lo + P_lo V_hi).  kernels/blocked.py mirrors this
// rounding (split_bf16) for the CPU tests.
// Live tiles only.  live_kv_tiles() gives the kv tiles [lo, hi) that hold a
// live key (kv_len, causal with q_offset, window) for any row of a span of
// flattened rows; masks are applied on the tiles that are not live for every
// row of a warpgroup.  A row with no live key at all takes the softmax of
// equal -1e30 scores, the mean of V over the Sk keys (as the plain versions
// and ref_attention do): a span that holds such a row walks every tile,
// and store() divides its sum by Sk.  The Python mirror is
// blocked.live_kv_tiles; flash_attention_live_tiles exports this one.
// Shared-memory tiles are TMA boxes of 64 rows x 64 bf16 (128 bytes, 8 KB),
// swizzled by 128 bytes; a tile of width 128 is two boxes 8 KB apart.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"   // AttnShape

namespace repro {
namespace tc {

constexpr int BK = 64;                    // keys per kv tile
constexpr int ROWS = 128;                 // query rows per block
constexpr int THREADS = 384;              // 2 consumer + 1 producer warpgroups
constexpr int CONSUMERS = 256;
constexpr int BOX_BYTES = 64 * 64 * 2;    // one 64 x 64 bf16 TMA box
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// ---- shared memory, barriers, TMA, clusters ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// The same, for data that a peer block of the cluster wrote.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Generic-proxy writes to shared memory become visible to wgmma and bulk
// copies (the async proxy) after this fence and a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
// The shared::cluster address of `addr` in the block of rank `rank`.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
// Copy `bytes` of this block's shared memory into a peer's (cluster
// address `dst`), completing `bytes` of transactions on the peer's barrier.
__device__ __forceinline__ void bulk_push(uint32_t dst, uint32_t src,
                                          uint32_t bytes, uint32_t peer_bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(peer_bar)
      : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma ----

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin registers in place around the asynchronous products: the compiler
// must neither read an accumulator before the wait nor reuse an A register.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+r"(r[i][c])::"memory");
}

// Matrix descriptor of a 128-byte-swizzled operand in shared memory.
// K-major (rows of 64 bf16 along the reduction): 8-row groups 1024 bytes
// apart; a k16 step inside a box advances the start by 32 bytes.
// MN-major (rows along the reduction, 64 bf16 of N per row): 8-row groups
// 1024 bytes apart (SBO), the next 64 columns of N one box later (LBO); a
// k16 step advances the start by 16 rows = 2048 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return make_desc(addr, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return make_desc(addr, BOX_BYTES, 1024);
}
// Byte offset of element (row, col) of a tile of 64-row boxes, as TMA's
// 128-byte swizzle lays it out.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  int c = col & 63;
  return (col >> 6) * BOX_BYTES + row * 128 + ((((c >> 3) ^ row) & 7) << 4) +
         ((c & 7) << 1);
}

// wgmma_rs: D (64 x N) += A (64 x 16, registers) * B (16 x N, descriptor).
// wgmma_ss: D (64 x N) += A (descriptor) * B (descriptor).  TRANS_B = 1 for
// an MN-major B.  Generated: one operand list per width N = 64, 128.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// ---- the attention step of one consumer warpgroup ----

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

struct KvRange {
  int lo, hi;   // kv tiles [lo, hi)
};

// Query positions of the flattened rows [r0, r1): [qmin, qmax].  A span
// that crosses from one head's rows into the next holds both ends of the
// query range.  Returns false for an empty span.
__host__ __device__ __forceinline__ bool q_span(int r0, int r1,
                                                const AttnShape& sh,
                                                int& qmin, int& qmax) {
  if (r1 <= r0) return false;
  if (r0 / sh.Sq == (r1 - 1) / sh.Sq) {
    qmin = r0 % sh.Sq + sh.q_offset;
    qmax = (r1 - 1) % sh.Sq + sh.q_offset;
  } else {
    qmin = sh.q_offset;
    qmax = sh.Sq - 1 + sh.q_offset;
  }
  return true;
}

// The keys [beg, end) live for query position q; both ends grow with q.
__host__ __device__ __forceinline__ void live_keys(const AttnShape& sh, int q,
                                                   int& beg, int& end) {
  end = sh.causal && q + 1 < sh.kv_len ? q + 1 : sh.kv_len;
  beg = sh.window > 0 && q - sh.window + 1 > 0 ? q - sh.window + 1 : 0;
}

// The kv tiles that hold a live key for some query position in [qmin, qmax]:
// keys in [beg(qmin), end(qmax)).  The positions with no live key lie at
// the ends of the span; if one is there, every tile (see the note atop).
__host__ __device__ __forceinline__ KvRange live_kv_tiles(const AttnShape& sh,
                                                          bool any, int qmin,
                                                          int qmax) {
  if (!any) return {0, 0};
  int beg0, end0, beg1, end1;
  live_keys(sh, qmin, beg0, end0);
  live_keys(sh, qmax, beg1, end1);
  if (end0 <= beg0 || end1 <= beg1) return {0, (sh.Sk + BK - 1) / BK};
  return {beg0 / BK, (end1 + BK - 1) / BK};
}

// Does tile j need the mask for some query position in [qmin, qmax]?
__device__ __forceinline__ bool edge_tile(const AttnShape& sh, int j, int qmin,
                                          int qmax) {
  int k0 = j * BK, k1 = k0 + BK - 1;
  return k1 >= sh.kv_len || (sh.causal && k1 > qmin) ||
         (sh.window > 0 && k0 <= qmax - sh.window);
}

// One consumer warpgroup's 64 query rows.  Thread (warp w, lane l) holds rows
// w*16 + l/4 and that + 8 of the warpgroup, columns 8i + 2(l%4) + {0, 1}.
template <int HDP, int HDVP>
struct TcRows {
  static constexpr int KS = HDP / 16;     // k16 steps of Q K^T
  uint32_t qa[KS][4];                     // Q as the A operand
  float o[HDVP / 2];                      // output accumulators
  float m[2], l[2];                       // running max, partial sum per row
  int qpos[2], head[2], qi[2];
  bool valid[2];
  int qmin, qmax;                         // query span of the warpgroup
  bool any;
  int t;                                  // l % 4

  // rows: the warpgroup's first flattened row.
  __device__ void init(const bf16* __restrict__ q, const AttnShape& sh, int b,
                       int kvh, int row0) {
    const int G = sh.Hq / sh.Hkv, nrows = G * sh.Sq;
    const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
    t = lane % 4;
    any = q_span(row0, min(row0 + 64, nrows), sh, qmin, qmax);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r = row0 + w * 16 + lane / 4 + 8 * h;
      valid[h] = r < nrows;
      head[h] = valid[h] ? kvh * G + r / sh.Sq : 0;
      qi[h] = valid[h] ? r % sh.Sq : 0;
      qpos[h] = qi[h] + sh.q_offset;
      m[h] = NEG_INF;
      l[h] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < HDVP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int h = c & 1, col = ks * 16 + (c >> 1) * 8 + 2 * t;
        uint32_t v = 0;
        if (valid[h] && col < sh.hd)
          v = *reinterpret_cast<const uint32_t*>(
              q + ((size_t)(b * sh.Hq + head[h]) * sh.Sq + qi[h]) * sh.hd + col);
        qa[ks][c] = v;
      }
  }

  // One kv tile j: k_hi/k_lo and v_hi/v_lo are the shared-memory addresses
  // of its K and V (the _lo halves only with SPLIT, the stream kernel's f32
  // K and V as bf16 pairs).
  template <bool SPLIT>
  __device__ void tile(const AttnShape& sh, int j, uint32_t k_hi, uint32_t k_lo,
                       uint32_t v_hi, uint32_t v_lo) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_rs<0>(s, qa[ks], desc_kmajor(k_hi + (ks / 4) * BOX_BYTES + (ks % 4) * 32), 1);
    if (SPLIT) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_rs<0>(s, qa[ks], desc_kmajor(k_lo + (ks / 4) * BOX_BYTES + (ks % 4) * 32), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(qa);

    const bool mask = edge_tile(sh, j, qmin, qmax);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = s[4 * i + 2 * h + e] * sh.scale;
          if (mask) {
            int kpos = j * BK + 8 * i + 2 * t + e;
            bool ok = kpos < sh.kv_len;
            if (sh.causal) ok = ok && kpos <= qpos[h];
            if (sh.window > 0) ok = ok && kpos > qpos[h] - sh.window;
            v = ok ? v : NEG_INF;
          }
          s[4 * i + 2 * h + e] = v;
          mx[h] = fmaxf(mx[h], v);
        }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 2));
      float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f((m[h] - m_new) * LOG2E);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2f((s[4 * i + 2 * h + e] - m[h]) * LOG2E);
          s[4 * i + 2 * h + e] = p;
          l[h] += p;
        }
#pragma unroll
    for (int i = 0; i < HDVP / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * i + 2 * h] *= alpha[h];
        o[4 * i + 2 * h + 1] *= alpha[h];
      }
    // P = P_hi + P_lo, re-packed from the accumulator layout to the A layout
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = s[8 * kk + 2 * c], b = s[8 * kk + 2 * c + 1];
        float ah = __bfloat162float(__float2bfloat16_rn(a));
        float bh = __bfloat162float(__float2bfloat16_rn(b));
        p_hi[kk][c] = pack_bf16(ah, bh);
        p_lo[kk][c] = pack_bf16(a - ah, b - bh);
      }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(o, p_hi[kk], desc_mnmajor(v_hi + kk * 2048), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(o, p_lo[kk], desc_mnmajor(v_hi + kk * 2048), 1);
    if (SPLIT) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(o, p_hi[kk], desc_mnmajor(v_lo + kk * 2048), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
  }

  // out (B, Hq, Sq, hdv) = O / l.  A row with no live key walked every
  // tile with weight 1 per key, and the keys past Sk hold V = 0 (TMA's
  // zero fill, or generated from zero rows of x_kv): its l becomes Sk.  A
  // row whose l is 0 (no tile: Sk = 0) gives 0.
  __device__ void store(bf16* __restrict__ out, const AttnShape& sh, int b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffff, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffff, l[h], 2);
      if (m[h] == NEG_INF) l[h] = (float)sh.Sk;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[h]) continue;
      float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
      bf16* row = out + ((size_t)(b * sh.Hq + head[h]) * sh.Sq + qi[h]) * sh.hdv;
#pragma unroll
      for (int i = 0; i < HDVP / 8; ++i) {
        int col = 8 * i + 2 * t;
        if (col < sh.hdv)
          *reinterpret_cast<uint32_t*>(row + col) =
              pack_bf16(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv);
      }
    }
  }
};

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime so that
// nothing links libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A 3-d bf16 tensor (d0 innermost, strides in bytes) read in boxes of
// (64, box1, box2) with the 128-byte swizzle; out-of-bounds reads are zero.
// Returns 0 or a CUDA error code.
inline int make_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
                    uint64_t d2, uint64_t stride1, uint64_t stride2,
                    uint32_t box1, uint32_t box2) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  cuuint64_t dims[3] = {d0, d1, d2}, strides[2] = {stride1, stride2};
  cuuint32_t box[3] = {64, box1, box2}, elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                  dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// TMA needs 16-byte aligned addresses and strides.
inline bool tma_ok(const void* p, uint64_t row_elems) {
  return ((uintptr_t)p % 16 == 0) && (row_elems * 2) % 16 == 0;
}

}  // namespace tc
}  // namespace repro
