// Warp-level tensor-core building blocks written as inline PTX, shared by
// the decode attention and SSD kernels (sm_80 instructions, built for
// sm_90a): 16-byte asynchronous copies into shared memory (cp.async, with
// zero fill), ldmatrix of 8 x 8 bf16 matrices (plain and transposed), and
// mma.sync m16n8k16 bf16 products with f32 accumulators.
//
// Fragments of mma.sync m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major), four 32-bit registers of two bf16:
//     a[0] (row g, cols 2t, 2t+1), a[1] (row g+8, cols 2t, 2t+1),
//     a[2] (row g, cols 2t+8, 2t+9), a[3] (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, k x n), two registers: b[0] (rows 2t, 2t+1, col g),
//     b[1] (rows 2t+8, 2t+9, col g);
//   C/D (16 x 8, f32): c[0], c[1] (row g, cols 2t, 2t+1), c[2], c[3]
//     (row g+8, cols 2t, 2t+1).
// ldmatrix hands thread l the pair (row l / 4, cols 2(l % 4), +1) of each
// 8 x 8 matrix, or with .trans the pair (rows 2(l % 4), +1, col l / 4):
// A from a row-major tile (x4), B from an n-major tile (x4 gives two n
// tiles), B from a k-major tile with .trans.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {
namespace wm {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with bytes == 0
// the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// (n > 3 waits as for 3: more than the caller needs, never less.)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo_half, float hi_half) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_half, hi_half);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two f32 values as their bf16 pairs: x ~ hi + lo, lo = bf16(x - hi),
// about 16 bits of each value (the split operands of the f32-grade
// products).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  __nv_bfloat162 h = __halves2bfloat162(h0, h1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack2(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

}  // namespace wm
}  // namespace repro
