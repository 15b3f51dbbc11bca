// Tensor-core and async-copy helpers for the bf16 kernels (sm_80+ PTX,
// compiled for sm_90a): 16-byte cp.async with zero fill, ldmatrix, and the
// warp-level mma.sync m16n8k16 bf16 -> f32 product.
//
// Fragment layouts of mma.m16n8k16 (lane = threadIdx.x % 32, g = lane / 4,
// c = 2 * (lane % 4)):
//   A 16x16 (row-major), 4 regs of bf16x2: a0 (g, c..c+1), a1 (g+8, c..),
//     a2 (g, c+8..), a3 (g+8, c+8..);
//   B 16x8 (k x n), 2 regs: b0 (k = c..c+1, n = g), b1 (k = c+8.., n = g);
//   C 16x8 f32, 4 floats: c0, c1 (g, c..c+1), c2, c3 (g+8, c..c+1).
// ldmatrix.x4 loads four 8x8 bf16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i holds matrix i's fragment (row g,
// columns c..c+1; with .trans, rows c..c+1 of column g).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; with ok = false it writes zeros and
// reads nothing (src-size 0), so ragged edges are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
// 4-byte async copy (one f32), zero-filled when ok = false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b, bf16 inputs, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 and packed, the lower column in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// x = hi + lo to about 2^-17 relative: hi = bf16(x), lo = bf16(x - hi).
// An f32 operand split so costs two mma.sync where one rounding to bf16
// would cost 2^-9 relative per term.
struct Bf16Pair {
  unsigned hi, lo;
};
__device__ __forceinline__ Bf16Pair split_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      a - __bfloat162float(h.x), b - __bfloat162float(h.y));
  return {*reinterpret_cast<const unsigned*>(&h),
          *reinterpret_cast<const unsigned*>(&l)};
}

}  // namespace rt
