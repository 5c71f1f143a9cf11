// Tensor-core building blocks of the port's bf16 kernels (sm_90a):
// 16-byte asynchronous copies into shared memory, ldmatrix fragment loads
// and the warp-level m16n8k16 bf16 MMA with float32 accumulation.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16" for .bf16), with g = lane / 4
// and q = lane % 4:
//   A (16 x 16, row-major): a0 = (g, 2q..2q+1), a1 = (g+8, 2q..),
//                           a2 = (g, 8+2q..),   a3 = (g+8, 8+2q..);
//   B (16 x 8, k x n):      b0 = (k 2q..2q+1, n g), b1 = (k 8+2q.., n g);
//   C (16 x 8, float32):    c0, c1 = (g, 2q..2q+1), c2, c3 = (g+8, 2q..).
// ldmatrix_x4 with lane l addressing row (l % 16), column 8 * (l / 16) of
// a 16 x 16 row-major tile returns exactly the A fragment; on a k x n
// row-major tile the .trans form returns the B fragments of its two
// 8-column halves (b0, b1 of columns 0-7, then b0, b1 of columns 8-15),
// and the plain form on an n x k row-major tile (keys x head dims) does
// the same for B = that tile transposed.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; when !full the destination is
// zero-filled and nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b on one 16 x 8 tile, bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values rounded to bf16 and packed low-first (the element
// order of a fragment register).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace rt
