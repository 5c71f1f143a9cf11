// FP32 register-tile building blocks of the port's float32 matmul kernels
// (gemm.cu, the float32 route of dispatch.cu), sm_90a.
//
// Operands reach shared memory through 16-byte cp.async copies, which
// zero-fill what lies past the real rows and columns, in a ring of stages
// so that the copies of one stage overlap the FMAs of another.  x tiles are stored
// row-major with rows padded to XPAD floats, so a thread reads four k of
// one row with one 16-byte load; y tiles are stored row-major (k x n), so
// it reads four columns of one k with one 16-byte load.
//
// The rounding invariant: every output element is one float32 FMA chain,
// in ascending k, from the value it starts at (0 for a fresh sum).
// fma_step() is one k of a register microtile and the callers run the k
// in order, so the microtile's shape, the stage depth and
// the thread layout never change an output's bits.  Skipping a zero tile
// drops only exact-zero contributions (fma(0, y, p) == p for finite y).
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace rt {

constexpr int XPAD = 4;   // floats of padding per shared x row (16 bytes)

// Four consecutive floats of row r, columns [c, c + 4), of a (rows x
// cols) row-major matrix with row stride ld, into shared dst by one
// 16-byte cp.async; zeros when the row or the columns lie past the
// matrix.  The matrix's base and rows are 16-byte aligned and cols % 4 ==
// 0, so four columns lie wholly inside or wholly outside it.
__device__ __forceinline__ void cp_async_row4(float* dst,
                                              const float* __restrict__ g,
                                              long r, long c, long rows,
                                              long cols, long ld) {
  const bool in = r < rows && c < cols;
  cp_async16(dst, in ? g + r * ld + c : g, in);
}

// Copy an R x C block (C a multiple of 4) of such a matrix, from row r0
// and column c0, to shared dst with row stride dst_ld, by the 32 lanes of
// one warp, neighbouring lanes on neighbouring 16 bytes of a row.
template <int R, int C>
__device__ __forceinline__ void warp_copy(float* dst, int dst_ld,
                                          const float* __restrict__ g,
                                          long r0, long c0, long rows,
                                          long cols, long ld, int lane) {
#pragma unroll
  for (int q = lane; q < R * C / 4; q += 32) {
    const int r = q / (C / 4), c = q % (C / 4) * 4;
    cp_async_row4(dst + r * dst_ld + c, g, r0 + r, c0 + c, rows, cols, ld);
  }
}

// One k step of a register microtile: acc[i][j] = fma(a[i], b[j],
// acc[i][j]).  Callers run the k of a slice in ascending order.
template <int R, int C>
__device__ __forceinline__ void fma_step(float (&acc)[R][C],
                                         const float (&a)[R],
                                         const float (&b)[C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// Component kk (0..3) of v.
__device__ __forceinline__ float lane_of(const float4& v, int kk) {
  return kk == 0 ? v.x : kk == 1 ? v.y : kk == 2 ? v.z : v.w;
}

}  // namespace rt
