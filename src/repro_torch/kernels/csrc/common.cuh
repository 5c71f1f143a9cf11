// Shared building blocks of the port's Hopper kernels (sm_90a).
//
// The sparse matmul kernels (spdmm, spmm) work on 16x16 float32 sub-tiles
// with a 16x16 thread block: thread (ty, tx) owns element (ty, tx) of each
// output sub-tile it computes (gemm and dispatch use the register tiles of
// fma.cuh and mma.cuh instead).  A sub-tile product stages both operands in shared memory and
// accumulates with one fused multiply-add per reduction element, in
// ascending k, into a float32 register.  Skipping a zero tile therefore
// drops only exact-zero contributions: fma(0, y, p) == p for finite y, so
// a walk that skips zero tiles rounds like the dense walk over the same
// block.
//
// Each kernel's C entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int T = 16;  // sub-tile edge

// Primitive codes of the planner (core/perf_model.py Primitive).
constexpr int SKIP = 0;
constexpr int GEMM = 1;
constexpr int SPDMM = 2;
constexpr int SPMM = 3;

// Element types a kernel reads, widened to float32 for the arithmetic.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Copy one 16x16 tile of g (row stride ld elements) to rows
// [row0, row0 + 16) and columns [col0, col0 + 16) of s, widened to
// float32; one element per thread, neighbouring tx on neighbouring
// addresses.
template <int W, typename E>
__device__ __forceinline__ void load_tile(float (*s)[W], int row0, int col0,
                                          const E* __restrict__ g,
                                          long ld) {
  s[row0 + threadIdx.y][col0 + threadIdx.x] =
      to_f32(g[(long)threadIdx.y * ld + threadIdx.x]);
}

// p += row (row0 + ty) of a times column (col0 + tx) of b over 16 k.
template <int WA, int WB>
__device__ __forceinline__ float tile_fma(float (*a)[WA], int row0,
                                          float (*b)[WB], int col0,
                                          float p) {
#pragma unroll
  for (int kk = 0; kk < T; ++kk)
    p = fmaf(a[row0 + threadIdx.y][kk], b[kk][col0 + threadIdx.x], p);
  return p;
}

}  // namespace rt
