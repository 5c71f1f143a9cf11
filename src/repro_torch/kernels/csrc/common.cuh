// Shared building blocks of the port's Hopper kernels (sm_90a).
//
// The float32 matmul kernels (gemm, the float32 route of dispatch, spdmm,
// spmm) accumulate on the FP32 FMA units in register microtiles fed from
// shared memory (fma.cuh; the block-sparse walks in sparse.cuh); the bf16
// routes use the tensor cores (mma.cuh).  Each float32 output accumulates
// with fused multiply-adds in ascending k into a float32 register.
// Skipping a zero tile therefore drops only exact-zero contributions:
// fma(0, y, p) == p for finite y, so a walk that skips zero tiles rounds
// like the dense walk over the same block.
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

}  // namespace rt
