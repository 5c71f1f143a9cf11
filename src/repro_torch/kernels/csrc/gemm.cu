// Dense tiled matmul: out = x @ y in float32.
//
// Replaces the Pallas kernel src/repro/kernels/gemm.py:37 (gemm, body
// _gemm_kernel), whose (i, j, k) grid carried an f32 VMEM accumulator from
// one k step to the next.  Here one CTA owns one 16x16 output tile and runs
// the k loop itself, staging each 16x16 operand tile pair in shared memory
// and keeping the sum in a register.
//
// Bound on the H100: at the GNN path's shapes (an output 16 columns wide)
// the product does ~2 flops per byte of x it reads, far below the card's
// FP32 ridge, so it is bound by reading x.  This first version stages tiles
// through shared memory without cp.async or TMA and does not use the
// tensor cores (TF32 would change the numerics); overlapping loads with the
// FMAs is later work.
#include "common.cuh"

namespace {

__global__ void gemm_kernel(const float* __restrict__ x,
                            const float* __restrict__ y,
                            float* __restrict__ out, int K, int N) {
  __shared__ float xs[rt::T][rt::T + 1];
  __shared__ float ys[rt::T][rt::T + 1];
  const long row0 = (long)blockIdx.y * rt::T;
  const long col0 = (long)blockIdx.x * rt::T;
  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += rt::T) {
    rt::load_tile(xs, 0, 0, x + row0 * K + k0, K);
    rt::load_tile(ys, 0, 0, y + (long)k0 * N + col0, N);
    __syncthreads();
    acc = rt::tile_fma(xs, 0, ys, 0, acc);
    __syncthreads();
  }
  out[(row0 + threadIdx.y) * N + col0 + threadIdx.x] = acc;
}

}  // namespace

// x (M, K), y (K, N), out (M, N), all row-major with M, K, N multiples of 16.
extern "C" int rt_gemm(const float* x, const float* y, float* out, int M,
                       int K, int N, void* stream) {
  dim3 grid(N / rt::T, M / rt::T), block(rt::T, rt::T);
  gemm_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, y, out, K, N);
  return (int)cudaGetLastError();
}
