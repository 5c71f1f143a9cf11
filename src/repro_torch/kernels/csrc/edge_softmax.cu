// Masked edge-softmax of GAT's attention kernel, thresholded:
//
//   s      = z @ [att_src | att_dst]                       (n, 2)
//   score  = LeakyReLU(s[i, 0] + s[j, 1], slope)
//   alpha  = softmax of score over row i's support (a != 0), else 0
//   out    = alpha > threshold ? alpha : 0
//
// Replaces the jnp body of attention_adjacency,
// src/repro/core/dynasparse.py:311 (:353-373); the reference has no Pallas
// kernel for it.  Rows with no support (bucket padding) take row_max := 0
// and denom := max(sum, 1e-30), so they come out exactly zero, not NaN.
//
// Design (a simple one that is right; the block counts of alpha are still
// a separate tile_nnz launch):
//
// * project_kernel: one thread per row computes its two projections, each
//   one fmaf chain over f ascending, so alpha's rounding does not depend on
//   a library matmul or on the TF32 setting.
// * edge_softmax_kernel: one warp per row, three passes over the row (the
//   second and third mostly hit L2): the masked max, the masked sum of
//   expf(score - max), then every element of the output row.  Each lane
//   walks its strided columns in order and a fixed xor-shuffle tree
//   combines the lanes (addition is commutative, so every lane holds the
//   same sum): no atomics, so the result is deterministic and the fused
//   and per-kernel engines see bitwise the same alpha.  Loads are 4-byte
//   and coalesced because a row of a (n floats, e.g. 3327) need not be
//   16-byte aligned; no row is staged in shared memory (a PubMed row is
//   79 KB).  expf and IEEE division, no fast-math intrinsics; the
//   threshold compares with strict '>' as the reference does.
//
// Bound on the H100: bytes -- a read once and alpha written once (2 * 4 *
// n^2; 88.6 MB at n = 3327, 0.026 ms at 3.35 TB/s).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;           // rows per CTA, one warp each
constexpr int PROJ_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void project_kernel(const float* __restrict__ z,
                               const float* __restrict__ att_src,
                               const float* __restrict__ att_dst,
                               float* __restrict__ s_src,
                               float* __restrict__ s_dst, int n, int f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* zi = z + (long)i * f;
  float p = 0.f, q = 0.f;
  for (int k = 0; k < f; ++k) {
    const float v = zi[k];
    p = fmaf(v, att_src[k], p);
    q = fmaf(v, att_dst[k], q);
  }
  s_src[i] = p;
  s_dst[i] = q;
}

__device__ __forceinline__ float leaky(float e, float slope) {
  return e >= 0.f ? e : slope * e;
}

__global__ void __launch_bounds__(WARPS * 32)
edge_softmax_kernel(const float* __restrict__ a, long lda,
                    const float* __restrict__ s_src,
                    const float* __restrict__ s_dst, float* __restrict__ out,
                    int n, float slope, float threshold) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;                       // the whole warp leaves
  const float* ai = a + (long)i * lda;
  float* oi = out + (long)i * n;
  const float si = s_src[i];

  // pass 1: the max of the scores over the row's support
  float mx = __int_as_float(0xff800000);    // -inf
#pragma unroll 8
  for (int j = lane; j < n; j += 32) {
    const float sc = leaky(si + s_dst[j], slope);
    if (ai[j] != 0.f) mx = fmaxf(mx, sc);
  }
  for (int d = 16; d; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, d));
  if (!isfinite(mx)) mx = 0.f;              // no support: 0, as the reference

  // pass 2: the masked sum, lane by lane in column order, then the tree
  float sum = 0.f;
#pragma unroll 8
  for (int j = lane; j < n; j += 32) {
    const float sc = leaky(si + s_dst[j], slope);
    if (ai[j] != 0.f) sum += expf(sc - mx);
  }
  for (int d = 16; d; d >>= 1) sum += __shfl_xor_sync(FULL, sum, d);
  const float denom = fmaxf(sum, 1e-30f);

  // pass 3: every element of the row, thresholded
#pragma unroll 8
  for (int j = lane; j < n; j += 32) {
    const float sc = leaky(si + s_dst[j], slope);
    const float al = ai[j] != 0.f ? expf(sc - mx) / denom : 0.f;
    oi[j] = al > threshold ? al : 0.f;
  }
}

}  // namespace

// a (n, n) float32 with row stride lda; z (n, f) float32 contiguous;
// att_src, att_dst (f,) float32; s scratch of 2n floats; out (n, n) float32
// contiguous, every element written.
extern "C" int rt_edge_softmax(const float* a, long lda, const float* z,
                               const float* att_src, const float* att_dst,
                               float* s, float* out, int n, int f,
                               float slope, float threshold, void* stream) {
  if (n <= 0) return 0;
  if (f < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  project_kernel<<<(n + PROJ_THREADS - 1) / PROJ_THREADS, PROJ_THREADS, 0,
                   st>>>(z, att_src, att_dst, s, s + n, n, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  edge_softmax_kernel<<<(n + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
      a, lda, s, s + n, out, n, slope, threshold);
  return (int)cudaGetLastError();
}
