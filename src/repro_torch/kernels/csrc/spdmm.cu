// Block-sparse x dense: out = dense(x) @ y with x in Block-CSR.
//
// Replaces the Pallas kernel src/repro/kernels/spdmm.py:50 (spdmm, body
// _spdmm_kernel).  The TPU grid ran Smax steps per tile-row and masked the
// steps past counts[i] with clamped index maps.  Here a CTA owns one 16x16
// output sub-tile of tile-row i, reads counts[i] and loops exactly that many
// times, so an empty tile costs nothing; the rhs tile address comes from
// col_idx[i, s] on the device.
//
// Bound on the H100: the bytes of the nonzero x tiles plus the y rows they
// select; the FMAs per byte are as low as gemm's.  Loads are staged through
// shared memory without prefetching (first version).
#include "common.cuh"

namespace {

__global__ void spdmm_kernel(const int* __restrict__ col_idx,
                             const int* __restrict__ counts,
                             const float* __restrict__ blocks,
                             const float* __restrict__ y,
                             float* __restrict__ out, int smax, int tm,
                             int tk, int n) {
  __shared__ float xs[rt::T][rt::T + 1];
  __shared__ float ys[rt::T][rt::T + 1];
  const int sub = tm / rt::T;
  const int i = blockIdx.y / sub, a = blockIdx.y % sub;
  const long col0 = (long)blockIdx.x * rt::T;
  const int cnt = counts[i];
  float acc = 0.f;
  for (int s = 0; s < cnt; ++s) {
    const long c = col_idx[(long)i * smax + s];
    const float* blk =
        blocks + ((long)i * smax + s) * tm * tk + (long)a * rt::T * tk;
    for (int k0 = 0; k0 < tk; k0 += rt::T) {
      rt::load_tile(xs, 0, 0, blk + k0, tk);
      rt::load_tile(ys, 0, 0, y + (c * tk + k0) * n + col0, n);
      __syncthreads();
      acc = rt::tile_fma(xs, 0, ys, 0, acc);
      __syncthreads();
    }
  }
  out[((long)i * tm + a * rt::T + threadIdx.y) * n + col0 + threadIdx.x] = acc;
}

}  // namespace

// col_idx (mb, smax) int32, counts (mb,) int32 <= smax, blocks
// (mb, smax, tm, tk), y (kb * tk, n), out (mb * tm, n); tm, tk, n multiples
// of 16.
extern "C" int rt_spdmm(const int* col_idx, const int* counts,
                        const float* blocks, const float* y, float* out,
                        int mb, int smax, int tm, int tk, int n,
                        void* stream) {
  dim3 grid(n / rt::T, mb * (tm / rt::T)), block(rt::T, rt::T);
  spdmm_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      col_idx, counts, blocks, y, out, smax, tm, tk, n);
  return (int)cudaGetLastError();
}
