// Block-sparse x block-sparse: out = dense(x) @ dense(y), x in Block-CSR,
// y in Block-CSC, walking only the tile pairs that are nonzero on both
// sides.
//
// Replaces the Pallas kernel src/repro/kernels/spmm.py:110 (spmm, body
// _spmm_kernel).  The TPU grid ran S steps per output tile with the
// intersection schedule (xpos, ypos, counts) in scalar prefetch.  Here a CTA
// owns one 16x16 output sub-tile of output tile (i, j), reads counts[i, j]
// and the two slot lists from device memory, and loops exactly that many
// times.
//
// Bound on the H100: the bytes of the intersecting tile pairs; FMAs per byte
// are as low as gemm's.  Loads are staged through shared memory without
// prefetching (first version).
#include "common.cuh"

namespace {

__global__ void spmm_kernel(const int* __restrict__ xpos,
                            const int* __restrict__ ypos,
                            const int* __restrict__ counts,
                            const float* __restrict__ xb,
                            const float* __restrict__ yb,
                            float* __restrict__ out, int nb, int S, int sx,
                            int sy, int tm, int tk, int tn) {
  __shared__ float xs[rt::T][rt::T + 1];
  __shared__ float ys[rt::T][rt::T + 1];
  const int subm = tm / rt::T, subn = tn / rt::T;
  const int i = blockIdx.y / subm, a = blockIdx.y % subm;
  const int j = blockIdx.x / subn, b = blockIdx.x % subn;
  const long ij = (long)i * nb + j;
  const int cnt = counts[ij];
  float acc = 0.f;
  for (int s = 0; s < cnt; ++s) {
    const long xp = xpos[ij * S + s], yp = ypos[ij * S + s];
    const float* xt = xb + ((long)i * sx + xp) * tm * tk + (long)a * rt::T * tk;
    const float* yt = yb + ((long)j * sy + yp) * tk * tn + (long)b * rt::T;
    for (int k0 = 0; k0 < tk; k0 += rt::T) {
      rt::load_tile(xs, 0, 0, xt + k0, tk);
      rt::load_tile(ys, 0, 0, yt + (long)k0 * tn, tn);
      __syncthreads();
      acc = rt::tile_fma(xs, 0, ys, 0, acc);
      __syncthreads();
    }
  }
  const long ldo = (long)nb * tn;
  out[((long)i * tm + a * rt::T + threadIdx.y) * ldo + (long)j * tn +
      b * rt::T + threadIdx.x] = acc;
}

}  // namespace

// xpos/ypos (mb, nb, S) int32, counts (mb, nb) int32 <= S, xb
// (mb, sx, tm, tk), yb (nb, sy, tk, tn), out (mb * tm, nb * tn); tile
// edges multiples of 16.
extern "C" int rt_spmm(const int* xpos, const int* ypos, const int* counts,
                       const float* xb, const float* yb, float* out, int mb,
                       int nb, int S, int sx, int sy, int tm, int tk, int tn,
                       void* stream) {
  dim3 grid(nb * (tn / rt::T), mb * (tm / rt::T)), block(rt::T, rt::T);
  spmm_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      xpos, ypos, counts, xb, yb, out, nb, S, sx, sy, tm, tk, tn);
  return (int)cudaGetLastError();
}
