// The executor's block path: one launch per dynasparse_matmul that walks
// the planner's (I, J, K) primitive-code grid on the device.
//
// Replaces the per-step dispatch of src/repro/core/dynasparse.py:239-258,
// where a lax.scan over output blocks and a fori_loop over k ran one
// lax.switch branch -- and, with kernels on, one Pallas call of
// src/repro/kernels/gemm.py:47, spdmm.py:92 or spmm.py:154 -- per (i, j, k)
// step.  Here one CTA owns one (bm, bn) output block (i, j) and runs the k
// loop in order, reading codes[i, j, k] from device memory:
//
//   SKIP   costs nothing;
//   GEMM   is a dense block MAC;
//   SPDMM  walks only the lhs block's nonzero 16x16 tiles;
//   SPMM   walks only the tile pairs nonzero on both sides.
//
// Tile occupancy comes from per-16x16-tile flags of x and y.  Each step
// accumulates into a fresh float32 partial that is then added to the
// running sum, as the reference adds acc + step.  The code and the flags
// are the same for every thread of the CTA, so the branches do not diverge.
//
// ``skip`` (nullable) is a device flag: when it points to nonzero the whole
// grid exits at once (the executor picked the row-CSR path on the device).
//
// Bound on the H100: the bytes of the x and y tiles the non-SKIP steps read
// (each at most once per output block), with ~2 FMAs per loaded element;
// loads are staged through shared memory without prefetching, and the
// tensor cores are unused (first version).
#include "common.cuh"

namespace {

template <int TM, int TN>
__global__ void dispatch_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                const int* __restrict__ codes,
                                const uint8_t* __restrict__ occx,
                                const uint8_t* __restrict__ occy,
                                float* __restrict__ out,
                                const int* __restrict__ skip, int J, int K,
                                int bk, long ldx, long ldy) {
  if (skip != nullptr && *skip != 0) return;
  constexpr int BM = TM * rt::T, BN = TN * rt::T;
  __shared__ float xs[BM][rt::T + 1];
  __shared__ float ys[rt::T][BN + 1];
  const int bi = blockIdx.y, bj = blockIdx.x;
  const int kts = bk / rt::T;       // 16-wide k slices per block
  const long xtc = ldx / rt::T;     // tile columns of x (= tile rows of y)
  const long ytc = ldy / rt::T;     // tile columns of y
  const int* code_row = codes + ((long)bi * J + bj) * K;

  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;

  for (int k = 0; k < K; ++k) {
    const int code = code_row[k];
    if (code == rt::SKIP) continue;
    float part[TM][TN];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) part[a][b] = 0.f;

    for (int kt = 0; kt < kts; ++kt) {
      const long gk = (long)k * kts + kt;  // global 16-wide k slice
      bool ux[TM], uy[TN];
      bool anyx = false, anyy = false;
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        ux[a] = code == rt::GEMM || occx[((long)bi * TM + a) * xtc + gk];
        anyx |= ux[a];
      }
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        uy[b] = code != rt::SPMM || occy[gk * ytc + (long)bj * TN + b];
        anyy |= uy[b];
      }
      if (!(anyx && anyy)) continue;  // uniform across the CTA
#pragma unroll
      for (int a = 0; a < TM; ++a)
        if (ux[a])
          rt::load_tile(xs, a * rt::T, 0,
                        x + ((long)bi * BM + a * rt::T) * ldx + gk * rt::T,
                        ldx);
#pragma unroll
      for (int b = 0; b < TN; ++b)
        if (uy[b])
          rt::load_tile(ys, 0, b * rt::T,
                        y + gk * rt::T * ldy + (long)bj * BN + b * rt::T, ldy);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b)
          if (ux[a] && uy[b])
            part[a][b] = rt::tile_fma(xs, a * rt::T, ys, b * rt::T, part[a][b]);
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) acc[a][b] += part[a][b];
  }
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b)
      out[((long)bi * BM + a * rt::T + threadIdx.y) * ldy + (long)bj * BN +
          b * rt::T + threadIdx.x] = acc[a][b];
}

template <int TM, int TN>
int launch(const float* x, const float* y, const int* codes,
           const uint8_t* occx, const uint8_t* occy, float* out,
           const int* skip, int I, int J, int K, int bk, long ldx, long ldy,
           cudaStream_t stream) {
  dim3 grid(J, I), block(rt::T, rt::T);
  dispatch_kernel<TM, TN><<<grid, block, 0, stream>>>(
      x, y, codes, occx, occy, out, skip, J, K, bk, ldx, ldy);
  return (int)cudaGetLastError();
}

template <int TM>
int launch_tn(int tn, const float* x, const float* y, const int* codes,
              const uint8_t* occx, const uint8_t* occy, float* out,
              const int* skip, int I, int J, int K, int bk, long ldx,
              long ldy, cudaStream_t stream) {
  switch (tn) {
    case 1: return launch<TM, 1>(x, y, codes, occx, occy, out, skip, I, J, K, bk, ldx, ldy, stream);
    case 2: return launch<TM, 2>(x, y, codes, occx, occy, out, skip, I, J, K, bk, ldx, ldy, stream);
    case 4: return launch<TM, 4>(x, y, codes, occx, occy, out, skip, I, J, K, bk, ldx, ldy, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (I*bm, K*bk) and y (K*bk, J*bn) row-major f32, zero-padded to block
// multiples; codes (I, J, K) int32; occx (I*bm/16, K*bk/16) and occy
// (K*bk/16, J*bn/16) uint8 tile-occupancy flags; out (I*bm, J*bn).
// bm and bn must be 16, 32 or 64; bk a multiple of 16.
extern "C" int rt_dispatch(const float* x, const float* y, const int* codes,
                           const uint8_t* occx, const uint8_t* occy,
                           float* out, const int* skip, int I, int J, int K,
                           int bm, int bk, int bn, void* stream) {
  const long ldx = (long)K * bk, ldy = (long)J * bn;
  const int tm = bm / rt::T, tn = bn / rt::T;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tm) {
    case 1: return launch_tn<1>(tn, x, y, codes, occx, occy, out, skip, I, J, K, bk, ldx, ldy, s);
    case 2: return launch_tn<2>(tn, x, y, codes, occx, occy, out, skip, I, J, K, bk, ldx, ldy, s);
    case 4: return launch_tn<4>(tn, x, y, codes, occx, occy, out, skip, I, J, K, bk, ldx, ldy, s);
  }
  return (int)cudaErrorInvalidValue;
}
