// The executor's block path: one launch per dynasparse_matmul that walks
// the planner's (I, J, K) primitive-code grid on the device.
//
// Replaces the per-step dispatch of src/repro/core/dynasparse.py:239-258,
// where a lax.scan over output blocks and a fori_loop over k ran one
// lax.switch branch -- and, with kernels on, one Pallas call of
// src/repro/kernels/gemm.py:47, spdmm.py:92 or spmm.py:154 -- per (i, j, k)
// step.  Here one CTA owns one output sub-block of at most 64 x 64 and runs
// the k loop in order, reading the code of its enclosing (bm, bn) block,
// codes[i, j, k], from device memory:
//
//   SKIP   costs nothing;
//   GEMM   is a dense block MAC;
//   SPDMM  walks only the lhs block's nonzero 16x16 tiles;
//   SPMM   walks only the tile pairs nonzero on both sides.
//
// Blocks of 128 or 256 rows or columns (the LM's (256, 256, 256)) run as
// 2 x 2 or 4 x 4 CTAs of 64 x 64 that share the block's codes, so a thread
// keeps at most 4 x 4 accumulators whatever the block edge.
//
// Tile occupancy comes from per-16x16-tile flags of x and y.  Operands are
// float32 or bfloat16 (both the same type), widened to float32 in shared
// memory.  Each step accumulates into a fresh float32 partial that is then
// added to the running sum, as the reference adds acc + step.  The code
// and the flags are the same for every thread of the CTA, so the branches
// do not diverge.
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

template <typename E, int TM, int TN>
__global__ void dispatch_kernel(const E* __restrict__ x,
                                const E* __restrict__ y,
                                const int* __restrict__ codes,
                                const uint8_t* __restrict__ occx,
                                const uint8_t* __restrict__ occy,
                                float* __restrict__ out,
                                const int* __restrict__ skip, int J, int K,
                                int bk, int rm, int rn, long ldx, long ldy) {
  if (skip != nullptr && *skip != 0) return;
  constexpr int BM = TM * rt::T, BN = TN * rt::T;
  __shared__ float xs[BM][rt::T + 1];
  __shared__ float ys[rt::T][BN + 1];
  const int bi = blockIdx.y, bj = blockIdx.x;   // sub-block of the output
  const int kts = bk / rt::T;       // 16-wide k slices per block
  const long xtc = ldx / rt::T;     // tile columns of x (= tile rows of y)
  const long ytc = ldy / rt::T;     // tile columns of y
  const int* code_row = codes + ((long)(bi / rm) * J + bj / rn) * K;

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

struct Args {
  const void* x;
  const void* y;
  const int* codes;
  const uint8_t* occx;
  const uint8_t* occy;
  float* out;
  const int* skip;
  int I, J, K, bk, rm, rn;
  long ldx, ldy;
  cudaStream_t stream;
};

template <typename E, int TM, int TN>
int launch(const Args& a) {
  dim3 grid(a.J * a.rn, a.I * a.rm), block(rt::T, rt::T);
  dispatch_kernel<E, TM, TN><<<grid, block, 0, a.stream>>>(
      static_cast<const E*>(a.x), static_cast<const E*>(a.y), a.codes,
      a.occx, a.occy, a.out, a.skip, a.J, a.K, a.bk, a.rm, a.rn, a.ldx,
      a.ldy);
  return (int)cudaGetLastError();
}

template <typename E, int TM>
int launch_tn(int tn, const Args& a) {
  switch (tn) {
    case 1: return launch<E, TM, 1>(a);
    case 2: return launch<E, TM, 2>(a);
    case 4: return launch<E, TM, 4>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename E>
int launch_tm(int tm, int tn, const Args& a) {
  switch (tm) {
    case 1: return launch_tn<E, 1>(tn, a);
    case 2: return launch_tn<E, 2>(tn, a);
    case 4: return launch_tn<E, 4>(tn, a);
  }
  return (int)cudaErrorInvalidValue;
}

// Sub-block edge in 16-wide tiles, and sub-blocks per block edge, for a
// block edge of 16, 32 or a multiple of 64.
bool split(int edge, int* tiles, int* per_block) {
  if (edge == 16 || edge == 32) {
    *tiles = edge / rt::T;
    *per_block = 1;
    return true;
  }
  if (edge > 0 && edge % 64 == 0) {
    *tiles = 4;
    *per_block = edge / 64;
    return true;
  }
  return false;
}

}  // namespace

// x (I*bm, K*bk) and y (K*bk, J*bn) row-major, both float32 (dtype 0) or
// both bfloat16 (dtype 1), zero-padded to block multiples; codes (I, J, K)
// int32; occx (I*bm/16, K*bk/16) and occy (K*bk/16, J*bn/16) uint8
// tile-occupancy flags; out (I*bm, J*bn) float32.  bm and bn must be 16,
// 32 or a multiple of 64; bk a multiple of 16.
extern "C" int rt_dispatch(const void* x, const void* y, int dtype,
                           const int* codes, const uint8_t* occx,
                           const uint8_t* occy, float* out, const int* skip,
                           int I, int J, int K, int bm, int bk, int bn,
                           void* stream) {
  Args a{x, y, codes, occx, occy, out, skip, I, J, K, bk, 1, 1,
         (long)K * bk, (long)J * bn, (cudaStream_t)stream};
  int tm, tn;
  if (!split(bm, &tm, &a.rm) || !split(bn, &tn, &a.rn) || bk % rt::T)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_tm<float>(tm, tn, a);
    case 1: return launch_tm<__nv_bfloat16>(tm, tn, a);
  }
  return (int)cudaErrorInvalidValue;
}
