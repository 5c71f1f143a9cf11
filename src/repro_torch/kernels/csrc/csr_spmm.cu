// Row-gather SPMM over the ELL view: out[i] = sum_{s < min(counts[i], rmax)}
// vals[i, s] * y[cols[i, s]], float32 accumulation.
//
// Replaces the Pallas kernel src/repro/kernels/csr_spmm.py:43 (csr_spmm,
// body _csr_spmm_kernel), whose (m, nb, rmax) grid took one row and one
// slot per step and masked slots past the row's count.  Here each thread
// owns one output element (row, col): a CTA of 256 threads spans
// ``cols_per`` columns (32..256, a power of two that covers the width up
// to 256) of 256 / cols_per rows, and a wide output adds CTAs along y.
// Each slot's y row is read as a contiguous vector across the threads of
// the row, and the loop stops at the row's own count; splitting the
// columns across CTAs keeps a hub row (hundreds of slots) from running
// all of its columns on one warp.
//
// Bound on the H100: the gathered y rows (nnz * n * 4 bytes) plus the ELL
// view and the output; FMAs per byte are below 1.  Each slot is two
// dependent loads (column id, then the y element), so a long row is bound
// by load latency; prefetching the slots is later work.
//
// ``run`` (nullable) is a device flag: when it points to 0 the kernel exits
// at once.  The executor launches this kernel and the block path together
// and lets the device pick, so it never copies the format decision to the
// host.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void csr_spmm_kernel(const float* __restrict__ vals,
                                const int* __restrict__ cols,
                                const int* __restrict__ counts,
                                const float* __restrict__ y,
                                float* __restrict__ out,
                                const int* __restrict__ run, int m, int rmax,
                                int n, long ldo, int cols_per) {
  if (run != nullptr && *run == 0) return;
  const int rows_per = THREADS / cols_per;
  const int row = blockIdx.x * rows_per + threadIdx.x / cols_per;
  const long col = (long)blockIdx.y * cols_per + threadIdx.x % cols_per;
  if (row >= m || col >= n) return;
  const int cnt = min(counts[row], rmax);
  const float* v = vals + (long)row * rmax;
  const int* c = cols + (long)row * rmax;
  float acc = 0.f;
  for (int s = 0; s < cnt; ++s) acc = fmaf(v[s], y[(long)c[s] * n + col], acc);
  out[(long)row * ldo + col] = acc;
}

}  // namespace

// vals/cols (m, rmax), counts (m,) true per-row counts (capped here), y
// (k, n) row-major, out rows of stride ldo (only [:m, :n] is written).
extern "C" int rt_csr_spmm(const float* vals, const int* cols,
                           const int* counts, const float* y, float* out,
                           const int* run, int m, int rmax, int n, long ldo,
                           void* stream) {
  int cols_per = 32;
  while (cols_per < n && cols_per < THREADS) cols_per *= 2;
  const int rows_per = THREADS / cols_per;
  dim3 grid((m + rows_per - 1) / rows_per, (n + cols_per - 1) / cols_per);
  csr_spmm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      vals, cols, counts, y, out, run, m, rmax, n, ldo, cols_per);
  return (int)cudaGetLastError();
}
