// Sparsity Profiler: per-tile nonzero counts, (M, N) -> (Mb, Nb) int32,
// or over a stack of B matrices, (B, M, N) -> (B, Mb, Nb).
//
// Replaces the Pallas kernel of src/repro/kernels/profile.py:25 (its
// pallas_call at :35), one grid step per (tm, tn) tile with a (1, 1)
// output block, and, for a stack, the fused reduction of
// batched_block_counts (src/repro/core/profiler.py:60) that profiles a
// serving wave's request inputs.  Here one CTA of 256 threads covers 256
// columns and up to 64 rows of one tile row of one matrix of the stack
// (blockIdx.z; the matrices lie a batch stride apart); each thread walks
// one column down those rows (neighbouring threads on neighbouring
// addresses), counts x != 0, adds its count to its tile's counter in
// shared memory, and the CTA adds each counter to the output with one
// integer atomic.  Integer sums are exact and order-free, so the counts
// equal the plain version's whatever the schedule, and each matrix of a
// stack counts bitwise as it does alone.  Any tile shape works, and
// ragged edge tiles count only the elements inside the matrix: no padded
// copy is made.  The caller zeroes ``out``.
//
// Bound on the H100: the bytes of x, read once (a pure streaming
// reduction: one compare and one add per element).
#include "common.cuh"

namespace {

constexpr int COLS = 256;     // columns per CTA (one per thread)
constexpr int ROWS = 64;      // rows per CTA at most (within one tile row)

template <typename E>
__global__ void tile_nnz_kernel(const E* __restrict__ x, int* __restrict__ out,
                                int M, int N, long ld, long bs, int tm, int tn,
                                int mb, int nb, int chunks) {
  __shared__ int counts[COLS + 1];
  x += (long)blockIdx.z * bs;                         // this CTA's matrix
  out += (long)blockIdx.z * mb * nb;
  const int c0 = blockIdx.x * COLS;
  const int ti = blockIdx.y / chunks;                 // tile row
  const int r0 = ti * tm + (blockIdx.y % chunks) * ROWS;
  const int r1 = min(min(r0 + ROWS, (ti + 1) * tm), M);
  const int t0 = c0 / tn;                             // first tile column
  const int ntiles = (min(c0 + COLS, N) - 1) / tn - t0 + 1;
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) counts[t] = 0;
  __syncthreads();
  const int c = c0 + threadIdx.x;
  if (c < N) {
    int n = 0;
    for (int r = r0; r < r1; ++r) n += rt::to_f32(x[(long)r * ld + c]) != 0.f;
    if (n) atomicAdd(&counts[c / tn - t0], n);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x)
    if (counts[t]) atomicAdd(&out[(long)ti * nb + t0 + t], counts[t]);
}

template <typename E>
int launch(const void* x, int* out, int B, int M, int N, long ld, long bs,
           int tm, int tn, cudaStream_t stream) {
  const int mb = (M + tm - 1) / tm, nb = (N + tn - 1) / tn;
  const int chunks = (tm + ROWS - 1) / ROWS;
  dim3 grid((N + COLS - 1) / COLS, mb * chunks, B);
  tile_nnz_kernel<E><<<grid, COLS, 0, stream>>>(
      static_cast<const E*>(x), out, M, N, ld, bs, tm, tn, mb, nb, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, M, N): B matrices bs elements apart (bs = 0 for one matrix), each
// with row stride ld, float32 (dtype 0) or bfloat16 (1); out (B,
// ceil(M/tm), ceil(N/tn)) int32, zeroed by the caller.  B is the grid's z
// extent (at most 65535).
extern "C" int rt_tile_nnz(const void* x, int dtype, int* out, int B, int M,
                           int N, long ld, long bs, int tm, int tn,
                           void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return 0;
  if (tm <= 0 || tn <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(x, out, B, M, N, ld, bs, tm, tn, s);
    case 1: return launch<__nv_bfloat16>(x, out, B, M, N, ld, bs, tm, tn, s);
  }
  return (int)cudaErrorInvalidValue;
}
