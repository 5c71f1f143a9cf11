// Dense tiled matmul: out = x @ y in float32.
//
// Replaces the Pallas kernel src/repro/kernels/gemm.py:37 (gemm, body
// _gemm_kernel), whose (i, j, k) grid carried an f32 VMEM accumulator from
// one k step to the next.  Here a CTA owns one output tile and runs the
// whole k loop itself; nothing is split over k.
//
// Bound on the H100, at the shapes the GNN path launches:
//   * the gemm strategy's Aggregate, A_mean @ H0 (3328 x 3328 @ 3328 x
//     3712): 82 GFLOP against 0.14 GB, bound by operations (1.23 ms at the
//     FP32 peak of 67 TFLOP/s);
//   * the Updates and the second Aggregate, outputs 16 columns wide
//     (3328 x 3712 @ 3712 x 16, 3328 x 3328 @ 3328 x 16): ~2 flops per
//     byte of x, bound by reading x once (~0.015 ms).
// The host picks the CTA tile from the output's shape (kernels/gemm.py
// gemm_launch):
//   * 128 x 128 (gemm_wide_kernel) for wide products: 256 threads of 8 x 8
//     outputs.  x's 128 x 16 tile is stored k-major, transposed on its way
//     through registers, so a thread reads four rows of one k, and four
//     columns of y, with one 16-byte shared load: 64 FMAs per 4 loads.  x
//     (global -> registers -> shared) and y (cp.async) are double-buffered:
//     the loads of step t + 1 are issued before the FMAs of step t, x's
//     registers stored after them; one barrier per 16-deep k step;
//   * 16 x 16 (2 x 1 per thread, 128 threads, 64-deep k stages) for
//     16-wide outputs, or when 128 x 128 tiles would leave the card short
//     of CTAs, so that one CTA per 16 rows keeps several stages of x in
//     flight: gemm_narrow_kernel, both operands row-major through a ring
//     of cp.async stages, one barrier per stage, a thread reading four k
//     of an x row with one 16-byte shared load (fma.cuh).
// Not the tensor cores: TF32 (or 3xTF32) would change the rounding.
//
// Rounding: every output is one fmaf chain from 0 over k ascending (a
// 16-deep k slice at a time; the tail past K is neither loaded nor
// multiplied), exactly as the first version's, so the result does not
// depend on the tile and equals dispatch.cu's float32 route with all-GEMM
// codes and one k-block bit for bit.
#include "fma.cuh"

namespace {

// The 16 x 16 tile: thread (ty, tx) owns rows ty and ty + 8, column tx.
constexpr int NARROW = 16, NARROW_K = 64, NARROW_STAGES = 4;
constexpr int NARROW_XS = NARROW_K + rt::XPAD;       // x row stride
constexpr int NARROW_SMEM =
    NARROW_STAGES * (NARROW * NARROW_XS + NARROW_K * NARROW) * 4;

__global__ void __launch_bounds__(128)
gemm_narrow_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out, int M, int K, int N) {
  constexpr int S = NARROW_STAGES;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                 // [S][16][NARROW_XS]
  float* ys = smem + S * NARROW * NARROW_XS;        // [S][64][16]
  const int tid = threadIdx.x, ty = tid / NARROW, tx = tid % NARROW;
  const long row0 = (long)blockIdx.y * NARROW, col0 = (long)blockIdx.x * NARROW;
  const int steps = (K + NARROW_K - 1) / NARROW_K;

  auto enqueue = [&](int step) {
    const int slot = step % S;
    const long k0 = (long)step * NARROW_K;
    for (int c = tid; c < NARROW * NARROW_K / 4; c += 128) {
      const int r = c / (NARROW_K / 4), cc = c % (NARROW_K / 4) * 4;
      rt::cp_async_row4(&xs[(slot * NARROW + r) * NARROW_XS + cc], x,
                        row0 + r, k0 + cc, M, K, K);
    }
    for (int c = tid; c < NARROW_K * NARROW / 4; c += 128) {
      const int r = c / (NARROW / 4), cc = c % (NARROW / 4) * 4;
      rt::cp_async_row4(&ys[(slot * NARROW_K + r) * NARROW + cc], y, k0 + r,
                        col0 + cc, K, N, N);
    }
  };

  float acc[2][1] = {{0.f}, {0.f}};
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) enqueue(s);
    rt::cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    rt::cp_async_wait<S - 2>();
    __syncthreads();   // `step` landed; slot (step - 1) % S is free
    if (step + S - 1 < steps) enqueue(step + S - 1);
    rt::cp_async_commit();
    const float* xst = xs + (step % S) * NARROW * NARROW_XS;
    const float* yst = ys + (step % S) * NARROW_K * NARROW;
    const int kvalid = min(NARROW_K, K - step * NARROW_K);   // 16 | kvalid
#pragma unroll
    for (int k4 = 0; k4 < NARROW_K / 4; ++k4) {
      if (k4 * 4 >= kvalid) break;
      const float4 a0 = *reinterpret_cast<const float4*>(
          &xst[ty * NARROW_XS + k4 * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(
          &xst[(ty + 8) * NARROW_XS + k4 * 4]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float ak[2] = {rt::lane_of(a0, kk), rt::lane_of(a1, kk)};
        const float b[1] = {yst[(k4 * 4 + kk) * NARROW + tx]};
        rt::fma_step(acc, ak, b);
      }
    }
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long r = row0 + ty + 8 * i;
    if (r < M && col0 + tx < N) out[r * N + col0 + tx] = acc[i][0];
  }
}

// The 128 x 128 tile (see the note at the top).
constexpr int WIDE = 128, WIDE_K = 16, WIDE_XS = WIDE + 4;

__global__ void __launch_bounds__(256, 2)
gemm_wide_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float xs[2][WIDE_K][WIDE_XS];   // k-major
  __shared__ __align__(16) float ys[2][WIDE_K][WIDE];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long row0 = (long)blockIdx.y * WIDE, col0 = (long)blockIdx.x * WIDE;
  const int steps = K / WIDE_K;
  float4 xr[2];
  auto load_x = [&](int step) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int q = tid + 256 * p, r = q / 4, kc = q % 4;
      xr[p] = row0 + r < M
                  ? *reinterpret_cast<const float4*>(
                        x + (row0 + r) * K + step * WIDE_K + kc * 4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_x = [&](int buf) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int q = tid + 256 * p, r = q / 4, kc = q % 4;
      xs[buf][kc * 4][r] = xr[p].x;
      xs[buf][kc * 4 + 1][r] = xr[p].y;
      xs[buf][kc * 4 + 2][r] = xr[p].z;
      xs[buf][kc * 4 + 3][r] = xr[p].w;
    }
  };
  auto load_y = [&](int step, int buf) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int q = tid + 256 * p, r = q / 32, cc = q % 32 * 4;
      rt::cp_async_row4(&ys[buf][r][cc], y, (long)step * WIDE_K + r,
                        col0 + cc, K, N, N);
    }
    rt::cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (steps > 0) {
    load_x(0);
    load_y(0, 0);
    store_x(0);
  }
  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    rt::cp_async_wait<0>();
    __syncthreads();   // buffers `cur` filled; nobody reads cur ^ 1 now
    if (step + 1 < steps) {
      load_x(step + 1);
      load_y(step + 1, cur ^ 1);
    }
#pragma unroll
    for (int k = 0; k < WIDE_K; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ys[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ys[cur][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      rt::fma_step(acc, a, b);
    }
    if (step + 1 < steps) store_x(cur ^ 1);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long r = row0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long c = col0 + j * 64 + tx * 4;
      if (c < N)
        *reinterpret_cast<float4*>(&out[r * N + c]) =
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                        acc[i][4 * j + 3]);
    }
  }
}

}  // namespace

// x (M, K), y (K, N), out (M, N), row-major float32 with M, K, N
// multiples of 16 (K may be 0: out = 0) and 16-byte aligned base
// pointers.  tile: 128 (128 x 128) or 16 (16 x 16), as kernels/gemm.py
// gemm_launch picks it.
extern "C" int rt_gemm(const float* x, const float* y, float* out, int M,
                       int K, int N, int tile, void* stream) {
  if (M % rt::T || K % rt::T || N % rt::T || M <= 0 || K < 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 128: {
      const dim3 grid((N + WIDE - 1) / WIDE, (M + WIDE - 1) / WIDE);
      gemm_wide_kernel<<<grid, 256, 0, s>>>(x, y, out, M, K, N);
      return (int)cudaGetLastError();
    }
    case 16: {   // NARROW_SMEM is under the 48 KB default
      const dim3 grid((N + NARROW - 1) / NARROW, (M + NARROW - 1) / NARROW);
      gemm_narrow_kernel<<<grid, 128, NARROW_SMEM, s>>>(x, y, out, M, K, N);
      return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorInvalidValue;
}
