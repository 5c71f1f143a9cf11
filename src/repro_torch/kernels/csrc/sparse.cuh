// The block-sparse walks of spdmm.cu and spmm.cu (sm_90a, FP32 FMA units).
//
// A walk runs the 16-deep k slices of an output's nonzero tiles, slot by
// slot and k ascending inside a tile: step t is slice t % kts of slot
// t / kts, with kts = tk / 16.  Each output is one fmaf chain from 0 over
// those steps, so the walk rounds like the dense product (fma(0, y, p) ==
// p for finite y), whatever the thread layout and the ring depth.
//
// Tile-rows start longest first: row_order_kernel ranks them by
// descending tile count on the device, in the same C call as the walk.
//
// The slot lists (col_idx, or an intersection plan's xpos / ypos) are read
// 32 slots at a time, one per lane, with the next 32 in flight
// (SlotWindow), so a step's addresses cost a shuffle, not a load.
#pragma once

#include "fma.cuh"

namespace rt {

constexpr int XS = T + XPAD;    // shared row stride of a 16-deep x slice

// The slot indices of one walk: lane l holds the index of slot 32 w + l of
// the current window w and, loaded one window ahead, of the next.  get(s)
// takes slots in order (s grows by at most one from call to call) and is
// called by the whole warp with the same s.
struct SlotWindow {
  const int* idx;
  int cnt, end, cur, nxt;

  __device__ __forceinline__ void start(const int* p, int count, int lane) {
    idx = p;
    cnt = count;
    end = 32;
    cur = lane < cnt ? p[lane] : 0;
    nxt = 32 + lane < cnt ? p[32 + lane] : 0;
  }

  __device__ __forceinline__ int get(int s, int lane) {
    if (s >= end) {
      end += 32;
      cur = nxt;
      nxt = end + lane < cnt ? idx[end + lane] : 0;
    }
    return __shfl_sync(0xffffffffu, cur, s & 31);
  }
};

// 16 bytes global -> shared at shared address `dst`, through L2 only
// (cp.async.cg) or also through L1 (cp.async.ca), so that the warps of a
// CTA that copy the same x tile meet there.
template <bool L1>
__device__ __forceinline__ void cp_async16_at(uint32_t dst,
                                              const float* src) {
  if (L1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src));
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src));
}

// Floats of one warp's ring of S slots (x slices, then y slices).
template <int WR, int S>
__host__ __device__ constexpr int ring_floats() {
  return S * (WR * XS + T * T);
}

// One warp's walk over `steps` steps with its own ring of S slots at
// shared xs / ys (ys = xs + S * WR * XS): a slot holds the step's WR x 16
// x slice (row stride XS) and 16 x 16 y slice (row stride 16).
// bases(xt, yt) gives the next step's slices in global memory (row
// strides ldx and ldy; the steps are asked for in order, once each); each
// lane copies its fixed 16-byte pieces of them, whole (the slices lie
// inside their operands).  Lane (ly, lx) = (lane / 4, lane % 4) owns rows
// ly + 8 h (h < WR / 8) and columns 4 lx .. 4 lx + 3 of the warp's WR x 16
// outputs: acc[h][v].  No barrier but the warp's own.
template <int WR, int S, bool L1X, class Bases>
__device__ __forceinline__ void warp_walk(float* xs, float* ys, int steps,
                                          long ldx, long ldy, Bases bases,
                                          float (&acc)[WR / 8][4],
                                          int lane) {
  constexpr int X = WR * XS, Y = T * T, RL = WR / 8;
  constexpr int NX = WR * T / 4 / 32, NY = Y / 4 / 32;   // pieces a lane
  const int ly = lane / 4, lx = lane % 4;
  // this lane's pieces: piece q = lane + 32 p is row q / 4, columns
  // 4 (q % 4) .. + 3 of the slice
  long gx[NX], gy[NY];
  uint32_t sx[NX], sy[NY];
#pragma unroll
  for (int p = 0; p < NX; ++p) {
    const int q = lane + 32 * p;
    gx[p] = q / 4 * ldx + q % 4 * 4;
    sx[p] = smem_addr(xs + q / 4 * XS + q % 4 * 4);
  }
#pragma unroll
  for (int p = 0; p < NY; ++p) {
    const int q = lane + 32 * p;
    gy[p] = q / 4 * ldy + q % 4 * 4;
    sy[p] = smem_addr(ys + q * 4);
  }
  auto enqueue = [&](int slot) {
    const float *xt, *yt;
    bases(xt, yt);
#pragma unroll
    for (int p = 0; p < NX; ++p)
      cp_async16_at<L1X>(sx[p] + slot * X * 4, xt + gx[p]);
#pragma unroll
    for (int p = 0; p < NY; ++p)
      cp_async16_at<false>(sy[p] + slot * Y * 4, yt + gy[p]);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) enqueue(s);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<S - 2>();
    __syncwarp();   // step t landed; slot (t - 1) % S is free
    if (t + S - 1 < steps) enqueue((t + S - 1) % S);
    cp_async_commit();
    const float* xst = xs + (t % S) * X;
    const float* yst = ys + (t % S) * Y;
    float4 xa[RL][T / 4], bv[T];
#pragma unroll
    for (int h = 0; h < RL; ++h)
#pragma unroll
      for (int k4 = 0; k4 < T / 4; ++k4)
        xa[h][k4] = *reinterpret_cast<const float4*>(
            xst + (ly + 8 * h) * XS + k4 * 4);
#pragma unroll
    for (int k = 0; k < T; ++k)
      bv[k] = *reinterpret_cast<const float4*>(yst + k * T + lx * 4);
#pragma unroll
    for (int k = 0; k < T; ++k) {
      const float b[4] = {bv[k].x, bv[k].y, bv[k].z, bv[k].w};
      float ak[RL];
#pragma unroll
      for (int h = 0; h < RL; ++h) ak[h] = lane_of(xa[h][k / 4], k % 4);
      fma_step(acc, ak, b);
    }
  }
  cp_async_wait<0>();
}

// The tile-rows in descending order of key (ties in row order): rank[i] =
// #{j : key[j] > key[i]} + #{j < i : key[j] == key[i]}, order[rank[i]] =
// i, one thread per row over keys staged in shared memory.  O(mb^2)
// comparisons: 0.0045 ms on the H100 at the GNN's 208 tile-rows.
__global__ void __launch_bounds__(256)
row_order_kernel(const int* __restrict__ key, int mb,
                 int* __restrict__ order) {
  __shared__ int ks[1024];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int ki = i < mb ? key[i] : 0;
  int rank = 0;
  for (int j0 = 0; j0 < mb; j0 += 1024) {
    const int n = min(1024, mb - j0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) ks[j] = key[j0 + j];
    __syncthreads();
    for (int j = 0; j < n; ++j)
      rank += ks[j] > ki || (ks[j] == ki && j0 + j < i);
  }
  if (i < mb) order[rank] = i;
}

inline cudaError_t launch_row_order(const int* key, int mb, int* order,
                                    cudaStream_t s) {
  row_order_kernel<<<(mb + 255) / 256, 256, 0, s>>>(key, mb, order);
  return cudaGetLastError();
}

// Store a warp's WR x 16 outputs (acc as warp_walk leaves them) at row
// r0, column c0 of out (row stride ldo, 16-byte aligned rows).
template <int WR>
__device__ __forceinline__ void warp_store(float* __restrict__ out, long ldo,
                                           long r0, long c0,
                                           const float (&acc)[WR / 8][4],
                                           int lane) {
#pragma unroll
  for (int h = 0; h < WR / 8; ++h)
    *reinterpret_cast<float4*>(out + (r0 + lane / 4 + 8 * h) * ldo + c0 +
                               lane % 4 * 4) =
        make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
}

}  // namespace rt
