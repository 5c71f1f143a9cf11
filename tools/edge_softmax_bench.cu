// Microbenchmark of GAT's edge_softmax kernel at CiteSeer's shape, beside
// the memory-bound yardsticks of its access pattern, on one CUDA card.
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/edge_softmax_bench tools/edge_softmax_bench.cu
//   build/edge_softmax_bench [hub]
//
// a is 3327 x 3327 float32 with its diagonal and 2 random columns a row
// set (seeded); with "hub", row 1000 also holds 541 random columns, as
// CiteSeer's longest row of A does.  Times are CUDA events over 50 calls
// after 3 warm-up calls, each ms per call:
//
// * memcpy of a (44 MB read, 44 MB written) and memset of a;
// * copy_rows / read_rows / write_rows: one warp a row, one 4-byte
//   coalesced access a lane, 8 loads in flight -- the pattern of the
//   kernel's pass 1 without its work;
// * edge_softmax: rt_edge_softmax with the wrapper's launch shape at
//   out_block (16, 16) (project_kernel and the main kernel), then the
//   main kernel alone; and an FNV-1a checksum of alpha, to compare builds
//   bit for bit.
#include "../src/repro_torch/kernels/csrc/edge_softmax.cu"

#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

namespace {

__global__ void copy_rows(const float* a, float* out, int n) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (i >= n) return;
  const float* ai = a + (long)i * n;
  float* oi = out + (long)i * n;
  for (int c0 = 0; c0 < (n + 31) / 32; c0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = (c0 + u) * 32 + lane;
      v[u] = j < n ? ai[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = (c0 + u) * 32 + lane;
      if (j < n) oi[j] = 2.f * v[u];
    }
  }
}

__global__ void read_rows(const float* a, unsigned* out, int n) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (i >= n) return;
  const float* ai = a + (long)i * n;
  unsigned acc = 0;
  for (int c0 = 0; c0 < (n + 31) / 32; c0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = (c0 + u) * 32 + lane;
      v[u] = j < n ? ai[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += __ballot_sync(FULL, v[u] != 0.f);
  }
  if (lane == 0) out[i] = acc;
}

__global__ void write_rows(float* out, int n) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (i >= n) return;
  for (int j = lane; j < n; j += 32) out[(long)i * n + j] = 0.f;
}

}  // namespace

int main(int argc, char** argv) {
  const bool hub = argc > 1 && !strcmp(argv[1], "hub");
  const int n = 3327, f = 16, bm = 16, bn = 16, rows = 16;
  const int nb = (n + bn - 1) / bn, nchunks = (n + 31) / 32;
  // the wrapper's shape (kernels/edge_softmax.py edge_launch): the list
  // route, s_dst staged, the counters in shared memory
  const int smem = rows * (8 * nchunks + 16) + 4 * (n + nb);
  std::vector<float> ha((size_t)n * n, 0.f), hz((size_t)n * f), hatt(2 * f);
  std::mt19937 rng(0);
  std::uniform_int_distribution<int> col(0, n - 1);
  std::normal_distribution<float> normal;
  for (int i = 0; i < n; ++i) {
    ha[(size_t)i * n + i] = 1.f;
    for (int e = 0; e < 2; ++e) ha[(size_t)i * n + col(rng)] = 0.5f;
  }
  if (hub)
    for (int e = 0; e < 541; ++e) ha[(size_t)1000 * n + col(rng)] = 0.25f;
  for (auto& v : hz) v = normal(rng);
  for (auto& v : hatt) v = normal(rng);
  const size_t bytes = (size_t)n * n * sizeof(float);
  float *a, *z, *att, *s, *out;
  int* counts;
  unsigned* words;
  cudaMalloc(&a, bytes);
  cudaMalloc(&out, bytes);
  cudaMalloc(&z, hz.size() * sizeof(float));
  cudaMalloc(&att, 2 * f * sizeof(float));
  cudaMalloc(&s, 2 * n * sizeof(float));
  cudaMalloc(&counts, (size_t)nb * nb * sizeof(int));
  cudaMalloc(&words, n * sizeof(unsigned));
  cudaMemcpy(a, ha.data(), bytes, cudaMemcpyHostToDevice);
  cudaMemcpy(z, hz.data(), hz.size() * sizeof(float), cudaMemcpyHostToDevice);
  cudaMemcpy(att, hatt.data(), 2 * f * sizeof(float), cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  auto time = [&](const char* name, auto fn) {
    for (int w = 0; w < 3; ++w) fn();
    cudaDeviceSynchronize();
    const int reps = 50;
    cudaEventRecord(e0);
    for (int r = 0; r < reps; ++r) fn();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    printf("%-36s %.4f ms  %s\n", name, ms / reps,
           cudaGetErrorString(cudaGetLastError()));
  };
  const int ctas = (n + 15) / 16;
  time("memcpy of a", [&] {
    cudaMemcpyAsync(out, a, bytes, cudaMemcpyDeviceToDevice);
  });
  time("memset of a", [&] { cudaMemsetAsync(out, 0, bytes); });
  time("copy_rows", [&] { copy_rows<<<ctas, 512>>>(a, out, n); });
  time("read_rows", [&] { read_rows<<<ctas, 512>>>(a, words, n); });
  time("write_rows", [&] { write_rows<<<ctas, 512>>>(out, n); });
  auto edge = [&] {
    rt_edge_softmax(a, 0, n, z, 0, att, att + f, s, out, counts, n, f, bm,
                    bn, LIST, rows, 1, 1, 1, smem, 0.2f, 0.02f, nullptr);
  };
  time(hub ? "edge_softmax (hub row)" : "edge_softmax", edge);
  Args p{a, n, s, s + n, out, counts, n, bm, bn, nb, rows, 1, 1, 1,
         0.2f, 0.02f};
  time("edge_softmax main kernel", [&] {
    launch_main<float, float, LIST>(p, (n + bm - 1) / bm, 32 * rows, smem,
                                    nullptr);
  });
  edge();
  std::vector<float> ho((size_t)n * n);
  cudaMemcpy(ho.data(), out, bytes, cudaMemcpyDeviceToHost);
  unsigned long long h = 1469598103934665603ull;
  const unsigned char* bp = reinterpret_cast<const unsigned char*>(ho.data());
  for (size_t b = 0; b < bytes; ++b) h = (h ^ bp[b]) * 1099511628211ull;
  printf("alpha fnv1a %016llx\n", h);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
