// FlashAttention forward: online softmax, the (Sq x Skv) scores never
// stored.
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention.py:75
// (its pallas_call at :92), which ran a (b*h, q-block, kv-block) grid with
// the running max m, denominator l and accumulator acc in VMEM scratch.
// Here one CTA of 256 threads owns BQ = 256 / G query rows of one (b, h)
// and loops over all kv positions itself (the TPU grid's sequential kv
// axis becomes the loop):
//
//   * a group of G = D / 16 neighbouring lanes shares one query row; lane
//     g of the group holds dims g, g + G, g + 2G, ... (16 of them) of q and
//     of the float32 accumulator, so a score is 16 FMAs per lane and a
//     butterfly of log2(G) shuffles, and the K/V reads of a group hit G
//     consecutive shared-memory words (no bank conflict);
//   * K and V stream through shared memory in tiles of BK = 256 / G keys
//     (32 KB for both, any D), widened to float32;
//   * every 16 keys, m, l and acc are rescaled once (float32 throughout).
//
// Semantics kept from the reference, which the wrapper (ops.py) relies on:
// queries sit at the end of the kv sequence (qpos = row + Skv - Sq, Sq a
// multiple of the reference's bq); a kv block of the reference's bk is
// processed only if it is not strictly in the future of the row's whole
// bq-block, so a row sees exactly the keys the TPU kernel fed it; masked
// scores are -1e30 (not -inf), so a row with no visible key among its
// processed keys averages them uniformly instead of giving NaN; the output
// is acc / max(l, 1e-30) in q's type.  GQA: head h reads kv head
// h / (H / Hkv) in place, with no repeated copy of K and V.
//
// Bound on the H100: operations (4 * D flops per visible (query, key)
// pair), against the tensor cores' bf16 rate; this first version runs on
// the float32 FMA units without tensor cores or asynchronous copies.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_LANE = 16;   // head dims per lane
constexpr int CHUNK = 16;      // keys per online-softmax rescale
constexpr float NEG = -1e30f;

template <typename E, int G>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const E* __restrict__ q, const E* __restrict__ k,
             const E* __restrict__ v, E* __restrict__ o, int H, int rep,
             int Sq, int Skv, int bq, int bk, int causal, float scale) {
  constexpr int D = PER_LANE * G;
  constexpr int BQ = THREADS / G;
  constexpr int BK = THREADS / G;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = b * (H / rep) + h / rep;
  const int g = threadIdx.x % G;
  const int row0 = blockIdx.x * BQ;
  const int row = row0 + threadIdx.x / G;
  const int off = Skv - Sq;   // queries aligned to the end of the kv

  // keys [0, L(r)) of row r are processed (the reference's block skip)
  auto limit = [&](int r) -> int {
    if (!causal) return Skv;
    const int q_end = (r / bq + 1) * bq - 1 + off;
    if (q_end < 0) return 0;
    return min(Skv, (q_end / bk + 1) * bk);
  };
  const int my_limit = row < Sq ? limit(row) : 0;
  const int cta_limit = limit(min(row0 + BQ, Sq) - 1);
  const int qpos = row + off;

  const E* qrow = q + ((long)bh * Sq + min(row, Sq - 1)) * D;
  const E* kb = k + (long)kvh * Skv * D;
  const E* vb = v + (long)kvh * Skv * D;
  float qr[PER_LANE], acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    qr[i] = rt::to_f32(qrow[g + G * i]);
    acc[i] = 0.f;
  }
  float m = NEG, l = 0.f;

  for (int t0 = 0; t0 < cta_limit; t0 += BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int kk = t0 + e / D;
      const bool in = kk < Skv;
      ks[e / D][e % D] = in ? rt::to_f32(kb[(long)kk * D + e % D]) : 0.f;
      vs[e / D][e % D] = in ? rt::to_f32(vb[(long)kk * D + e % D]) : 0.f;
    }
    __syncthreads();
    for (int c0 = 0; c0 < BK && t0 + c0 < cta_limit; c0 += CHUNK) {
      float s[CHUNK];
      float m_cur = -INFINITY;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i)
          part = fmaf(qr[i], ks[c0 + c][g + G * i], part);
#pragma unroll
        for (int w = G / 2; w > 0; w /= 2)
          part += __shfl_xor_sync(0xffffffffu, part, w);
        const int kpos = t0 + c0 + c;
        float sc = part * scale;
        if (kpos >= my_limit) sc = -INFINITY;         // never processed
        else if (causal && kpos > qpos) sc = NEG;     // masked
        s[c] = sc;
        m_cur = fmaxf(m_cur, sc);
      }
      const float m_new = fmaxf(m, m_cur);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        s[c] = expf(s[c] - m_new);
        psum += s[c];
      }
      l = alpha * l + psum;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        float pv = 0.f;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          pv = fmaf(s[c], vs[c0 + c][g + G * i], pv);
        acc[i] = alpha * acc[i] + pv;
      }
      m = m_new;
    }
  }
  if (row < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    E* orow = o + ((long)bh * Sq + row) * D;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      rt::store_f32(&orow[g + G * i], acc[i] * inv);
  }
}

template <typename E, int G>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Skv, int bq, int bk, int causal,
           float scale, cudaStream_t stream) {
  constexpr int BQ = THREADS / G;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<E, G><<<grid, THREADS, 0, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(o), H, H / Hkv, Sq, Skv, bq,
      bk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int H, int Hkv, int Sq, int Skv, int bq, int bk,
             int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<E, 1>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
    case 32: return launch<E, 2>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
    case 64: return launch<E, 4>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
    case 128: return launch<E, 8>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o (B, H, Sq, D); k, v (B, Hkv, Skv, D); contiguous, all float32
// (dtype 0) or all bfloat16 (1).  D in {16, 32, 64, 128}; H % Hkv == 0;
// Sq % bq == 0 and Skv % bk == 0 (the wrapper front-pads).
extern "C" int rt_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, int dtype, int B,
                                  int H, int Hkv, int Sq, int Skv, int D,
                                  int bq, int bk, int causal, float scale,
                                  void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || H % Hkv || bq <= 0 || bk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_d<float>(D, q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
    case 1: return launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
