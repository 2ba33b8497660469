// Tiled pairwise distances [nq, d] x [ne, d] -> [nq, ne] f32, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/distance.py::_dist_kernel
// (wrapper pairwise_distance_pallas, PRUNE = false), the flat scan behind
// core/distributed.py:brute_force_knn, and ::_dist_prune_kernel (wrapper
// pairwise_distance_prune_pallas, PRUNE = true), which adds the
// triangle-inequality survival mask d <= r_q + r_e on the finished tile
// (sqeuclidean: the mask is taken on sqrt(max(d, 0)) and the squared d is
// returned; equality survives).  The TPU wrapper pads queries with r = -1
// and entries with r = -inf so that padding never survives; here the tile
// edges are masked instead and nothing outside [nq, ne] is written.
//   d_inf        max_t |q_t - e_t|       (bitwise equal to the plain version:
//                                         a max is exact in any order)
//   sqeuclidean  sum_t (q_t - e_t)^2     (>= 0 by construction)
//   ip           -sum_t q_t * e_t
// Full f32 on the CUDA cores: no TF32, no library product.  The TPU kernel
// expands sqeuclidean as |q|^2 - 2 q.e + |e|^2 to feed its matrix unit and
// clamps at 0; without a matrix unit in f32 the direct difference costs the
// same flops and loses no digits, and stays within the 1e-5 tolerance the
// reference's own tests hold the kernel to.
//
// What bounds it on this card: at the scan's width (d = 20) bytes — the
// [nq, ne] output is written once (268 MB at nq=1024, ne=65536) against
// about 3 flops per (pair, dimension).  Design: a block computes a
// 64 x 64 output tile with 256 threads, 4 x 4 outputs each, staging
// 32-wide chunks of d for its 64 queries and 64 entries in shared memory
// (transposed, padded against bank clashes); the reduction over d runs in
// registers inside the block, so nothing is carried between blocks.  Each
// output row of the tile is written as 16 consecutive floats per thread
// group.
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBE = 64;
constexpr int kBD = 32;
constexpr int kThreads = 256;

enum Metric { kDinf = 0, kSqEuclidean = 1, kIp = 2 };

template <int METRIC, bool PRUNE>
__global__ void __launch_bounds__(kThreads)
dist_kernel(const float* __restrict__ q, const float* __restrict__ e,
            const float* __restrict__ rq, const float* __restrict__ re,
            float* __restrict__ out, unsigned char* __restrict__ mask,
            int nq, int ne, int d) {
  __shared__ float qs[kBD][kBQ + 1];
  __shared__ float es[kBD][kBE + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.y * kBQ;
  const int e0 = blockIdx.x * kBE;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBD) {
    for (int t = threadIdx.x; t < kBQ * kBD; t += kThreads) {
      const int row = t / kBD, col = t % kBD;
      const int gq = q0 + row, gk = k0 + col;
      qs[col][row] = (gq < nq && gk < d) ? q[(long long)gq * d + gk] : 0.f;
    }
    for (int t = threadIdx.x; t < kBE * kBD; t += kThreads) {
      const int row = t / kBD, col = t % kBD;
      const int ge = e0 + row, gk = k0 + col;
      es[col][row] = (ge < ne && gk < d) ? e[(long long)ge * d + gk] : 0.f;
    }
    __syncthreads();
    const int kmax = min(kBD, d - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float qa[4], eb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[kk][ty + 16 * a];
#pragma unroll
      for (int c = 0; c < 4; ++c) eb[c] = es[kk][tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (METRIC == kDinf) {
            acc[a][c] = fmaxf(acc[a][c], fabsf(__fsub_rn(qa[a], eb[c])));
          } else if (METRIC == kSqEuclidean) {
            const float diff = __fsub_rn(qa[a], eb[c]);
            acc[a][c] = fmaf(diff, diff, acc[a][c]);
          } else {
            acc[a][c] = fmaf(qa[a], eb[c], acc[a][c]);
          }
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gq = q0 + ty + 16 * a;
    if (gq >= nq) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ge = e0 + tx + 16 * c;
      if (ge >= ne) continue;
      const float dv = (METRIC == kIp) ? -acc[a][c] : acc[a][c];
      const long long o = (long long)gq * ne + ge;
      out[o] = dv;
      if (PRUNE) {
        const float t = (METRIC == kSqEuclidean) ? __fsqrt_rn(fmaxf(dv, 0.f)) : dv;
        mask[o] = t <= __fadd_rn(rq[gq], re[ge]);
      }
    }
  }
}

template <bool PRUNE>
void launch(dim3 grid, cudaStream_t st, int metric, const float* q,
            const float* e, const float* rq, const float* re, float* out,
            unsigned char* mask, int nq, int ne, int d) {
  if (metric == kDinf)
    dist_kernel<kDinf, PRUNE><<<grid, kThreads, 0, st>>>(q, e, rq, re, out, mask, nq, ne, d);
  else if (metric == kSqEuclidean)
    dist_kernel<kSqEuclidean, PRUNE><<<grid, kThreads, 0, st>>>(q, e, rq, re, out, mask, nq, ne, d);
  else
    dist_kernel<kIp, PRUNE><<<grid, kThreads, 0, st>>>(q, e, rq, re, out, mask, nq, ne, d);
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 on success).  With
// ``mask`` non-null the survival mask is written too (rq [nq], re [ne]
// radii; mask [nq, ne] bytes 0/1).
extern "C" int pairwise_distance_launch(const float* q, const float* e,
                                        const float* rq, const float* re,
                                        float* out, unsigned char* mask,
                                        int nq, int ne, int d, int metric,
                                        void* stream) {
  if (nq < 0 || ne < 0 || d < 1 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  if (mask != nullptr && (rq == nullptr || re == nullptr))
    return (int)cudaErrorInvalidValue;
  if (nq == 0 || ne == 0) return 0;
  if ((nq + kBQ - 1) / kBQ > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((ne + kBE - 1) / kBE, (nq + kBQ - 1) / kBQ);
  cudaStream_t st = (cudaStream_t)stream;
  if (mask != nullptr)
    launch<true>(grid, st, metric, q, e, rq, re, out, mask, nq, ne, d);
  else
    launch<false>(grid, st, metric, q, e, rq, re, out, mask, nq, ne, d);
  return (int)cudaGetLastError();
}
