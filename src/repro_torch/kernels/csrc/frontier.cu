// Fused frontier scorer of the SM-tree cohort descent, for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/frontier.py:
//   _frontier_kernel         (PRUNE = false; shared epilogue _emit)
//   _frontier_kernel_pruned  (PRUNE = true: parent-distance pre-filter)
//
// For each (query i, frontier slot j) the kernel loads node page
// fids[i, j] and writes, for every entry s of the page,
//   dmax = d + r, score = d - r, dq = d   at valid internal entries,
//   leaf_d = d                            at valid leaf entries,
// and +inf elsewhere (also for every entry of a slot with id < 0), where
// d = metric(q_i, vecs[node, s]).  With PRUNE, an entry whose parent
// distances give |qpd[i, j] - pdist| > rq[i] + r + 2e-5 is dropped before
// its metric is evaluated (equality keeps), and a page with no live entry
// skips the metric and the page load altogether.
//
// What bounds it on this card: bytes.  The four [b, F, cap] f32 outputs are
// written in full whatever the data (8.4 MB each at b=1024, F=64, cap=32),
// while the metric costs about 3 flops per dimension per live entry; a page
// is read once per slot that references it.  Design: one warp per
// (i, j) pair, the block's warps on consecutive pairs so output rows are
// written as whole coalesced lines.  Each lane owns one or two entries
// (cap <= 64).  The page is staged in shared memory with coalesced loads
// of the live rows only (a ballot of the keep mask tells the warp which),
// rows padded to an odd stride so the per-lane metric walks hit distinct
// banks.  No scalar prefetch and nothing carried between blocks: the warp
// reads its own node id.
//
// Bitwise contract with the plain PyTorch version (frontier_scores_torch)
// and, through it, with the JAX package: every op rounds once
// (__fsub_rn/__fmul_rn/__fadd_rn, built with --fmad=false so nothing is
// contracted into an FMA), l1/l2 sum in _sum_last's fixed association
// (halve, add, carry the odd tail; tails added innermost first), l2 takes
// the correctly rounded __fsqrt_rn, and d_inf is a max, exact in any order.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxDim = 128;
constexpr int kMaxCap = 64;
constexpr int kMaxWarpsPerBlock = 8;
constexpr float kPrunePad = 2e-5f;   // kernels/frontier.py:_PRUNE_PAD
constexpr unsigned kFull = 0xffffffffu;

enum Metric { kDinf = 0, kL2 = 1, kL1 = 2 };

// d(q, row).  ``row`` is the entry's staged page row; the l1/l2 fold
// overwrites it in place.
template <int METRIC>
__device__ float metric_row(const float* __restrict__ q, float* row, int dim) {
  if constexpr (METRIC == kDinf) {
    float m = 0.f;
    for (int t = 0; t < dim; ++t) m = fmaxf(m, fabsf(__fsub_rn(q[t], row[t])));
    return m;
  } else {
    for (int t = 0; t < dim; ++t) {
      const float d = __fsub_rn(q[t], row[t]);
      row[t] = (METRIC == kL2) ? __fmul_rn(d, d) : fabsf(d);
    }
    // _sum_last: at each level add the halves pairwise, carrying an odd tail;
    // the innermost level's tail is added to the total first
    float tails[8];              // one per halving step with an odd length
    int nt = 0;
    int n = dim;
    while (n > 1) {
      const int h = n >> 1;
      if (n & 1) tails[nt++] = row[n - 1];
      for (int i = 0; i < h; ++i) row[i] = __fadd_rn(row[i], row[i + h]);
      n = h;
    }
    float s = row[0];
    while (nt > 0) s = __fadd_rn(s, tails[--nt]);
    return (METRIC == kL2) ? __fsqrt_rn(s) : s;
  }
}

template <int METRIC, bool PRUNE>
__global__ void frontier_kernel(
    const int* __restrict__ fids, const float* __restrict__ queries,
    const float* __restrict__ vecs, const float* __restrict__ radius,
    const unsigned char* __restrict__ ival,
    const unsigned char* __restrict__ lval,
    const float* __restrict__ pdist, const float* __restrict__ qpd,
    const float* __restrict__ rq,
    float* __restrict__ dmax, float* __restrict__ score,
    float* __restrict__ leafd, float* __restrict__ dq,
    long long pairs, int w, int n_nodes, int cap, int dim, int stride) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pair =
      (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (pair >= pairs) return;              // the whole warp leaves together
  const long long i = pair / w;
  float* qs = smem + warp * (dim + cap * stride);
  float* page = qs + dim;

  const int fid = fids[pair];
  const bool ok = fid >= 0;
  const long long node = min(max(fid, 0), n_nodes - 1);
  const float qp = PRUNE ? qpd[pair] : 0.f;
  const float rqi = PRUNE ? rq[i] : 0.f;

  bool iv[2], lv[2];
  float r[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int s = lane + 32 * u;
    iv[u] = lv[u] = false;
    r[u] = 0.f;
    if (s < cap) {
      const long long e = node * cap + s;
      r[u] = radius[e];
      bool keep = ok;
      if (PRUNE) {
        // triangle-inequality pre-filter, before any metric work:
        // keep = |qpd - pdist| <= (rq + r) + pad, in the reference's order
        const float lb = fabsf(__fsub_rn(qp, pdist[e]));
        keep = keep && (lb <= __fadd_rn(__fadd_rn(rqi, r[u]), kPrunePad));
      }
      iv[u] = keep && ival[e] != 0;
      lv[u] = keep && lval[e] != 0;
    }
  }
  const unsigned live0 = __ballot_sync(kFull, iv[0] || lv[0]);
  const unsigned live1 = __ballot_sync(kFull, iv[1] || lv[1]);
  const long long o = pair * cap;
  const float inf = CUDART_INF_F;

  if ((live0 | live1) != 0u) {
    // stage the query row and the live page rows (coalesced, live rows only)
    for (int t = lane; t < dim; t += 32) qs[t] = queries[i * dim + t];
    const float* pg = vecs + node * cap * dim;
    for (int t = lane; t < cap * dim; t += 32) {
      const int s = t / dim;
      const unsigned bits = s < 32 ? live0 : live1;
      if ((bits >> (s & 31)) & 1u) page[s * stride + (t - s * dim)] = pg[t];
    }
    __syncwarp();
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int s = lane + 32 * u;
    if (s >= cap) continue;
    float d = 0.f;
    if (iv[u] || lv[u]) d = metric_row<METRIC>(qs, page + s * stride, dim);
    dmax[o + s] = iv[u] ? __fadd_rn(d, r[u]) : inf;
    score[o + s] = iv[u] ? __fsub_rn(d, r[u]) : inf;
    leafd[o + s] = lv[u] ? d : inf;
    dq[o + s] = iv[u] ? d : inf;
  }
}

template <int METRIC, bool PRUNE>
void launch(dim3 grid, dim3 block, size_t smem, cudaStream_t st,
            const int* fids, const float* queries, const float* vecs,
            const float* radius, const unsigned char* ival,
            const unsigned char* lval, const float* pdist, const float* qpd,
            const float* rq, float* dmax, float* score, float* leafd,
            float* dq, long long pairs, int w, int n_nodes, int cap, int dim,
            int stride) {
  frontier_kernel<METRIC, PRUNE><<<grid, block, smem, st>>>(
      fids, queries, vecs, radius, ival, lval, pdist, qpd, rq, dmax, score,
      leafd, dq, pairs, w, n_nodes, cap, dim, stride);
}

}  // namespace

extern "C" int frontier_max_dim() { return kMaxDim; }
extern "C" int frontier_max_cap() { return kMaxCap; }

// Launch on ``stream``; returns cudaGetLastError() (0 on success).
// pdist/qpd/rq are read only when prune != 0.
extern "C" int frontier_scores_launch(
    const int* fids, const float* queries, const float* vecs,
    const float* radius, const unsigned char* ival, const unsigned char* lval,
    const float* pdist, const float* qpd, const float* rq, float* dmax,
    float* score, float* leafd, float* dq, int b, int w, int n_nodes,
    int cap, int dim, int metric, int prune, void* stream) {
  if (dim < 1 || dim > kMaxDim || cap < 1 || cap > kMaxCap || n_nodes < 1 ||
      metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)b * w;
  if (pairs == 0) return 0;
  const int stride = (dim % 2 == 0) ? dim + 1 : dim;   // odd: no bank clash
  const size_t per_warp = sizeof(float) * (size_t)(dim + cap * stride);
  int wpb = (int)((48 * 1024) / per_warp);
  wpb = wpb < 1 ? 1 : (wpb > kMaxWarpsPerBlock ? kMaxWarpsPerBlock : wpb);
  const dim3 grid((unsigned)((pairs + wpb - 1) / wpb));
  const dim3 block(32 * wpb);
  const size_t smem = per_warp * wpb;
  cudaStream_t st = (cudaStream_t)stream;
#define FRONTIER_ARGS                                                        \
  grid, block, smem, st, fids, queries, vecs, radius, ival, lval, pdist, qpd, \
      rq, dmax, score, leafd, dq, pairs, w, n_nodes, cap, dim, stride
  if (prune) {
    if (metric == kDinf) launch<kDinf, true>(FRONTIER_ARGS);
    else if (metric == kL2) launch<kL2, true>(FRONTIER_ARGS);
    else launch<kL1, true>(FRONTIER_ARGS);
  } else {
    if (metric == kDinf) launch<kDinf, false>(FRONTIER_ARGS);
    else if (metric == kL2) launch<kL2, false>(FRONTIER_ARGS);
    else launch<kL1, false>(FRONTIER_ARGS);
  }
#undef FRONTIER_ARGS
  return (int)cudaGetLastError();
}
