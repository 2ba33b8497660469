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
// Two variants, chosen by the launcher from the row width:
//
// * narrow rows (dim <= kNarrowMaxDim = 128, the SM-tree's own objects).
//   What bounds it: bytes.  The four [b, F, cap] f32 outputs are written in
//   full whatever the data (8.4 MB each at b=1024, F=64, cap=32), while the
//   metric costs about 3 flops per dimension per live entry.  Design: one
//   warp per (i, j) pair, the block's warps on consecutive pairs so output
//   rows are written as whole coalesced lines.  Each lane owns one or two
//   entries (cap <= 64).  The page is staged in shared memory with
//   coalesced loads of the live rows only (a ballot of the keep mask tells
//   the warp which), rows padded to an odd stride so the per-lane metric
//   walks hit distinct banks.
//
// * wide rows (dim > 128: kNN-LM keys are hidden states, 2048 wide for
//   qwen2.5-3b).  A page of 32 such rows is 256 KB, more than a block's
//   shared memory, so no page is staged.  What bounds it: bytes again,
//   now the live entry rows (8 KB each at dim 2048) against 3 flops per
//   element.  Design: one block per (i, j) pair; the query row is staged
//   once per block; each warp takes one live entry at a time and reads
//   its row with coalesced loads straight from device memory.  d_inf is a
//   warp max (exact in any order).  l1/l2 write the per-dimension terms
//   into the warp's own row buffer in shared memory and fold it there
//   cooperatively: at each halving level the lanes split the adds
//   row[t] += row[t + h] and __syncwarp() separates the levels, so every
//   sum keeps _sum_last's association exactly.
//
// No scalar prefetch and nothing carried between blocks in either: a warp
// or block reads its own node id.
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

constexpr int kNarrowMaxDim = 128;
constexpr int kMaxCap = 64;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kWideWarps = 8;
constexpr int kWideStaticSmem = 512;  // bytes of the wide kernel's static arrays
constexpr float kPrunePad = 2e-5f;   // kernels/frontier.py:_PRUNE_PAD
constexpr unsigned kFull = 0xffffffffu;

enum Metric { kDinf = 0, kL2 = 1, kL1 = 2 };

// _sum_last's odd tails, added to the folded total innermost first.  Level
// k of the fold has length dim >> k; when that is odd, its last element
// row[(dim >> k) - 1] is the level's tail.  Level k writes only below
// (dim >> k) >> 1, so every tail still lies where it was carried when the
// fold is done: no stack is needed, whatever dim is.
__device__ __forceinline__ float add_tails(float s, const float* row, int dim) {
  const int levels = 31 - __clz(dim);          // floor(log2(dim))
  for (int k = levels - 1; k >= 0; --k) {
    const int n = dim >> k;
    if (n & 1) s = __fadd_rn(s, row[n - 1]);
  }
  return s;
}

// per-dimension term of l1/l2 (before the fold)
template <int METRIC>
__device__ __forceinline__ float term(float q, float e) {
  const float d = __fsub_rn(q, e);
  return (METRIC == kL2) ? __fmul_rn(d, d) : fabsf(d);
}

// d(q, row), one lane alone.  ``row`` is the entry's staged page row; the
// l1/l2 fold overwrites it in place.
template <int METRIC>
__device__ float metric_row(const float* __restrict__ q, float* row, int dim) {
  if constexpr (METRIC == kDinf) {
    float m = 0.f;
    for (int t = 0; t < dim; ++t) m = fmaxf(m, fabsf(__fsub_rn(q[t], row[t])));
    return m;
  } else {
    for (int t = 0; t < dim; ++t) row[t] = term<METRIC>(q[t], row[t]);
    // _sum_last: at each level add the halves pairwise, carrying an odd tail
    for (int n = dim; n > 1; n >>= 1) {
      const int h = n >> 1;
      for (int i = 0; i < h; ++i) row[i] = __fadd_rn(row[i], row[i + h]);
    }
    const float s = add_tails(row[0], row, dim);
    return (METRIC == kL2) ? __fsqrt_rn(s) : s;
  }
}

// the keep mask of entry e, before any metric work: valid, and with
// PRUNE |qpd - pdist| <= (rq + r) + pad, in the reference's order
template <bool PRUNE>
__device__ __forceinline__ bool keep_entry(bool ok, float qp, float rqi,
                                           float r, const float* pdist,
                                           long long e) {
  if (!PRUNE) return ok;
  const float lb = fabsf(__fsub_rn(qp, pdist[e]));
  return ok && (lb <= __fadd_rn(__fadd_rn(rqi, r), kPrunePad));
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
      const bool keep = keep_entry<PRUNE>(ok, qp, rqi, r[u], pdist, e);
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

// Wide rows: one block per (i, j) pair, a warp per live entry at a time.
template <int METRIC, bool PRUNE>
__global__ void frontier_wide_kernel(
    const int* __restrict__ fids, const float* __restrict__ queries,
    const float* __restrict__ vecs, const float* __restrict__ radius,
    const unsigned char* __restrict__ ival,
    const unsigned char* __restrict__ lval,
    const float* __restrict__ pdist, const float* __restrict__ qpd,
    const float* __restrict__ rq,
    float* __restrict__ dmax, float* __restrict__ score,
    float* __restrict__ leafd, float* __restrict__ dq,
    int w, int n_nodes, int cap, int dim) {
  extern __shared__ float smem[];
  __shared__ float r_s[kMaxCap];
  __shared__ unsigned char live_s[kMaxCap];   // bit 0: internal, bit 1: leaf
  __shared__ int any_live;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const long long pair = blockIdx.x;
  const long long i = pair / w;
  const long long o = pair * cap;
  const float inf = CUDART_INF_F;

  const int fid = fids[pair];
  const bool ok = fid >= 0;
  const long long node = min(max(fid, 0), n_nodes - 1);
  if (threadIdx.x == 0) any_live = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < cap; s += blockDim.x) {
    const long long e = node * cap + s;
    const float r = radius[e];
    const bool keep = keep_entry<PRUNE>(ok, PRUNE ? qpd[pair] : 0.f,
                                        PRUNE ? rq[i] : 0.f, r, pdist, e);
    const bool iv = keep && ival[e] != 0;
    const bool lv = keep && lval[e] != 0;
    r_s[s] = r;
    live_s[s] = (unsigned char)(iv | (lv << 1));
    if (iv || lv) any_live = 1;        // every writer stores the same value
  }
  __syncthreads();
  if (!any_live) {                     // the whole block leaves together
    for (int s = threadIdx.x; s < cap; s += blockDim.x) {
      dmax[o + s] = inf;
      score[o + s] = inf;
      leafd[o + s] = inf;
      dq[o + s] = inf;
    }
    return;
  }
  float* qs = smem;                               // [dim]
  float* row = smem + dim + (size_t)warp * dim;   // [dim], l1/l2 only
  for (int t = threadIdx.x; t < dim; t += blockDim.x) qs[t] = queries[i * dim + t];
  __syncthreads();

  const float* pg = vecs + node * cap * dim;
  for (int s = warp; s < cap; s += nwarps) {     // s is uniform in the warp
    const unsigned f = live_s[s];
    float d = 0.f;
    if (f != 0u) {
      const float* ev = pg + (long long)s * dim;
      if constexpr (METRIC == kDinf) {
        float m = 0.f;
        for (int t = lane; t < dim; t += 32)
          m = fmaxf(m, fabsf(__fsub_rn(qs[t], ev[t])));
#pragma unroll
        for (int x = 16; x > 0; x >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, x));
        d = m;
      } else {
        for (int t = lane; t < dim; t += 32) row[t] = term<METRIC>(qs[t], ev[t]);
        __syncwarp();
        for (int n = dim; n > 1; n >>= 1) {
          const int h = n >> 1;
          for (int t = lane; t < h; t += 32) row[t] = __fadd_rn(row[t], row[t + h]);
          __syncwarp();
        }
        d = add_tails(row[0], row, dim);
        if (METRIC == kL2) d = __fsqrt_rn(d);
        __syncwarp();                  // all lanes read row before it is reused
      }
    }
    if (lane == 0) {
      const bool iv = f & 1u, lv = f & 2u;
      const float r = r_s[s];
      dmax[o + s] = iv ? __fadd_rn(d, r) : inf;
      score[o + s] = iv ? __fsub_rn(d, r) : inf;
      leafd[o + s] = lv ? d : inf;
      dq[o + s] = iv ? d : inf;
    }
  }
}

// dynamic shared memory a wide block may take on the current device
int wide_smem_cap() {
  int dev = 0, v = 48 * 1024;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v - kWideStaticSmem;
}

// warps per wide block for this (metric, cap, dim); 0 when a row buffer
// does not fit
int wide_warps(int metric, int cap, int dim, int smem_cap) {
  int nw = cap < kWideWarps ? cap : kWideWarps;
  if (metric == kDinf) return (size_t)dim * 4 <= (size_t)smem_cap ? nw : 0;
  const long long fit = ((long long)smem_cap / 4 - dim) / dim;
  if (fit < nw) nw = (int)(fit < 0 ? 0 : fit);
  return nw;
}

struct Args {
  const int* fids; const float* queries; const float* vecs;
  const float* radius; const unsigned char* ival; const unsigned char* lval;
  const float* pdist; const float* qpd; const float* rq;
  float* dmax; float* score; float* leafd; float* dq;
  long long pairs; int w, n_nodes, cap, dim;
};

template <int METRIC, bool PRUNE>
int launch(const Args& a, cudaStream_t st) {
  if (a.dim <= kNarrowMaxDim) {
    const int stride = (a.dim % 2 == 0) ? a.dim + 1 : a.dim;   // odd: no bank clash
    const size_t per_warp = sizeof(float) * (size_t)(a.dim + a.cap * stride);
    int wpb = (int)((48 * 1024) / per_warp);
    wpb = wpb < 1 ? 1 : (wpb > kMaxWarpsPerBlock ? kMaxWarpsPerBlock : wpb);
    const dim3 grid((unsigned)((a.pairs + wpb - 1) / wpb));
    frontier_kernel<METRIC, PRUNE><<<grid, 32 * wpb, per_warp * wpb, st>>>(
        a.fids, a.queries, a.vecs, a.radius, a.ival, a.lval, a.pdist, a.qpd,
        a.rq, a.dmax, a.score, a.leafd, a.dq, a.pairs, a.w, a.n_nodes, a.cap,
        a.dim, stride);
    return (int)cudaGetLastError();
  }
  const int smem_cap = wide_smem_cap();
  const int nw = wide_warps(METRIC, a.cap, a.dim, smem_cap);
  if (nw < 1 || a.pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t)a.dim * (METRIC == kDinf ? 1 : 1 + nw);
  cudaError_t err = cudaFuncSetAttribute(
      frontier_wide_kernel<METRIC, PRUNE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  frontier_wide_kernel<METRIC, PRUNE><<<(unsigned)a.pairs, 32 * nw, smem, st>>>(
      a.fids, a.queries, a.vecs, a.radius, a.ival, a.lval, a.pdist, a.qpd,
      a.rq, a.dmax, a.score, a.leafd, a.dq, a.w, a.n_nodes, a.cap, a.dim);
  return (int)cudaGetLastError();
}

}  // namespace

// The widest row the wide variant takes on the current device (l1/l2 need
// the query row and one row buffer in a block's shared memory).
extern "C" int frontier_max_dim() { return wide_smem_cap() / 8; }
extern "C" int frontier_max_cap() { return kMaxCap; }
extern "C" int frontier_narrow_max_dim() { return kNarrowMaxDim; }

// Launch on ``stream``; returns the CUDA error code (0 on success).
// pdist/qpd/rq are read only when prune != 0.
extern "C" int frontier_scores_launch(
    const int* fids, const float* queries, const float* vecs,
    const float* radius, const unsigned char* ival, const unsigned char* lval,
    const float* pdist, const float* qpd, const float* rq, float* dmax,
    float* score, float* leafd, float* dq, int b, int w, int n_nodes,
    int cap, int dim, int metric, int prune, void* stream) {
  if (dim < 1 || cap < 1 || cap > kMaxCap || n_nodes < 1 || metric < 0 ||
      metric > 2)
    return (int)cudaErrorInvalidValue;
  const Args a{fids, queries, vecs, radius, ival, lval, pdist, qpd, rq,
               dmax, score, leafd, dq, (long long)b * w, w, n_nodes, cap, dim};
  if (a.pairs == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (prune) {
    if (metric == kDinf) return launch<kDinf, true>(a, st);
    if (metric == kL2) return launch<kL2, true>(a, st);
    return launch<kL1, true>(a, st);
  }
  if (metric == kDinf) return launch<kDinf, false>(a, st);
  if (metric == kL2) return launch<kL2, false>(a, st);
  return launch<kL1, false>(a, st);
}
