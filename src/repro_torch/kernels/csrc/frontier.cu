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
//   shared memory, so no page is staged.  What bounds it: bytes, the live
//   entry rows (8 KB each at dim 2048) against 3 flops per element.  A
//   fold through shared memory (every term stored, ~11 levels each ending
//   in a __syncwarp()) cost more than the loads; so the fold stays in
//   registers wherever the dim allows.  Design:
//
//   - Runs.  Block x takes the run of G consecutive pairs x*G .. x*G+G
//     (G <= kRun = 8).  Consecutive pairs of a frontier row share their
//     query, so the block stages one query row for each query of the run,
//     and it writes the run's outputs at the end as whole rows.  Each warp
//     takes one (pair, entry) item at a time whose keep mask holds the
//     entry, and streams the entry's row from device memory.  A node that
//     p pairs of a launch visit is read p times; the repeats meet in the
//     50 MB L2 where they fall close in time.  Sorting a launch's pairs by
//     node, so that a block could read a shared row once for all its pairs,
//     was measured and left out: on the descent's own frontiers the sort
//     costs more than it saves (PERF.md).
//   - The fold in registers.  Lane l owns the elements t with t mod P in
//     [V*l, V*l + V), P = 32*V: V = 4 (16-byte loads) where dim % 8 == 0
//     and both rows are 16-byte aligned, else V = 1.  Write t = P*j +
//     V*l + c: element t sits in "slot" j of lane l, component c.  A
//     _sum_last level of half-length h that is a multiple of P adds two
//     values of one lane, slot j and slot j + h/P.  So while the halving
//     stays a multiple of P (R <= kMaxRegLevels levels, a template
//     argument), the lane folds its slots alone: after R such levels, slot
//     i of the remaining M = len/P slots is a tree over the slots
//     j = i + M*u, u < 2^R, whose first level pairs u with u + 2^(R-1).
//     The lane streams those slots in bit-reversed order of u, so that each
//     level pairs neighbours, with fold_batch vectors in flight, and folds
//     them with a binary-counter stack of R partials whose every index is
//     a constant: 2048 floats at V = 4 are R = 4 levels over 16 slots, 4
//     float4 of stack.  Each add is the add of _sum_last's level, only
//     done earlier.
//   - The end of the fold.  Where M == 1 (dim = 128 * 2^R at V = 4, 32 *
//     2^R (+1) at V = 1) the remaining P values are one vector a lane, and
//     the levels h = 64 .. 4 (V = 4) or 16 .. 1 (V = 1) are
//     __shfl_down_sync by h/V lanes; h = 2, 1 add within the float4.  No
//     shared memory, no barrier.  Otherwise (3072, 4096, 7168, ...) the
//     lane writes its M partials to its warp's buffer in shared memory,
//     and the warp finishes with the cooperative fold (lanes split each
//     level's adds, __syncwarp() between levels) and add_tails over that
//     buffer.  Where no level keeps the mapping (R = 0: 896, 1023, ...),
//     the lane adds element t and t + dim/2 itself (both loads coalesced)
//     and the buffer takes level 1's dim/2 partials.  An odd dim has one
//     more tail, element dim - 1, added last.
//     tests/test_torch_frontier_fold.py replays this order in PyTorch
//     against _sum_last at every dim it names.
//   - d_inf is a max, exact in any order: one running max a lane, then a
//     warp max.
//   The dynamic shared memory is the run's query rows plus, for a dim that
//   needs it, one buffer a warp.  G is the largest that lets as many blocks
//   share an SM by shared memory as by registers (launch bounds: two
//   blocks of 8 warps, so at most 128 registers), and that leaves every SM
//   a block.
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

#include <mutex>

namespace {

constexpr int kNarrowMaxDim = 128;
constexpr int kMaxCap = 64;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kWideWarps = 8;
constexpr int kRun = 8;              // pairs a wide block takes (G)
constexpr int kMaxRegLevels = 4;     // fold levels a lane keeps in registers
static_assert(kMaxRegLevels == 4, "launch_wide_levels has a case for each R");
constexpr int kLoadBatch = 4;        // row vectors a lane has in flight (R == 0, d_inf)
// row vectors a lane has in flight in the register fold
template <int V> constexpr int fold_batch = V == 4 ? 4 : 8;
constexpr int kMinBlocks = 2;        // wide blocks an SM must hold (registers)
// bytes of the wide kernel's static arrays (pair_s .. d_s), rounded up; a
// launch reads the exact size from the kernel
constexpr int kWideStaticSmem = kRun * (8 + 4 + 1 + 8 + 4 + kMaxCap * 9) + 256;
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

template <int V> struct Vec { float v[V]; };

template <int V>
__device__ __forceinline__ Vec<V> load_global(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int V>
__device__ __forceinline__ Vec<V> load_shared(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_shared(float* p, const Vec<V>& x) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  else
    *p = x.v[0];
}

template <int METRIC, int V>
__device__ __forceinline__ Vec<V> term_vec(const Vec<V>& q, const Vec<V>& e) {
  Vec<V> r;
#pragma unroll
  for (int c = 0; c < V; ++c) r.v[c] = term<METRIC>(q.v[c], e.v[c]);
  return r;
}

template <int V>
__device__ __forceinline__ Vec<V> add_vec(const Vec<V>& a, const Vec<V>& b) {
  Vec<V> r;
#pragma unroll
  for (int c = 0; c < V; ++c) r.v[c] = __fadd_rn(a.v[c], b.v[c]);
  return r;
}

__host__ __device__ constexpr int bitrev(int k, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((k >> i) & 1) << (bits - 1 - i);
  return r;
}

// Push leaf k (in bit-reversed slot order) of a 2^R-leaf fold onto the
// binary-counter stack: level l of the stack holds the sum of the last
// 2^l leaves while bit l of k is 0.  After leaf 2^R - 1, ``carry`` is the
// whole tree.  k is a constant after unrolling: no branch, registers only.
template <int V, int R>
__device__ __forceinline__ void push_leaf(Vec<V> (&st)[R], Vec<V>& carry,
                                          const Vec<V>& leaf, int k) {
  carry = leaf;
#pragma unroll
  for (int l = 0; l < R; ++l) {
    if (!((k >> l) & 1)) { st[l] = carry; break; }
    carry = add_vec<V>(st[l], carry);
  }
}

// The register levels: for each slot i < M, the tree over the lane's
// slots i + M*u, u < 2^R, streamed in bit-reversed order of u with a
// batch of row vectors in flight.  With M == 1 the result is the lane's
// vector of the remaining P values; with M > 1 each slot i goes to
// buf[i*P + V*lane ..].
template <int METRIC, int V, int R>
__device__ __forceinline__ Vec<V> fold_slots(const float* __restrict__ ev,
                                             const float* q, int M, int lane,
                                             float* buf) {
  constexpr int P = 32 * V, NK = 1 << R, B = fold_batch<V>;
  Vec<V> st[R], carry;
  if constexpr (NK >= B) {
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int k0 = 0; k0 < NK; k0 += B) {
        Vec<V> e[B];
#pragma unroll
        for (int u = 0; u < B; ++u)
          e[u] = load_global<V>(ev + (i + M * bitrev(k0 + u, R)) * P + V * lane);
#pragma unroll
        for (int u = 0; u < B; ++u) {
          const int off = (i + M * bitrev(k0 + u, R)) * P + V * lane;
          push_leaf<V, R>(st, carry, term_vec<METRIC, V>(load_shared<V>(q + off), e[u]),
                          k0 + u);
        }
      }
      if (M > 1) store_shared<V>(buf + i * P + V * lane, carry);
    }
  } else {
    // a batch spans B / NK slots: leaf f = i*NK + k, and k = u % NK
    for (int f0 = 0; f0 < M * NK; f0 += B) {
      Vec<V> e[B];
#pragma unroll
      for (int u = 0; u < B; ++u)
        if (f0 + u < M * NK)
          e[u] = load_global<V>(ev + (((f0 + u) >> R) + M * bitrev(u % NK, R)) * P + V * lane);
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int f = f0 + u;
        if (f >= M * NK) break;
        const int off = ((f >> R) + M * bitrev(u % NK, R)) * P + V * lane;
        push_leaf<V, R>(st, carry, term_vec<METRIC, V>(load_shared<V>(q + off), e[u]), u % NK);
        if (u % NK == NK - 1 && M > 1) store_shared<V>(buf + (f >> R) * P + V * lane, carry);
      }
    }
  }
  return carry;
}

// _sum_last's last levels over the P = 32*V values that lane l holds as
// one vector (element V*l + c): h = 16V .. V by shuffles, then within the
// vector.  The total lands in lane 0.
template <int V>
__device__ __forceinline__ float shuffle_fold(Vec<V> a) {
#pragma unroll
  for (int x = 16; x >= 1; x >>= 1) {
#pragma unroll
    for (int c = 0; c < V; ++c)
      a.v[c] = __fadd_rn(a.v[c], __shfl_down_sync(kFull, a.v[c], x));
  }
  if constexpr (V == 4)
    return __fadd_rn(__fadd_rn(a.v[0], a.v[2]), __fadd_rn(a.v[1], a.v[3]));
  else
    return a.v[0];
}

// the cooperative fold of a warp's buffer of ``n`` partials: _sum_last from
// that length on, each level's adds split across the lanes
__device__ __forceinline__ float buffer_fold(float* buf, int n, int lane) {
  __syncwarp();
  for (int m = n; m > 1; m >>= 1) {
    const int h = m >> 1;
    for (int t = lane; t < h; t += 32) buf[t] = __fadd_rn(buf[t], buf[t + h]);
    __syncwarp();
  }
  const float s = add_tails(buf[0], buf, n);
  __syncwarp();                        // every lane has read buf before reuse
  return s;
}

// How one warp folds a row (frontier.cu's header): the kernel's R register
// levels leave M slots a lane; buf_len floats of warp buffer (0 when the
// fold ends in shuffles).  With R == 0 the lane folds level 0 alone and
// the buffer takes the dim/2 partials.
struct Fold { int M, buf_len; };

// d(q, row), reading the row from device memory once; exact in lane 0
// (d_inf: in every lane)
template <int METRIC, int V, int R>
__device__ __forceinline__ float metric_wide(const float* __restrict__ ev,
                                             const float* q, int dim,
                                             const Fold& f, float* buf, int lane) {
  constexpr int P = 32 * V;
  if constexpr (METRIC == kDinf) {
    float m = 0.f;
    const int nv = dim / V;
    for (int v0 = lane; v0 < nv; v0 += 32 * kLoadBatch) {
      Vec<V> e[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u)
        if (v0 + 32 * u < nv) e[u] = load_global<V>(ev + (v0 + 32 * u) * V);
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int x = (v0 + 32 * u) * V;
        if (x >= dim) break;
        const Vec<V> qv = load_shared<V>(q + x);
#pragma unroll
        for (int c = 0; c < V; ++c) m = fmaxf(m, fabsf(__fsub_rn(qv.v[c], e[u].v[c])));
      }
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, x));
    return m;
  } else {
    float d;
    if constexpr (R == 0) {
      // level 0 pairs t with t + h in one lane (both loads coalesced), then
      // the buffer from level 1 on
      const int h = dim >> 1, nv = h / V;
      for (int v0 = lane; v0 < nv; v0 += 32 * kLoadBatch) {
        Vec<V> e0[kLoadBatch], e1[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          if (v0 + 32 * u < nv) {
            e0[u] = load_global<V>(ev + (v0 + 32 * u) * V);
            e1[u] = load_global<V>(ev + (v0 + 32 * u) * V + h);
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int x = (v0 + 32 * u) * V;
          if (x >= h) break;
          store_shared<V>(buf + x, add_vec<V>(term_vec<METRIC, V>(load_shared<V>(q + x), e0[u]),
                                             term_vec<METRIC, V>(load_shared<V>(q + x + h), e1[u])));
        }
      }
      d = buffer_fold(buf, h, lane);
    } else {
      const Vec<V> c = fold_slots<METRIC, V, R>(ev, q, f.M, lane, buf);
      d = f.M == 1 ? shuffle_fold<V>(c) : buffer_fold(buf, f.M * P, lane);
    }
    if (dim & 1)                       // level 0's tail, element dim - 1
      d = __fadd_rn(d, term<METRIC>(q[dim - 1], __ldg(ev + dim - 1)));
    return METRIC == kL2 ? __fsqrt_rn(d) : d;
  }
}

// Wide rows: a block per run of ``run`` consecutive pairs, a warp per
// (pair, entry) item (header above).
template <int METRIC, bool PRUNE, int V, int R>
__global__ void __launch_bounds__(32 * kWideWarps, kMinBlocks) frontier_wide_kernel(
    const int* __restrict__ fids, const float* __restrict__ queries,
    const float* __restrict__ vecs, const float* __restrict__ radius,
    const unsigned char* __restrict__ ival,
    const unsigned char* __restrict__ lval,
    const float* __restrict__ pdist, const float* __restrict__ qpd,
    const float* __restrict__ rq,
    float* __restrict__ dmax, float* __restrict__ score,
    float* __restrict__ leafd, float* __restrict__ dq,
    long long pairs, int w, int n_nodes, int cap, int dim, int run, int qrows,
    Fold fold) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long pair_s[kRun];
  __shared__ int fid_s[kRun];
  __shared__ bool any_s[kRun];
  __shared__ long long qi_s[kRun];     // the staged query rows' indices
  __shared__ int qslot_s[kRun];        // pair g's row among them
  __shared__ int nq_s;
  __shared__ unsigned char live_s[kRun][kMaxCap];   // bit 0: internal, bit 1: leaf
  __shared__ float r_s[kRun][kMaxCap];
  __shared__ float d_s[kRun][kMaxCap];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const float inf = CUDART_INF_F;
  const long long first = (long long)blockIdx.x * run;
  const int ng = (int)min((long long)run, pairs - first);

  if ((int)threadIdx.x < ng) {
    const long long p = first + threadIdx.x;
    pair_s[threadIdx.x] = p;
    fid_s[threadIdx.x] = fids[p];
  }
  __syncthreads();
  // the keep mask of every (pair, entry), before any metric work
  for (int g = warp; g < ng; g += nwarps) {
    const long long p = pair_s[g];
    const int fid = fid_s[g];
    const long long node = min(max(fid, 0), n_nodes - 1);
    const float qp = PRUNE ? qpd[p] : 0.f;
    const float rqi = PRUNE ? rq[p / w] : 0.f;
    bool any = false;
    for (int s = lane; s < cap; s += 32) {
      const long long e = node * cap + s;
      const float r = radius[e];
      const bool keep = keep_entry<PRUNE>(fid >= 0, qp, rqi, r, pdist, e);
      const bool iv = keep && ival[e] != 0;
      const bool lv = keep && lval[e] != 0;
      r_s[g][s] = r;
      live_s[g][s] = (unsigned char)(iv | (lv << 1));
      any = any || iv || lv;
    }
    any = __any_sync(kFull, any);
    if (lane == 0) any_s[g] = any;
  }
  // one staged row for each run of pairs with the same query (consecutive
  // pairs of a frontier row share it), if one of them has a live entry
  if (threadIdx.x == 0) {
    int nq = 0;
    for (int g = 0; g < ng; ++g) {
      const long long i = pair_s[g] / w;
      if (nq == 0 || qi_s[nq - 1] != i) qi_s[nq++] = i;
      qslot_s[g] = nq - 1;
    }
    nq_s = nq;
  }
  __syncthreads();
  float* qs = smem;                                         // [qrows][dim]
  float* buf = smem + (size_t)qrows * dim + (size_t)warp * fold.buf_len;
  for (int k = 0; k < nq_s; ++k) {
    bool live = false;
    for (int g = 0; g < ng; ++g) live = live || (qslot_s[g] == k && any_s[g]);
    if (!live) continue;
    const float* src = queries + qi_s[k] * dim;
    for (int x = threadIdx.x * V; x < dim; x += blockDim.x * V)
      store_shared<V>(qs + (size_t)k * dim + x, load_global<V>(src + x));
  }
  __syncthreads();

  // items: (pair g, entry s), a warp each; all of an item is uniform in the warp
  for (int it = warp; it < ng * cap; it += nwarps) {
    const int g = it / cap;
    const int s = it - g * cap;
    if (live_s[g][s] == 0) continue;
    const long long node = min(max(fid_s[g], 0), n_nodes - 1);
    const float d = metric_wide<METRIC, V, R>(vecs + (node * cap + s) * dim,
                                              qs + (size_t)qslot_s[g] * dim, dim, fold,
                                              buf, lane);
    if (lane == 0) d_s[g][s] = d;
  }
  __syncthreads();
  // the run's outputs, a pair's row at a time
  for (int x = threadIdx.x; x < ng * cap; x += blockDim.x) {
    const int g = x / cap;
    const int s = x - g * cap;
    const unsigned f = live_s[g][s];
    const float d = f != 0u ? d_s[g][s] : 0.f;
    const float r = r_s[g][s];
    const long long o = pair_s[g] * cap + s;
    const bool iv = f & 1u, lv = f & 2u;
    dmax[o] = iv ? __fadd_rn(d, r) : inf;
    score[o] = iv ? __fsub_rn(d, r) : inf;
    leafd[o] = lv ? d : inf;
    dq[o] = iv ? d : inf;
  }
}

// dynamic shared memory a wide block may take on the current device
int wide_smem_cap() {
  int dev = 0, v = 48 * 1024;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v - kWideStaticSmem;
}

// register levels at period 32*vec: those whose half-length is a multiple
// of it, at most kMaxRegLevels
int reg_levels(int dim, int vec) {
  const int P = 32 * vec;
  int R = 0, n = dim;
  while (R < kMaxRegLevels && (n >> 1) >= P && (n >> 1) % P == 0) {
    n >>= 1;
    ++R;
  }
  return R;
}

struct Args {
  const int* fids; const float* queries; const float* vecs;
  const float* radius; const unsigned char* ival; const unsigned char* lval;
  const float* pdist; const float* qpd; const float* rq;
  float* dmax; float* score; float* leafd; float* dq;
  long long pairs; int w, n_nodes, cap, dim;
};

// What a launch needs to know of the device and of one kernel, read (and
// the kernel's dynamic shared memory limit raised) once for each device.
struct KernelInfo { bool ok; int sms, sm_smem, regs; size_t static_smem, smem_cap; };
constexpr int kMaxDevices = 64;

// One cache for each instantiation: they all share one function type, so
// the cache cannot be keyed on the kernel's type.
template <int METRIC, bool PRUNE, int V, int R>
KernelInfo wide_kernel_info(int dev) {
  static std::mutex mu;
  static KernelInfo info[kMaxDevices];          // zero: not read yet
  auto kern = frontier_wide_kernel<METRIC, PRUNE, V, R>;
  std::lock_guard<std::mutex> lock(mu);
  KernelInfo& k = info[dev];
  if (!k.ok) {
    cudaFuncAttributes at;
    int optin = 48 * 1024;
    k.sms = 132;
    k.sm_smem = 228 * 1024;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&k.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&k.sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (cudaFuncGetAttributes(&at, kern) != cudaSuccess) return k;
    k.smem_cap = optin - at.sharedSizeBytes;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)k.smem_cap) != cudaSuccess)
      return k;
    k.regs = at.numRegs;
    k.static_smem = at.sharedSizeBytes;
    k.ok = true;
  }
  return k;
}

// One wide launch.  The run G is the largest (at most kRun) that lets as
// many blocks share an SM by shared memory as by registers, and that gives
// every SM a block.  A run's pairs span at most (G - 1) / w + 2 queries:
// the rows staged.
template <int METRIC, bool PRUNE, int V, int R>
int launch_wide(const Args& a, cudaStream_t st) {
  auto kern = frontier_wide_kernel<METRIC, PRUNE, V, R>;
  Fold fold{0, 0};
  if (METRIC != kDinf) {
    const int n = a.dim >> R;                 // the length after R levels
    fold.M = R > 0 ? n / (32 * V) : 0;
    fold.buf_len = R == 0 ? a.dim >> 1 : (fold.M == 1 ? 0 : n);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const KernelInfo k = wide_kernel_info<METRIC, PRUNE, V, R>(dev);
  if (!k.ok) {
    err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const size_t cap = k.smem_cap;
  int warps = kWideWarps;
  auto qrows = [&](int run) {
    const int spanned = (run - 1) / a.w + 2;
    return spanned < run ? spanned : run;
  };
  auto smem = [&](int run) {
    return sizeof(float) * ((size_t)qrows(run) * a.dim + (size_t)warps * fold.buf_len);
  };
  while (warps > 1 && smem(1) > cap) --warps;     // the widest rows
  const int threads = 32 * warps;
  const int warp_regs = ((k.regs * 32 + 255) / 256) * 256;   // allocation unit
  int by_regs = 65536 / (warp_regs * warps);
  if (by_regs > 2048 / threads) by_regs = 2048 / threads;
  auto by_smem = [&](int run) {
    return (int)((size_t)k.sm_smem / (smem(run) + k.static_smem + 1024));
  };
  int run = kRun;
  while (run > 1 && (smem(run) > cap || by_smem(run) < by_regs)) --run;
  const long long per_sm = a.pairs / k.sms;
  if (per_sm < run) run = per_sm < 1 ? 1 : (int)per_sm;
  if (smem(run) > cap) return (int)cudaErrorInvalidValue;
  const long long blocks = (a.pairs + run - 1) / run;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, threads, smem(run), st>>>(
      a.fids, a.queries, a.vecs, a.radius, a.ival, a.lval, a.pdist,
      a.qpd, a.rq, a.dmax, a.score, a.leafd, a.dq, a.pairs, a.w, a.n_nodes,
      a.cap, a.dim, run, qrows(run), fold);
  return (int)cudaGetLastError();
}

template <int METRIC, bool PRUNE, int V>
int launch_wide_levels(const Args& a, int R, cudaStream_t st) {
  switch (R) {
    case 0: return launch_wide<METRIC, PRUNE, V, 0>(a, st);
    case 1: return launch_wide<METRIC, PRUNE, V, 1>(a, st);
    case 2: return launch_wide<METRIC, PRUNE, V, 2>(a, st);
    case 3: return launch_wide<METRIC, PRUNE, V, 3>(a, st);
    default: return launch_wide<METRIC, PRUNE, V, 4>(a, st);
  }
}

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
  if constexpr (METRIC == kDinf) {
    const bool aligned = a.dim % 4 == 0 &&
        (((unsigned long long)a.vecs | (unsigned long long)a.queries) & 15ull) == 0;
    return aligned ? launch_wide<METRIC, PRUNE, 4, 0>(a, st)
                   : launch_wide<METRIC, PRUNE, 1, 0>(a, st);
  } else {
    // 16-byte loads where the rows allow (level 0's t + dim/2 too, so
    // dim % 8 == 0)
    const bool aligned = a.dim % 8 == 0 &&
        (((unsigned long long)a.vecs | (unsigned long long)a.queries) & 15ull) == 0;
    if (aligned) return launch_wide_levels<METRIC, PRUNE, 4>(a, reg_levels(a.dim, 4), st);
    return launch_wide_levels<METRIC, PRUNE, 1>(a, reg_levels(a.dim, 1), st);
  }
}

}  // namespace

// The widest row the wide variant takes on the current device (one query
// row and, for l1/l2 at the worst dim, one row buffer in shared memory).
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
