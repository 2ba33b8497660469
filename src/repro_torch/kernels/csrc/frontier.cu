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
// Pages of any width.  An entry's four outputs depend only on its own row,
// radius, validity and pdist and on its pair's query, qpd and rq, so a page
// of cap > kSeg = 64 entries is scored as consecutive segments of at most
// 64 entries, each like a page of its own, in the same launch: a narrow
// warp keeps and stages one segment at a time (a page stage holds
// min(cap, 64) rows whatever cap is), a wide block loops over the segments
// of its run and stages each query row once.  The index's own pages (cap
// <= 32: one entry a lane) and the wide pages up to 64 entries run
// instantiations with no segment code, as before; wider wide pages take
// one instantiation a metric (SEGS: 4-byte loads, the fold from level 1 in
// the warp buffer, which is _sum_last's order at any dim).
//
// Two variants, chosen by the launcher from the row width:
//
// * narrow rows (dim <= kNarrowMaxDim = 128, the SM-tree's own objects).
//   What bounds it: bytes, and the latency of the chain that reaches them.
//   The four [b, F, cap] f32 outputs are written in full whatever the data
//   (8.4 MB each at b=1024, F=64, cap=32), the live rows are read (80 B
//   each at dim 20), and the metric costs about 3 flops per dimension per
//   live entry.  But each pair is a chain of dependent loads (its node id,
//   then the page's radius/validity/pdist rows, then the live page rows),
//   and on the descent's own frontiers most pairs are empty slots or
//   pruned pages while a few carry many live entries, bunched at the head
//   of each query's frontier.  Design (PERF.md has the variants measured
//   on the way):
//
//   - Persistent warps, balanced.  The grid is as many blocks of
//     kNarrowWarps warps as the SMs hold at once (registers, threads,
//     shared memory), and no more than the pairs need.  Warp x of T takes
//     pairs x, x + T, x + 2T, ...: a contiguous range per warp left the
//     warps that drew a query's head with all its live pairs (2x slower on
//     the exact geometry's levels), and runs of 4 to 16 consecutive pairs
//     were slower than single pairs.
//   - Per-pair scalars a chunk at a time.  For 32 pairs at once each lane
//     loads one pair's node id, query row, qpd and rq; a pair's scalars
//     come by __shfl_sync, so only one pair in 32 waits for its node id.
//   - The keep step runs ahead of the score step.  It reads pair kp's
//     radius, validity (and pdist) rows from device memory, a lane an
//     entry, and computes its keep mask; a pair with no live entry (empty slot, pruned page) gets
//     its +inf rows at once, costs no copy and takes no stage; a live
//     pair's rows go to the next of kNarrowStages page stages, and the
//     keep step goes on until that many live pairs are in flight.  The
//     score step waits for the oldest stage's mbarrier, scores it and
//     frees it.  Copying the metadata rows ahead into shared memory by
//     cp.async (1 or 4 pairs ahead, validity rows as 4-byte words) was
//     measured and left out: no faster on the descent's own frontiers.
//   - The copies.  A stage holds the live rows of the page row-major at a
//     row stride that is a multiple of 4 floats with an odd quarter, and
//     the query row after it.  The warp lists the live rows (filtered or
//     not) and copies them with cp.async, the lanes on consecutive units of
//     the listed rows, a lane's (row, unit) stepped by (32 / units,
//     32 % units): no division per copy.  A unit is 16 bytes where the rows
//     are 16-byte aligned (dim % 4 == 0, vecs and queries 16-byte aligned),
//     else 4 bytes.  Each lane's arrival on the stage's mbarrier waits for
//     its copies.
//   - The metric.  Lane s scores entry s (and s + 32) from its staged row:
//     16-byte loads, 8 lanes a phase on 8 distinct bank quads.  d_inf is a
//     max in any order.  l1/l2 write their terms down the lane's column of
//     a term buffer (pitch 33: conflict-free), then sum them in
//     _sum_last's association with no stack: _sum_last over dim terms is
//     a tree of L = floor(log2 dim) levels whose leaf x is the element
//     sum of (dim >> (j + 1)) over the set bits j of x, then, innermost
//     first, one tree of 2^lev leaves for each level lev whose length
//     dim >> lev is odd (based at (dim >> lev) - 1).  fold_leaf lists the
//     leaves in that order once a block; LeafTree<M> adds a tree's two
//     halves, unrolled at compile time for each L (a switch).
//     tests/test_torch_frontier_fold_narrow.py replays this order in
//     PyTorch against _sum_last at every dim 1..128.
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
// or block reads its own node ids.
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
// entries a segment: a page wider than this is scored as consecutive
// segments of at most kSeg entries (header, "Pages of any width")
constexpr int kSeg = 64;
constexpr int kNarrowWarps = 8;       // warps a narrow block holds, at most
constexpr int kNarrowStages = 2;     // a narrow warp's page ring: pairs staged or in flight
// pairs a narrow launch takes (32-bit indices; 2^30 pairs of outputs are
// far beyond a card's memory)
constexpr int kNarrowMaxPairs = 1 << 30;
constexpr int kTermPitch = 33;       // a narrow warp's term buffer: lane l's column l
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
constexpr int kWideStaticSmem = kRun * (8 + 4 + 1 + 1 + 8 + 4 + kSeg * 9) + 256;
constexpr float kPrunePad = 2e-5f;   // kernels/frontier.py:_PRUNE_PAD
constexpr unsigned kFull = 0xffffffffu;

// floats of a narrow warp's l1/l2 term buffer (dim rows of kTermPitch),
// rounded up so that the next warp's stages stay 16-byte aligned
__host__ __device__ constexpr int term_len(int dim) { return (dim * kTermPitch + 3) & ~3; }

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

// the keep mask of an entry, before any metric work: valid, and with
// PRUNE |qpd - pdist| <= (rq + r) + pad, in the reference's order
template <bool PRUNE>
__device__ __forceinline__ bool keep_entry(bool ok, float qp, float rqi, float r,
                                           float pd) {
  if (!PRUNE) return ok;
  const float lb = fabsf(__fsub_rn(qp, pd));
  return ok && (lb <= __fadd_rn(__fadd_rn(rqi, r), kPrunePad));
}

// ---------------------------------------------------------------- narrow rows

// Leaf x of _sum_last's tree sequence over ``dim`` terms (header, "The
// fold"): the main tree's 2^L leaves, then each odd level's tail tree,
// innermost first.  Leaf x of a tree over levels < lev is the element
// base + sum of (dim >> (j + 1)) over the set bits j of x.
__device__ __forceinline__ int fold_leaf(int x, int dim) {
  const int L = 31 - __clz(dim);
  int lev = L, base = 0;
  if (x >= (1 << L)) {
    x -= 1 << L;
    for (lev = L - 1; lev >= 0; --lev) {
      if (!((dim >> lev) & 1)) continue;
      if (x < (1 << lev)) break;
      x -= 1 << lev;
    }
    base = (dim >> lev) - 1;
  }
  int idx = base;
  for (int j = 0; j < lev; ++j)
    if ((x >> j) & 1) idx += dim >> (j + 1);
  return idx;
}

// The tree over leaves x .. x + 2^M - 1 of the sequence: its two halves,
// each a tree, added.  Leaf x is the term at col[leaf_off[x]].
template <int M>
struct LeafTree {
  static __device__ __forceinline__ float sum(const float* col, const int* leaf_off, int x) {
    return __fadd_rn(LeafTree<M - 1>::sum(col, leaf_off, x),
                     LeafTree<M - 1>::sum(col, leaf_off, x + (1 << (M - 1))));
  }
};
template <>
struct LeafTree<0> {
  static __device__ __forceinline__ float sum(const float* col, const int* leaf_off, int x) {
    return col[leaf_off[x]];
  }
};

// _sum_last's tails from level LEV down: where dim >> lev is odd, the tree
// of the next 2^lev leaves, added to the running sum innermost first.
template <int LEV>
__device__ __forceinline__ float add_tail_trees(const float* col, const int* leaf_off, int dim,
                                                int x, float s) {
  if ((dim >> LEV) & 1) {
    s = __fadd_rn(s, LeafTree<LEV>::sum(col, leaf_off, x));
    x += 1 << LEV;
  }
  return add_tail_trees<LEV - 1>(col, leaf_off, dim, x, s);
}
template <>
__device__ __forceinline__ float add_tail_trees<-1>(const float*, const int*, int, int,
                                                    float s) {
  return s;
}

// _sum_last of a lane's terms (term t at col[t * kTermPitch]) for a dim
// with floor(log2 dim) == L; ``leaf_off[x]`` = fold_leaf(x) * kTermPitch.
template <int L>
__device__ __forceinline__ float fold_terms(const float* col, const int* leaf_off, int dim) {
  return add_tail_trees<L - 1>(col, leaf_off, dim, 1 << L, LeafTree<L>::sum(col, leaf_off, 0));
}

// d(q, entry): ``row`` is the entry's staged row, ``q`` the query's (both
// 16-byte aligned); l1/l2 write their terms down the lane's column
// ``col`` of its warp's term buffer, then fold them.
template <int METRIC>
__device__ __forceinline__ float metric_narrow(const float* row, const float* q, float* col,
                                               const int* leaf_off, int dim) {
  const int nv = dim >> 2;
  if constexpr (METRIC == kDinf) {
    float m = 0.f;
    for (int c = 0; c < nv; ++c) {
      const float4 e = *reinterpret_cast<const float4*>(row + 4 * c);
      const float4 x = *reinterpret_cast<const float4*>(q + 4 * c);
      m = fmaxf(m, fabsf(__fsub_rn(x.x, e.x)));
      m = fmaxf(m, fabsf(__fsub_rn(x.y, e.y)));
      m = fmaxf(m, fabsf(__fsub_rn(x.z, e.z)));
      m = fmaxf(m, fabsf(__fsub_rn(x.w, e.w)));
    }
    for (int t = 4 * nv; t < dim; ++t) m = fmaxf(m, fabsf(__fsub_rn(q[t], row[t])));
    return m;
  } else {
    for (int c = 0; c < nv; ++c) {
      const float4 e = *reinterpret_cast<const float4*>(row + 4 * c);
      const float4 x = *reinterpret_cast<const float4*>(q + 4 * c);
      float* o = col + 4 * c * kTermPitch;
      o[0] = term<METRIC>(x.x, e.x);
      o[kTermPitch] = term<METRIC>(x.y, e.y);
      o[2 * kTermPitch] = term<METRIC>(x.z, e.z);
      o[3 * kTermPitch] = term<METRIC>(x.w, e.w);
    }
    for (int t = 4 * nv; t < dim; ++t) col[t * kTermPitch] = term<METRIC>(q[t], row[t]);
    float s;
    switch (31 - __clz(dim)) {
      case 0: s = fold_terms<0>(col, leaf_off, dim); break;
      case 1: s = fold_terms<1>(col, leaf_off, dim); break;
      case 2: s = fold_terms<2>(col, leaf_off, dim); break;
      case 3: s = fold_terms<3>(col, leaf_off, dim); break;
      case 4: s = fold_terms<4>(col, leaf_off, dim); break;
      case 5: s = fold_terms<5>(col, leaf_off, dim); break;
      case 6: s = fold_terms<6>(col, leaf_off, dim); break;
      default: s = fold_terms<7>(col, leaf_off, dim); break;
    }
    return (METRIC == kL2) ? __fsqrt_rn(s) : s;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// one float by cp.async
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// four floats by cp.async, cached in L2 only
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// the barrier counts this lane's arrival once all its cp.async copies so
// far have landed
__device__ __forceinline__ void bar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// The per-pair scalars of 32 consecutive pairs of a warp, one a lane:
// node id, query row, and with PRUNE qpd and rq of that row.
struct Chunk {
  int fid, i;
  float qp, rqi;
};

// What a narrow launch tells its warps about the staging (header above).
struct NarrowStage {
  int stride;      // floats between staged rows: a multiple of 4, stride / 4 odd
  int len;         // floats of one stage: rows 0 .. n - 1 a segment's entries (n =
                   // min(cap, kSeg)), row n the query
  int unit;        // floats a row copy moves at a time: 4 (16-byte cp.async), else 1
};

// floats of a narrow warp's shared memory: the page stages, the staged
// segments' radii (kNarrowStages x n, n = min(cap, kSeg)) and, for l1/l2, the
// term buffer; a multiple of 4, so every warp's stages stay 16-byte aligned
template <int METRIC>
__host__ __device__ inline int narrow_warp_floats(const NarrowStage& sg, int n, int dim) {
  return kNarrowStages * (sg.len + ((n + 3) & ~3)) + (METRIC == kDinf ? 0 : term_len(dim));
}

// A lane's walk over the (live row, unit) copies of a pair: it starts at
// (k0, c0) = (lane / C, lane % C) of C units a row and steps by
// (32 / C, 32 % C): no division per copy.
struct CopyWalk { int k0, c0, dk, dc, units; };

// Stage a kept segment's live rows (``page``: its first row; ``n``: its
// entries) and its query row into ``stg``; the
// stage's barrier (32 arrivals) completes when they have landed.  The warp
// lists the live rows (``rows``, its own list in shared memory) and copies
// them unit by unit with cp.async, 16 or 4 bytes at a time, the 32 lanes on
// consecutive units, and each lane's arrival waits for its copies.
template <int NU>
__device__ __forceinline__ void stage_pair(float* stg, unsigned long long* bar,
                                           unsigned char* rows, unsigned long long live,
                                           const float* page, const float* q,
                                           const NarrowStage& sg, const CopyWalk& cw, int n,
                                           int dim, int lane) {
  float* qs = stg + n * sg.stride;
  __syncwarp();                                 // the last pair's list is read
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int s = lane + 32 * u;
    if ((live >> s) & 1ull) rows[__popcll(live & ((1ull << s) - 1ull))] = (unsigned char)s;
  }
  __syncwarp();
  const int copies = __popcll(live) * cw.units;
  for (int g = lane, k = cw.k0, c = cw.c0; g < copies; g += 32) {
    const int s = rows[k];
    if (sg.unit == 4)
      cp_async16(stg + s * sg.stride + 4 * c, page + s * dim + 4 * c);
    else
      cp_async4(stg + s * sg.stride + c, page + s * dim + c);
    k += cw.dk;
    c += cw.dc;
    if (c >= cw.units) { c -= cw.units; ++k; }
  }
  for (int c = lane; c < cw.units; c += 32) {
    if (sg.unit == 4)
      cp_async16(qs + 4 * c, q + 4 * c);
    else
      cp_async4(qs + c, q + c);
  }
  bar_arrive_copies(bar);
}

// Narrow rows: persistent warps, each on every T-th pair (header above).
// The keep step runs ahead of the score step: it keeps segment ks of pair
// kp (a page of cap <= kSeg entries is one segment), writes a segment with
// no live entry at once, and hands a live segment's row copies to the next
// free stage, until kNarrowStages live segments are in flight.  NU:
// entries a lane (min(cap, kSeg) <= 32 * NU).
template <int METRIC, bool PRUNE, int NU>
__global__ void __launch_bounds__(32 * kNarrowWarps) frontier_narrow_kernel(
    const int* __restrict__ fids, const float* __restrict__ queries,
    const float* __restrict__ vecs, const float* __restrict__ radius,
    const unsigned char* __restrict__ ival,
    const unsigned char* __restrict__ lval,
    const float* __restrict__ pdist, const float* __restrict__ qpd,
    const float* __restrict__ rq,
    float* __restrict__ dmax, float* __restrict__ score,
    float* __restrict__ leafd, float* __restrict__ dq,
    int pairs, int w, int n_nodes, int cap, int dim, NarrowStage sg) {
  constexpr int S = kNarrowStages;
  extern __shared__ __align__(16) float smem[];
  __shared__ int leaf_off[kNarrowMaxDim];
  __shared__ unsigned long long bars[kNarrowWarps][S];
  __shared__ unsigned char live_rows[kNarrowWarps][kSeg];
  __shared__ unsigned char slot_f[kNarrowWarps][S][kSeg];   // a staged segment's flags
  __shared__ int slot_pair[kNarrowWarps][S];
  __shared__ int slot_s0[kNarrowWarps][S];                  // its first entry
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (METRIC != kDinf)
    for (int x = threadIdx.x; x < dim; x += blockDim.x)
      leaf_off[x] = fold_leaf(x, dim) * kTermPitch;
  if (lane < S)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" ::"r"(smem_addr(&bars[warp][lane]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // warp x of T takes pairs x, x + T, x + 2T, ...: its t-th pair is
  // x + t * T, so the heavy stretches of a frontier (a query's first slots,
  // before its empty ones) spread over all warps
  const int T = gridDim.x * (blockDim.x >> 5);
  const int x = blockIdx.x * (blockDim.x >> 5) + warp;
  if (x >= pairs) return;                       // the whole warp leaves together
  const int end = (pairs - 1 - x) / T + 1;      // this warp's pairs
  auto pair_of = [&](int t) { return x + t * T; };
  // this warp's shared memory (narrow_warp_floats): S page stages, the
  // staged segments' radii, the term buffer.  NU == 1 (cap <= 32): a page is
  // one segment, and the segment bookkeeping folds away at compile time.
  const int sn = NU == 1 ? cap : min(cap, kSeg);   // a stage's entry rows
  float* ring = smem + (size_t)warp * narrow_warp_floats<METRIC>(sg, sn, dim);
  float* slot_r = ring + S * sg.len;
  float* col = slot_r + S * sn + lane;          // this lane's term column
  const int units = dim / sg.unit;
  const CopyWalk cw{lane / units, lane % units, 32 / units, 32 % units, units};
  const float inf = CUDART_INF_F;

  // the scalars of chunk c (this warp's pairs 32c .. 32c + 31), one a lane
  auto load_chunk = [&](int c) {
    Chunk ch{-1, 0, 0.f, 0.f};
    const int t = 32 * c + lane;
    if (t < end) {
      const int p = pair_of(t);
      ch.fid = fids[p];
      ch.i = p / w;
      if (PRUNE) { ch.qp = qpd[p]; ch.rqi = rq[ch.i]; }
    }
    return ch;
  };
  auto write_row = [&](long long o, int s, unsigned f, float d, float r) {
    const bool iv = f & 1u, lv = f & 2u;
    dmax[o + s] = iv ? __fadd_rn(d, r) : inf;
    score[o + s] = iv ? __fsub_rn(d, r) : inf;
    leafd[o + s] = lv ? d : inf;
    dq[o + s] = iv ? d : inf;
  };

  Chunk ch = load_chunk(0);                     // the chunk that holds pair kp
  unsigned parity = 0;                          // bit k: the phase stage k waits for
  int kp = 0, s0 = 0, head = 0, staged = 0;     // s0: pair kp's segment's first entry
  while (true) {
    // keep steps: until S live segments are in flight or the range is kept
    while (staged < S && kp < end) {
      if (kp > 0 && (kp & 31) == 0 && s0 == 0) ch = load_chunk(kp >> 5);
      const int fid = __shfl_sync(kFull, ch.fid, kp & 31);
      const float qp = PRUNE ? __shfl_sync(kFull, ch.qp, kp & 31) : 0.f;
      const float rqi = PRUNE ? __shfl_sync(kFull, ch.rqi, kp & 31) : 0.f;
      const int node = min(fid, n_nodes - 1);
      const int n = NU == 1 ? cap : min(kSeg, cap - s0);   // the segment's entries
      float r[NU];
      unsigned f[NU];
      unsigned long long live = 0;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int s = lane + 32 * u;
        bool keep = false, iv = false, lv = false;
        r[u] = 0.f;
        if (fid >= 0 && s < n) {
          const long long e = (long long)node * cap + s0 + s;
          r[u] = radius[e];
          keep = keep_entry<PRUNE>(true, qp, rqi, r[u], PRUNE ? pdist[e] : 0.f);
          iv = ival[e] != 0;
          lv = lval[e] != 0;
        }
        f[u] = (keep && iv) | ((keep && lv) << 1);
        live |= (unsigned long long)__ballot_sync(kFull, f[u] != 0) << (32 * u);
      }
      if (live) {                               // to the next free stage
        const int st = head + staged < S ? head + staged : head + staged - S;
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int s = lane + 32 * u;
          if (s < n) {
            slot_r[st * sn + s] = r[u];
            slot_f[warp][st][s] = (unsigned char)f[u];
          }
        }
        if (lane == 0) {
          slot_pair[warp][st] = pair_of(kp);
          if (NU > 1) slot_s0[warp][st] = s0;
        }
        stage_pair<NU>(ring + st * sg.len, &bars[warp][st], live_rows[warp], live,
                       vecs + ((long long)node * cap + s0) * dim,
                       queries + (long long)__shfl_sync(kFull, ch.i, kp & 31) * dim, sg, cw,
                       sn, dim, lane);
        ++staged;
      } else {                                  // nothing to score: +inf rows now
        const long long o = (long long)pair_of(kp) * cap + s0;
#pragma unroll
        for (int u = 0; u < NU; ++u)
          if (lane + 32 * u < n) write_row(o, lane + 32 * u, 0u, 0.f, 0.f);
      }
      if (NU == 1 || (s0 += kSeg) >= cap) {     // the pair is kept: the next one
        s0 = 0;
        ++kp;
      }
    }
    if (staged == 0) break;
    // score step: the oldest staged segment, once its copies have landed
    bar_wait(&bars[warp][head], (parity >> head) & 1u);
    parity ^= 1u << head;
    __syncwarp();
    const float* stg = ring + head * sg.len;
    const int s1 = NU == 1 ? 0 : slot_s0[warp][head];
    const int n = NU == 1 ? cap : min(kSeg, cap - s1);
    const long long o = (long long)slot_pair[warp][head] * cap + s1;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int s = lane + 32 * u;
      if (s >= n) continue;
      const unsigned f = slot_f[warp][head][s];
      float d = 0.f;
      if (f != 0u)
        d = metric_narrow<METRIC>(stg + s * sg.stride, stg + sn * sg.stride, col, leaf_off,
                                  dim);
      write_row(o, s, f, d, slot_r[head * sn + s]);
    }
    __syncwarp();                        // the stage is read before it is refilled
    head = head + 1 < S ? head + 1 : 0;
    --staged;
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
// (pair, entry) item (header above).  SEGS: pages wider than kSeg, scored a
// segment at a time; the instantiations for cap <= kSeg have no segment
// code at all.
template <int METRIC, bool PRUNE, int V, int R, bool SEGS = false>
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
  __shared__ bool qdone_s[kRun];       // SEGS: row k is staged (by an earlier segment)
  __shared__ unsigned char live_s[kRun][kSeg];   // bit 0: internal, bit 1: leaf
  __shared__ float r_s[kRun][kSeg];
  __shared__ float d_s[kRun][kSeg];
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
  float* qs = smem;                                         // [qrows][dim]
  float* buf = smem + (size_t)qrows * dim + (size_t)warp * fold.buf_len;
  // does a pair of query row k have a live entry in this segment?
  auto qlive = [&](int k) {
    bool live = false;
    for (int g = 0; g < ng; ++g) live = live || (qslot_s[g] == k && any_s[g]);
    return live;
  };
  // entries s0 .. s0 + n - 1 of every page of the run, as if they were the
  // page (SEGS: one segment of kSeg entries at a time; else the whole page)
  auto segment = [&](const int s0, const int n) {
    // the keep mask of every (pair, entry), before any metric work
    for (int g = warp; g < ng; g += nwarps) {
      const long long p = pair_s[g];
      const int fid = fid_s[g];
      const long long node = min(max(fid, 0), n_nodes - 1);
      const float qp = PRUNE ? qpd[p] : 0.f;
      const float rqi = PRUNE ? rq[p / w] : 0.f;
      bool any = false;
      for (int s = lane; s < n; s += 32) {
        const long long e = node * cap + s0 + s;
        const float r = radius[e];
        const bool keep = keep_entry<PRUNE>(fid >= 0, qp, rqi, r, PRUNE ? pdist[e] : 0.f);
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
    // pairs of a frontier row share it), once one of them has a live entry
    if (threadIdx.x == 0 && s0 == 0) {
      int nq = 0;
      for (int g = 0; g < ng; ++g) {
        const long long i = pair_s[g] / w;
        if (nq == 0 || qi_s[nq - 1] != i) {
          if (SEGS) qdone_s[nq] = false;
          qi_s[nq++] = i;
        }
        qslot_s[g] = nq - 1;
      }
      nq_s = nq;
    }
    __syncthreads();
    for (int k = 0; k < nq_s; ++k) {
      if ((SEGS && qdone_s[k]) || !qlive(k)) continue;
      const float* src = queries + qi_s[k] * dim;
      for (int x = threadIdx.x * V; x < dim; x += blockDim.x * V)
        store_shared<V>(qs + (size_t)k * dim + x, load_global<V>(src + x));
    }
    __syncthreads();

    // items: (pair g, entry s), a warp each; all of an item is uniform in the warp
    for (int it = warp; it < ng * n; it += nwarps) {
      const int g = it / n;
      const int s = it - g * n;
      if (live_s[g][s] == 0) continue;
      const long long node = min(max(fid_s[g], 0), n_nodes - 1);
      const float d = metric_wide<METRIC, V, R>(vecs + (node * cap + s0 + s) * dim,
                                                qs + (size_t)qslot_s[g] * dim, dim, fold,
                                                buf, lane);
      if (lane == 0) d_s[g][s] = d;
    }
    if (SEGS && threadIdx.x == 0 && s0 + kSeg < cap)   // read by the next segment
      for (int k = 0; k < nq_s; ++k) qdone_s[k] = qdone_s[k] || qlive(k);
    __syncthreads();
    // the segment's outputs, a pair's row at a time
    for (int x = threadIdx.x; x < ng * n; x += blockDim.x) {
      const int g = x / n;
      const int s = x - g * n;
      const unsigned f = live_s[g][s];
      const float d = f != 0u ? d_s[g][s] : 0.f;
      const float r = r_s[g][s];
      const long long o = pair_s[g] * cap + s0 + s;
      const bool iv = f & 1u, lv = f & 2u;
      dmax[o] = iv ? __fadd_rn(d, r) : inf;
      score[o] = iv ? __fsub_rn(d, r) : inf;
      leafd[o] = lv ? d : inf;
      dq[o] = iv ? d : inf;
    }
    if (SEGS && s0 + kSeg < cap) __syncthreads();   // the segment's arrays are read
  };
  if constexpr (SEGS) {
    for (int s0 = 0; s0 < cap; s0 += kSeg) segment(s0, min(kSeg, cap - s0));
  } else {
    segment(0, cap);
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

// The device's limits and one kernel's attributes, with its dynamic shared
// memory limit raised to what the device allows; ok is false on an error.
KernelInfo read_kernel_info(const void* kern, int dev) {
  KernelInfo k{};
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
  return k;
}

// One cache for each instantiation (read once for each device): they all
// share one function type, so the cache cannot be keyed on the kernel's type.
template <int METRIC, bool PRUNE, int V, int R, bool SEGS>
KernelInfo wide_kernel_info(int dev) {
  static std::mutex mu;
  static KernelInfo info[kMaxDevices];          // zero: not read yet
  std::lock_guard<std::mutex> lock(mu);
  if (!info[dev].ok)
    info[dev] = read_kernel_info((const void*)frontier_wide_kernel<METRIC, PRUNE, V, R, SEGS>,
                                 dev);
  return info[dev];
}

template <int METRIC, bool PRUNE, int NU>
KernelInfo narrow_kernel_info(int dev) {
  static std::mutex mu;
  static KernelInfo info[kMaxDevices];
  std::lock_guard<std::mutex> lock(mu);
  if (!info[dev].ok)
    info[dev] = read_kernel_info((const void*)frontier_narrow_kernel<METRIC, PRUNE, NU>, dev);
  return info[dev];
}

// One narrow launch: blocks of up to kNarrowWarps warps, as many as fit on
// an SM by registers, threads and shared memory (narrow_warp_floats a
// warp), that many for every SM, and no more warps than pairs.
template <int METRIC, bool PRUNE, int NU>
int launch_narrow(const Args& a, cudaStream_t st) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const KernelInfo k = narrow_kernel_info<METRIC, PRUNE, NU>(dev);
  if (!k.ok) {
    err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  // rows at a multiple of 4 floats whose quarter is odd: a lane's 16-byte
  // reads of its own row, 8 lanes a phase, hit 8 distinct bank quads
  NarrowStage sg;
  sg.stride = (a.dim + 3) & ~3;
  if ((sg.stride >> 2) % 2 == 0) sg.stride += 4;
  const int sn = a.cap < kSeg ? a.cap : kSeg;     // a stage's entry rows
  sg.len = (sn + 1) * sg.stride;
  const bool aligned = a.dim % 4 == 0 &&
      (((unsigned long long)a.vecs | (unsigned long long)a.queries) & 15ull) == 0;
  sg.unit = aligned ? 4 : 1;
  const size_t ring = sizeof(float) * narrow_warp_floats<METRIC>(sg, sn, a.dim);
  int warps = kNarrowWarps;
  while (warps > 1 && warps * ring > k.smem_cap) --warps;
  if (ring > k.smem_cap) return (int)cudaErrorInvalidValue;
  const int threads = 32 * warps;
  const int warp_regs = ((k.regs * 32 + 255) / 256) * 256;   // allocation unit
  int per_sm = 65536 / (warp_regs * warps);
  if (per_sm > 2048 / threads) per_sm = 2048 / threads;
  const int by_smem = (int)(k.sm_smem / (warps * ring + k.static_smem + 1024));
  if (per_sm > by_smem) per_sm = by_smem;
  if (per_sm < 1) per_sm = 1;
  if (a.pairs >= kNarrowMaxPairs) return (int)cudaErrorInvalidValue;
  const int pairs = (int)a.pairs;
  int blocks = k.sms * per_sm;
  const int need = (pairs + warps - 1) / warps;
  if (blocks > need) blocks = need;
  frontier_narrow_kernel<METRIC, PRUNE, NU><<<blocks, threads, warps * ring, st>>>(
      a.fids, a.queries, a.vecs, a.radius, a.ival, a.lval, a.pdist, a.qpd, a.rq,
      a.dmax, a.score, a.leafd, a.dq, pairs, a.w, a.n_nodes, a.cap, a.dim, sg);
  return (int)cudaGetLastError();
}

// One wide launch.  The run G is the largest (at most kRun) that lets as
// many blocks share an SM by shared memory as by registers, and that gives
// every SM a block.  A run's pairs span at most (G - 1) / w + 2 queries:
// the rows staged.
template <int METRIC, bool PRUNE, int V, int R, bool SEGS = false>
int launch_wide(const Args& a, cudaStream_t st) {
  auto kern = frontier_wide_kernel<METRIC, PRUNE, V, R, SEGS>;
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
  const KernelInfo k = wide_kernel_info<METRIC, PRUNE, V, R, SEGS>(dev);
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
  if (a.dim <= kNarrowMaxDim)
    return a.cap <= 32 ? launch_narrow<METRIC, PRUNE, 1>(a, st)    // segments of
                       : launch_narrow<METRIC, PRUNE, 2>(a, st);   // <= 64 entries
  // pages wider than kSeg: one instantiation a metric, 4-byte loads and the
  // fold from level 1 in the warp buffer (R = 0), _sum_last's order at any dim
  if (a.cap > kSeg) return launch_wide<METRIC, PRUNE, 1, 0, true>(a, st);
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
extern "C" int frontier_narrow_max_dim() { return kNarrowMaxDim; }

// Launch on ``stream``; returns the CUDA error code (0 on success).
// pdist/qpd/rq are read only when prune != 0.
extern "C" int frontier_scores_launch(
    const int* fids, const float* queries, const float* vecs,
    const float* radius, const unsigned char* ival, const unsigned char* lval,
    const float* pdist, const float* qpd, const float* rq, float* dmax,
    float* score, float* leafd, float* dq, int b, int w, int n_nodes,
    int cap, int dim, int metric, int prune, void* stream) {
  if (dim < 1 || cap < 1 || n_nodes < 1 || metric < 0 || metric > 2)
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
