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
// Full f32 on the CUDA cores, direct differences: no TF32, no library
// product.  Tensor cores do not pay here: a product of depth 20 pads to 24
// for TF32, 3xTF32 (needed for f32 accuracy) triples the work, and the
// output still has to be written.  The TPU's |q|^2 - 2 q.e + |e|^2
// expansion of sqeuclidean cancels near zero (errors of 1e-6 to 1e-5 in
// the squared distance), enough to flip prune decisions held at 1e-6.
//
// What bounds it on this card.  The [nq, ne] output is 93-98% of the bytes
// (1.024 GB of 1.10 GB on the index path's 256 x 1,000,000 x 20 scan: 0.33
// ms at 3.35 TB/s), and each 4-byte output costs d (pair, dimension) steps:
// d_inf an FADD and an FMNMX (|x| is a free modifier), sqeuclidean an FADD
// and an FFMA, ip one FFMA.  At d = 20 that is 40 instructions an output
// for d_inf and sqeuclidean: at one warp instruction a clock on each of
// the 528 SM sub-partitions, 1.98 GHz, 5.12e9 steps take 0.33 ms as well.
// The inner loop's SASS (tools/distance_turns.py) is 272 instructions for
// 128 steps for d_inf and sqeuclidean (128 FADD, 128 FMNMX or FFMA, 8
// LDS.128, 8 others: 2.125 a step) and 144 for ip.  Measured on an H100
// (PERF.md): the loop alone, no copies and no stores, issues about 0.65
// of an instruction a clock (0.5 for ip's FFMAs) at 1,980 MHz, and the
// copies add ~17%, the stores ~5%.  So the kernel is bound by the issue of
// its arithmetic, at about half the byte bound; the tile shapes, unrolls,
// 16-byte staging and occupancies measured beside this design were no
// faster.
//
// Design:
//   - Persistent blocks: as many as the SMs hold at once (two a SM, by
//     registers), each walking the 64 x 256 output tiles t = block, block +
//     G, ... with the query tile fastest (t = et * nqt + qt).  The nqt
//     blocks that share an entry tile run it at about the same time, so
//     each entry row comes from device memory once and from L2 after.
//   - A thread computes 8 queries x 8 entries: warp w takes queries
//     8w .. 8w + 7 of the tile, lane l entries 4l .. 4l + 3 and 128 + 4l ..
//     131 + 4l.  Per dimension it reads two float4 of queries (the same
//     address in every lane: a broadcast) and two float4 of entries
//     (consecutive 16 bytes a lane: conflict-free), 4 shared loads for 128
//     FP instructions (64 for ip).
//   - Staging: a two-stage ring in shared memory, each stage one 32-wide
//     chunk of d for the tile's 64 queries and 256 entries, transposed
//     ([k][query], [k][entry]) so that the loads above are 16 bytes wide.
//     The copy does the transposing: cp.async of 4 bytes a element,
//     consecutive threads on consecutive elements of the rows (coalesced
//     reads from L2/device memory; any row alignment and any d), so the
//     next step's chunk lands while this one is computed.  Row pitches 68
//     and 260 floats keep the transposing writes at most 3-way conflicted
//     at d = 20.  Entry rows staged untransposed by 16-byte copies (rows
//     swizzled against bank conflicts) cut the copies 4x but ran no
//     faster and spilled at 128 registers.
//   - Stores: each lane writes its 4 consecutive outputs of a row as one
//     16-byte store (a warp: 512 contiguous bytes), 4-byte stores at a
//     ragged edge or where ne % 4 != 0; the PRUNE mask 4 bytes a lane from
//     the same registers.  The stores drain while the next tile computes.
#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kBQ = 64;                 // queries a tile: 8 a warp
constexpr int kBE = 256;                // entries a tile: 8 a lane
constexpr int kBD = 32;                 // dimensions a stage holds at most
constexpr int kStages = 2;
constexpr int kPQ = kBQ + 4;            // pitch of a staged query column [k][.]
constexpr int kPE = kBE + 4;            // pitch of a staged entry column [k][.]
constexpr int kMaxDevices = 64;

enum Metric { kDinf = 0, kSqEuclidean = 1, kIp = 2 };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most one group (the newest) is still in flight
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy rows r0 .. r0 + rows - 1, columns k0 .. k0 + kc - 1 of a row-major
// [*, d] matrix into dst[k][row] (pitch P), transposed, 4 bytes a copy:
// thread x takes flat elements x, x + kThreads, ... of the [rows, kc] block,
// walked with no division per copy.
template <int P>
__device__ __forceinline__ void stage_cols(float* dst, const float* __restrict__ src, long long r0,
                                           int rows, int k0, int kc, int d) {
  const int n = rows * kc;
  const int dr = kThreads / kc, dk = kThreads % kc;
  int r = threadIdx.x / kc, k = threadIdx.x % kc;
  for (int f = threadIdx.x; f < n; f += kThreads) {
    cp_async4(dst + k * P + r, src + (r0 + r) * d + k0 + k);
    r += dr;
    k += dk;
    if (k >= kc) { k -= kc; ++r; }
  }
}

template <int METRIC>
__device__ __forceinline__ float step(float acc, float q, float e) {
  if (METRIC == kDinf) return fmaxf(acc, fabsf(__fsub_rn(q, e)));
  if (METRIC == kSqEuclidean) {
    const float diff = __fsub_rn(q, e);
    return fmaf(diff, diff, acc);
  }
  return fmaf(q, e, acc);
}

// What a launch tells the blocks: the tile grid and the d chunks.
struct Walk {
  int nq, ne, d;
  int nqt;             // query tiles
  long long tiles;     // query tiles x entry tiles
  int nch;             // d chunks a tile
  bool vec;            // rows of out (and mask) allow 16-byte (4-byte) stores
};

template <int METRIC, bool PRUNE>
__global__ void __launch_bounds__(kThreads, 2)
dist_kernel(const float* __restrict__ q, const float* __restrict__ e,
            const float* __restrict__ rq, const float* __restrict__ re,
            float* __restrict__ out, unsigned char* __restrict__ mask, Walk wk) {
  extern __shared__ __align__(16) float smem[];
  const int kd = wk.d < kBD ? wk.d : kBD;       // dimensions a stage holds
  const int stage_len = kd * (kPQ + kPE);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = gridDim.x;

  // the copies of step (tile t, chunk c) into stage s, as one commit group
  auto issue = [&](long long t, int c, int s) {
    float* qs = smem + s * stage_len;
    float* es = qs + kd * kPQ;
    const int qt = (int)(t % wk.nqt);
    const long long e0 = (t / wk.nqt) * kBE;
    const int q0 = qt * kBQ;
    const int k0 = c * kBD;
    const int kc = min(kBD, wk.d - k0);
    stage_cols<kPQ>(qs, q, q0, min(kBQ, wk.nq - q0), k0, kc, wk.d);
    stage_cols<kPE>(es, e, e0, (int)min((long long)kBE, wk.ne - e0), k0, kc, wk.d);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  long long t = blockIdx.x, ti = blockIdx.x;    // computed / issued step's tile
  int c = 0, ci = 0, s = 0;                     // their chunks; the stage computed
  issue(ti, ci, 0);
  cp_commit();
  while (t < wk.tiles) {
    // the next step's copies, into the other stage
    if (++ci == wk.nch) { ci = 0; ti += G; }
    if (ti < wk.tiles) issue(ti, ci, s ^ 1);
    cp_commit();
    cp_wait_one();
    __syncthreads();

    const float* qs = smem + s * stage_len + 8 * warp;
    const float* es = smem + s * stage_len + kd * kPQ + 4 * lane;
    const int kc = min(kBD, wk.d - c * kBD);
#pragma unroll 2
    for (int k = 0; k < kc; ++k) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + k * kPQ);
      const float4 qb = *reinterpret_cast<const float4*>(qs + k * kPQ + 4);
      const float4 ea = *reinterpret_cast<const float4*>(es + k * kPE);
      const float4 eb = *reinterpret_cast<const float4*>(es + k * kPE + 128);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const float ev[8] = {ea.x, ea.y, ea.z, ea.w, eb.x, eb.y, eb.z, eb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = step<METRIC>(acc[i][j], qv[i], ev[j]);
    }

    if (c == wk.nch - 1) {                      // the tile is done: write it
      const int q0 = (int)(t % wk.nqt) * kBQ + 8 * warp;
      const long long e0 = (t / wk.nqt) * kBE + 4 * lane;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int gq = q0 + i;
        if (gq < wk.nq) {
          const float rqi = PRUNE ? __ldg(rq + gq) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long ge = e0 + 128 * h;
            float v[4];
#pragma unroll
            for (int x = 0; x < 4; ++x)
              v[x] = METRIC == kIp ? -acc[i][4 * h + x] : acc[i][4 * h + x];
            const long long o = (long long)gq * wk.ne + ge;
            const bool whole = wk.vec && ge + 3 < wk.ne;
            if (whole) {
              *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
              for (int x = 0; x < 4; ++x)
                if (ge + x < wk.ne) out[o + x] = v[x];
            }
            if (PRUNE) {
              unsigned m = 0;
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                if (ge + x >= wk.ne) continue;
                const float tv = METRIC == kSqEuclidean ? __fsqrt_rn(fmaxf(v[x], 0.f)) : v[x];
                m |= (unsigned)(tv <= __fadd_rn(rqi, __ldg(re + ge + x))) << (8 * x);
              }
              if (whole) {
                *reinterpret_cast<unsigned*>(mask + o) = m;
              } else {
#pragma unroll
                for (int x = 0; x < 4; ++x)
                  if (ge + x < wk.ne) mask[o + x] = (unsigned char)(m >> (8 * x));
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
    }
    __syncthreads();                            // stage s is read before it is refilled
    if (++c == wk.nch) { c = 0; t += G; }
    s ^= 1;
  }
}

// The device's limits and one kernel's registers, with its dynamic shared
// memory limit raised to the largest stage ring; read once for each device.
struct KernelInfo { bool ok; int sms, sm_smem, regs; size_t static_smem; };

template <int METRIC, bool PRUNE>
KernelInfo kernel_info(int dev) {
  static std::mutex mu;
  static KernelInfo info[kMaxDevices];          // zero: not read yet
  std::lock_guard<std::mutex> lock(mu);
  KernelInfo& k = info[dev];
  if (k.ok) return k;
  const void* kern = (const void*)dist_kernel<METRIC, PRUNE>;
  cudaFuncAttributes at;
  k.sms = 132;
  k.sm_smem = 228 * 1024;
  cudaDeviceGetAttribute(&k.sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&k.sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (cudaFuncGetAttributes(&at, kern) != cudaSuccess) return k;
  const int most = (int)sizeof(float) * kStages * kBD * (kPQ + kPE);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most) !=
      cudaSuccess)
    return k;
  k.regs = at.numRegs;
  k.static_smem = at.sharedSizeBytes;
  k.ok = true;
  return k;
}

// One launch: as many blocks as the SMs hold at once by registers,
// threads and shared memory, and no more than the tiles.
template <int METRIC, bool PRUNE>
int launch(const Walk& wk, cudaStream_t st, const float* q, const float* e,
           const float* rq, const float* re, float* out, unsigned char* mask) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const KernelInfo k = kernel_info<METRIC, PRUNE>(dev);
  if (!k.ok) {
    err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const int kd = wk.d < kBD ? wk.d : kBD;
  const size_t smem = sizeof(float) * kStages * kd * (kPQ + kPE);
  const int warp_regs = ((k.regs * 32 + 255) / 256) * 256;   // allocation unit
  int per_sm = 65536 / (warp_regs * (kThreads / 32));
  if (per_sm > 2048 / kThreads) per_sm = 2048 / kThreads;
  const int by_smem = (int)(k.sm_smem / (smem + k.static_smem + 1024));
  if (per_sm > by_smem) per_sm = by_smem;
  if (per_sm < 1) per_sm = 1;
  long long blocks = (long long)k.sms * per_sm;
  if (blocks > wk.tiles) blocks = wk.tiles;
  dist_kernel<METRIC, PRUNE><<<(unsigned)blocks, kThreads, smem, st>>>(q, e, rq, re, out, mask,
                                                                       wk);
  return (int)cudaGetLastError();
}

template <bool PRUNE>
int launch_metric(int metric, const Walk& wk, cudaStream_t st, const float* q,
                  const float* e, const float* rq, const float* re, float* out,
                  unsigned char* mask) {
  if (metric == kDinf) return launch<kDinf, PRUNE>(wk, st, q, e, rq, re, out, mask);
  if (metric == kSqEuclidean) return launch<kSqEuclidean, PRUNE>(wk, st, q, e, rq, re, out, mask);
  return launch<kIp, PRUNE>(wk, st, q, e, rq, re, out, mask);
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
  Walk wk;
  wk.nq = nq;
  wk.ne = ne;
  wk.d = d;
  wk.nqt = (nq + kBQ - 1) / kBQ;
  wk.tiles = (long long)wk.nqt * ((ne + kBE - 1) / kBE);
  wk.nch = (d + kBD - 1) / kBD;
  wk.vec = ne % 4 == 0 && ((unsigned long long)out & 15ull) == 0 &&
           ((unsigned long long)mask & 3ull) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (mask != nullptr) return launch_metric<true>(metric, wk, st, q, e, rq, re, out, mask);
  return launch_metric<false>(metric, wk, st, q, e, rq, re, out, mask);
}
