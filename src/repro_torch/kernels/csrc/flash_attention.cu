// GQA flash-attention forward on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_fwd_kernel (wrapper flash_attention_fwd), which the LM's
// full-sequence forward reaches through kernels/ops.py:attention.
//
//   out[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, kvh, j]) v[b, kvh, j]
//
// over the keys j a row may see: j < sk and, when causal, j <= i + (sk - sq)
// (bottom-right aligned, as the TPU kernel), with
// kvh = (bh / h) * hk + (bh % h) / (h / hk) (GQA).  Masked logits are -1e30
// (never -inf), the softmax runs online in f32 (running max m, running sum
// l, rescaled accumulator), a row with l == 0 writes zeros, and the output
// has q's type (f32 or bf16).
//
// The wrapper refuses causal sq > sk: rows whose every key is masked then
// get a value that depends on the TPU kernel's block size (its exp(s - m)
// is 1 over a fully masked tile).  No model path reaches it: the LM's
// attention always has sq == sk.  So every row sees key 0, in its first
// key tile.
//
// What bounds it on this card: operations.  At the LM's prefill shape
// [4, 16, 2048, 128] causal a launch does 68.7 GFLOP (two products over
// the visible half of the logits) against 67 MB (f32) of inputs and output.
//   * bf16: 68.7 GFLOP / 989 TFLOP/s = 0.069 ms for the function.  The
//     kernel takes Q K^T in one pass of bf16 wgmma and P V in two (P split
//     in two bf16 parts, below), 1.5x the products: 0.104 ms at its own
//     arithmetic.
//   * f32: the port holds the kernel to 2e-4 of the plain f32 version, and
//     one pass of TF32 (10-bit mantissas) misses that: emulated on the CPU
//     at [1, 4, 2048, 128] causal with N(0, 1) inputs against an f64
//     reference, plain TF32 errs by 1.27e-3, f32 by 1.5e-6.  3xTF32 —
//     x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and
//     a.b ~ lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b) — errs by 4.8e-7.  So
//     each product is three TF32 wgmma: 3 x 68.7 GFLOP / 495 TFLOP/s =
//     0.416 ms (the CUDA cores' f32 rate would give 1.026 ms).
//
// Design.  A block is up to four warpgroups (bf16: four; f32: two), each
// with its own 64 query rows (wgmma M = 64), sharing every K/V tile, so
// each K/V byte is staged once for 256 (128) query rows; all heads' heaviest
// causal tiles are launched first, and the key loop stops at the block's
// last visible key (a warpgroup skips the tiles past its own).  Per key
// tile:
//   1. S = Q K^T with wgmma, Q and K both read from shared memory, K-major
//      (their natural row layout).  f32: K's lo rows follow its hi rows,
//      so B = [K hi; K lo] is one tile of 2 BK rows, and two wgmma of that
//      shape, A = Q hi (shared memory) and A = Q lo (registers: split once
//      per block, A fragments kept for the whole loop), give hi.hi +
//      hi.lo + lo.hi + lo.lo in one accumulator; S is its two halves added;
//   2. the online softmax on the accumulator registers: each row's max
//      over the four threads that hold it by shuffles, its sum only once,
//      at the end; the mask is applied only on tiles that cross the
//      diagonal or the end of the keys;
//   3. O += P V with wgmma, P taken from registers as the A operand.  bf16:
//      P split into hi = bf16(p) and lo = bf16(p - hi), two products (lo.V,
//      then hi.V), V the B operand in its natural [keys][d] layout
//      (MN-major): ~16 bits of p, as the reference's f32 p (pv()).  f32: P
//      split hi/lo in registers, three products; tf32 wgmma takes only
//      K-major B, so V is staged transposed (V^T,
//      [d][keys]), each group of 8 keys permuted so that the accumulator
//      fragment of S is the A fragment of P as it stands (no shuffles).
// K and V tiles come in by cp.async into a ring of two stages: the next
// tile's copy is in flight while this tile's products run.  In f32 a pass
// over each landed tile splits it into hi and lo halves.  Shared memory
// holds every operand in the no-swizzle wgmma layout: 8-row x 16-byte core
// matrices, written by cp.async so that eight neighbouring lanes fill one
// 128-byte core matrix.  Rows past the end and columns past d are
// zero-filled; head widths are padded to 32/64/128/256.  Row strides that
// are not a multiple of 16 bytes are staged element by element (bf16:
// plain loads; f32: 4-byte cp.async).
//
// Tiles (shared memory per block at d = 128): bf16 64 keys, 128 KB; f32
// 32 keys, Q hi and K, V^T hi and lo, 192 KB; one block an SM.  At d = 256
// bf16 takes two warpgroups and 32-key tiles, and f32 one warpgroup with
// Q's lo half in shared memory and 8-key tiles (the registers and shared
// memory hold no more).  On the card, more warpgroups a block (fewer K/V
// stagings a query row) and wider f32 tiles each paid; a third or fourth
// ring stage, narrower f32 tiles and ordering the blocks head by head (to
// keep a head's K/V in L2) did not.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWgRows = 64;           // query rows per warpgroup: wgmma M
constexpr float kMasked = -1e30f;     // flash_attention.py:NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  // warpgroups per block, each its own 64 query rows, all sharing the K/V
  // tiles: as many as the registers (bf16, f32) and shared memory (f32 at
  // d = 256: Q's hi and lo halves) allow
  static constexpr int WG = F32 ? (D == 256 ? 1 : 2) : (D == 256 ? 2 : 4);
  static constexpr int THREADS = 128 * WG;
  static constexpr int BQ = kWgRows * WG;
  static constexpr int BK = F32 ? (D <= 128 ? 32 : 8) : (D <= 128 ? 64 : 32);
  // f32: Q's lo half lives in registers (A of the lo.hi product) up to
  // d = 128; at d = 256 it would not fit and stays beside the hi half
  static constexpr bool QLO_REGS = F32 && D <= 128;
  static constexpr int Q_HALVES = F32 && !QLO_REGS ? 2 : 1;
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements per 16-byte chunk
  static constexpr int CH = D / EPC;                // chunks per Q/K row
  static constexpr int NV = D < 64 ? D : 64;        // N of one P.V wgmma
  static constexpr int HALVES = F32 ? 2 : 1;        // hi (and lo)
  static constexpr int WGQ_BYTES = kWgRows * D * (int)sizeof(T);   // one warpgroup's Q
  static constexpr int Q_BYTES = BQ * D * (int)sizeof(T);
  static constexpr int KV_BYTES = BK * D * (int)sizeof(T);
  static constexpr int STAGE_BYTES = 2 * HALVES * KV_BYTES;   // K hi, lo, V hi, lo
  static constexpr int STAGES = 2;                  // K/V ring
  static constexpr int SMEM = Q_HALVES * Q_BYTES + STAGES * STAGE_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- asynchronous copies ------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// one element, zero-filled when !ok (f32: asynchronous; bf16: 2 bytes is
// below cp.async's smallest size, so a plain load and store)
__device__ __forceinline__ void copy_elem(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void copy_elem(uint32_t dst, const __nv_bfloat16* src, bool ok) {
  const unsigned short x = ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
  asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(dst), "h"(x) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) x columns [0, D) of a row-major [nrows][d]
// matrix into shared memory at dst, element (r, c) at
//   (r / 8) * RG + (c / EPC) * CS + (r % 8) * 16 + (c % EPC) * sizeof(T),
// zero past nrows and d.  Lanes 8i..8i+7 take rows 0..7 of one 16-byte
// chunk: one 128-byte core matrix per eight lanes.
template <typename T, int NT, int ROWS, int D, int RG, int CS>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src, int row0,
                                          int nrows, int d, bool vec) {
  constexpr int EPC = 16 / (int)sizeof(T), CH = D / EPC;
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
      const int chunk = (i >> 3) % CH, r = ((i >> 3) / CH) * 8 + (i & 7);
      const bool ok = row0 + r < nrows && chunk * EPC < d;
      cp_async16(dst + (r >> 3) * RG + chunk * CS + (r & 7) * 16,
                 ok ? src + (long long)(row0 + r) * d + chunk * EPC : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool ok = row0 + r < nrows && c < d;
      copy_elem(dst + (r >> 3) * RG + (c / EPC) * CS + (r & 7) * 16 +
                    (c % EPC) * (int)sizeof(T),
                ok ? src + (long long)(row0 + r) * d + c : src, ok);
    }
  }
}

// f32 V^T: keys [row0, row0 + BK) of a [nrows][d] matrix, transposed into
// the K-major layout of the P.V B operand (N = d, K = keys): element
// (c, kp) at (c / 8) * BK * 32 + (kp / 4) * 128 + (c % 8) * 16 + (kp % 4) * 4,
// where position kp of each group of 8 holds key 2 * (kp % 4) + kp / 4 —
// the key the S accumulator fragment puts at A column kp (see pv()).
template <int NT, int BK, int D>
__device__ __forceinline__ void load_vt(uint32_t dst, const float* src, int row0,
                                        int nrows, int d) {
  for (int i = threadIdx.x; i < BK * D; i += NT) {
    const int j = i & 3, c8 = (i >> 2) & 7, rest = i >> 5;
    const int c = (rest % (D / 8)) * 8 + c8, kq = rest / (D / 8);
    const int kp = kq * 4 + j;                       // position in the tile
    const int key = (kp & ~7) + 2 * (kp & 3) + ((kp >> 2) & 1);
    const bool ok = row0 + key < nrows && c < d;
    copy_elem(dst + (c >> 3) * (BK * 32) + kq * 128 + (c & 7) * 16 + j * 4,
              ok ? src + (long long)(row0 + key) * d + c : src, ok);
  }
}

// ---- 3xTF32 --------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}

// in place: bytes of f32 at buf become tf32(x) and tf32(x - tf32(x)) at
// buf + bytes
template <int NT>
__device__ __forceinline__ void split_tf32(uint8_t* buf, int bytes) {
  float4* hi = reinterpret_cast<float4*>(buf);
  float4* lo = reinterpret_cast<float4*>(buf + bytes);
  for (int i = threadIdx.x; i < bytes / 16; i += NT) {
    float4 x = hi[i], h, l;
    h.x = __uint_as_float(tf32(x.x)); l.x = __uint_as_float(tf32(x.x - h.x));
    h.y = __uint_as_float(tf32(x.y)); l.y = __uint_as_float(tf32(x.y - h.y));
    h.z = __uint_as_float(tf32(x.z)); l.z = __uint_as_float(tf32(x.z - h.z));
    h.w = __uint_as_float(tf32(x.w)); l.w = __uint_as_float(tf32(x.w - h.w));
    hi[i] = h;
    lo[i] = l;
  }
}

// ---- wgmma ---------------------------------------------------------------

// shared-memory matrix descriptor, no swizzle: start address, LBO (the
// byte step between core matrices along K) and SBO (along M or N)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D[64 x N] (+)= A B in f32, one wgmma; acc == 0 overwrites D.  SS: A
// and B from shared memory, both K-major.  RS: A from registers, B from
// shared memory (bf16: MN-major, V as it lies; tf32: K-major, the only
// layout tf32 takes).  Only the shapes the kernel issues are defined.
template <bool F32, int N> struct SS;
template <bool F32, int N> struct RS;
template <> struct SS<false, 32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "l"(a), "l"(b), "r"(acc));
  }
};
template <> struct SS<false, 64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
                 : "l"(a), "l"(b), "r"(acc));
  }
};
template <> struct SS<true, 16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
                 : "l"(a), "l"(b), "r"(acc));
  }
};
template <> struct SS<true, 64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
                 : "l"(a), "l"(b), "r"(acc));
  }
};
template <> struct RS<false, 32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <> struct RS<false, 64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <> struct RS<true, 32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <> struct RS<true, 64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// S[64 x BK] = Q K^T (unscaled) for one warpgroup, Q and K tiles K-major
// in shared memory.  f32: Q's lo half is the A fragments qlo, or (QLO_REGS
// false) Q_BYTES after its hi half.
template <typename T, int D>
__device__ __forceinline__ void qk(float* s, uint32_t sq, uint32_t sk,
                                   const uint32_t (*qlo)[4]) {
  using C = Cfg<T, D>;
  constexpr uint32_t SBO = C::CH * 128;
  wg_fence();
  if constexpr (C::F32) {
    // K's lo rows follow its hi rows, so B = [K hi; K lo] is one K-major
    // tile of 2 BK rows, and one accumulator of N = 2 BK takes
    // hi.[hi; lo] + lo.[hi; lo]: S = its two halves added (lo.lo, below
    // the other three terms, comes free with the shape)
    constexpr int BK = C::BK;
    float acc[BK];
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t a = sq + 256 * kk;
      const uint64_t b = desc(sk + 256 * kk, 128, SBO);
      SS<true, 2 * BK>::mma(acc, desc(a, 128, SBO), b, kk > 0);
      if constexpr (C::QLO_REGS)
        RS<true, 2 * BK>::mma(acc, qlo[kk], b, 1);
      else
        SS<true, 2 * BK>::mma(acc, desc(a + C::Q_BYTES, 128, SBO), b, 1);
    }
    wg_commit_wait();
    fence_regs<BK>(acc);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = acc[i] + acc[BK / 2 + i];
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      SS<false, C::BK>::mma(s, desc(sq + 256 * kk, 128, SBO),
                            desc(sk + 256 * kk, 128, SBO), kk > 0);
    wg_commit_wait();
    fence_regs<C::BK / 2>(s);
  }
}

// f32, QLO_REGS: this thread's A fragments of its warpgroup's Q tile (at
// sq, K-major) split in place: the hi halves stay in shared memory, the lo
// halves come back.  The tf32 A fragment of k step kk holds row r0 (e
// even) or r0 + 8, column 8 kk + lane % 4 (e < 2) or + 4.
template <int D>
__device__ __forceinline__ void split_q_frags(uint32_t (*qlo)[4], uint8_t* sq,
                                              int r0, int quad) {
  constexpr int SBO = D / 4 * 128;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e & 1) * 8;
      float* p = reinterpret_cast<float*>(sq + (r >> 3) * SBO + (2 * kk + (e >> 1)) * 128 +
                                          (r & 7) * 16 + quad * 4);
      const float x = *p;
      const uint32_t hi = tf32(x);
      *p = __uint_as_float(hi);
      qlo[kk][e] = tf32(x - __uint_as_float(hi));
    }
}

// O[64 x D] += P V, P in the S accumulator fragment: p[4j + e] is row
// r0 (e < 2) or r0 + 8, key 8j + 2 * (lane % 4) + (e & 1)
template <typename T, int D>
__device__ __forceinline__ void pv(float (*o)[Cfg<T, D>::NV / 2], const float* p,
                                   uint32_t sv) {
  using C = Cfg<T, D>;
  constexpr int NV = C::NV, BK = C::BK;
  if constexpr (C::F32) {
    // the tf32 A fragment holds columns lane % 4 and lane % 4 + 4; the
    // accumulator holds keys 2 (lane % 4) and 2 (lane % 4) + 1, and V^T
    // is stored with that permutation (load_vt)
    constexpr uint32_t SBO = BK * 32;
    uint32_t hi[BK / 8][4], lo[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const float x[4] = {p[4 * kk], p[4 * kk + 2], p[4 * kk + 1], p[4 * kk + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[kk][e] = tf32(x[e]);
        lo[kk][e] = tf32(x[e] - __uint_as_float(hi[kk][e]));
      }
    }
#pragma unroll
    for (int ch = 0; ch < D / NV; ++ch) fence_regs<NV / 2>(o[ch]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int ch = 0; ch < D / NV; ++ch) {
        const uint32_t b = sv + 256 * kk + ch * (NV / 8) * SBO;
        RS<true, NV>::mma(o[ch], lo[kk], desc(b, 128, SBO), 1);
        RS<true, NV>::mma(o[ch], hi[kk], desc(b + C::KV_BYTES, 128, SBO), 1);
        RS<true, NV>::mma(o[ch], hi[kk], desc(b, 128, SBO), 1);
      }
  } else {
    // the bf16 A fragment is the accumulator fragment, two keys a register.
    // P is taken in two bf16 parts, hi = bf16(p) and lo = bf16(p - hi)
    // (p - hi is exact in f32): O takes lo.V, then hi.V, so P keeps ~16
    // bits, as the reference's kernel keeps p in f32.  Rounded to bf16
    // once, 39% of the outputs parted from the plain version's at the bf16
    // prefill shapes on an H100 80GB HBM3 (700 W), 0.26% in two parts.
    // The lo products are issued and waited for first, so the hi
    // fragments reuse their registers.
    constexpr uint32_t SBO = BK * 16;
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int part = 0; part < 2; ++part) {  // 0: lo, 1: hi
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x0 = p[8 * kk + 2 * e], x1 = p[8 * kk + 2 * e + 1];
          __nv_bfloat162 x = __floats2bfloat162_rn(x0, x1);
          if (part == 0) {
            const float2 hi = __bfloat1622float2(x);
            x = __floats2bfloat162_rn(x0 - hi.x, x1 - hi.y);
          }
          a[kk][e] = *reinterpret_cast<const uint32_t*>(&x);
        }
#pragma unroll
      for (int ch = 0; ch < D / NV; ++ch) fence_regs<NV / 2>(o[ch]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int ch = 0; ch < D / NV; ++ch)
          RS<false, NV>::mma(o[ch], a[kk],
                             desc(sv + 256 * kk + ch * (NV / 8) * SBO, 128, SBO), 1);
      if (part == 0) {
        wg_commit_wait();
#pragma unroll
        for (int ch = 0; ch < D / NV; ++ch) fence_regs<NV / 2>(o[ch]);
      }
    }
  }
  wg_commit_wait();
#pragma unroll
  for (int ch = 0; ch < D / NV; ++ch) fence_regs<NV / 2>(o[ch]);
}

// 2^x by the SFU (two ulp; a subnormal result is 0, which no row sum feels)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// the K and V tiles of keys [k0, k0 + BK) into one ring stage
template <typename T, int D>
__device__ __forceinline__ void load_kv(uint8_t* stage, const T* kb, const T* vb,
                                        int k0, int sk, int d, bool vec) {
  using C = Cfg<T, D>;
  const uint32_t s = smem_u32(stage);
  load_tile<T, C::THREADS, C::BK, D, C::CH * 128, 128>(s, kb, k0, sk, d, vec);
  const uint32_t sv = s + C::HALVES * C::KV_BYTES;
  if constexpr (C::F32)
    load_vt<C::THREADS, C::BK, D>(sv, vb, k0, sk, d);
  else   // MN-major: key groups 128 bytes apart, d groups BK * 16
    load_tile<T, C::THREADS, C::BK, D, 128, C::BK * 16>(sv, vb, k0, sk, d, vec);
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int h, int hk,
                 int sq, int sk, int d, float scale_log2, int causal, int vec) {
  using C = Cfg<T, D>;
  constexpr int BK = C::BK, NV = C::NV;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sQ = smem;                                   // hi [, lo]
  uint8_t* stages = smem + C::Q_HALVES * C::Q_BYTES;    // STAGES x (K hi [lo], V hi [lo])

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2), quad = lane & 3;   // rows r0, r0 + 8
  // one block per (batch x head, query tile), all heads' heaviest causal
  // tiles first
  const int nbh = (int)(gridDim.x / ((sq + C::BQ - 1) / C::BQ));
  const int bh = (int)(blockIdx.x % nbh);
  const int qb0 = (int)((gridDim.x - 1 - blockIdx.x) / nbh) * C::BQ;
  const int q0 = qb0 + wg * kWgRows;                         // this warpgroup's rows
  const long long kvh = (long long)(bh / h) * hk + (bh % h) / (h / hk);
  const T* qb = q + (long long)bh * sq * d;
  const T* kb = k + kvh * sk * d;
  const T* vb = v + kvh * sk * d;
  const int off = sk - sq;
  // keys past a tile's last visible one are masked for all its rows: the
  // block loads up to its own, each warpgroup computes up to its own
  const int nt = ((causal ? min(sk, qb0 + C::BQ + off) : sk) + BK - 1) / BK;
  const int nt_wg = ((causal ? min(sk, q0 + kWgRows + off) : sk) + BK - 1) / BK;
  const uint32_t sq_wg = smem_u32(sQ) + wg * C::WGQ_BYTES;

  // Q comes with tile 0; tiles 0 .. STAGES - 2 are in flight before the loop
  load_tile<T, C::THREADS, C::BQ, D, C::CH * 128, 128>(smem_u32(sQ), qb, qb0, sq, d, vec);
#pragma unroll
  for (int i = 0; i < C::STAGES - 1; ++i) {
    if (i < nt) load_kv<T, D>(stages + i * C::STAGE_BYTES, kb, vb, i * BK, sk, d, vec);
    cp_commit();
  }

  float o[D / NV][NV / 2];
#pragma unroll
  for (int ch = 0; ch < D / NV; ++ch)
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[ch][i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  uint32_t qlo[C::QLO_REGS ? D / 8 : 1][4];   // f32: Q's lo half, A fragments

  for (int t = 0; t < nt; ++t) {
    uint8_t* stage = stages + (t % C::STAGES) * C::STAGE_BYTES;
    const int next = t + C::STAGES - 1;   // into the stage released at the end of t - 1
    if (next < nt)
      load_kv<T, D>(stages + (next % C::STAGES) * C::STAGE_BYTES, kb, vb, next * BK,
                    sk, d, vec);
    cp_commit();
    cp_wait<C::STAGES - 1>();   // tile t (and Q) landed; later tiles may be in flight
    if constexpr (C::F32) {
      __syncthreads();
      if (t == 0) {
        if constexpr (C::QLO_REGS)
          split_q_frags<D>(qlo, sQ + wg * C::WGQ_BYTES, r0, quad);
        else
          split_tf32<C::THREADS>(sQ, C::Q_BYTES);
      }
      split_tf32<C::THREADS>(stage, C::KV_BYTES);
      split_tf32<C::THREADS>(stage + 2 * C::KV_BYTES, C::KV_BYTES);
    }
    fence_proxy_async();
    __syncthreads();

    if (t < nt_wg) {   // warpgroup-uniform
      float s[BK / 2];
      qk<T, D>(s, sq_wg, smem_u32(stage), qlo);

      const int k0 = t * BK;
      const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > q0 + off);
      float mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale_log2;
          if (masked) {
            const int key = k0 + 8 * j + 2 * quad + (e & 1);
            const int qpos = q0 + r0 + (e >> 1) * 8 + off;
            if (key >= sk || (causal && key > qpos)) x = kMasked;
          }
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float m_new = fmaxf(m[a], quad_max(mx[a]));
        corr[a] = ex2(m[a] - m_new);
        m[a] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * j + e] = ex2(s[4 * j + e] - m[e >> 1]);
          rs[e >> 1] += s[4 * j + e];
        }
      // l stays a per-thread partial sum until the end: corr is the same
      // for the four threads of a row
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
      for (int ch = 0; ch < D / NV; ++ch)
#pragma unroll
        for (int i = 0; i < NV / 2; ++i) o[ch][i] *= corr[(i >> 1) & 1];

      pv<T, D>(o, s, smem_u32(stage + C::HALVES * C::KV_BYTES));
    }
    __syncthreads();   // stage t % STAGES is free for tile t + STAGES
  }

  T* ob = out + (long long)bh * sq * d;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float la = quad_sum(l[a]);
    const float inv = 1.f / (la == 0.f ? 1.f : la);
    const int gq = q0 + r0 + 8 * a;
    if (gq >= sq) continue;
#pragma unroll
    for (int ch = 0; ch < D / NV; ++ch)
#pragma unroll
      for (int j = 0; j < NV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = ch * NV + 8 * j + 2 * quad + e;
          if (c < d) store(ob + (long long)gq * d + c, o[ch][4 * j + 2 * a + e] * inv);
        }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int h, int hk, int sq, int sk, int d, float scale, int causal,
           cudaStream_t st) {
  constexpr int smem = Cfg<T, D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte cp.async needs 16-byte aligned rows
  const int vec = (d * (int)sizeof(T)) % 16 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  constexpr int BQ = Cfg<T, D>::BQ;
  const long long blocks = (long long)b * h * ((sq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<T, D><<<(unsigned)blocks, Cfg<T, D>::THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, h, hk, sq, sk, d,
      scale * kLog2e, causal, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int b,
             int h, int hk, int sq, int sk, int d, float scale, int causal,
             cudaStream_t st) {
  if (d <= 32) return launch<T, 32>(q, k, v, out, b, h, hk, sq, sk, d, scale, causal, st);
  if (d <= 64) return launch<T, 64>(q, k, v, out, b, h, hk, sq, sk, d, scale, causal, st);
  if (d <= 128) return launch<T, 128>(q, k, v, out, b, h, hk, sq, sk, d, scale, causal, st);
  return launch<T, 256>(q, k, v, out, b, h, hk, sq, sk, d, scale, causal, st);
}

}  // namespace

extern "C" int flash_attention_max_head_dim() { return 256; }

// q [b, h, sq, d], k/v [b, hk, sk, d], out [b, h, sq, d], all contiguous
// and of one type (dtype 0: f32, 1: bf16).  Launch on ``stream``; returns
// the CUDA error code (0 on success).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out, int b,
                                          int h, int hk, int sq, int sk, int d,
                                          float scale, int causal, int dtype,
                                          void* stream) {
  if (b < 0 || h < 1 || hk < 1 || h % hk != 0 || sq < 0 || sk < 1 || d < 1 ||
      d > 256 || (causal && sq > sk) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, b, h, hk, sq, sk, d, scale, causal, st);
  return launch_d<__nv_bfloat16>(q, k, v, out, b, h, hk, sq, sk, d, scale, causal, st);
}
