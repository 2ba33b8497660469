// GQA flash-attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_fwd_kernel (wrapper flash_attention_fwd), which the LM's
// full-sequence forward reaches through kernels/ops.py:attention.
//
//   out[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, kvh, j]) v[b, kvh, j]
//
// over the keys j a row may see: j < sk and, when causal, j <= i + (sk - sq)
// (bottom-right aligned, as the TPU kernel).  kvh = h // (h / hk) (GQA).
// Masked logits are -1e30 (never -inf), the softmax runs online in f32
// (running max m, running sum l, rescaled accumulator), and a row with
// l == 0 writes zeros.  Inputs are f32 or bf16, upcast to f32 as they are
// staged; the output has the inputs' type.
//
// The wrapper refuses causal sq > sk: rows whose every key is masked then
// get a value that depends on the TPU kernel's block size (its exp(s - m)
// is 1 over a fully masked tile).  No model path reaches it: the LM's
// attention always has sq == sk.
//
// What bounds it on this card: operations.  At the LM's prefill shape
// [4, 16, 2048, 128] causal, a launch does about 68.7 GFLOP (two products
// over half of the 2048 x 2048 logits per head) against 67 MB of inputs and
// output, far above the f32 balance point (about 20 flops a byte).  The
// products run in full f32 on the CUDA cores — no TF32: the port holds the
// kernel to 2e-4 of the plain version.
//
// Design (simple and correct first): one block of 256 threads per
// (batch x head, 64-row query tile); the heaviest causal tiles are launched
// first.  The query tile is staged once, transposed; the block walks the
// key/value tiles (64 keys, 32 for head widths above 128), staging K
// transposed and V as rows in shared memory (dynamic, above the 48 KB
// static limit).  Each thread owns 4 query rows x 4 (or 2) key columns of
// the logits and 4 rows x D/16 columns of the accumulator; the row max and
// row sum are reduced across the 16 threads that share a row with warp
// shuffles.  Causal tiles that are fully masked are never visited (the
// key loop ends at the tile's last visible key).  Head widths up to 256
// are padded to the next of 32/64/128/256 with zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;     // flash_attention.py:NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
__host__ __device__ constexpr int key_tile() { return D <= 128 ? 64 : 32; }

template <int D>
__host__ __device__ constexpr size_t smem_floats() {
  constexpr int BK = key_tile<D>();
  return (size_t)D * (kBQ + 1) + (size_t)D * (BK + 1) + (size_t)BK * D +
         (size_t)kBQ * (BK + 1);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, m));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int h, int hk,
                 int sq, int sk, int d, float scale, int causal) {
  constexpr int BK = key_tile<D>();
  constexpr int NB = BK / 16;       // logit columns per thread
  constexpr int NJ = D / 16;        // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;                          // [D][kBQ + 1]
  float* Kt = Qt + D * (kBQ + 1);            // [D][BK + 1]
  float* Vs = Kt + D * (BK + 1);             // [BK][D]
  float* Ps = Vs + BK * D;                   // [kBQ][BK + 1]

  const int tx = threadIdx.x & 15;           // column group
  const int ty = threadIdx.x >> 4;           // row group: rows ty + 16a
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heavy tiles first
  const int g = h / hk;
  const long long kvh = (long long)(bh / h) * hk + (bh % h) / g;
  const T* qb = q + (long long)bh * sq * d;
  const T* kb = k + kvh * sk * d;
  const T* vb = v + kvh * sk * d;
  const int off = sk - sq;

  for (int t = threadIdx.x; t < kBQ * D; t += kThreads) {
    const int r = t / D, c = t - (t / D) * D;
    const int gq = q0 + r;
    Qt[c * (kBQ + 1) + r] = (gq < sq && c < d) ? to_f32(qb[(long long)gq * d + c]) : 0.f;
  }

  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kMasked;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;
  }
  // keys past the tile's last visible one are masked for every row
  const int kend = causal ? min(sk, q0 + kBQ + off) : sk;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();               // the previous tile's K, V and P are used up
    for (int t = threadIdx.x; t < BK * D; t += kThreads) {
      const int r = t / D, c = t - (t / D) * D;
      const int gk = k0 + r;
      const bool in = gk < sk && c < d;
      Kt[c * (BK + 1) + r] = in ? to_f32(kb[(long long)gk * d + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[(long long)gk * d + c]) : 0.f;
    }
    __syncthreads();

    float s[4][NB];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) s[a][b] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qa[4], kc[NB];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = Qt[c * (kBQ + 1) + ty + 16 * a];
#pragma unroll
      for (int b = 0; b < NB; ++b) kc[b] = Kt[c * (BK + 1) + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < NB; ++b) s[a][b] = fmaf(qa[a], kc[b], s[a][b]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = ty + 16 * a;
      const int qpos = q0 + row + off;
      float mx = kMasked;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int kpos = k0 + tx + 16 * b;
        const bool vis = kpos < sk && (!causal || kpos <= qpos);
        s[a][b] = vis ? s[a][b] * scale : kMasked;
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_new = fmaxf(m[a], half_warp_max(mx));
      const float corr = expf(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float p = expf(s[a][b] - m_new);
        Ps[row * (BK + 1) + tx + 16 * b] = p;
        rs += p;
      }
      l[a] = l[a] * corr + half_warp_sum(rs);
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[a][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], vc[NJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = Ps[(ty + 16 * a) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vc[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[a][j] = fmaf(pa[a], vc[j], acc[a][j]);
    }
  }

  T* ob = out + (long long)bh * sq * d;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gq = q0 + ty + 16 * a;
    if (gq >= sq) continue;
    const float inv = 1.f / (l[a] == 0.f ? 1.f : l[a]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ob[(long long)gq * d + c] = from_f32<T>(acc[a][j] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int h, int hk, int sq, int sk, int d, float scale, int causal,
           cudaStream_t st) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, h, hk, sq, sk, d, scale,
      causal);
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
  if ((long long)b * h > 0x7fffffffLL || (sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, b, h, hk, sq, sk, d, scale, causal, st);
  return launch_d<__nv_bfloat16>(q, k, v, out, b, h, hk, sq, sk, d, scale, causal, st);
}
