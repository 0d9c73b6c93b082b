// Blockwise online-softmax attention (causal and/or sliding window, GQA) for
// Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_bh (the Pallas
// kernel _flash_kernel) together with its wrapper ops.flash_attention:
//   o[b, h, i] = sum_j softmax_j(q[b,h,i] . k[b,g,j] * sm_scale) v[b,g,j]
// over the keys j that the mask keeps (j <= i when causal, j > i - window
// when window > 0), g = h / (H / KV) the query head's KV head, sm_scale =
// 1/sqrt(D).  Masked scores are -1e30, the running max starts at -1e30, and
// the denominator is clamped at 1e-30, all as the Pallas kernel does: a row
// whose first visited tile is fully masked sums exp(0) there, and the first
// real score washes that out with alpha = exp(-1e30 - m) = 0.  m, l and the
// accumulator are f32; the output is written in the input's dtype.
//
// Bound on the H100.  At the Jamba serve shape (B 4, H 32, KV 8, L 2,048,
// D 128, causal) the work is 4 * B * H * D * L(L+1)/2 FLOP ~ 1.4e11, ~0.14
// ms at the 989 TFLOP/s bf16 tensor-core peak, against 2 * B * L * D *
// (2H + 2KV) bytes ~ 168 MB of q, k, v and o (~50 us at 3.35 TB/s): the
// operations bound it.
//
// Design: right and simple first.  One block of 256 threads per (64 query
// rows, head, batch row); four threads share a query row and each holds a
// quarter of its head dim (dims c, c+4, c+8, ...) in registers, for q and
// for the f32 accumulator.  Key/value tiles of 32 rows are converted to f32
// into shared memory; a score is four partial dot products summed with two
// warp shuffles.  All products and sums are f32 FMAs on the CUDA cores (no
// tensor cores, no TF32), so f32 inputs stay true f32.  Tiles wholly above
// the diagonal, or wholly before the window, are skipped.  The head dim is
// any D <= 128 (64, 80 and 128 in the registered configs): dims past D are
// zero in registers and shared memory, so no padding of the tensors is
// needed.  L need not be a multiple of a tile: keys past L are masked and
// their values zeroed, query rows past L are not stored.  GQA reads the KV
// head of each query head in place; KV is never repeated in memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 32;                 // keys per tile
constexpr int kDMax = 128;              // largest head dim
constexpr int kTPR = 4;                 // threads per query row
constexpr int kThreads = kBQ * kTPR;    // 256
constexpr int kDPT = kDMax / kTPR;      // head dims per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KV, int L, int D, int causal, int window,
                       float sm_scale) {
  __shared__ float s_k[kBK][kDMax];
  __shared__ float s_v[kBK][kDMax];

  const int tid = threadIdx.x;
  const int r = tid / kTPR;             // query row inside the block
  const int c = tid % kTPR;             // this thread's dims: c + kTPR * i
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int qi = q0 + r;

  const T* qp = q + ((size_t)b * H + h) * L * D;
  const T* kp = k + ((size_t)b * KV + g) * L * D;
  const T* vp = v + ((size_t)b * KV + g) * L * D;

  float qr[kDPT], acc[kDPT];
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int d = c + kTPR * i;
    qr[i] = (qi < L && d < D) ? to_f32(qp[(size_t)qi * D + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // keys this block can see: [lo, hi), tile-aligned at lo
  int lo = 0, hi = L;
  if (causal) hi = min(L, q0 + kBQ);
  if (window > 0) lo = max(0, q0 - window + 1);
  lo = lo / kBK * kBK;

  for (int k0 = lo; k0 < hi; k0 += kBK) {
    __syncthreads();                    // the previous tile is consumed
    for (int e = tid; e < kBK * kDMax; e += kThreads) {
      const int j = e / kDMax, d = e % kDMax;
      const int kj = k0 + j;
      const bool ok = kj < L && d < D;
      s_k[j][d] = ok ? to_f32(kp[(size_t)kj * D + d]) : 0.f;
      s_v[j][d] = ok ? to_f32(vp[(size_t)kj * D + d]) : 0.f;
    }
    __syncthreads();

    float s[kBK];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDPT; ++i) part = fmaf(qr[i], s_k[j][c + kTPR * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      bool keep = kj < L;
      if (causal) keep = keep && kj <= qi;
      if (window > 0) keep = keep && kj > qi - window;
      s[j] = keep ? part * sm_scale : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      p_sum += s[j];
    }
    l = alpha * l + p_sum;
#pragma unroll
    for (int i = 0; i < kDPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int i = 0; i < kDPT; ++i) acc[i] = fmaf(s[j], s_v[j][c + kTPR * i], acc[i]);
    }
    m = m_new;
  }

  if (qi < L) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + (((size_t)b * H + h) * L + qi) * D;
#pragma unroll
    for (int i = 0; i < kDPT; ++i) {
      const int d = c + kTPR * i;
      if (d < D) store(op + d, acc[i] / denom);
    }
  }
}

}  // namespace

extern "C" {

int flash_attention_max_d() { return kDMax; }

// q (B, H, L, D), k and v (B, KV, L, D), o (B, H, L, D): contiguous device
// arrays of f32 (dtype 0) or bf16 (dtype 1).  Launches on `stream` without
// synchronising; returns cudaGetLastError() (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KV, int L, int D,
                           int causal, int window, float sm_scale, int dtype,
                           int device, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || L < 1 || D < 1 ||
      D > kDMax || window < 0 || H > 65535 || B > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kBQ - 1) / kBQ, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    flash_attention_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, H, KV,
        L, D, causal, window, sm_scale);
  else
    flash_attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, H, KV, L, D, causal,
        window, sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
