// Fused MoE router for Hopper (sm_90a): logits -> top-k -> softmax over the k.
//
// Replaces repro/kernels/moe_router.py::moe_router (the Pallas kernel
// _router_kernel).  For every token t of x (T, d) and router weight W (d, E):
//   logits[t] = x[t] W                       (f32)
//   k passes: take the row maximum and its index (the lowest index among
//             equal maxima, as jnp.argmax and lax.top_k give it), then set
//             that entry to -1e30
//   weights[t] = softmax of the k maxima;  idx[t] = their expert indices.
// The (T, E) logits never leave the chip.
//
// Bound on the H100.  At the Jamba serve prefill (T 8,192, d 4,096, E 16,
// k 2, bf16 x, f32 W) the work is 2 T d E ~ 1.1 GFLOP and the bytes are
// x (67 MB) plus W (256 KB) plus the outputs (131 KB): ~20 us at 3.35 TB/s
// against ~16 us for the FLOP at the 67 TFLOP/s f32 peak, so bytes bound
// it.  A decode step (T 4) reads W's 256 KB and a few KB of x: ~80 ns at
// 3.35 TB/s, so the launch bounds it in practice.
//
// Design: simple first, with the d-long dot products spread over threads.
// One block of 256 threads takes TB = 8 tokens; thread (j, e) with
// e = tid % E and j = tid / E < J = 256 / E owns expert e's products over
// the d indices j, j + J, j + 2J, ... for all 8 tokens at once: each W
// element is read once per block (coalesced over e) and used 8 times, and
// the loads of one thread are independent, so many are in flight (a
// single thread walking all of d for one token waits on each load in
// turn; that first design took 191 us at T = 4).  The block walks d in
// 256-wide slices of its x rows, converted to f32 in shared memory.  The
// J partial sums of each logit are then added in a fixed order (j = 0, 1,
// ...), the logits go to shared memory, and one thread per token runs the
// k argmax passes over its E logits with a strict `>` scan from expert 0
// up (the first maximum wins) and the softmax.  E <= 256 experts, any
// k <= E, any d.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTB = 8;                  // tokens per block
constexpr int kDSlice = 256;            // d per shared-memory slice
constexpr int kMaxE = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_router_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ weights, int* __restrict__ idx, int T_,
                  int d, int E, int k) {
  __shared__ float s_x[kTB][kDSlice];
  __shared__ float s_part[kTB][kThreads];     // [token][j * E + e]
  __shared__ float s_logits[kTB][kMaxE];

  const int tid = threadIdx.x;
  const int J = kThreads / E;           // d-parts per expert
  const int e = tid % E, j = tid / E;
  const bool active = j < J;
  const int t0 = blockIdx.x * kTB;
  const int nt = min(kTB, T_ - t0);

  float acc[kTB];
#pragma unroll
  for (int r = 0; r < kTB; ++r) acc[r] = 0.f;
  for (int d0 = 0; d0 < d; d0 += kDSlice) {
    const int nd = min(kDSlice, d - d0);
    __syncthreads();                    // the previous slice is consumed
#pragma unroll
    for (int u = 0; u < kTB * kDSlice / kThreads; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / kDSlice, dd = i % kDSlice;
      s_x[r][dd] = (r < nt && dd < nd)
                       ? to_f32(x[(size_t)(t0 + r) * d + d0 + dd]) : 0.f;
    }
    __syncthreads();
    if (active) {
      const float* wp = w + (size_t)d0 * E + e;
#pragma unroll 4
      for (int dd = j; dd < nd; dd += J) {
        const float wv = __ldg(wp + (size_t)dd * E);
#pragma unroll
        for (int r = 0; r < kTB; ++r) acc[r] = fmaf(s_x[r][dd], wv, acc[r]);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < kTB; ++r) s_part[r][tid] = acc[r];
  }
  __syncthreads();
  for (int i = tid; i < nt * E; i += kThreads) {
    const int r = i / E, ee = i % E;
    float sum = 0.f;
    for (int jj = 0; jj < J; ++jj) sum += s_part[r][jj * E + ee];
    s_logits[r][ee] = sum;
  }
  __syncthreads();

  if (tid < nt) {
    float* row = s_logits[tid];
    const size_t out = (size_t)(t0 + tid) * k;
    float m = kNegInf;
    for (int kk = 0; kk < k; ++kk) {
      float best = row[0];
      int arg = 0;
      for (int jj = 1; jj < E; ++jj)
        if (row[jj] > best) {
          best = row[jj];
          arg = jj;
        }
      row[arg] = kNegInf;
      weights[out + kk] = best;         // the value for now, the weight below
      idx[out + kk] = arg;
      m = fmaxf(m, best);
    }
    float sum = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const float p = expf(weights[out + kk] - m);
      weights[out + kk] = p;
      sum += p;
    }
    for (int kk = 0; kk < k; ++kk) weights[out + kk] /= sum;
  }
}

}  // namespace

extern "C" {

int moe_router_max_e() { return kMaxE; }

// x (T, d) f32 (dtype 0) or bf16 (dtype 1), w (d, E) f32, weights (T, k)
// f32, idx (T, k) int32; all contiguous on the device.  Launches on `stream`
// without synchronising; returns cudaGetLastError() (0 on success).
int moe_router_launch(const void* x, const void* w, void* weights, void* idx,
                      int T, int d, int E, int k, int dtype, int device,
                      void* stream) {
  if (T < 1 || d < 1 || E < 1 || E > kMaxE || k < 1 || k > E ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (T + kTB - 1) / kTB;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    moe_router_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)w, (float*)weights, (int*)idx, T, d, E,
        k);
  else
    moe_router_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)w, (float*)weights, (int*)idx,
        T, d, E, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
