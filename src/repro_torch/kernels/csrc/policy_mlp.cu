// Fused RLTune actor MLP for Hopper (sm_90a).
//
// Replaces repro/kernels/policy_mlp.py::policy_mlp (the Pallas kernel
// _policy_kernel): masked logits of a shared 3-layer MLP over every queue row,
//   out[q] = mask[q] > 0 ? (tanh(tanh(x[q] W1 + b1) W2 + b2) W3 + b3) : -1e9.
//
// Bound on the H100.  Per row the work is 2 * (F*H1 + H1*H2 + H2) FLOP
// (5,184 at the actor's 8 -> 64 -> 32 -> 1) against 40 bytes of traffic
// (x 32, mask 4, out 4); the weights (2,689 floats, 10.8 KB) are read once.
// At Q = 4096 that is 21 MFLOP and ~175 KB: ~0.32 us at the 67 TFLOP/s
// non-tensor FP32 peak and ~0.05 us at 3.35 TB/s.  Both are far below a
// kernel launch (several us), so launch latency, not the card, sets the
// time of one call; CUDA graphs or fusing the head and tail calls are the
// levers for that, not this kernel's body.
//
// Design: right and simple.  The Pallas kernel is one grid=() block over the
// whole array; here the rows are independent, so the grid is ceil(Q / 128)
// blocks of 128 threads and each thread owns one row.  Every block stages all
// six weight tensors in shared memory (every thread of a warp reads the same
// weight, a broadcast), then each thread streams the hidden layer: one tanh
// unit of layer 1 at a time, folded straight into H2 register accumulators of
// layer 2, so neither hidden vector is ever stored.
//
// The widths are compile-time maxima (F <= 8, H1 <= 64, H2 <= 32: the actor's
// own 8 -> 64 -> 32 -> 1).  A smaller network is zero-padded to them while it
// is staged, which changes no sum: a padded input, hidden unit or output unit
// adds fmaf(0, 0, s) == s.  Fixed widths let the compiler unroll the inner
// loops without guards and keep the accumulators in registers; with the
// widths as runtime loop bounds the same kernel ran about ten times slower.
// All arithmetic is f32 FMA in a fixed order with accurate tanhf (no
// fast-math), which keeps the result within 1e-5 of the plain f32 version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kF = 8;    // input features per row (maximum)
constexpr int kH1 = 64;  // first hidden width (maximum)
constexpr int kH2 = 32;  // second hidden width (maximum; register accumulators)

__global__ void __launch_bounds__(kThreads)
policy_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ w3,
                  const float* __restrict__ b3, const float* __restrict__ mask,
                  float* __restrict__ out, int Q, int F, int H1, int H2) {
  __shared__ __align__(16) float s_w1[kF * kH1];   // (kF, kH1) row-major
  __shared__ __align__(16) float s_w2[kH1 * kH2];  // (kH1, kH2) row-major
  __shared__ float s_b1[kH1], s_b2[kH2], s_w3[kH2], s_b3;

  // stage the weights, zero beyond the real (F, H1, H2)
  for (int i = threadIdx.x; i < kF * kH1; i += kThreads) {
    const int f = i / kH1, j = i % kH1;
    s_w1[i] = (f < F && j < H1) ? w1[f * H1 + j] : 0.f;
  }
  for (int i = threadIdx.x; i < kH1 * kH2; i += kThreads) {
    const int j = i / kH2, k = i % kH2;
    s_w2[i] = (j < H1 && k < H2) ? w2[j * H2 + k] : 0.f;
  }
  for (int i = threadIdx.x; i < kH1; i += kThreads)
    s_b1[i] = i < H1 ? b1[i] : 0.f;
  for (int i = threadIdx.x; i < kH2; i += kThreads) {
    s_b2[i] = i < H2 ? b2[i] : 0.f;
    s_w3[i] = i < H2 ? w3[i] : 0.f;  // the (H2, 1) column
  }
  if (threadIdx.x == 0) s_b3 = b3[0];
  __syncthreads();

  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= Q) return;  // ragged edge: after the only barrier

  float xr[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) xr[f] = f < F ? x[(size_t)row * F + f] : 0.f;

  float acc2[kH2];
#pragma unroll
  for (int k = 0; k < kH2; ++k) acc2[k] = 0.f;

#pragma unroll 2
  for (int j = 0; j < kH1; ++j) {
    float a = 0.f;
#pragma unroll
    for (int f = 0; f < kF; ++f) a = fmaf(xr[f], s_w1[f * kH1 + j], a);
    const float h = tanhf(a + s_b1[j]);
#pragma unroll
    for (int k = 0; k < kH2; ++k) acc2[k] = fmaf(h, s_w2[j * kH2 + k], acc2[k]);
  }

  float logit = 0.f;
#pragma unroll
  for (int k = 0; k < kH2; ++k)
    logit = fmaf(tanhf(acc2[k] + s_b2[k]), s_w3[k], logit);
  logit += s_b3;
  out[row] = mask[row] > 0.f ? logit : -1e9f;
}

}  // namespace

extern "C" {

int policy_mlp_max_f() { return kF; }
int policy_mlp_max_h1() { return kH1; }
int policy_mlp_max_h2() { return kH2; }

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 on success).  Pointers are device pointers to contiguous f32 arrays.
int policy_mlp_launch(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, const void* w3,
                      const void* b3, const void* mask, void* out, int Q,
                      int F, int H1, int H2, int device, void* stream) {
  if (Q < 1 || F < 1 || F > kF || H1 < 1 || H1 > kH1 || H2 < 1 || H2 > kH2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Q + kThreads - 1) / kThreads;
  policy_mlp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (const float*)w3, (const float*)b3,
      (const float*)mask, (float*)out, Q, F, H1, H2);
  return (int)cudaGetLastError();
}

}  // extern "C"
