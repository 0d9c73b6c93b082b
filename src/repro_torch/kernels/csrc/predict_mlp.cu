// Fused quantile-head runtime-predictor MLP for Hopper (sm_90a).
//
// Replaces repro/kernels/predict_mlp.py::predict_mlp (the Pallas kernel
// _predict_kernel): log-runtime residuals of the online runtime predictor for
// every row of a batch, all quantile heads at once,
//   out[b, :] = tanh(tanh(x[b] W1 + b1) W2 + b2) W3 + b3.
// No mask; f32 throughout.
//
// Bound on the H100.  Per row the work is 2 * (F*H1 + H1*H2 + H2*Q) FLOP
// (1,632 at the predictor's 21 -> 24 -> 12 -> 2) against 92 bytes of
// traffic (x 84, out 8); the weights (854 floats, 3.4 KB) are read once.  At
// B = 2,560, the deepest batch of a saturated queue window, that is 4.2 MFLOP
// and ~239 KB: ~0.06 us at the 67 TFLOP/s non-tensor FP32 peak and ~0.07 us
// at 3.35 TB/s.  Both are far below a kernel launch (several us), so launch
// latency, not the card, sets the time of one call.
//
// Design: right and simple, in the form of policy_mlp.cu.  The Pallas kernel
// is one grid=() block over the whole batch; here the rows are independent,
// so the grid is ceil(B / 128) blocks of 128 threads and each thread owns one
// row.  Every block stages all six weight tensors in shared memory (every
// thread of a warp reads the same weight, a broadcast), then each thread
// streams the first hidden layer one tanh unit at a time, folded straight
// into H2 register accumulators of the second layer, and folds the second
// layer's tanh units into Q head accumulators.  No hidden vector is stored.
//
// The widths are compile-time maxima (F <= 24, H1 <= 24, H2 <= 12, Q <= 2;
// the predictor's own net is 21 -> 24 -> 12 -> 2).  A smaller net is
// zero-padded to them while it is staged, which changes no sum: a padded
// input, hidden unit or head adds fmaf(0, w, s) == s or fmaf(h, 0, s) == s,
// and a padded hidden unit is tanh(0) == 0.  Fixed widths let the compiler
// unroll the inner loops without guards and keep the accumulators in
// registers (runtime loop bounds cost policy_mlp.cu 10x).  All arithmetic is
// f32 FMA in a fixed order with accurate tanhf (no fast-math), which keeps
// the result within 1e-5 of the plain f32 version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kF = 24;   // input features per row (maximum)
constexpr int kH1 = 24;  // first hidden width (maximum)
constexpr int kH2 = 12;  // second hidden width (maximum; register accumulators)
constexpr int kQ = 2;    // quantile heads (maximum)

__global__ void __launch_bounds__(kThreads)
predict_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ w3,
                   const float* __restrict__ b3, float* __restrict__ out,
                   int B, int F, int H1, int H2, int Q) {
  __shared__ float s_w1[kF * kH1];   // (kF, kH1) row-major
  __shared__ float s_w2[kH1 * kH2];  // (kH1, kH2) row-major
  __shared__ float s_w3[kH2 * kQ];   // (kH2, kQ) row-major
  __shared__ float s_b1[kH1], s_b2[kH2], s_b3[kQ];

  // stage the weights, zero beyond the real (F, H1, H2, Q)
  for (int i = threadIdx.x; i < kF * kH1; i += kThreads) {
    const int f = i / kH1, j = i % kH1;
    s_w1[i] = (f < F && j < H1) ? w1[f * H1 + j] : 0.f;
  }
  for (int i = threadIdx.x; i < kH1 * kH2; i += kThreads) {
    const int j = i / kH2, k = i % kH2;
    s_w2[i] = (j < H1 && k < H2) ? w2[j * H2 + k] : 0.f;
  }
  for (int i = threadIdx.x; i < kH2 * kQ; i += kThreads) {
    const int k = i / kQ, q = i % kQ;
    s_w3[i] = (k < H2 && q < Q) ? w3[k * Q + q] : 0.f;
  }
  for (int i = threadIdx.x; i < kH1; i += kThreads)
    s_b1[i] = i < H1 ? b1[i] : 0.f;
  for (int i = threadIdx.x; i < kH2; i += kThreads)
    s_b2[i] = i < H2 ? b2[i] : 0.f;
  for (int i = threadIdx.x; i < kQ; i += kThreads)
    s_b3[i] = i < Q ? b3[i] : 0.f;
  __syncthreads();

  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= B) return;  // ragged edge: after the only barrier

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

  float head[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) head[q] = 0.f;
#pragma unroll
  for (int k = 0; k < kH2; ++k) {
    const float h = tanhf(acc2[k] + s_b2[k]);
#pragma unroll
    for (int q = 0; q < kQ; ++q) head[q] = fmaf(h, s_w3[k * kQ + q], head[q]);
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    if (q < Q) out[(size_t)row * Q + q] = head[q] + s_b3[q];
}

}  // namespace

extern "C" {

int predict_mlp_max_f() { return kF; }
int predict_mlp_max_h1() { return kH1; }
int predict_mlp_max_h2() { return kH2; }
int predict_mlp_max_q() { return kQ; }

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 on success).  Pointers are device pointers to contiguous f32 arrays.
int predict_mlp_launch(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* w3,
                       const void* b3, void* out, int B, int F, int H1,
                       int H2, int Q, int device, void* stream) {
  if (B < 1 || F < 1 || F > kF || H1 < 1 || H1 > kH1 || H2 < 1 || H2 > kH2 ||
      Q < 1 || Q > kQ)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kThreads - 1) / kThreads;
  predict_mlp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (const float*)w3, (const float*)b3, (float*)out, B, F,
      H1, H2, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
