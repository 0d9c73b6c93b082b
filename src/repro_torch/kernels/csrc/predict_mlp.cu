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
// at 3.35 TB/s.  Both are far below a kernel launch (~1 us of graph replay
// on the card), so the launch, one round trip to memory and the latency of
// a row's dependent chain set the time of a call, not the card's rates.
//
// Design: latency first, without giving up throughput at large B.  The
// first version gave each row one thread, which staged the weights into
// shared memory in a loop whose every load waited for the one before
// (a round trip to L2 each), then ran a dependent chain of ~800 FMAs: ~5.8
// us whatever B.  Here:
//  - Two lanes share a row (16 rows a warp, 64 a block of 128 threads):
//    lane p computes first-layer units 12 p .. 12 p + 11 (twelve
//    independent chains of F FMAs) and second-layer units 6 p .. 6 p + 5
//    over all 24 hidden values, which the two lanes exchange by shuffles in
//    a fixed order (unit 0, 1, ..., 23); each lane's share of the two heads
//    is summed over its six units in order, and the two shares are added
//    with one xor shuffle; lane q writes head q.
//  - Every global load is issued before any is used: the weights, padded to
//    the maximum widths (F <= 24, H1 <= 24, H2 <= 12, Q <= 2), and the
//    row's inputs, one round trip to memory; then the weights go to shared
//    memory and one barrier.  The padded layout has compile-time strides,
//    so a lane reads its twelve (six) weights of a row with 16-byte
//    (8-byte) vector loads at compile-time offsets, which the compiler
//    issues ahead of the FMAs; every lane with the same p reads the same
//    address (a broadcast).
//  - The grid is one block per 64 rows; at B 16,384 that is 256 blocks of
//    62 registers a thread (nvcc 12.9 -Xptxas -v, no spills, 3.7 KB of
//    static shared memory), all resident at once.
// Lanes per row trade latency (fewer units a lane) against instructions
// per row (every lane reads its weights and x): on the card eight lanes
// with each lane's weights loaded from global memory into registers were
// fast at small B and far slower at B 16,384 (their loads, not the
// arithmetic, were the work); four lanes were as fast as two at small B
// and slower at B 16,384.
//
// A smaller net is zero-padded: a padded input, hidden unit or head adds
// fmaf(0, w, s) == s or fmaf(h, 0, s) == s, and a padded hidden unit is
// tanh(0) == 0.  All arithmetic is f32 FMA in a fixed order with accurate
// tanhf (no fast-math), which keeps the result within 1e-5 of the plain
// f32 version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 2;                         // lanes per row
constexpr int kRowsPerBlock = kThreads / kLanes;  // 64
constexpr int kF = 24;   // input features per row (maximum)
constexpr int kH1 = 24;  // first hidden width (maximum)
constexpr int kH2 = 12;  // second hidden width (maximum)
constexpr int kQ = 2;    // quantile heads (maximum)
constexpr int kU1 = kH1 / kLanes;   // first-layer units a lane
constexpr int kU2 = kH2 / kLanes;   // second-layer units a lane
constexpr int kN1 = (kF * kH1 + kThreads - 1) / kThreads;   // w1 loads a thread
constexpr int kN2 = (kH1 * kH2 + kThreads - 1) / kThreads;  // w2 loads a thread
static_assert(kU1 % 4 == 0 && kU2 % 2 == 0 && kH2 * kQ <= kThreads &&
              kLanes == kQ, "widths");

// N consecutive floats of shared memory at p into registers, 16 bytes (N a
// multiple of 4) or 8 bytes at a time; p is aligned to match
template <int N>
__device__ __forceinline__ void lds(float (&r)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      r[i] = v.x;
      r[i + 1] = v.y;
      r[i + 2] = v.z;
      r[i + 3] = v.w;
    }
  } else {
    static_assert(N % 2 == 0, "width");
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      r[i] = v.x;
      r[i + 1] = v.y;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
predict_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ w3,
                   const float* __restrict__ b3, float* __restrict__ out,
                   int B, int F, int H1, int H2, int Q) {
  __shared__ __align__(16) float s_w1[kF * kH1];   // (kF, kH1)
  __shared__ __align__(16) float s_w2[kH1 * kH2];  // (kH1, kH2)
  __shared__ __align__(16) float s_w3[kH2 * kQ];   // (kH2, kQ)
  __shared__ __align__(16) float s_b1[kH1];
  __shared__ __align__(16) float s_b2[kH2];
  __shared__ float s_b3[kQ];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p = lane % kLanes;          // lane inside the row's pair
  const int base = lane - p;            // the pair's first lane
  const int row = blockIdx.x * kRowsPerBlock + tid / kLanes;

  // every global load first: the weights padded to the maximum widths
  // (zero past the real net), and this row's inputs
  float t1[kN1], t2[kN2], tb1 = 0.f, tb2 = 0.f, tw3 = 0.f, tb3 = 0.f;
#pragma unroll
  for (int n = 0; n < kN1; ++n) {
    const int e = tid + n * kThreads, f = e / kH1, j = e % kH1;
    t1[n] = (e < kF * kH1 && f < F && j < H1) ? __ldg(w1 + f * H1 + j) : 0.f;
  }
#pragma unroll
  for (int n = 0; n < kN2; ++n) {
    const int e = tid + n * kThreads, j = e / kH2, k = e % kH2;
    t2[n] = (e < kH1 * kH2 && j < H1 && k < H2) ? __ldg(w2 + j * H2 + k)
                                                : 0.f;
  }
  if (tid < H1) tb1 = __ldg(b1 + tid);
  if (tid < H2) tb2 = __ldg(b2 + tid);
  if (tid < kH2 * kQ) {
    const int k = tid / kQ, q = tid % kQ;
    tw3 = (k < H2 && q < Q) ? __ldg(w3 + k * Q + q) : 0.f;
  }
  if (tid < Q) tb3 = __ldg(b3 + tid);
  float xr[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f)
    xr[f] = (row < B && f < F) ? __ldg(x + (size_t)row * F + f) : 0.f;
#pragma unroll
  for (int n = 0; n < kN1; ++n)
    if (tid + n * kThreads < kF * kH1) s_w1[tid + n * kThreads] = t1[n];
#pragma unroll
  for (int n = 0; n < kN2; ++n)
    if (tid + n * kThreads < kH1 * kH2) s_w2[tid + n * kThreads] = t2[n];
  if (tid < kH1) s_b1[tid] = tb1;
  if (tid < kH2) s_b2[tid] = tb2;
  if (tid < kH2 * kQ) s_w3[tid] = tw3;
  if (tid < kQ) s_b3[tid] = tb3;
  __syncthreads();

  // layer 1: units p kU1 .. p kU1 + kU1 - 1, each a chain over f in order
  float a1[kU1];
#pragma unroll
  for (int u = 0; u < kU1; ++u) a1[u] = 0.f;
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    float w[kU1];
    lds(w, s_w1 + f * kH1 + p * kU1);
#pragma unroll
    for (int u = 0; u < kU1; ++u) a1[u] = fmaf(xr[f], w[u], a1[u]);
  }
  float h1[kU1];
  {
    float b[kU1];
    lds(b, s_b1 + p * kU1);
#pragma unroll
    for (int u = 0; u < kU1; ++u) h1[u] = tanhf(a1[u] + b[u]);
  }

  // layer 2: hidden unit j from lane j / kU1 of the pair, in order
  float a2[kU2];
#pragma unroll
  for (int u = 0; u < kU2; ++u) a2[u] = 0.f;
#pragma unroll
  for (int j = 0; j < kH1; ++j) {
    const float hj = __shfl_sync(0xffffffffu, h1[j % kU1], base + j / kU1);
    float w[kU2];
    lds(w, s_w2 + j * kH2 + p * kU2);
#pragma unroll
    for (int u = 0; u < kU2; ++u) a2[u] = fmaf(hj, w[u], a2[u]);
  }

  // heads: this lane's share over its units in order, plus the other's
  float head[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) head[q] = 0.f;
  {
    float b[kU2], w[kU2 * kQ];
    lds(b, s_b2 + p * kU2);
    lds(w, s_w3 + p * kU2 * kQ);
#pragma unroll
    for (int u = 0; u < kU2; ++u) {
      const float g = tanhf(a2[u] + b[u]);
#pragma unroll
      for (int q = 0; q < kQ; ++q) head[q] = fmaf(g, w[u * kQ + q], head[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    head[q] += __shfl_xor_sync(0xffffffffu, head[q], 1);
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    if (row < B && p == q && q < Q)
      out[(size_t)row * Q + q] = head[q] + s_b3[q];
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
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  predict_mlp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (const float*)w3, (const float*)b3, (float*)out, B, F,
      H1, H2, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
