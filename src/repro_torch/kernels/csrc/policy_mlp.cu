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
// kernel launch (~1 us of graph replay), so the launch, one round trip to
// memory and the latency of a row's dependent chain set the time of a call.
//
// Design: latency first.  The first kernel gave each row one thread: a
// staging loop whose every load waited for the one before (a division, a
// modulo and one L2 round trip per element), then a chain of 64 hidden units
// (8 FMAs, an accurate tanhf and 32 FMAs each) per thread: ~9 us whatever Q,
// and the head call at Q 256 ran on 2 of 132 SMs.  Here:
//  - Eight lanes of a warp share a row.  Lane p computes first-layer units
//    8p .. 8p + 7 (eight independent chains of F FMAs) and second-layer
//    units 4p .. 4p + 3 over all 64 hidden values, which the row's lanes
//    hand over by shuffles in a fixed order (unit 0, 1, ..., 63); the
//    logit is one chain over the 32 second-layer values, handed over the
//    same way in order.  Every sum is thus taken in the one-thread-a-row
//    kernel's order and the logits are bit for bit that kernel's: a greedy
//    schedule, which a near-tie of the default actor's logits can turn, is
//    kept (an order of partial sums added by xor shuffles changed the
//    4096-job Philly run's decisions from 6,078 to 6,102 on the card).  A
//    row's lanes are four apart (lane = 4p + q for the q-th row group of
//    the warp): so the eight lanes of a quarter warp read two weight
//    addresses, not eight (on the card 10-30% faster than adjacent lanes
//    at every Q).
//  - Each lane group takes kR consecutive rows (1 up to Q 2,048, 2 up to
//    8,192, else 4: the launcher picks by Q).  The rows share each weight a
//    lane reads from shared memory, which bounds the time at large Q; more
//    rows a group lengthen each lane's chain, which bounds it at small Q.
//  - Every global load is issued before any is used: the weights and the
//    rows' x and mask, one round trip to memory; then the weights go to
//    shared memory and one barrier.  A lane reads its eight (four) weights
//    of a row with 16-byte loads at compile-time offsets; every lane with
//    the same p reads the same address (a broadcast).
//  - kExact: the actor's own 8 -> 64 -> 32 -> 1 on 16-byte aligned arrays
//    is staged with 16-byte vector loads straight from the given arrays, no
//    padding and no guards.  Any other net within F <= 8, H1 <= 64, H2 <= 32
//    is zero-padded to those widths while it is staged, which changes no
//    sum: a padded input or unit adds fmaf(0, w, s) == s or fmaf(h, 0, s)
//    == s, and a padded hidden unit is tanh(0) == 0.
// All arithmetic is f32 FMA in a fixed order with accurate tanhf (no
// fast-math), which keeps the result within 1e-5 of the plain f32 version;
// kR and the lane layout change no row's order of work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kF = 8;    // input features per row (maximum)
constexpr int kH1 = 64;  // first hidden width (maximum)
constexpr int kH2 = 32;  // second hidden width (maximum)
constexpr int kLanes = 8;                // lanes per row
constexpr int kGroups = 32 / kLanes;     // row groups a warp
constexpr int kU1 = kH1 / kLanes;        // first-layer units a lane
constexpr int kU2 = kH2 / kLanes;        // second-layer units a lane
constexpr int kN1 = kF * kH1 / kThreads;   // w1 elements a thread stages
constexpr int kN2 = kH1 * kH2 / kThreads;  // w2 elements a thread stages
constexpr int kV1 = kH1 / 4, kV2 = kV1 + kH2 / 4, kV3 = kV2 + kH2 / 4;
static_assert(kN1 % 4 == 0 && kN2 % 4 == 0 && kV3 < kThreads, "widths");

// N consecutive floats at p (16-byte aligned, N a multiple of 4) into r
template <int N>
__device__ __forceinline__ void ld4(float (&r)[N], const float* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    r[i] = v.x;
    r[i + 1] = v.y;
    r[i + 2] = v.z;
    r[i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void st4(float* p, const float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
}

template <int kR, bool kExact>
__global__ void __launch_bounds__(kThreads)
policy_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ w3,
                  const float* __restrict__ b3, const float* __restrict__ mask,
                  float* __restrict__ out, int Q, int F, int H1, int H2) {
  __shared__ __align__(16) float s_w1[kF * kH1];   // (kF, kH1) row-major
  __shared__ __align__(16) float s_w2[kH1 * kH2];  // (kH1, kH2) row-major
  __shared__ __align__(16) float s_b1[kH1];
  __shared__ __align__(16) float s_b2[kH2];
  __shared__ __align__(16) float s_w3[kH2];        // the (H2, 1) column
  __shared__ float s_b3;
  constexpr int kRowsPerBlock = kThreads / kLanes * kR;
  static_assert(kU1 % 4 == 0 && kU2 % 4 == 0, "lanes");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p = lane / kGroups;         // unit share of the lane
  const int q = lane % kGroups;         // row group of the lane (its lane p = 0)
  // this lane group's kR consecutive rows
  const int row0 = blockIdx.x * kRowsPerBlock + ((tid >> 5) * kGroups + q) * kR;

  // ---- every global load first ----
  // this thread's share of w1 and w2: kN1 (kN2) consecutive elements of the
  // padded (kF, kH1) and (kH1, kH2) layouts; then one float4 of b1, b2 or w3
  // (threads 0..31) and b3 (thread 32)
  float t1[kN1], t2[kN2], tv[4] = {0.f, 0.f, 0.f, 0.f}, tb3 = 0.f;
  const int e1 = tid * kN1, e2 = tid * kN2;
  if constexpr (kExact) {
    ld4(t1, w1 + e1);
    ld4(t2, w2 + e2);
    if (tid < kV1) ld4(tv, b1 + 4 * tid);
    else if (tid < kV2) ld4(tv, b2 + 4 * (tid - kV1));
    else if (tid < kV3) ld4(tv, w3 + 4 * (tid - kV2));
  } else {
#pragma unroll
    for (int n = 0; n < kN1; ++n) {
      const int f = (e1 + n) / kH1, j = (e1 + n) % kH1;
      t1[n] = (f < F && j < H1) ? __ldg(w1 + f * H1 + j) : 0.f;
    }
#pragma unroll
    for (int n = 0; n < kN2; ++n) {
      const int j = (e2 + n) / kH2, k = (e2 + n) % kH2;
      t2[n] = (j < H1 && k < H2) ? __ldg(w2 + j * H2 + k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (tid < kV1) {
        const int u = 4 * tid + i;
        tv[i] = u < H1 ? __ldg(b1 + u) : 0.f;
      } else if (tid < kV2) {
        const int u = 4 * (tid - kV1) + i;
        tv[i] = u < H2 ? __ldg(b2 + u) : 0.f;
      } else if (tid < kV3) {
        const int u = 4 * (tid - kV2) + i;
        tv[i] = u < H2 ? __ldg(w3 + u) : 0.f;
      }
    }
  }
  if (tid == kV3) tb3 = __ldg(b3);
  float xr[kR][kF], m[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = row0 + r;
    if constexpr (kExact) {
      if (row < Q) {
        ld4(xr[r], x + (size_t)row * kF);
      } else {
#pragma unroll
        for (int f = 0; f < kF; ++f) xr[r][f] = 0.f;
      }
    } else {
#pragma unroll
      for (int f = 0; f < kF; ++f)
        xr[r][f] = (row < Q && f < F) ? __ldg(x + (size_t)row * F + f) : 0.f;
    }
    m[r] = (p == 0 && row < Q) ? __ldg(mask + row) : 0.f;
  }

  st4(s_w1 + e1, t1);
  st4(s_w2 + e2, t2);
  if (tid < kV1) st4(s_b1 + 4 * tid, tv);
  else if (tid < kV2) st4(s_b2 + 4 * (tid - kV1), tv);
  else if (tid < kV3) st4(s_w3 + 4 * (tid - kV2), tv);
  if (tid == kV3) s_b3 = tb3;
  __syncthreads();                      // the only barrier; no early return

  // ---- layer 1: units p kU1 .. p kU1 + kU1 - 1, each a chain over f ----
  float h1[kR][kU1];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int u = 0; u < kU1; ++u) h1[r][u] = 0.f;
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    float w[kU1];
    ld4(w, s_w1 + f * kH1 + p * kU1);
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int u = 0; u < kU1; ++u) h1[r][u] = fmaf(xr[r][f], w[u], h1[r][u]);
  }
  {
    float b[kU1];
    ld4(b, s_b1 + p * kU1);
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int u = 0; u < kU1; ++u) h1[r][u] = tanhf(h1[r][u] + b[u]);
  }

  // ---- layer 2: hidden unit j from lane j / kU1 of the group, in order ----
  float a2[kR][kU2];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int u = 0; u < kU2; ++u) a2[r][u] = 0.f;
#pragma unroll
  for (int j = 0; j < kH1; ++j) {
    float w[kU2];
    ld4(w, s_w2 + j * kH2 + p * kU2);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float hj = __shfl_sync(0xffffffffu, h1[r][j % kU1],
                                   q + (j / kU1) * kGroups);
#pragma unroll
      for (int u = 0; u < kU2; ++u) a2[r][u] = fmaf(hj, w[u], a2[r][u]);
    }
  }

  // ---- the logit: one chain over the 32 second-layer values in order,
  // unit k from lane k / kU2 of the group ----
  float b[kU2];
  ld4(b, s_b2 + p * kU2);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float g[kU2];
#pragma unroll
    for (int u = 0; u < kU2; ++u) g[u] = tanhf(a2[r][u] + b[u]);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kH2; ++k)
      s = fmaf(__shfl_sync(0xffffffffu, g[k % kU2], q + (k / kU2) * kGroups),
               s_w3[k], s);
    const int row = row0 + r;
    if (p == 0 && row < Q) out[row] = m[r] > 0.f ? s + s_b3 : -1e9f;
  }
}

template <int kR>
cudaError_t launch(bool exact, int Q, cudaStream_t st, const float* x,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* w3, const float* b3,
                   const float* mask, float* out, int F, int H1, int H2) {
  constexpr int rows = kThreads / kLanes * kR;
  auto kernel = exact ? policy_mlp_kernel<kR, true>
                      : policy_mlp_kernel<kR, false>;
  kernel<<<(Q + rows - 1) / rows, kThreads, 0, st>>>(
      x, w1, b1, w2, b2, w3, b3, mask, out, Q, F, H1, H2);
  return cudaGetLastError();
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
  const bool aligned = ((reinterpret_cast<size_t>(x) |
                         reinterpret_cast<size_t>(w1) |
                         reinterpret_cast<size_t>(b1) |
                         reinterpret_cast<size_t>(w2) |
                         reinterpret_cast<size_t>(b2) |
                         reinterpret_cast<size_t>(w3)) & 15) == 0;
  const bool exact = aligned && F == kF && H1 == kH1 && H2 == kH2;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fx = (const float*)x, *fw1 = (const float*)w1,
              *fb1 = (const float*)b1, *fw2 = (const float*)w2,
              *fb2 = (const float*)b2, *fw3 = (const float*)w3,
              *fb3 = (const float*)b3, *fm = (const float*)mask;
  float* fo = (float*)out;
  if (Q <= 2048)
    return (int)launch<1>(exact, Q, st, fx, fw1, fb1, fw2, fb2, fw3, fb3, fm,
                          fo, F, H1, H2);
  if (Q <= 8192)
    return (int)launch<2>(exact, Q, st, fx, fw1, fb1, fw2, fb2, fw3, fb3, fm,
                          fo, F, H1, H2);
  return (int)launch<4>(exact, Q, st, fx, fw1, fb1, fw2, fb2, fw3, fb3, fm,
                        fo, F, H1, H2);
}

}  // extern "C"
