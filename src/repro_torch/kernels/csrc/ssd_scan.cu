// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan.py::ssd_scan_bh (the Pallas kernel
// _ssd_kernel) together with its wrapper ops.ssd_scan, which computed the
// final state and the initial state's share of y in jnp afterwards.  Per
// (batch row b, head h), with a_t = dt_t A_h and cs the inclusive cumsum of
// a inside a chunk, each chunk computes
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j      (intra)
//        + exp(cs_i) C_i . S                                     (inter)
//   S'   = exp(cs_last) S + sum_j exp(cs_last - cs_j) dt_j x_j B_j^T
// with the (P, N) state S carried in f32 from chunk to chunk, starting from
// zero, and written out after the last chunk.  An initial state S0 is added
// as the reference's wrapper adds it: y_i from the zero state is rounded to
// the input dtype, then exp(cs_i) C_i . S0 (cs from the start of the
// sequence) is added in f32 and the sum rounded again; the final state is
// S + exp(cs_L) S0.  That work (S0 in shared memory, a second C . S0 dot
// product per output) lives in its own instantiation, kInit: folded into
// the one kernel it doubled the registers (64 -> 128) and slowed the scan
// without an initial state, which is the one serving runs.
//
// Bound on the H100.  At the Jamba serve shape (B 4, L 2,048, H 128, P 64,
// N 16, bf16) the chunked form at the reference's 256-step chunk is ~21
// GFLOP (C B^T per (b, chunk); the lower-triangular W x, C S and the state
// update per (b, h, chunk)), ~22 us at the bf16 tensor-core peak; the bytes
// are x and y (2 x 134 MB) plus dt, B, C and the final state, ~275 MB or
// ~82 us at 3.35 TB/s: bytes bound it.
//
// Design: right and simple first.  One block of 256 threads per (h, b)
// walks the sequence in order (the sequential chunk axis of the TPU grid
// becomes a loop inside the block) with the state in shared memory.  The
// kernel's chunk is 64 steps, the tile that fits shared memory with N = 128
// (x dt, B, C, the 64 x 64 weights W and the 64 x 128 state, ~132 KB, and
// ~165 KB with an initial state's S0 beside the carried state); the
// SSD identity makes y and the final state independent of the chunk length,
// so the wrapper keeps the reference's contract on its `chunk` argument and
// the kernel cuts each chunk into 64-step tiles (a last tile may be short).
// Per tile: x dt, B and C into shared memory and the cumsum of dt A as a
// warp scan (loading each thread's elements into registers ahead of the
// barrier instead took 255 registers and ran at half the speed); (1) W_ij =
// (C_i . B_j) exp(cs_i - cs_j), computed only for j <= i (exp(cs_i - cs_j)
// overflows above the diagonal, and no inf is ever multiplied by 0); (2) y
// rows, four threads per row, each with a quarter of P in registers, intra
// term then inter term; (3) the state update, P N elements spread over the
// block.
// x, B and C are read in their (B, L, H, P) and (B, L, N) layouts with no
// transpose.  All arithmetic is f32 FMAs.  Rows of shared memory are padded
// by one word against bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;                  // steps per tile (the kernel's chunk)
constexpr int kThreads = 256;
constexpr int kPMax = 64;
constexpr int kNMax = 128;
constexpr int kRowThreads = 4;          // threads per output row
constexpr int kPPT = kPMax / kRowThreads;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// value v rounded to T and read back as f32
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

// floats of shared memory for state width N and head dim P (and S0 when an
// initial state is given)
__host__ __device__ constexpr int smem_floats(int P, int N, bool init) {
  return kT * P            // x dt
         + 2 * kT * (N + 1) // B, C
         + kT * (kT + 1)    // W
         + (init ? 2 : 1) * P * (N + 1)  // S (and S0)
         + 2 * kT;          // cs, exp(cs_last - cs)
}

// kInit: an initial state is given (its own instantiation, so the scan
// without one carries none of its work)
template <typename T, bool kInit>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bs,
                const T* __restrict__ Cs, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ state, int L, int H,
                int P, int N) {
  extern __shared__ float smem[];
  const int N1 = N + 1;
  float* s_x = smem;                    // [kT][P]   x dt
  float* s_b = s_x + kT * P;            // [kT][N1]
  float* s_c = s_b + kT * N1;           // [kT][N1]
  float* s_w = s_c + kT * N1;           // [kT][kT + 1]
  float* s_s = s_w + kT * (kT + 1);     // [P][N1]   carried state
  float* s_cs = s_s + P * N1;           // [kT]
  float* s_carry = s_cs + kT;           // [kT]
  float* s_s0 = s_carry + kT;           // [P][N1]   initial state, if any

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a_h = A[h];
  const size_t state_off = ((size_t)b * H + h) * P * N;

  for (int e = tid; e < P * N; e += kThreads) {
    s_s[(e / N) * N1 + e % N] = 0.f;
    if (kInit) s_s0[(e / N) * N1 + e % N] = init[state_off + e];
  }
  float cs_base = 0.f;                  // sum of dt A over the earlier tiles

  const int row = tid / kRowThreads;    // output row of phase 2
  const int pc = tid % kRowThreads;     // its dims: pc + kRowThreads * kk

  for (int t0 = 0; t0 < L; t0 += kT) {
    const int nt = min(kT, L - t0);
    // ---- load the tile: dt A, x dt, B, C (zero past nt) ----
    __syncthreads();                    // the previous tile is consumed
    float a_i = 0.f;
    if (tid < kT && tid < nt) a_i = dt[((size_t)b * L + t0 + tid) * H + h] * a_h;
    for (int e = tid; e < kT * P; e += kThreads) {
      const int i = e / P, p = e % P;
      float v = 0.f;
      if (i < nt) {
        const size_t li = (size_t)b * L + t0 + i;
        v = to_f32(x[(li * H + h) * P + p]) * dt[li * H + h];
      }
      s_x[e] = v;
    }
    for (int e = tid; e < kT * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const size_t src = ((size_t)b * L + t0 + i) * N + n;
      s_b[i * N1 + n] = i < nt ? to_f32(Bs[src]) : 0.f;
      s_c[i * N1 + n] = i < nt ? to_f32(Cs[src]) : 0.f;
    }
    // inclusive cumsum of dt A over the tile: a scan in each of the first
    // two warps, then the first warp's total added to the second's
    if (tid < kT) {
      float run = a_i;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, run, off);
        if ((tid & 31) >= off) run += up;
      }
      s_cs[tid] = run;
    }
    __syncthreads();
    if (tid >= 32 && tid < kT) s_cs[tid] += s_cs[31];
    __syncthreads();
    const float total = s_cs[nt - 1];
    if (tid < kT) s_carry[tid] = tid < nt ? expf(total - s_cs[tid]) : 0.f;

    // ---- (1) W_ij = (C_i . B_j) exp(cs_i - cs_j) on j <= i < nt ----
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int i = e / kT, j = e % kT;
      float w = 0.f;
      if (j <= i && i < nt) {
        float g = 0.f;
        for (int n = 0; n < N; ++n) g = fmaf(s_c[i * N1 + n], s_b[j * N1 + n], g);
        w = g * expf(s_cs[i] - s_cs[j]);
      }
      s_w[i * (kT + 1) + j] = w;
    }
    __syncthreads();

    // ---- (2) y rows: intra-chunk, then the carried state's share ----
    if (row < nt) {
      float acc[kPPT];
#pragma unroll
      for (int kk = 0; kk < kPPT; ++kk) acc[kk] = 0.f;
      for (int j = 0; j <= row; ++j) {
        const float w = s_w[row * (kT + 1) + j];
#pragma unroll
        for (int kk = 0; kk < kPPT; ++kk) {
          const int p = pc + kRowThreads * kk;
          if (p < P) acc[kk] = fmaf(w, s_x[j * P + p], acc[kk]);
        }
      }
      const float ecs = expf(s_cs[row]);
      const float ecs0 = kInit ? expf(cs_base + s_cs[row]) : 0.f;
      const size_t yrow = (((size_t)b * L + t0 + row) * H + h) * P;
#pragma unroll
      for (int kk = 0; kk < kPPT; ++kk) {
        const int p = pc + kRowThreads * kk;
        if (p < P) {
          float cs_dot = 0.f;
          for (int n = 0; n < N; ++n)
            cs_dot = fmaf(s_c[row * N1 + n], s_s[p * N1 + n], cs_dot);
          float out = acc[kk] + ecs * cs_dot;
          if (kInit) {                  // round, add S0's share, round again
            float c_s0 = 0.f;
            for (int n = 0; n < N; ++n)
              c_s0 = fmaf(s_c[row * N1 + n], s_s0[p * N1 + n], c_s0);
            out = round_to(out, T()) + ecs0 * c_s0;
          }
          store(y + yrow + p, out);
        }
      }
    }
    __syncthreads();                    // phase 3 overwrites the state

    // ---- (3) S = exp(total) S + sum_j carry_j (x dt)_j B_j^T ----
    const float decay = expf(total);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e % N;
      float ds = 0.f;
      for (int j = 0; j < nt; ++j)
        ds = fmaf(s_b[j * N1 + n], s_x[j * P + p] * s_carry[j], ds);
      s_s[p * N1 + n] = s_s[p * N1 + n] * decay + ds;
    }
    cs_base += total;
  }
  __syncthreads();
  const float decay0 = expf(cs_base);
  for (int e = tid; e < P * N; e += kThreads) {
    const int i = (e / N) * N1 + e % N;
    state[state_off + e] = kInit ? s_s[i] + decay0 * s_s0[i] : s_s[i];
  }
}

template <typename T, bool kInit>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bs, const void* Cs, const void* init, void* y,
                   void* state, int L, int H, int P, int N, dim3 grid,
                   cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(P, N, kInit);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, kInit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T, kInit><<<grid, kThreads, smem, s>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bs,
      (const T*)Cs, (const float*)init, (T*)y, (float*)state, L, H, P, N);
  return cudaSuccess;
}

}  // namespace

extern "C" {

int ssd_scan_max_p() { return kPMax; }
int ssd_scan_max_n() { return kNMax; }

// x (B, L, H, P), B/C (B, L, N) and y (B, L, H, P) in f32 (dtype 0) or bf16
// (dtype 1); dt (B, L, H), A (H,), init (B, H, P, N) or null, and state
// (B, H, P, N) in f32; all contiguous on the device.  Launches on `stream`
// without synchronising; returns cudaGetLastError() (0 on success).
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bs, const void* Cs, const void* init, void* y,
                    void* state, int B, int L, int H, int P, int N, int dtype,
                    int device, void* stream) {
  if (B < 1 || L < 1 || H < 1 || P < 1 || P > kPMax || N < 1 || N > kNMax ||
      B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B);
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    err = init ? launch<float, true>(x, dt, A, Bs, Cs, init, y, state, L, H,
                                     P, N, grid, s)
               : launch<float, false>(x, dt, A, Bs, Cs, init, y, state, L, H,
                                      P, N, grid, s);
  else
    err = init ? launch<bf16, true>(x, dt, A, Bs, Cs, init, y, state, L, H,
                                    P, N, grid, s)
               : launch<bf16, false>(x, dt, A, Bs, Cs, init, y, state, L, H,
                                     P, N, grid, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
