// Mamba2 SSD (state-space duality) scan for Hopper (sm_90a), chunk-parallel.
//
// Replaces repro/kernels/ssd_scan.py::ssd_scan_bh (the Pallas kernel
// _ssd_kernel) together with its wrapper ops.ssd_scan, which computed the
// final state and the initial state's share of y in jnp afterwards.  Per
// (batch row b, head h), with a_t = dt_t A_h and cs the inclusive cumsum of
// a inside a chunk,
//   S_c     = sum_j exp(cs_last - cs_j) dt_j x_j B_j^T        (chunk state)
//   S_in(0) = 0,  S_in(c + 1) = exp(cs_last(c)) S_in(c) + S_c  (carried)
//   y_i     = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//             + exp(cs_i) C_i . S_in(c)
// and the final state is S_in(n_chunks).  The SSD identity makes y and the
// final state independent of the chunk length, so the chunk is this
// kernel's own choice (chunk_len: 128 steps in bf16 at N <= 16, else 64);
// the wrapper keeps the reference's contract on its `chunk`.  An initial
// state S0 is added as the reference's wrapper adds it: y from the zero
// state is rounded to the input dtype, then exp(cs0_i) C_i . S0 (cs0 from
// the start of the sequence) is added in f32 and the sum rounded again; the
// final state is S_in(n_chunks) + exp(cs0_L) S0.  That work lives in its own
// instantiation (kInit), so the scan without an initial state carries none
// of it.
//
// Bound on the H100.  At the Jamba serve shape (B 4, L 2,048, H 128, P 64,
// N 16, bf16) the bytes are x and y (2 x 134 MB) plus dt, B, C and the
// final state, ~275 MB or ~82 us at 3.35 TB/s; the products, ~21 GFLOP at
// the reference's 256-step chunk, take ~22 us at the bf16 tensor-core peak:
// bytes bound it.  The three kernels below also read x twice and move the
// f32 chunk states (34 MB at 128-step chunks) four times: ~545 MB in all.
//
// Design: one call launches three kernels (kKernelsPerCall).
//  1. chunk_state: one block per (chunk, group of kHeads heads, b) computes
//     S_c of each head into an f32 scratch (B, H, n_chunks, P, NT), NT = N
//     rounded up to 16 or 128, and the chunk's sum of dt A.
//  2. state_pass: one block per (h, b) runs the short recurrence over the
//     chunks in f32 in place (S_c becomes S_in(c)), writes the final state
//     and each chunk's start of cs0 (for the initial state's share).
//  3. chunk_scan: one block per (chunk, group of heads, b) computes y.
// Blocks 1 and 3 walk their kHeads heads with the next head's x, dt (and,
// in 3, S_in and S0) tiles loaded by cp.async into the other of two
// buffers while the current head computes; B and C are loaded once per
// block.  x, B and C are read in their (B, L, H, P) and (B, L, N) layouts.
// Each warp makes its own copy of the chunk's cumsum (no barrier between
// making and use).
// bf16: the products run on the tensor cores (mma.sync m16n8k16, f32
// accumulators), one 16-row tile a warp.  C . B^T takes the bf16 inputs as
// they are (exact products); where an operand is an f32 value made in the
// kernel (the decay-weighted W, dt-scaled B, the carried state S_in, S_mid,
// S0), it is split into a bf16 high part and the bf16 rounding of the rest,
// and both are multiplied (the reference computes those products in f32).
// A 128-step chunk halves the chunk-state scratch of a 64-step one (state
// passing fell from 57 to 24 us at the serve shape); its outputs kernel
// keeps the tensor work of 64-step chunks (see chunk_scan_bf16).
// f32: the same three kernels with IEEE FMAs (no TF32), one head a block,
// register tiles of 4 x 8 outputs a thread.
// Accurate expf throughout (no fast-math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kKernelsPerCall = 3;
constexpr int kQ = 64;          // steps per chunk (f32; bf16 at N 128)
constexpr int kP = 64;          // head dim tile (P <= 64)
constexpr int kNMax = 128;
constexpr int kThreads = 128;   // four warps
constexpr int kHeads = 4;       // heads per block of kernels 1 and 3 (bf16)
constexpr int kPassThreads = 256;
constexpr int kXS = kP + 8;     // bf16 row stride of x tiles (ldmatrix
                                // rows land in distinct banks)

// ------------------------------------------------------------ helpers --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and gets (row l / 4, columns 2 (l % 4), +1) of each (.trans: the
// transposed matrix's)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// d (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col).  With g = lane
// / 4 and t = lane % 4: a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}, b = {(2t.., g), (2t + 8.., g)}, d = {(g, 2t), (g,
// 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}; a pair's first element in the
// low half
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (u, v) as a bf16 pair: the high parts in hi, the rest rounded in lo
__device__ __forceinline__ void split(float u, float v, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(u - hf.x, v - hf.y));
}

// v rounded to bf16 and read back as f32
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// A (rmax, cmax) tile: dst[r * ds + c] = src[r * ss + c] for r < nr and
// c < nc, zero elsewhere.  vec: 16-byte cp.async copies (nc a multiple of
// 16 / sizeof(T), src 16-byte aligned at every row), else element copies.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ds, const T* src,
                                          size_t ss, int nr, int nc, int rmax,
                                          int cmax, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const int cpr = cmax / E;
    for (int e = threadIdx.x; e < rmax * cpr; e += blockDim.x) {
      const int r = e / cpr, c = (e % cpr) * E;
      const bool ok = r < nr && c < nc;
      cp_async16(dst + r * ds + c, ok ? src + r * ss + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rmax * cmax; e += blockDim.x) {
      const int r = e / cmax, c = e % cmax;
      dst[r * ds + c] = (r < nr && c < nc) ? src[r * ss + c] : T(0.f);
    }
  }
}

// dt of head h over the chunk's QC steps (zero past nt)
template <int QC>
__device__ __forceinline__ void load_dt(float* dst, const float* dt,
                                        size_t row0, int nt, int H, int h) {
  for (int i = threadIdx.x; i < QC; i += blockDim.x)
    cp_async4(dst + i, dt + (row0 + min(i, nt - 1)) * H + h, i < nt);
}

// Inclusive cumsum of dt A over a chunk of QC steps by one warp: lane l
// holds steps l, l + 32, ...  Writes cs[QC] and returns the chunk's total.
template <int QC>
__device__ __forceinline__ float chunk_cumsum(const float* s_dt, float a_h,
                                              float* cs) {
  constexpr int K = QC / 32;
  const int lane = threadIdx.x & 31;
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = s_dt[lane + 32 * k] * a_h;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float u = __shfl_up_sync(0xffffffffu, v[k], off);
      if (lane >= off) v[k] += u;
    }
  }
#pragma unroll
  for (int k = 1; k < K; ++k) v[k] += __shfl_sync(0xffffffffu, v[k - 1], 31);
#pragma unroll
  for (int k = 0; k < K; ++k) cs[lane + 32 * k] = v[k];
  return __shfl_sync(0xffffffffu, v[K - 1], 31);
}

// NT: the state width N rounded up to 16 or 128 (scratch and tile width)
__host__ __device__ constexpr int state_width(int N) {
  return N <= 16 ? 16 : kNMax;
}

// The chunk length of the bf16 kernels: 128 steps at N <= 16 (half the
// chunk-state scratch of 64 steps; the tiles fit three blocks an SM), 64 at
// N 128 (the B, C, state and S0 tiles of 128 steps would not fit).
__host__ __device__ constexpr int chunk_len(int NT, bool is_bf16) {
  return is_bf16 && NT == 16 ? 128 : kQ;
}

// ============================================ 1. chunk states (bf16) ====
template <int NT, int QC>
struct StateSmemBf16 {
  static constexpr int BS = NT + 8;
  static constexpr size_t b = 0;                          // bf16 [QC][BS]
  static constexpr size_t x = b + sizeof(bf16) * QC * BS;  // bf16 [2][QC][kXS]
  static constexpr size_t dt = x + sizeof(bf16) * 2 * QC * kXS;  // f32 [2][QC]
  static constexpr size_t w = dt + sizeof(float) * 2 * QC;   // f32 [4][QC]
  static constexpr size_t cs = w + sizeof(float) * 4 * QC;   // f32 [4][QC]
  static constexpr size_t bytes = cs + sizeof(float) * 4 * QC;
};

template <int NT, int QC>
__global__ void __launch_bounds__(kThreads)
chunk_state_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bs,
                 float* __restrict__ states, float* __restrict__ totals,
                 int L, int H, int P, int N, int nc, bool xvec, bool bvec) {
  using S = StateSmemBf16<NT, QC>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_b = reinterpret_cast<bf16*>(smem + S::b);
  bf16* s_x = reinterpret_cast<bf16*>(smem + S::x);
  float* s_dt = reinterpret_cast<float*>(smem + S::dt);
  const int c = blockIdx.x, h0 = blockIdx.y * kHeads, b = blockIdx.z;
  const int l0 = c * QC, nt = min(QC, L - l0), nh = min(kHeads, H - h0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // each warp's own copy of the cumsum and weights: no barrier between
  // making and use
  float* s_w = reinterpret_cast<float*>(smem + S::w) + warp * QC;
  float* s_cs = reinterpret_cast<float*>(smem + S::cs) + warp * QC;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const size_t row0 = (size_t)b * L + l0;

  auto load_head = [&](int k, int s) {
    const int h = h0 + k;
    load_tile(s_x + s * QC * kXS, kXS, x + (row0 * H + h) * P, (size_t)H * P,
              nt, P, QC, kP, xvec);
    load_dt<QC>(s_dt + s * QC, dt, row0, nt, H, h);
  };
  load_tile(s_b, S::BS, Bs + row0 * N, (size_t)N, nt, N, QC, NT, bvec);
  load_head(0, 0);
  cp_async_commit();
  for (int k = 0; k < nh; ++k) {
    const int s = k & 1, h = h0 + k;
    if (k + 1 < nh) load_head(k + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();               // head k's tiles are in
    __syncthreads();
    {
      const float total = chunk_cumsum<QC>(s_dt + s * QC, A[h], s_cs);
      // w_j = dt_j exp(total - cs_j): step j's weight in the chunk state
#pragma unroll
      for (int j = lane; j < QC; j += 32)
        s_w[j] = s_dt[s * QC + j] * expf(total - s_cs[j]);
      if (warp == 0 && lane == 0)
        totals[((size_t)b * H + h) * nc + c] = total;
    }
    __syncwarp();
    // S_c^T rows p = 16 warp .. +15: A = x^T (p, j) from the (j, p) tile
    // (ldmatrix .trans), B = w_j B_j[n] split into high and low parts
    float acc[NT / 8][4];
#pragma unroll
    for (int u = 0; u < NT / 8; ++u)
      acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
    const bf16* xs = s_x + s * QC * kXS;
#pragma unroll
    for (int kb = 0; kb < QC / 16; ++kb) {
      uint32_t a[4];
      ldsm_x4_t(a, xs + (kb * 16 + (mi >> 1) * 8 + r8) * kXS + 16 * warp +
                       (mi & 1) * 8);
      const int j = kb * 16 + 2 * t;
      const float w0 = s_w[j], w1 = s_w[j + 1], w8 = s_w[j + 8],
                  w9 = s_w[j + 9];
#pragma unroll
      for (int u = 0; u < NT / 8; ++u) {
        const int n = u * 8 + g;
        uint32_t hi0, lo0, hi1, lo1;
        split(w0 * __bfloat162float(s_b[j * S::BS + n]),
              w1 * __bfloat162float(s_b[(j + 1) * S::BS + n]), hi0, lo0);
        split(w8 * __bfloat162float(s_b[(j + 8) * S::BS + n]),
              w9 * __bfloat162float(s_b[(j + 9) * S::BS + n]), hi1, lo1);
        mma(acc[u], a, hi0, hi1);
        mma(acc[u], a, lo0, lo1);
      }
    }
    float* st = states + (((size_t)b * H + h) * nc + c) * P * NT;
    const int p0 = 16 * warp + g;
#pragma unroll
    for (int u = 0; u < NT / 8; ++u) {
      const int n = u * 8 + 2 * t;
      if (p0 < P)
        *reinterpret_cast<float2*>(st + p0 * NT + n) =
            make_float2(acc[u][0], acc[u][1]);
      if (p0 + 8 < P)
        *reinterpret_cast<float2*>(st + (p0 + 8) * NT + n) =
            make_float2(acc[u][2], acc[u][3]);
    }
    __syncthreads();                  // stage s, s_w and s_cs are reused
  }
}

// ============================================= 3. chunk scan (bf16) ====
template <int NT, int QC, bool kInit>
struct ScanSmemBf16 {
  static constexpr int kWarps = QC / 16;   // one 16-row tile each
  static constexpr int BS = NT + 8;   // bf16 row stride of B and C
  static constexpr int SS = NT + 8;   // f32 row stride of S_in, S0, S_mid
  static constexpr size_t b = 0;                               // [QC][BS]
  static constexpr size_t c = b + sizeof(bf16) * QC * BS;      // [QC][BS]
  static constexpr size_t x = c + sizeof(bf16) * QC * BS;      // [2][QC][kXS]
  static constexpr size_t dt = x + sizeof(bf16) * 2 * QC * kXS;  // [2][QC]
  static constexpr size_t s = dt + sizeof(float) * 2 * QC;       // [2][kP][SS]
  static constexpr size_t s0 = s + sizeof(float) * 2 * kP * SS;  // [2][kP][SS]
  static constexpr size_t cs = s0 + (kInit ? sizeof(float) * 2 * kP * SS : 0);
  static constexpr size_t f = cs + sizeof(float) * kWarps * QC;  // [kWarps][QC]
  static constexpr size_t mid = f + sizeof(float) * kWarps * QC;  // [kP][SS]
  static constexpr size_t bytes = mid + (QC > kQ ? sizeof(float) * kP * SS : 0);
};

// Warp w computes the 16 rows 16 w .. 16 w + 15 of y.  At QC 64 (four
// warps) C . B^T, which no head changes, is computed once per block.  At
// QC 128 (eight warps) the chunk runs as two halves of 64 steps: the first
// half's state S_mid = exp(cs_63) S_in + sum_{j<64} exp(cs_63 - cs_j) dt_j
// x_j B_j^T is made in shared memory before either half, and the second
// half's carried share is exp(cs_i - cs_63) C_i . S_mid: the tensor work of
// 64-step chunks on the scratch of 128-step ones; C . B^T is recomputed
// with each head, a 16-column block at a time.  (On the card, four warps
// each taking tiles w and 7 - w, and eight warps splitting the head dim,
// were slower.)
template <int NT, int QC, bool kInit>
__global__ void __launch_bounds__(QC / 16 * 32)
chunk_scan_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bs,
                const bf16* __restrict__ Cs, const float* __restrict__ states,
                const float* __restrict__ cs0, const float* __restrict__ init,
                bf16* __restrict__ y, int L, int H, int P, int N, int nc,
                bool xvec, bool bvec, bool ivec) {
  using S = ScanSmemBf16<NT, QC, kInit>;
  constexpr int MT = QC / 16;
  constexpr bool kKeepG = MT == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_b = reinterpret_cast<bf16*>(smem + S::b);
  bf16* s_c = reinterpret_cast<bf16*>(smem + S::c);
  bf16* s_x = reinterpret_cast<bf16*>(smem + S::x);
  float* s_dt = reinterpret_cast<float*>(smem + S::dt);
  float* s_s = reinterpret_cast<float*>(smem + S::s);
  float* s_s0 = reinterpret_cast<float*>(smem + S::s0);
  float* s_mid = reinterpret_cast<float*>(smem + S::mid);
  const int c = blockIdx.x, h0 = blockIdx.y * kHeads, b = blockIdx.z;
  const int l0 = c * QC, nt = min(QC, L - l0), nh = min(kHeads, H - h0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int mt = warp, half = mt >> 2;        // row tile, its half
  const int i0 = 16 * mt + g, i1 = i0 + 8;    // this thread's two rows
  // each warp's own copies of the cumsum and the column factors: no barrier
  // between making and use
  float* s_cs = reinterpret_cast<float*>(smem + S::cs) + warp * QC;
  float* s_f = reinterpret_cast<float*>(smem + S::f) + warp * QC;
  const size_t row0 = (size_t)b * L + l0;

  auto load_head = [&](int k, int s) {
    const int h = h0 + k;
    load_tile(s_x + s * QC * kXS, kXS, x + (row0 * H + h) * P, (size_t)H * P,
              nt, P, QC, kP, xvec);
    load_dt<QC>(s_dt + s * QC, dt, row0, nt, H, h);
    const size_t bh = (size_t)b * H + h;
    load_tile(s_s + s * kP * S::SS, S::SS, states + (bh * nc + c) * P * NT,
              (size_t)NT, P, NT, kP, NT, true);
    if (kInit)
      load_tile(s_s0 + s * kP * S::SS, S::SS, init + bh * P * N, (size_t)N,
                P, N, kP, NT, ivec);
  };
  load_tile(s_b, S::BS, Bs + row0 * N, (size_t)N, nt, N, QC, NT, bvec);
  load_tile(s_c, S::BS, Cs + row0 * N, (size_t)N, nt, N, QC, NT, bvec);
  load_head(0, 0);
  cp_async_commit();

  uint32_t cf[NT / 16][4];      // this warp's rows of C: the A fragments
  float G[kKeepG ? QC / 8 : 1][4];   // QC 64: C . B^T of them, j-tiles of 8
  // C . B^T of this warp's rows and the 16 columns of j-block kb into g2
  auto cbt = [&](int kb, float (&g2)[2][4]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) g2[e][0] = g2[e][1] = g2[e][2] = g2[e][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT / 16; ++kk) {
      uint32_t bb[4];
      ldsm_x4(bb, s_b + (kb * 16 + (mi >> 1) * 8 + r8) * S::BS + kk * 16 +
                      (mi & 1) * 8);
      mma(g2[0], cf[kk], bb[0], bb[1]);
      mma(g2[1], cf[kk], bb[2], bb[3]);
    }
  };
  // C_i . S for this warp's rows, S (p, n) in f32 (pairs split into high
  // and low parts as the B fragments)
  auto state_share = [&](const float* sm, float (&z)[kP / 8][4]) {
#pragma unroll
    for (int u = 0; u < kP / 8; ++u) z[u][0] = z[u][1] = z[u][2] = z[u][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT / 16; ++kk) {
#pragma unroll
      for (int u = 0; u < kP / 8; ++u) {
        const float* sp = sm + (u * 8 + g) * S::SS + kk * 16 + 2 * t;
        const float2 v0 = *reinterpret_cast<const float2*>(sp);
        const float2 v1 = *reinterpret_cast<const float2*>(sp + 8);
        uint32_t hi0, lo0, hi1, lo1;
        split(v0.x, v0.y, hi0, lo0);
        split(v1.x, v1.y, hi1, lo1);
        mma(z[u], cf[kk], hi0, hi1);
        mma(z[u], cf[kk], lo0, lo1);
      }
    }
  };
  for (int k = 0; k < nh; ++k) {
    const int s = k & 1, h = h0 + k;
    if (k + 1 < nh) load_head(k + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (k == 0) {
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk)
        ldsm_x4(cf[kk], s_c + (16 * mt + (mi & 1) * 8 + r8) * S::BS +
                            kk * 16 + (mi >> 1) * 8);
      if constexpr (kKeepG) {
#pragma unroll
        for (int kb = 0; kb < MT; ++kb) {
          if (kb > mt) break;
          float g2[2][4];
          cbt(kb, g2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            G[2 * kb][e] = g2[0][e];
            G[2 * kb + 1][e] = g2[1][e];
          }
        }
      }
    }
    chunk_cumsum<QC>(s_dt + s * QC, A[h], s_cs);
    __syncwarp();
    // exp(cs_i - cs_j) = exp(cs_i - cs_m0) exp(cs_m0 - cs_k0) exp(cs_k0 -
    // cs_j), m0 and k0 the first steps of the 16-step blocks of i and j, all
    // three <= 1 for j <= i: f_j = dt_j exp(cs_k0 - cs_j) once per step
#pragma unroll
    for (int j = lane; j < QC; j += 32)
      s_f[j] = s_dt[s * QC + j] * expf(s_cs[j & ~15] - s_cs[j]);
    __syncwarp();
    const bf16* xs = s_x + s * QC * kXS;
    const float* ss = s_s + s * kP * S::SS;
    if constexpr (QC > kQ) {
      // S_mid: warp w its rows p = 16 (w % 4) .. +15 and n-tiles of half
      // w / 4: exp(cs_63) S_in + x^T (w' B) over the first half, w'_j =
      // exp(cs_63 - cs_k0) f_j, as in chunk_state
      constexpr int NTW = NT / 16;
      const float c63 = s_cs[kQ - 1], e63 = expf(c63);
      const int p0 = 16 * (warp & 3) + g, nb = (warp >> 2) * NTW;
      float m[NTW][4];
#pragma unroll
      for (int u = 0; u < NTW; ++u) {
        const int n = (nb + u) * 8 + 2 * t;
        const float2 a = *reinterpret_cast<const float2*>(ss + p0 * S::SS + n);
        const float2 a8 =
            *reinterpret_cast<const float2*>(ss + (p0 + 8) * S::SS + n);
        m[u][0] = e63 * a.x;
        m[u][1] = e63 * a.y;
        m[u][2] = e63 * a8.x;
        m[u][3] = e63 * a8.y;
      }
#pragma unroll
      for (int kb = 0; kb < kQ / 16; ++kb) {
        uint32_t a[4];
        ldsm_x4_t(a, xs + (kb * 16 + (mi >> 1) * 8 + r8) * kXS +
                         16 * (warp & 3) + (mi & 1) * 8);
        const int j = kb * 16 + 2 * t;
        const float e = expf(c63 - s_cs[16 * kb]);
        const float w0 = e * s_f[j], w1 = e * s_f[j + 1];
        const float w8 = e * s_f[j + 8], w9 = e * s_f[j + 9];
#pragma unroll
        for (int u = 0; u < NTW; ++u) {
          const int n = (nb + u) * 8 + g;
          uint32_t hi0, lo0, hi1, lo1;
          split(w0 * __bfloat162float(s_b[j * S::BS + n]),
                w1 * __bfloat162float(s_b[(j + 1) * S::BS + n]), hi0, lo0);
          split(w8 * __bfloat162float(s_b[(j + 8) * S::BS + n]),
                w9 * __bfloat162float(s_b[(j + 9) * S::BS + n]), hi1, lo1);
          mma(m[u], a, hi0, hi1);
          mma(m[u], a, lo0, lo1);
        }
      }
#pragma unroll
      for (int u = 0; u < NTW; ++u) {
        const int n = (nb + u) * 8 + 2 * t;
        *reinterpret_cast<float2*>(s_mid + p0 * S::SS + n) =
            make_float2(m[u][0], m[u][1]);
        *reinterpret_cast<float2*>(s_mid + (p0 + 8) * S::SS + n) =
            make_float2(m[u][2], m[u][3]);
      }
      __syncthreads();                // every warp reads all of S_mid
    }

    const float cs_i0 = s_cs[i0], cs_i1 = s_cs[i1];
    const float cm = s_cs[16 * mt];
    const float r0 = expf(cs_i0 - cm), r1 = expf(cs_i1 - cm);
    // ---- intra-half: y = W x, W_ij = (C_i . B_j) exp(cs_i - cs_j) dt_j on
    // j <= i within the half, split into high and low parts; x (j, p) by
    // ldmatrix .trans
    float acc[kP / 8][4];
#pragma unroll
    for (int u = 0; u < kP / 8; ++u)
      acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
#pragma unroll
    for (int kb = 0; kb < MT; ++kb) {
      if (kb > mt) break;
      if (kb < 4 * half) continue;
      float g2[2][4];
      if constexpr (kKeepG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          g2[0][e] = G[2 * kb][e];
          g2[1][e] = G[2 * kb + 1][e];
        }
      } else {
        cbt(kb, g2);
      }
      const float dm = kb == mt ? 1.f : expf(cm - s_cs[16 * kb]);
      const float a0 = r0 * dm, a1 = r1 * dm;
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = (2 * kb + q) * 8 + 2 * t;
        const float2 f = *reinterpret_cast<const float2*>(s_f + j);
        const float* gv = g2[q];
        const float w00 = j <= i0 ? gv[0] * a0 * f.x : 0.f;
        const float w01 = j + 1 <= i0 ? gv[1] * a0 * f.y : 0.f;
        const float w10 = j <= i1 ? gv[2] * a1 * f.x : 0.f;
        const float w11 = j + 1 <= i1 ? gv[3] * a1 * f.y : 0.f;
        split(w00, w01, ahi[2 * q], alo[2 * q]);
        split(w10, w11, ahi[2 * q + 1], alo[2 * q + 1]);
      }
#pragma unroll
      for (int pp = 0; pp < kP / 16; ++pp) {
        uint32_t bx[4];
        ldsm_x4_t(bx, xs + (kb * 16 + (mi & 1) * 8 + r8) * kXS + pp * 16 +
                          (mi >> 1) * 8);
        mma(acc[2 * pp], ahi, bx[0], bx[1]);
        mma(acc[2 * pp], alo, bx[0], bx[1]);
        mma(acc[2 * pp + 1], ahi, bx[2], bx[3]);
        mma(acc[2 * pp + 1], alo, bx[2], bx[3]);
      }
    }
    // ---- the carried state's share: exp(cs_i - cs_start) C_i . S_start,
    // S_in from the chunk's start or S_mid from step 63
    {
      const float cs_start = half ? s_cs[kQ - 1] : 0.f;
      float z[kP / 8][4];
      state_share(half ? s_mid : ss, z);
      const float e0 = expf(cs_i0 - cs_start), e1 = expf(cs_i1 - cs_start);
#pragma unroll
      for (int u = 0; u < kP / 8; ++u) {
        acc[u][0] += e0 * z[u][0];
        acc[u][1] += e0 * z[u][1];
        acc[u][2] += e1 * z[u][2];
        acc[u][3] += e1 * z[u][3];
      }
    }
    if constexpr (kInit) {
      // round, add S0's share exp(cs0_i) C_i . S0 in f32, round again
      float z[kP / 8][4];
      state_share(s_s0 + s * kP * S::SS, z);
      const float base = __ldg(cs0 + ((size_t)b * H + h) * nc + c);
      const float e0 = expf(base + cs_i0), e1 = expf(base + cs_i1);
#pragma unroll
      for (int u = 0; u < kP / 8; ++u) {
        acc[u][0] = round_bf16(acc[u][0]) + e0 * z[u][0];
        acc[u][1] = round_bf16(acc[u][1]) + e0 * z[u][1];
        acc[u][2] = round_bf16(acc[u][2]) + e1 * z[u][2];
        acc[u][3] = round_bf16(acc[u][3]) + e1 * z[u][3];
      }
    }
    // ---- y rows l0 + i0 and l0 + i1, columns u * 8 + 2t, +1 ----
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = rr ? i1 : i0;
      if (i < nt) {
        bf16* yr = y + ((row0 + i) * H + h) * P;
#pragma unroll
        for (int u = 0; u < kP / 8; ++u) {
          const int p = u * 8 + 2 * t;
          const float v0 = acc[u][2 * rr], v1 = acc[u][2 * rr + 1];
          if ((P & 1) == 0 && p + 1 < P) {
            *reinterpret_cast<__nv_bfloat162*>(yr + p) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (p < P) yr[p] = __float2bfloat16(v0);
            if (p + 1 < P) yr[p + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
    __syncthreads();                  // stage s and S_mid are reused
  }
}

// ============================================= 1. chunk states (f32) ====
template <int NT>
struct StateSmemF32 {
  static constexpr int XS = kP + 4, BS = NT + 4;
  static constexpr size_t x = 0;                              // [kQ][XS]
  static constexpr size_t b = x + sizeof(float) * kQ * XS;    // [kQ][BS]
  static constexpr size_t dt = b + sizeof(float) * kQ * BS;   // [kQ]
  static constexpr size_t cs = dt + sizeof(float) * kQ;       // [kQ]
  static constexpr size_t bytes = cs + sizeof(float) * kQ;
};

template <int NT>
__global__ void __launch_bounds__(kThreads)
chunk_state_f32(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bs,
                float* __restrict__ states, float* __restrict__ totals, int L,
                int H, int P, int N, int nc, bool xvec, bool bvec) {
  using S = StateSmemF32<NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_x = reinterpret_cast<float*>(smem + S::x);
  float* s_b = reinterpret_cast<float*>(smem + S::b);
  float* s_dt = reinterpret_cast<float*>(smem + S::dt);
  float* s_cs = reinterpret_cast<float*>(smem + S::cs);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int l0 = c * kQ, nt = min(kQ, L - l0);
  const size_t row0 = (size_t)b * L + l0;
  load_tile(s_x, S::XS, x + (row0 * H + h) * P, (size_t)H * P, nt, P, kQ, kP,
            xvec);
  load_tile(s_b, S::BS, Bs + row0 * N, (size_t)N, nt, N, kQ, NT, bvec);
  load_dt<kQ>(s_dt, dt, row0, nt, H, h);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float total = chunk_cumsum<kQ>(s_dt, A[h], s_cs);
    s_dt[lane] *= expf(total - s_cs[lane]);            // w_j
    s_dt[lane + 32] *= expf(total - s_cs[lane + 32]);
    if (lane == 0) totals[((size_t)b * H + h) * nc + c] = total;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kQ * kP; e += kThreads) {
    const int j = e / kP, p = e % kP;
    s_x[j * S::XS + p] *= s_dt[j];                     // w_j x_j
  }
  __syncthreads();
  // thread: row p = tid / 2 of S_c, columns (tid % 2) NT / 2 .. + NT / 2
  const int p = threadIdx.x >> 1, n0 = (threadIdx.x & 1) * (NT / 2);
  float acc[NT / 2];
#pragma unroll
  for (int u = 0; u < NT / 2; ++u) acc[u] = 0.f;
  for (int j = 0; j < kQ; ++j) {
    const float xv = s_x[j * S::XS + p];
#pragma unroll
    for (int u = 0; u < NT / 2; u += 4) {
      const float4 bv = *reinterpret_cast<const float4*>(s_b + j * S::BS + n0 + u);
      acc[u] = fmaf(xv, bv.x, acc[u]);
      acc[u + 1] = fmaf(xv, bv.y, acc[u + 1]);
      acc[u + 2] = fmaf(xv, bv.z, acc[u + 2]);
      acc[u + 3] = fmaf(xv, bv.w, acc[u + 3]);
    }
  }
  if (p < P) {
    float* st = states + ((((size_t)b * H + h) * nc + c) * P + p) * NT + n0;
#pragma unroll
    for (int u = 0; u < NT / 2; u += 4)
      *reinterpret_cast<float4*>(st + u) =
          make_float4(acc[u], acc[u + 1], acc[u + 2], acc[u + 3]);
  }
}

// ============================================== 3. chunk scan (f32) ====
template <int NT, bool kInit>
struct ScanSmemF32 {
  static constexpr int XS = kP + 4, BS = NT + 4, WS = kQ + 4;
  static constexpr size_t x = 0;                                 // [kQ][XS]
  static constexpr size_t b = x + sizeof(float) * kQ * XS;       // [kQ][BS]
  static constexpr size_t c = b + sizeof(float) * kQ * BS;       // [kQ][BS]
  static constexpr size_t s = c + sizeof(float) * kQ * BS;       // [kP][BS]
  static constexpr size_t s0 = s + sizeof(float) * kP * BS;      // [kP][BS]
  static constexpr size_t w = s0 + (kInit ? sizeof(float) * kP * BS : 0);
  static constexpr size_t dt = w + sizeof(float) * kQ * WS;      // [kQ]
  static constexpr size_t cs = dt + sizeof(float) * kQ;          // [kQ]
  static constexpr size_t bytes = cs + sizeof(float) * kQ;
};

template <int NT, bool kInit>
__global__ void __launch_bounds__(kThreads)
chunk_scan_f32(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bs,
               const float* __restrict__ Cs, const float* __restrict__ states,
               const float* __restrict__ cs0, const float* __restrict__ init,
               float* __restrict__ y, int L, int H, int P, int N, int nc,
               bool xvec, bool bvec, bool ivec) {
  using S = ScanSmemF32<NT, kInit>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_x = reinterpret_cast<float*>(smem + S::x);
  float* s_b = reinterpret_cast<float*>(smem + S::b);
  float* s_c = reinterpret_cast<float*>(smem + S::c);
  float* s_s = reinterpret_cast<float*>(smem + S::s);
  float* s_s0 = reinterpret_cast<float*>(smem + S::s0);
  float* s_w = reinterpret_cast<float*>(smem + S::w);
  float* s_dt = reinterpret_cast<float*>(smem + S::dt);
  float* s_cs = reinterpret_cast<float*>(smem + S::cs);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int l0 = c * kQ, nt = min(kQ, L - l0);
  const size_t row0 = (size_t)b * L + l0, bh = (size_t)b * H + h;
  load_tile(s_x, S::XS, x + (row0 * H + h) * P, (size_t)H * P, nt, P, kQ, kP,
            xvec);
  load_tile(s_b, S::BS, Bs + row0 * N, (size_t)N, nt, N, kQ, NT, bvec);
  load_tile(s_c, S::BS, Cs + row0 * N, (size_t)N, nt, N, kQ, NT, bvec);
  load_tile(s_s, S::BS, states + (bh * nc + c) * P * NT, (size_t)NT, P, NT,
            kP, NT, true);
  if (kInit)
    load_tile(s_s0, S::BS, init + bh * P * N, (size_t)N, P, N, kP, NT, ivec);
  load_dt<kQ>(s_dt, dt, row0, nt, H, h);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum<kQ>(s_dt, A[h], s_cs);
  __syncthreads();
  // W_ij = (C_i . B_j) exp(cs_i - cs_j) dt_j on j <= i (exp(cs_i - cs_j)
  // overflows above the diagonal, and no inf is ever multiplied by 0),
  // stored at (j, i)
  for (int e = threadIdx.x; e < kQ * kQ; e += kThreads) {
    const int i = e % kQ, j = e / kQ;
    float w = 0.f;
    if (j <= i) {
      float gij = 0.f;
      for (int n = 0; n < NT; ++n)
        gij = fmaf(s_c[i * S::BS + n], s_b[j * S::BS + n], gij);
      w = gij * expf(s_cs[i] - s_cs[j]) * s_dt[j];
    }
    s_w[j * S::WS + i] = w;
  }
  __syncthreads();
  // thread: rows 4 (tid / 8) .. +3, columns tid % 8 + 8 v (v < 8)
  const int ib = (threadIdx.x >> 3) * 4, pc = threadIdx.x & 7;
  float acc[4][8], z[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[a][v] = z[a][v] = 0.f;
  for (int j = 0; j < ib + 4; ++j) {
    const float4 w = *reinterpret_cast<const float4*>(s_w + j * S::WS + ib);
    const float wa[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const float xv = s_x[j * S::XS + pc + 8 * v];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][v] = fmaf(wa[a], xv, acc[a][v]);
    }
  }
  // C_i . S (and C_i . S0): z[a][v] over n, S rows p = pc + 8 v
  auto state_share = [&](const float* sm) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int v = 0; v < 8; ++v) z[a][v] = 0.f;
    for (int n = 0; n < NT; ++n) {
      float ca[4], sv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) ca[a] = s_c[(ib + a) * S::BS + n];
#pragma unroll
      for (int v = 0; v < 8; ++v) sv[v] = sm[(pc + 8 * v) * S::BS + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int v = 0; v < 8; ++v) z[a][v] = fmaf(ca[a], sv[v], z[a][v]);
    }
  };
  state_share(s_s);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float e = expf(s_cs[ib + a]);
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[a][v] += e * z[a][v];
  }
  if constexpr (kInit) {
    state_share(s_s0);
    const float base = __ldg(cs0 + bh * nc + c);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float e = expf(base + s_cs[ib + a]);
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[a][v] += e * z[a][v];
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (ib + a < nt) {
      float* yr = y + ((row0 + ib + a) * H + h) * P;
#pragma unroll
      for (int v = 0; v < 8; ++v)
        if (pc + 8 * v < P) yr[pc + 8 * v] = acc[a][v];
    }
  }
}

// ================================================== 2. state passing ====
// One block per (h, b); each thread carries four consecutive (p, n)
// elements over the chunks: S_c is replaced by S_in(c) in place.
template <bool kInit>
__global__ void __launch_bounds__(kPassThreads)
state_pass(float* __restrict__ states, const float* __restrict__ totals,
           float* __restrict__ cs0, const float* __restrict__ init,
           float* __restrict__ state, int H, int P, int N, int NT, int nc) {
  constexpr int kAhead = 8;           // chunks loaded before they are used
  const size_t bh = (size_t)blockIdx.y * H + blockIdx.x;
  const int E = P * NT;
  float* st = states + bh * nc * E;
  const float* tot = totals + bh * nc;
  for (int e = 4 * threadIdx.x; e < E; e += 4 * kPassThreads) {
    float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
    float run = 0.f;                  // cs0 at the start of chunk c
    for (int c0 = 0; c0 < nc; c0 += kAhead) {
      float4 v[kAhead];
      float d[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (c0 + u < nc) {
          v[u] = *reinterpret_cast<const float4*>(st + (size_t)(c0 + u) * E + e);
          d[u] = __ldg(tot + c0 + u);
        }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (c0 + u < nc) {
          *reinterpret_cast<float4*>(st + (size_t)(c0 + u) * E + e) = S;
          if (e == 0) cs0[bh * nc + c0 + u] = run;
          run += d[u];
          const float f = expf(d[u]);
          S = make_float4(fmaf(f, S.x, v[u].x), fmaf(f, S.y, v[u].y),
                          fmaf(f, S.z, v[u].z), fmaf(f, S.w, v[u].w));
        }
    }
    const int p = e / NT, n = e % NT;
    const float vals[4] = {S.x, S.y, S.z, S.w};
    const float decay = kInit ? expf(run) : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (n + q < N) {
        const size_t o = (bh * P + p) * N + n + q;
        state[o] = kInit ? vals[q] + decay * init[o] : vals[q];
      }
  }
}

// ============================================================ launch ====
bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int NT, bool kInit>
cudaError_t run(bool is_bf16, const void* x, const void* dt, const void* A,
                const void* Bs, const void* Cs, const void* init, void* y,
                void* state, void* scratch, int B, int L, int H, int P, int N,
                bool xvec, bool bvec, bool ivec, cudaStream_t st) {
  constexpr int QC = chunk_len(NT, true);
  const int q = chunk_len(NT, is_bf16);
  const int nc = (L + q - 1) / q;
  float* states = (float*)scratch;
  float* totals = states + (size_t)B * H * nc * P * NT;
  float* cs0 = totals + (size_t)B * H * nc;
  const float* fdt = (const float*)dt;
  const float* fA = (const float*)A;
  const float* fin = (const float*)init;
  const dim3 grid_bf16(nc, (H + kHeads - 1) / kHeads, B), grid_f32(nc, H, B);
  cudaError_t err;
  if (is_bf16) {
    const size_t s1 = StateSmemBf16<NT, QC>::bytes;
    if ((err = prepare(chunk_state_bf16<NT, QC>, s1)) != cudaSuccess)
      return err;
    chunk_state_bf16<NT, QC><<<grid_bf16, kThreads, s1, st>>>(
        (const bf16*)x, fdt, fA, (const bf16*)Bs, states, totals, L, H, P, N,
        nc, xvec, bvec);
  } else {
    const size_t s1 = StateSmemF32<NT>::bytes;
    if ((err = prepare(chunk_state_f32<NT>, s1)) != cudaSuccess) return err;
    chunk_state_f32<NT><<<grid_f32, kThreads, s1, st>>>(
        (const float*)x, fdt, fA, (const float*)Bs, states, totals, L, H, P,
        N, nc, xvec, bvec);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  state_pass<kInit><<<dim3(H, B), kPassThreads, 0, st>>>(
      states, totals, cs0, fin, (float*)state, H, P, N, NT, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (is_bf16) {
    const size_t s3 = ScanSmemBf16<NT, QC, kInit>::bytes;
    if ((err = prepare(chunk_scan_bf16<NT, QC, kInit>, s3)) != cudaSuccess)
      return err;
    chunk_scan_bf16<NT, QC, kInit><<<grid_bf16, QC / 16 * 32, s3, st>>>(
        (const bf16*)x, fdt, fA, (const bf16*)Bs, (const bf16*)Cs, states,
        cs0, fin, (bf16*)y, L, H, P, N, nc, xvec, bvec, ivec);
  } else {
    const size_t s3 = ScanSmemF32<NT, kInit>::bytes;
    if ((err = prepare(chunk_scan_f32<NT, kInit>, s3)) != cudaSuccess)
      return err;
    chunk_scan_f32<NT, kInit><<<grid_f32, kThreads, s3, st>>>(
        (const float*)x, fdt, fA, (const float*)Bs, (const float*)Cs, states,
        cs0, fin, (float*)y, L, H, P, N, nc, xvec, bvec, ivec);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ssd_scan_max_p() { return kP; }
int ssd_scan_max_n() { return kNMax; }
int ssd_scan_kernels_per_call() { return kKernelsPerCall; }

// Bytes of device scratch one call needs: the chunk states (B, H,
// n_chunks, P, NT), the chunk totals and the chunk starts of cs0, in f32.
long long ssd_scan_scratch_bytes(int B, int L, int H, int P, int N,
                                 int dtype) {
  const int NT = state_width(N), q = chunk_len(NT, dtype == 1);
  const long long nc = (L + q - 1) / q;
  return 4LL * B * H * nc * ((long long)P * NT + 2);
}

// x (B, L, H, P), B/C (B, L, N) and y (B, L, H, P) in f32 (dtype 0) or bf16
// (dtype 1); dt (B, L, H), A (H,), init (B, H, P, N) or null, and state
// (B, H, P, N) in f32; scratch of ssd_scan_scratch_bytes(...) bytes, 16-byte
// aligned; all contiguous on the device.  Launches on `stream` without
// synchronising; returns the first CUDA error (0 on success).
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bs, const void* Cs, const void* init, void* y,
                    void* state, void* scratch, int B, int L, int H, int P,
                    int N, int dtype, int device, void* stream) {
  if (B < 1 || L < 1 || H < 1 || P < 1 || P > kP || N < 1 || N > kNMax ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1) ||
      !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool is_bf16 = dtype == 1;
  const int E = is_bf16 ? 8 : 4;    // elements of a 16-byte copy
  const bool xvec = P % E == 0 && aligned16(x);
  const bool bvec = N % E == 0 && aligned16(Bs) && aligned16(Cs);
  const bool ivec = N % 4 == 0 && (init == nullptr || aligned16(init));
  cudaStream_t s = (cudaStream_t)stream;
  if (state_width(N) == 16)
    err = init ? run<16, true>(is_bf16, x, dt, A, Bs, Cs, init, y, state,
                               scratch, B, L, H, P, N, xvec, bvec, ivec, s)
               : run<16, false>(is_bf16, x, dt, A, Bs, Cs, init, y, state,
                                scratch, B, L, H, P, N, xvec, bvec, ivec, s);
  else
    err = init ? run<kNMax, true>(is_bf16, x, dt, A, Bs, Cs, init, y, state,
                                  scratch, B, L, H, P, N, xvec, bvec, ivec, s)
               : run<kNMax, false>(is_bf16, x, dt, A, Bs, Cs, init, y, state,
                                   scratch, B, L, H, P, N, xvec, bvec, ivec,
                                   s);
  return (int)err;
}

}  // extern "C"
