// Fused MoE router for Hopper (sm_90a): logits -> top-k -> softmax over the k.
//
// Replaces repro/kernels/moe_router.py::moe_router (the Pallas kernel
// _router_kernel).  For every token t of x (T, d) and router weight W (d, E):
//   logits[t] = x[t] W                       (f32)
//   k passes: take the row maximum and its index (the lowest index among
//             equal maxima, as jnp.argmax and lax.top_k give it), then set
//             that entry to -1e30
//   weights[t] = softmax of the k maxima;  idx[t] = their expert indices.
//
// Bound on the H100.  At the Jamba serve prefill (T 8,192, d 4,096, E 16,
// k 2, bf16 x, f32 W) the work is 2 T d E ~ 1.1 GFLOP and the bytes are
// x (67 MB) plus W (256 KB) plus the outputs (131 KB): ~20 us at 3.35 TB/s
// against ~16 us for the FLOP at the 67 TFLOP/s f32 peak, so bytes bound
// it.  A decode step (T 4) reads W's 256 KB and a few KB of x: ~80 ns at
// 3.35 TB/s, so the launches and one round trip to memory bound it.
//
// Design: three routes, chosen by moe_router_path from (T, d, E, dtype).
//  split (decode; T up to a crossover measured by tools/router_routes.py,
//    384 against mma, 1,536 against tiled): d is split over S ~ 128
//    blocks so that every SM takes a share of W.  moe_router_partial:
//    block (s, group of 8 tokens) starts
//    its W loads, stages its x slice (f32) in shared memory, and thread (j,
//    e) sums rows j, j + J, ... of the slice (J = 256 / E); the J sums go
//    through shared memory in the order j = 0, 1, ... into an f32 scratch
//    (S, T, E).  moe_router_topk: one block a token; thread (j, e) adds the
//    partials s of its run [j c, (j + 1) c) in order (c = ceil(S / J)),
//    the runs are added in the order j = 0, 1, ..., and one warp runs the
//    top-k.  The second kernel is a programmatic dependent launch: it
//    starts while the first runs and waits for its partials.  Two kernels a
//    call, no atomics: the same bits on every run and every graph replay.
//  mma (prefill; bf16 x, d % 8 == 0, 16-byte aligned rows, E <= 128): the
//    tensor cores.  moe_router_split_w writes W as three bf16 matrices whose
//    sum is W exactly (hi = bf16(W), mid = bf16(W - hi), lo = bf16(W - hi -
//    mid): 8 + 8 + 8 significant bits cover f32's 24), laid out tile by
//    tile as the kernel's ring holds them, so x (bf16) . W is three
//    exact-product mma.sync m16n8k16 with f32 sums.  moe_router_mma computes
//    logits^T = W^T x^T: one block of 8 warps takes 64 tokens and every
//    expert; a warp's A operand is 16 experts of W's parts, its B operand
//    the 64 tokens, and the 8 / MG warps that share an expert tile split the
//    k steps of each d tile, so no warp loads a fragment another loads.  The
//    copy engine fills a 3-8-stage ring: x by a 2-D tensor map (64 x 64
//    boxes, 128-byte swizzle, zeros past T and d), W's parts by one bulk
//    copy a tile, both counted on an mbarrier.  Per tile a warp's products
//    go into zeroed fragments, then one IEEE add into the running logits
//    (the tensor cores' truncating sums span one tile, not all of d); the k
//    parts are added in order at the end.  Two kernels a call.  (A ring
//    filled by cp.async was slower: a block's 16-byte copies kept too few
//    bytes in flight.)
//  tiled (f32 x, and every call the mma route refuses): SIMT register
//    tiles.  One block of 256 threads takes 64 tokens and every expert; x
//    tiles (stored d-major, f32) and W tiles go through two shared-memory
//    buffers (x by registers, W by cp.async), and thread (ty, tx) owns
//    tokens 4 ty .. 4 ty + 3 times experts tx, tx + 16, ...: one FMA chain
//    over d = 0, 1, ... for each logit.  One kernel a call.
// Every route sums each expert's logit in the same order as every other
// expert's, so identical W columns give identical logits and the top-k
// takes the lower index.  The top-k (shared by all three routes) keeps the
// row in a warp's registers; each pass takes every lane's first maximum and
// a (value, index) shuffle reduction whose ties go to the lower index.
// E <= 256 experts, any k <= E, any d; accurate expf (no fast-math).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxE = 256;
constexpr float kNegInf = -1e30f;       // a taken expert, as the reference
// routes: the values moe_router_path returns
constexpr int kSplit = 0, kTiled = 1, kMma = 2;
// split: the largest T it takes where the mma route takes the rest, and
// where the tiled route does (measured crossovers on the H100), blocks over
// d, tokens a partial block, the most d rows one block owns
constexpr int kSplitMaxTMma = 384;
constexpr int kSplitMaxTTiled = 1536;
constexpr int kSplitBlocks = 128;
constexpr int kSplitTokens = 8;
constexpr int kSplitMaxRows = 512;
// tiled and mma: tokens a block
constexpr int kTM = 64;
constexpr int kTiledXS = kTM + 4;       // f32 stride of a d-major x tile row
constexpr int kMmaThreads = 256;
constexpr int kMmaMaxE = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__host__ __device__ inline int split_rows(int d) {
  int r = (d + kSplitBlocks - 1) / kSplitBlocks;
  r = (r + 31) / 32 * 32;
  return r < kSplitMaxRows ? r : kSplitMaxRows;
}
__host__ __device__ inline int split_blocks(int d) {
  const int r = split_rows(d);
  return (d + r - 1) / r;
}
// experts padded: to 16 a thread column (tiled), to whole pairs of 8-wide
// tensor-core tiles (mma)
inline int tiled_ept(int E) {
  return E <= 16 ? 1 : E <= 32 ? 2 : E <= 64 ? 4 : E <= 128 ? 8 : 16;
}
inline int mma_ep(int E) {
  return E <= 16 ? 16 : E <= 32 ? 32 : E <= 64 ? 64 : 128;
}

// ------------------------------------------------------------ helpers --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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
// l / 8 and gets (row l / 4, columns 2 (l % 4), +1) of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// d (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col).  With g = lane
// / 4 and t = lane % 4: a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}, b = {(2t.., g), (2t + 8.., g)}, d = {(g, 2t), (g,
// 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The top-k of one token's E logits (row, in shared memory) by the calling
// warp: weights[0..k) and idx[0..k) of the token.  Lane l holds experts l,
// l + 32, ...; a pass takes each lane's first maximum (strict > upwards),
// then the warp's by shuffles, ties to the lower index; the winner becomes
// -1e30.  Value kk stays in lane kk % 32; the softmax is exp(v - max) over
// the sum, each lane's share summed upwards and the lanes by xor shuffles.
__device__ __forceinline__ void warp_topk(const float* row, int E, int k,
                                          float* __restrict__ weights,
                                          int* __restrict__ idx) {
  constexpr int kPer = kMaxE / 32;
  const int lane = threadIdx.x & 31;
  float v[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = lane + 32 * q;
    v[q] = e < E ? row[e] : -INFINITY;
  }
  float mine[kPer], m = 0.f;           // this lane's taken values, the max
  for (int kk = 0; kk < k; ++kk) {
    float best = v[0];
    int arg = lane;
#pragma unroll
    for (int q = 1; q < kPer; ++q)
      if (v[q] > best) {
        best = v[q];
        arg = lane + 32 * q;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
      if (ob > best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (lane + 32 * q == arg) v[q] = kNegInf;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (lane + 32 * q == kk) mine[q] = best;
    if (lane == 0) idx[kk] = arg;
    if (kk == 0) m = best;
  }
  // softmax over the k values: lane l holds values l, l + 32, ...
  float sum = 0.f;
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    if (lane + 32 * q < k) {
      mine[q] = expf(mine[q] - m);
      sum += mine[q];
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    if (lane + 32 * q < k) weights[lane + 32 * q] = mine[q] / sum;
}

// ------------------------------------------------------- split route --
// Block (s, y): rows [s rows, (s + 1) rows) of W and tokens [8 y, 8 y + 8)
// -> part[s][t][e], the partial logits of the slice.
template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_router_partial(const T* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ part, int T_, int d, int E,
                   int rows) {
  __shared__ float s_x[kSplitTokens][kSplitMaxRows];
  __shared__ float s_part[kSplitTokens][kThreads];    // [token][j * E + e]
  const int tid = threadIdx.x, s = blockIdx.x;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int t0 = blockIdx.y * kSplitTokens;
  const int nt = min(kSplitTokens, T_ - t0);
  const int d0 = s * rows, nd = min(rows, d - d0);
  const int J = kThreads / E, e = tid % E, j = tid / E;
  const bool active = j < J;
  constexpr int kU = 8;                 // W rows a thread has in flight
  float wv[kU];
  auto load_w = [&](int base) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int dd = base + u * J;
      wv[u] = (active && dd < nd) ? __ldg(w + (size_t)(d0 + dd) * E + e)
                                  : 0.f;
    }
  };
  load_w(j);                            // started before x is staged
  for (int i = tid; i < kSplitTokens * rows; i += kThreads) {
    const int r = i / rows, c = i % rows;
    s_x[r][c] = (r < nt && c < nd)
                    ? to_f32(x[(size_t)(t0 + r) * d + d0 + c]) : 0.f;
  }
  __syncthreads();
  float acc[kSplitTokens];
#pragma unroll
  for (int r = 0; r < kSplitTokens; ++r) acc[r] = 0.f;
  for (int base = j; active && base < nd; base += kU * J) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int dd = base + u * J;
      if (dd < nd) {
#pragma unroll
        for (int r = 0; r < kSplitTokens; ++r)
          acc[r] = fmaf(s_x[r][dd], wv[u], acc[r]);
      }
    }
    if (base + kU * J < nd) load_w(base + kU * J);
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < kSplitTokens; ++r) s_part[r][tid] = acc[r];
  }
  __syncthreads();
  for (int i = tid; i < nt * E; i += kThreads) {
    const int r = i / E, ee = i % E;
    float sum = 0.f;
    for (int jj = 0; jj < J; ++jj) sum += s_part[r][jj * E + ee];
    part[((size_t)s * T_ + t0 + r) * E + ee] = sum;
  }
}

// Block t: the S partials of token t summed in a fixed order, then the top-k.
// Launched as a programmatic dependent of moe_router_partial: it may start
// while the partials are made, and waits for them before reading any.
__global__ void __launch_bounds__(kThreads)
moe_router_topk(const float* __restrict__ part, float* __restrict__ weights,
                int* __restrict__ idx, int T_, int E, int k, int S) {
  __shared__ float s_part[kThreads];
  __shared__ float s_logit[kMaxE];
  const int t = blockIdx.x, tid = threadIdx.x;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int J = kThreads / E, e = tid % E, j = tid / E;
  if (j < J) {
    const int c = (S + J - 1) / J;
    const int s0 = min(S, j * c), s1 = min(S, s0 + c);
    const float* p = part + (size_t)t * E + e;
    const size_t step = (size_t)T_ * E;
    float sum = 0.f;
    for (int s = s0; s < s1; s += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = s + u < s1 ? p[(s + u) * step] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s + u < s1) sum += v[u];
    }
    s_part[tid] = sum;
  }
  __syncthreads();
  if (tid < E) {
    float v = 0.f;
    for (int jj = 0; jj < J; ++jj) v += s_part[jj * E + tid];
    s_logit[tid] = v;
  }
  __syncthreads();
  if (tid < 32)
    warp_topk(s_logit, E, k, weights + (size_t)t * k, idx + (size_t)t * k);
}

// ------------------------------------------------------- tiled route --
// TK: d a tile, 128 where W's tiles are small (more x loads in flight)
template <int EPT>
struct TiledSmem {
  static constexpr int EP = 16 * EPT;
  static constexpr int TK = EPT <= 4 ? 128 : EPT == 8 ? 64 : 32;
  static constexpr int X = 2 * TK * kTiledXS;       // floats of the x buffers
  static constexpr int W = 2 * TK * EP;
  static constexpr size_t BYTES = 4 * (size_t)(X + W);
  static_assert(X + W >= kTM * (EP + 1), "logits fit the tile buffers");
};

template <typename T, int EPT>
__global__ void __launch_bounds__(kThreads)
moe_router_tiled(const T* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ weights, int* __restrict__ idx, int T_,
                 int d, int E, int k) {
  using S = TiledSmem<EPT>;
  constexpr int TK = S::TK, NX = kTM * TK / kThreads;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* xs = smem;                     // [2][TK][kTiledXS], d-major
  float* ws = smem + S::X;              // [2][TK][EP]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * kTM, nt = min(kTM, T_ - t0);
  const int nk = (d + TK - 1) / TK;
  // x element u of this thread: warp-group g = warp + 8 u of 32 elements, d
  // column c(u) and token row r(u); a warp reads 4 rows x 8 consecutive d,
  // and its d-major stores hit 32 banks
  auto col = [&](int u) {
    return (lane & 7) + 8 * ((warp + 8 * u) % (TK / 8));
  };
  auto row = [&](int u) {
    return (lane >> 3) + 4 * ((warp + 8 * u) / (TK / 8));
  };
  float xr[NX];
  auto load_x = [&](int kt) {
#pragma unroll
    for (int u = 0; u < NX; ++u) {
      const int r = row(u), dc = kt * TK + col(u);
      xr[u] = (r < nt && dc < d) ? to_f32(x[(size_t)(t0 + r) * d + dc]) : 0.f;
    }
  };
  auto store_x = [&](int buf) {
    float* dst = xs + buf * TK * kTiledXS;
#pragma unroll
    for (int u = 0; u < NX; ++u) dst[col(u) * kTiledXS + row(u)] = xr[u];
  };
  auto load_w = [&](int kt, int buf) {
    float* dst = ws + buf * TK * S::EP;
    const int d0 = kt * TK;
    for (int i = tid; i < TK * S::EP; i += kThreads) {
      const int cc = i / S::EP, e = i % S::EP;
      const bool ok = d0 + cc < d && e < E;
      cp_async4(dst + i, ok ? w + (size_t)(d0 + cc) * E + e : w, ok);
    }
  };
  float acc[4][EPT];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < EPT; ++i) acc[q][i] = 0.f;

  load_x(0);
  load_w(0, 0);
  cp_async_commit();
  store_x(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_x(kt + 1);
      load_w(kt + 1, buf ^ 1);
    }
    cp_async_commit();
    const float* xb = xs + buf * TK * kTiledXS + 4 * ty;
    const float* wb = ws + buf * TK * S::EP + tx;
#pragma unroll 8
    for (int cc = 0; cc < TK; ++cc) {
      const float4 xv = *reinterpret_cast<const float4*>(xb + cc * kTiledXS);
      float wr[EPT];
#pragma unroll
      for (int i = 0; i < EPT; ++i) wr[i] = wb[cc * S::EP + 16 * i];
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        acc[0][i] = fmaf(xv.x, wr[i], acc[0][i]);
        acc[1][i] = fmaf(xv.y, wr[i], acc[1][i]);
        acc[2][i] = fmaf(xv.z, wr[i], acc[2][i]);
        acc[3][i] = fmaf(xv.w, wr[i], acc[3][i]);
      }
    }
    if (kt + 1 < nk) store_x(buf ^ 1);
    cp_async_wait<0>();
    __syncthreads();
  }
  // logits [kTM][EP + 1] over the tile buffers, then a warp a token
  float* lg = smem;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < EPT; ++i)
      lg[(4 * ty + q) * (S::EP + 1) + tx + 16 * i] = acc[q][i];
  __syncthreads();
  for (int r = warp; r < nt; r += kThreads / 32)
    warp_topk(lg + r * (S::EP + 1), E, k, weights + (size_t)(t0 + r) * k,
              idx + (size_t)(t0 + r) * k);
}

// --------------------------------------------------------- mma route --
// Transposed: logits^T = W^T x^T, so a warp's A operand is 16 experts of
// W's three parts and its B operand the block's 64 tokens of x.  MG warps
// split the experts (16 each), KP = 8 / MG warps the k steps of a tile; no
// warp loads a fragment another one loads.
template <int MG>
struct MmaGeom {
  static constexpr int EP = 16 * MG;
  static constexpr int KP = 8 / MG;
  static constexpr int KB = KP >= 4 ? 1 : 4 / KP;   // k16 steps a warp, a tile
  static constexpr int TK = 16 * KP * KB;            // d a tile
  static constexpr int XS = TK + 8;                  // bf16 row stride (the
                                                     // ldmatrix rows of 16 B
                                                     // land in distinct banks)
  static constexpr int NQ = kTM / 16;                // token-tile pairs
  static constexpr int W = 3 * EP * XS;              // bf16 of a W stage
};
// The copy engine fills the ring: x by a 2-D tensor map (boxes of 64 tokens
// x 64 d, 128-byte swizzle, rows past T and columns past d filled with
// zeros), W's three parts by one bulk copy a tile from a scratch that holds
// them tile by tile as the ring does.
template <int MG, int NST>
struct MmaSmem : MmaGeom<MG> {
  using G = MmaGeom<MG>;
  static constexpr int XB = 2 * kTM * G::TK;        // bytes of an x stage
  static constexpr int WB = 2 * G::W;               // bytes of a W stage
  static constexpr int STAGE = (XB + WB + 1023) / 1024 * 1024;
  static constexpr size_t RING = (size_t)NST * STAGE;
  static constexpr size_t BYTES = 1024 + 1024 + RING;   // alignment, barriers
  static_assert(RING >= 4 * (size_t)G::KP * kTM * (G::EP + 1),
                "the k parts' logits fit the ring");
};

// w3[((kt 3 + p) EP + n) XS + c] = part p of W[kt TK + c][n] (zero for n >=
// E, kt TK + c >= d and in the row padding c >= TK); a thread a pair.
template <int MG>
__global__ void __launch_bounds__(kThreads)
moe_router_split_w(const float* __restrict__ w, bf16* __restrict__ w3, int d,
                   int E) {
  using G = MmaGeom<MG>;
  constexpr int per_tile = G::EP * (G::XS / 2);
  const int nk = (d + G::TK - 1) / G::TK;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nk * per_tile) return;
  const int kt = i / per_tile, rem = i % per_tile;
  const int n = rem / (G::XS / 2), cc = 2 * (rem % (G::XS / 2));
  const int c = kt * G::TK + cc;
  float a = 0.f, b = 0.f;
  if (n < E && cc < G::TK && c < d) {   // d is even: c + 1 < d too
    a = __ldg(w + (size_t)c * E + n);
    b = __ldg(w + (size_t)(c + 1) * E + n);
  }
  bf16* dst = w3 + ((size_t)kt * 3 * G::EP + n) * G::XS + cc;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    *reinterpret_cast<__nv_bfloat162*>(dst + p * G::EP * G::XS) = h;
    a -= hf.x;                          // exact: the rest of a
    b -= hf.y;
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

template <int MG, int NST>
__global__ void __launch_bounds__(kMmaThreads)
moe_router_mma(const __grid_constant__ CUtensorMap xmap,
               const bf16* __restrict__ w3, float* __restrict__ weights,
               int* __restrict__ idx, int T_, int d, int E, int k) {
  using S = MmaSmem<MG, NST>;
  constexpr int EP = S::EP, KP = S::KP, KB = S::KB, TK = S::TK, XS = S::XS;
  constexpr int TM = kTM, NQ = S::NQ;
  extern __shared__ float4 smem_f4[];
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_f4) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  char* ring = base + 1024;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mg = warp % MG, kp = warp / MG;   // expert tile, k part
  const int t0 = blockIdx.x * TM, nt = min(TM, T_ - t0);
  const int nk = (d + TK - 1) / TK;
  auto xs = [&](int slot) {             // [TK / 64][TM][64], swizzled
    return reinterpret_cast<bf16*>(ring + slot * S::STAGE);
  };
  auto ws = [&](int slot) {
    return reinterpret_cast<bf16*>(ring + slot * S::STAGE + S::XB);
  };
  auto fetch = [&](int kt) {            // by thread 0
    const int slot = kt % NST;
    mbar_expect_tx(&full[slot], S::XB + S::WB);
#pragma unroll
    for (int h = 0; h < TK / 64; ++h)
      tma_load_2d(xs(slot) + h * TM * 64, &xmap, kt * TK + 64 * h, t0,
                  &full[slot]);
    bulk_load(ws(slot), w3 + (size_t)kt * S::W, S::WB, &full[slot]);
  };
  if (tid == 0) {
    for (int st = 0; st < NST; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kt = 0; kt < NST && kt < nk; ++kt) fetch(kt);
  }
  __syncthreads();
  float tot[2 * NQ][4];                 // token tiles of 8
#pragma unroll
  for (int u = 0; u < 2 * NQ; ++u)
    tot[u][0] = tot[u][1] = tot[u][2] = tot[u][3] = 0.f;
  // ldmatrix: A (expert, k) rows 16 mg + lane % 16, columns 8 (lane / 16)
  // of the padded W tile; B (token, k) rows lane % 8 + 8 (lane / 16) of a
  // token-tile pair, 16-byte chunk (lane / 8) % 2 of the k step, in the
  // 64-wide swizzled boxes (chunk c of row r sits at c ^ (r % 8))
  const int a_off = (16 * mg + (lane & 15)) * XS + (lane >> 4) * 8 +
                    16 * KB * kp;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_chunk = (lane >> 3) & 1;
  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % NST;
    mbar_wait(&full[slot], (kt / NST) & 1);
    const bf16* wa = ws(slot) + a_off;
    const bf16* xb = xs(slot);
    float c[2 * NQ][4];
#pragma unroll
    for (int u = 0; u < 2 * NQ; ++u)
      c[u][0] = c[u][1] = c[u][2] = c[u][3] = 0.f;
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int kc = 2 * (KB * kp + j) + b_chunk;      // 16-byte chunk of k
      const bf16* box = xb + (kc >> 3) * TM * 64;
      uint32_t a[3][4], b[NQ][4];
#pragma unroll
      for (int p = 0; p < 3; ++p) ldsm_x4(a[p], wa + p * EP * XS + 16 * j);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int r = 16 * q + b_row;
        ldsm_x4(b[q], box + r * 64 + (((kc & 7) ^ (r & 7)) << 3));
      }
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          mma(c[2 * q], a[p], b[q][0], b[q][1]);
          mma(c[2 * q + 1], a[p], b[q][2], b[q][3]);
        }
    }
#pragma unroll
    for (int u = 0; u < 2 * NQ; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[u][i] += c[u][i];
    __syncthreads();                    // every warp is done with the slot
    if (tid == 0 && kt + NST < nk) fetch(kt + NST);
  }
  // part kp at lg[kp][token][expert], then part 0 += 1, 2, ...
  float* lg = reinterpret_cast<float*>(ring);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < 2 * NQ; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      lg[(kp * TM + 8 * u + 2 * t + (i & 1)) * (EP + 1) + 16 * mg + g +
         8 * (i >> 1)] = tot[u][i];
  __syncthreads();
  if (KP > 1) {
    for (int i = tid; i < TM * EP; i += kMmaThreads) {
      float* at = lg + (i / EP) * (EP + 1) + i % EP;
      float v = at[0];
#pragma unroll
      for (int h = 1; h < KP; ++h) v += at[h * TM * (EP + 1)];
      at[0] = v;
    }
    __syncthreads();
  }
  for (int r = warp; r < nt; r += kMmaThreads / 32)
    warp_topk(lg + r * (EP + 1), E, k, weights + (size_t)(t0 + r) * k,
              idx + (size_t)(t0 + r) * k);
}

// ---------------------------------------------------------- launches --
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
cudaError_t run_split(const T* x, const float* w, float* weights, int* idx,
                      float* part, int T_, int d, int E, int k,
                      cudaStream_t s) {
  const int rows = split_rows(d), S = split_blocks(d);
  const dim3 grid(S, (T_ + kSplitTokens - 1) / kSplitTokens);
  moe_router_partial<T><<<grid, kThreads, 0, s>>>(x, w, part, T_, d, E, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(T_);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, moe_router_topk, (const float*)part,
                            weights, idx, T_, E, k, S);
}

template <typename T, int EPT>
cudaError_t run_tiled_ept(const T* x, const float* w, float* weights,
                          int* idx, int T_, int d, int E, int k,
                          cudaStream_t s) {
  const size_t smem = TiledSmem<EPT>::BYTES;
  cudaError_t err = prepare(moe_router_tiled<T, EPT>, smem);
  if (err != cudaSuccess) return err;
  moe_router_tiled<T, EPT><<<(T_ + kTM - 1) / kTM, kThreads, smem, s>>>(
      x, w, weights, idx, T_, d, E, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_tiled(const T* x, const float* w, float* weights, int* idx,
                      int T_, int d, int E, int k, cudaStream_t s) {
  switch (tiled_ept(E)) {
    case 1: return run_tiled_ept<T, 1>(x, w, weights, idx, T_, d, E, k, s);
    case 2: return run_tiled_ept<T, 2>(x, w, weights, idx, T_, d, E, k, s);
    case 4: return run_tiled_ept<T, 4>(x, w, weights, idx, T_, d, E, k, s);
    case 8: return run_tiled_ept<T, 8>(x, w, weights, idx, T_, d, E, k, s);
    default: return run_tiled_ept<T, 16>(x, w, weights, idx, T_, d, E, k, s);
  }
}

// cuTensorMapEncodeTiled, found once through the runtime's entry-point
// query, so the library needs no link flag beyond the runtime's
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int MG, int NST>
cudaError_t run_mma_mg(const bf16* x, const float* w, float* weights,
                       int* idx, bf16* w3, int T_, int d, int E, int k,
                       cudaStream_t s) {
  using S = MmaSmem<MG, NST>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)T_};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {64, kTM}, estr[2] = {1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<bf16*>(x), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare(moe_router_mma<MG, NST>, S::BYTES);
  if (err != cudaSuccess) return err;
  const int nk = (d + S::TK - 1) / S::TK;
  const int pairs = nk * S::EP * (S::XS / 2);
  moe_router_split_w<MG><<<(pairs + kThreads - 1) / kThreads, kThreads, 0,
                           s>>>(w, w3, d, E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_router_mma<MG, NST><<<(T_ + kTM - 1) / kTM, kMmaThreads, S::BYTES, s>>>(
      xmap, w3, weights, idx, T_, d, E, k);
  return cudaGetLastError();
}

cudaError_t run_mma(const bf16* x, const float* w, float* weights, int* idx,
                    bf16* w3, int T_, int d, int E, int k, cudaStream_t s) {
  switch (mma_ep(E)) {
    case 16: return run_mma_mg<1, 6>(x, w, weights, idx, w3, T_, d, E, k, s);
    case 32: return run_mma_mg<2, 8>(x, w, weights, idx, w3, T_, d, E, k, s);
    case 64: return run_mma_mg<4, 5>(x, w, weights, idx, w3, T_, d, E, k, s);
    default: return run_mma_mg<8, 3>(x, w, weights, idx, w3, T_, d, E, k, s);
  }
}

inline int mma_tk(int E) { return E <= 16 ? 128 : 64; }
static_assert(MmaGeom<1>::TK == 128 && MmaGeom<2>::TK == 64 &&
                  MmaGeom<4>::TK == 64 && MmaGeom<8>::TK == 64,
              "mma_tk is the kernel's tile");

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

int moe_router_max_e() { return kMaxE; }

// The route of a call: mma (2) takes bf16 x (dtype 1) with d % 8 == 0,
// 16-byte aligned rows (x_aligned) and E <= 128, tiled (1) every other
// call; split (0) takes T up to its crossover with the one that would.
int moe_router_path(int T, int d, int E, int dtype, int x_aligned) {
  const bool mma = dtype == 1 && d % 8 == 0 && x_aligned && E <= kMmaMaxE;
  if (T <= (mma ? kSplitMaxTMma : kSplitMaxTTiled)) return kSplit;
  return mma ? kMma : kTiled;
}

// CUDA kernels one call on route `path` launches.
int moe_router_kernels(int path) { return path == kTiled ? 1 : 2; }

// Bytes of device scratch a call on route `path` needs: the f32 partial
// logits (S, T, E) of split; W's three bf16 parts of mma, in whole tiles of
// (3, E_pad, TK + 8).
long long moe_router_scratch_bytes(int T, int d, int E, int path) {
  if (path == kSplit) return 4LL * split_blocks(d) * T * E;
  if (path == kMma)
    return 2LL * 3 * mma_ep(E) * (mma_tk(E) + 8) *
           ((d + mma_tk(E) - 1) / mma_tk(E));
  return 0;
}

// x (T, d) f32 (dtype 0) or bf16 (dtype 1), w (d, E) f32, weights (T, k)
// f32, idx (T, k) int32, scratch of moe_router_scratch_bytes(...) bytes
// (16-byte aligned); all contiguous on the device.  `path` is a route that
// takes the call (moe_router_path's, or split or tiled for any call, or mma
// where its conditions hold).  Launches on `stream` without synchronising;
// returns the first CUDA error (0 on success).
int moe_router_launch(const void* x, const void* w, void* weights, void* idx,
                      void* scratch, int T, int d, int E, int k, int dtype,
                      int path, int device, void* stream) {
  if (T < 1 || d < 1 || E < 1 || E > kMaxE || k < 1 || k > E ||
      (dtype != 0 && dtype != 1) || path < kSplit || path > kMma ||
      (path != kTiled && !aligned16(scratch)) ||
      (path == kSplit && (long long)T > 65535LL * kSplitTokens) ||
      (path == kMma && (dtype != 1 || d % 8 != 0 || !aligned16(x) ||
                        E > kMmaMaxE)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const float* wf = (const float*)w;
  float* wo = (float*)weights;
  int* io = (int*)idx;
  if (path == kSplit)
    err = dtype == 0
              ? run_split((const float*)x, wf, wo, io, (float*)scratch, T, d,
                          E, k, s)
              : run_split((const bf16*)x, wf, wo, io, (float*)scratch, T, d,
                          E, k, s);
  else if (path == kTiled)
    err = dtype == 0 ? run_tiled((const float*)x, wf, wo, io, T, d, E, k, s)
                     : run_tiled((const bf16*)x, wf, wo, io, T, d, E, k, s);
  else
    err = run_mma((const bf16*)x, wf, wo, io, (bf16*)scratch, T, d, E, k, s);
  return (int)err;
}

}  // extern "C"
