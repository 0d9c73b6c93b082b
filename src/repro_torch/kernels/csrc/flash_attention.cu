// Blockwise online-softmax attention (causal and/or sliding window, GQA) for
// Hopper (sm_90a): bf16 on the tensor cores (wgmma), f32 on IEEE FMAs.
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
// accumulator are f32; the output is written in the input's dtype.  GQA
// reads each query head's KV head in place (KV is never repeated in
// memory), and neither D nor L is padded in device memory.
//
// Bound on the H100.  At the Jamba serve shape (B 4, H 32, KV 8, L 2,048,
// D 128, causal, bf16) the work is 4 * B * H * D * L(L+1)/2 FLOP ~ 1.4e11,
// ~139 us at the 989 TFLOP/s bf16 tensor-core peak, against 2 * B * L * D *
// (2H + 2KV) bytes ~ 168 MB of q, k, v and o (~50 us at 3.35 TB/s): the
// operations bound it.
//
// bf16 (flash_attention_bf16_kernel<DP>): one block of four warpgroups (512
// threads) per (256 query rows, head, batch row); warpgroup w owns rows
// 64 w .. 64 w + 63 and all four share each K/V tile.
//  - Products: S = Q K^T is wgmma m64n64k16 with Q and K both read from
//    shared memory (K-major operands); O += P V is wgmma m64nDPk16 with P
//    from registers and V from shared memory (an MN-major, transposed,
//    operand).  f32 accumulation.  P goes from the S accumulators straight
//    into bf16 A fragments in registers (no round trip through shared
//    memory).
//  - Online softmax in registers, in the log2 domain: scores are scaled by
//    sm_scale * log2(e) before masking, so masked scores are -1e30 there
//    and 2^(-1e30 - m) keeps the semantics above; 2^x is the hardware's
//    ex2.approx.ftz (2 ulp; a P below 2^-126 flushes to 0, far below what
//    bf16 P V can hold).  A thread holds two
//    rows (g and g + 8 of its warp's 16); their running max is reduced over
//    the quad of lanes that share the row (two shuffles), and the rescale by
//    alpha stays on the O fragments.  l sums the f32 P (before P is rounded
//    to bf16 for P V), per thread, and is reduced over the quad once at the
//    end.
//  - Q (256 rows) and K/V tiles of 64 keys sit in shared memory in the
//    128-byte swizzled layout the wgmma descriptors name: 64-dim atom
//    columns of 128-byte rows, 16-byte chunk c of row r stored at c ^ (r %
//    8), atoms 1024-byte aligned.  K and V are double-buffered: all threads
//    issue cp.async 16-byte copies of tile t + 1 while tile t is computed,
//    one barrier per tile; zero-fill (src-size 0) serves keys past L and
//    dims past D.  fence.proxy.async makes the copies visible to wgmma.
//    Where D % 8 != 0 or a pointer is not 16-byte aligned, the same kernel
//    loads and stores element by element instead.
//  - Tiles wholly above the block's diagonal or wholly before its window
//    are skipped; the element mask is applied only on tiles that cross the
//    block's diagonal, its window's edge or L.  Query tiles are launched
//    heaviest first (blockIdx.x reversed), so the causal tail of the grid
//    is short.
//  - Head widths DP = 64 (stablelm, granite, whisper), 80 (h2o-danube) and
//    128 (jamba, qwen3, yi, nemotron, internvl2) are instantiated; any
//    other D <= 128 runs in the next width up (the Python wrapper picks it),
//    zero-filled in shared memory.
//  - Four warpgroups a block cap a thread at 128 registers and keep four
//    warpgroups on an SM, one block (129 KB of dynamic shared memory at DP
//    128 and 80, 65 KB at DP 64).  Each tile's two products are waited for
//    before the softmax that needs them, so a warpgroup's softmax does not
//    overlap its own tensor-core work; the other three warpgroups' do.
//    (The first route, mma.sync m16n8k16 with ldmatrix, four warps per 64
//    rows, was right and slower on the card, and was dropped.)
//  Registers, spills (nvcc 12.9 -Xptxas -v, sm_90a): DP 128: 128, none;
//  DP 80: 126, none; DP 64: 118, none.  f32 kernel: 128, none, 32 KB of
//  static shared memory.
//
// f32 (flash_attention_f32_kernel): the IEEE-FMA kernel of the first port,
// kept as the parity path (TF32 would not hold 2e-5).  One block of 256
// threads per (64 query rows, head, batch row); four threads share a query
// row and each holds a quarter of its head dim in registers.  Key/value
// tiles of 32 rows go through shared memory; a score is four partial dot
// products summed with two warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kDMax = 128;              // largest head dim

// ------------------------------------------------------------- f32 path --

constexpr int kF32BQ = 64;              // query rows per block
constexpr int kF32BK = 32;              // keys per tile
constexpr int kF32TPR = 4;              // threads per query row
constexpr int kF32Threads = kF32BQ * kF32TPR;   // 256
constexpr int kF32DPT = kDMax / kF32TPR;        // head dims per thread

__global__ void __launch_bounds__(kF32Threads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int H, int KV, int L, int D, int causal, int window,
                           float sm_scale) {
  __shared__ float s_k[kF32BK][kDMax];
  __shared__ float s_v[kF32BK][kDMax];

  const int tid = threadIdx.x;
  const int r = tid / kF32TPR;          // query row inside the block
  const int c = tid % kF32TPR;          // this thread's dims: c + kF32TPR * i
  const int q0 = blockIdx.x * kF32BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int qi = q0 + r;

  const float* qp = q + ((size_t)b * H + h) * L * D;
  const float* kp = k + ((size_t)b * KV + g) * L * D;
  const float* vp = v + ((size_t)b * KV + g) * L * D;

  float qr[kF32DPT], acc[kF32DPT];
#pragma unroll
  for (int i = 0; i < kF32DPT; ++i) {
    const int d = c + kF32TPR * i;
    qr[i] = (qi < L && d < D) ? qp[(size_t)qi * D + d] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // keys this block can see: [lo, hi), tile-aligned at lo
  int lo = 0, hi = L;
  if (causal) hi = min(L, q0 + kF32BQ);
  if (window > 0) lo = max(0, q0 - window + 1);
  lo = lo / kF32BK * kF32BK;

  for (int k0 = lo; k0 < hi; k0 += kF32BK) {
    __syncthreads();                    // the previous tile is consumed
    for (int e = tid; e < kF32BK * kDMax; e += kF32Threads) {
      const int j = e / kDMax, d = e % kDMax;
      const int kj = k0 + j;
      const bool ok = kj < L && d < D;
      s_k[j][d] = ok ? kp[(size_t)kj * D + d] : 0.f;
      s_v[j][d] = ok ? vp[(size_t)kj * D + d] : 0.f;
    }
    __syncthreads();

    float s[kF32BK];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kF32BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kF32DPT; ++i)
        part = fmaf(qr[i], s_k[j][c + kF32TPR * i], part);
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
    for (int j = 0; j < kF32BK; ++j) {
      s[j] = expf(s[j] - m_new);
      p_sum += s[j];
    }
    l = alpha * l + p_sum;
#pragma unroll
    for (int i = 0; i < kF32DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32BK; ++j) {
#pragma unroll
      for (int i = 0; i < kF32DPT; ++i)
        acc[i] = fmaf(s[j], s_v[j][c + kF32TPR * i], acc[i]);
    }
    m = m_new;
  }

  if (qi < L) {
    const float denom = fmaxf(l, 1e-30f);
    float* op = o + (((size_t)b * H + h) * L + qi) * D;
#pragma unroll
    for (int i = 0; i < kF32DPT; ++i) {
      const int d = c + kF32TPR * i;
      if (d < D) op[d] = acc[i] / denom;
    }
  }
}

// ------------------------------------------------------------ bf16 path --

using bf16 = __nv_bfloat16;

constexpr int kWG = 4;                  // warpgroups a block, 64 rows each
constexpr int kThreads = 128 * kWG;     // 512
constexpr int kBQ = 64 * kWG;           // query rows per block
constexpr int kBK = 64;                 // keys per tile

template <int DP>
struct Tiles {
  static constexpr int NA = (DP + 63) / 64;        // 128-byte atom columns
  static constexpr int QTILE = kBQ * NA * 128;     // bytes of the Q tile
  static constexpr int TILE = kBK * NA * 128;      // bytes of a K or V tile
  static constexpr size_t SMEM = QTILE + 4 * TILE + 1024;  // + alignment
  static constexpr int KSTEPS = DP / 16;           // k-steps of Q K^T
  static constexpr int DB = DP / 8;                // 8-dim column blocks of O
  static_assert(DP % 16 == 0 && DP <= kDMax, "head width");
};

// 2^x on the special-function unit (exp2f adds range handling around it,
// 4% of the kernel's time at the serve shape)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, visible to the tensor cores' reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared-memory descriptor of a 128-byte-swizzled operand: start address,
// leading and stride byte offsets (all multiples of 16).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (m64 x n64, f32) = (scale_d ? d : 0) + a b: a (m64 x k16) and b
// (n64 x k16) bf16 in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (m64 x n64, f32) += a (m64 x k16, bf16 registers) b (k16 x n64,
// bf16 in shared memory, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (m64 x n80, f32) += a (m64 x k16, bf16 registers) b (k16 x n80,
// bf16 in shared memory, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 "
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (m64 x n128, f32) += a (m64 x k16, bf16 registers) b (k16 x n128,
// bf16 in shared memory, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Byte offset of the 16-byte chunk ch (dims 8 ch .. 8 ch + 7) of row r in a
// tile of R rows: 64-dim atom columns of R rows x 128 bytes, chunk index
// xor-ed with r % 8 (the 128-byte swizzle; atoms are 1024-byte aligned).
__device__ __forceinline__ uint32_t swz(int r, int ch, int R) {
  return (ch >> 3) * R * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// ROWS x DP tile of rows row0.. of src (row length D) into dst in the
// swizzled layout, zero past L and past D.  vec: cp.async 16-byte chunks
// (D % 8 == 0, 16-byte aligned rows); otherwise element by element.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* src,
                                          int row0, int L, int D, bool vec,
                                          int tid) {
  constexpr int CPR = DP / 8;           // 16-byte chunks per row
  if (vec) {
#pragma unroll
    for (int c = tid; c < ROWS * CPR; c += kThreads) {
      const int r = c / CPR, ch = c % CPR;
      const int gr = row0 + r;
      const bool ok = gr < L && ch * 8 < D;
      cp_async16(dst + swz(r, ch, ROWS),
                 ok ? src + (size_t)gr * D + ch * 8 : src, ok);
    }
  } else {
    for (int e = tid; e < ROWS * DP; e += kThreads) {
      const int r = e / DP, d = e % DP;
      const int gr = row0 + r;
      *reinterpret_cast<bf16*>(dst + swz(r, d >> 3, ROWS) + (d & 7) * 2) =
          (gr < L && d < D) ? src[(size_t)gr * D + d] : __float2bfloat16(0.f);
    }
  }
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&acc)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&acc)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(acc, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<80>(float (&acc)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n80(acc, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&acc)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(acc, a, db);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            int H, int KV, int L, int D, int causal,
                            int window, float scale_log2, int vec) {
  using T = Tiles<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* sQ = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* sK = sQ + T::QTILE;    // [2][TILE]
  unsigned char* sV = sK + 2 * T::TILE; // [2][TILE]
  const uint32_t aQ = (uint32_t)__cvta_generic_to_shared(sQ);
  const uint32_t aK = aQ + T::QTILE, aV = aK + 2 * T::TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;           // fragment coordinates
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int gk = h / (H / KV);

  const bf16* qp = q + ((size_t)b * H + h) * L * D;
  const bf16* kp = k + ((size_t)b * KV + gk) * L * D;
  const bf16* vp = v + ((size_t)b * KV + gk) * L * D;

  // keys this block can see: [lo, hi), tile-aligned at lo
  int lo = 0, hi = L;
  if (causal) hi = min(L, q0 + kBQ);
  if (window > 0) lo = max(0, q0 - window + 1);
  lo = lo / kBK * kBK;
  const int n_tiles = (hi - lo + kBK - 1) / kBK;

  load_tile<DP, kBQ>(sQ, qp, q0, L, D, vec, tid);
  load_tile<DP, kBK>(sK, kp, lo, L, D, vec, tid);
  load_tile<DP, kBK>(sV, vp, lo, L, D, vec, tid);
  cp_async_commit();

  float acc[T::DB * 4];
#pragma unroll
  for (int i = 0; i < T::DB * 4; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t aQw = aQ + (warp >> 2) * 64 * 128;  // its rows of Q

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = lo + it * kBK;
    const int buf = it & 1;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();    // tile it landed; every warp is done with it - 1
    if (it + 1 < n_tiles) {
      load_tile<DP, kBK>(sK + (buf ^ 1) * T::TILE, kp, k0 + kBK, L, D, vec,
                         tid);
      load_tile<DP, kBK>(sV + (buf ^ 1) * T::TILE, vp, k0 + kBK, L, D, vec,
                         tid);
      cp_async_commit();
    }
    const uint32_t kb = aK + buf * T::TILE, vb = aV + buf * T::TILE;

    // ---- S = Q K^T (f32): Q and K K-major, k16 slices 32 bytes apart
    // inside a 64-dim atom column ----
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk) {
      const uint32_t col = (kk & 3) * 32;
      wgmma_ss_n64(s, smem_desc(aQw + (kk >> 2) * kBQ * 128 + col, 16, 1024),
                   smem_desc(kb + (kk >> 2) * kBK * 128 + col, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // ---- scale to the log2 domain, mask, online softmax ----
    // (one test for the whole block: testing each warpgroup's own rows
    // made the warpgroups mask in different iterations, 20% slower)
    const bool full = k0 + kBK <= L && (!causal || k0 + kBK - 1 <= q0) &&
                      (window == 0 || k0 > q0 + kBQ - 1 - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (!full) {
        const int key = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
        const int row = row0 + ((i >> 1) & 1) * 8;
        bool keep = key < L;
        if (causal) keep = keep && key <= row;
        if (window > 0) keep = keep && key > row - window;
        if (!keep) x = kNegInf;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = fast_exp2(s[i] - m[(i >> 1) & 1]);
      s[i] = p;
      rs[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < T::DB * 4; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // ---- O += P V: P as bf16 A fragments straight from S, V MN-major
    // (64-dim blocks kBK * 128 bytes apart, 8-key groups 1024 apart) ----
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    wgmma_fence();      // after every register the wgmmas read is written
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv<DP>(acc, pa[kk], smem_desc(vb + kk * 2048, kBK * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  // ---- o = acc / l, straight from the fragments ----
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    denom[r] = fmaxf(l[r], 1e-30f);
  }
  bf16* op = o + ((size_t)b * H + h) * L * D;
#pragma unroll
  for (int i = 0; i < T::DB * 4; i += 2) {
    const int row = row0 + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + 2 * t4;
    const float r = denom[(i >> 1) & 1];
    if (row < L) {
      bf16* dst = op + (size_t)row * D + col;
      if (vec) {
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(acc[i] / r, acc[i + 1] / r);
      } else {
        if (col < D) dst[0] = __float2bfloat16(acc[i] / r);
        if (col + 1 < D) dst[1] = __float2bfloat16(acc[i + 1] / r);
      }
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int L, int D, int causal,
                        int window, float sm_scale, int vec, cudaStream_t s) {
  const size_t smem = Tiles<DP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBQ - 1) / kBQ, H, B);
  flash_attention_bf16_kernel<DP><<<grid, kThreads, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, H, KV, L, D,
      causal, window, sm_scale * 1.4426950408889634f, vec);
  return cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// q (B, H, L, D), k and v (B, KV, L, D), o (B, H, L, D): contiguous device
// arrays of f32 (dtype 0) or bf16 (dtype 1).  dp is the instantiated head
// width the bf16 kernel runs in (64, 80 or 128, at least D; ignored for
// f32).  Launches on `stream` without synchronising; returns
// cudaGetLastError() (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KV, int L, int D,
                           int dp, int causal, int window, float sm_scale,
                           int dtype, int device, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || L < 1 || D < 1 ||
      D > kDMax || window < 0 || H > 65535 || B > 65535 ||
      (dtype != 0 && dtype != 1) ||
      (dtype == 1 && ((dp != 64 && dp != 80 && dp != 128) || D > dp)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((L + kF32BQ - 1) / kF32BQ, H, B);
    flash_attention_f32_kernel<<<grid, kF32Threads, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, H, KV,
        L, D, causal, window, sm_scale);
  } else {
    const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                    aligned16(v) && aligned16(o);
    err = dp == 64    ? launch_bf16<64>(q, k, v, o, B, H, KV, L, D, causal,
                                        window, sm_scale, vec, s)
          : dp == 80  ? launch_bf16<80>(q, k, v, o, B, H, KV, L, D, causal,
                                        window, sm_scale, vec, s)
                      : launch_bf16<128>(q, k, v, o, B, H, KV, L, D, causal,
                                         window, sm_scale, vec, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
