// Shared pieces of the tensor-core kernels for Hopper (sm_90a): the
// forwards of flash_fwd_tc.cu and flash_fwd_pipelined_tc.cu and the
// backward (C1, C2, C3) of flash_bwd_tc.cu.
//
// Operands are 16-bit (bf16 or fp16) tiles in shared memory in the
// 128-byte swizzled layout that wgmma's descriptors describe: 8-row groups
// of 128-byte rows, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8); a head dim of 128 or 256 is two or four 64-column atoms,
// each R rows of 128 bytes.  Tiles are filled by 16-byte cp.async copies
// (or by TMA, tma_common.cuh) and read by wgmma through the async proxy,
// hence fence_proxy_async() between the copies' wait (or a generic
// store) and the first product.  Products take 16-bit
// operands and sum in f32 registers; the m64nNk16 accumulator layout of
// 16 columns is the A-fragment layout of one k16 step, so a product's
// result becomes the register operand of the next (pack2).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the copies' writes become visible to wgmma's (async-proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads of accumulators across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled operand: start address,
// leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
// K-major operand (the product's depth runs along the rows' D
// elements): rows [row0, row0 + 64 or N) of an R-row tile, k16 step kk.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  return make_desc(tile + (kk >> 2) * (R * 128) + row0 * 128 + (kk & 3) * 32,
                   16, 1024);
}
// MN-major B operand (the depth runs down the tile's R rows, N = D along
// them): rows [16 kk, 16 kk + 16); the 64-column atoms R * 128 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t desc_t(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, R * 128, 1024);
}

// D = (scale_d ? D : 0) + A B over one k16 step; A, B in shared memory,
// both K-major; N = the B tile's rows; T the 16-bit operand type.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// The same with both operands MN-major (the transpose bits): A's 64 rows
// run along a 64-column atom of its tile, B as in wgmma_rs.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d);
// D += A B over one k16 step; A (64 x 16 of T) from registers, B
// MN-major in shared memory.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&fa)[4],
                                         uint64_t db);

#define PTC_ACC8(d, o)                                                   \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),            \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define PTC_ACC16(d) PTC_ACC8(d, 0), PTC_ACC8(d, 8)
#define PTC_ACC32(d) \
  PTC_ACC8(d, 0), PTC_ACC8(d, 8), PTC_ACC8(d, 16), PTC_ACC8(d, 24)
#define PTC_ACC64(d)                                                     \
  PTC_ACC32(d), PTC_ACC8(d, 32), PTC_ACC8(d, 40), PTC_ACC8(d, 48),       \
      PTC_ACC8(d, 56)
#define PTC_REGS16                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define PTC_REGS32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define PTC_REGS64                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// the products of one operand type TS ("bf16" or "f16"): ss at N = 32,
// 64 and 128, ss with both operands transposed at N = 64, rs at N = 64
// and 128
#define PTC_DEFINE_WGMMA(T, TS)                                          \
  template <>                                                            \
  __device__ __forceinline__ void wgmma_ss<T, 32>(                       \
      float(&d)[16], uint64_t da, uint64_t db, int scale_d) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"            \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." TS        \
                 "." TS " " PTC_REGS16 ", %16, %17, p, 1, 1, 0, 0;\n}\n" \
                 : PTC_ACC16(d)                                          \
                 : "l"(da), "l"(db), "r"(scale_d));                      \
  }                                                                      \
  template <>                                                            \
  __device__ __forceinline__ void wgmma_ss_t<T, 64>(                     \
      float(&d)[32], uint64_t da, uint64_t db, int scale_d) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"            \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TS        \
                 "." TS " " PTC_REGS32 ", %32, %33, p, 1, 1, 1, 1;\n}\n" \
                 : PTC_ACC32(d)                                          \
                 : "l"(da), "l"(db), "r"(scale_d));                      \
  }                                                                      \
  template <>                                                            \
  __device__ __forceinline__ void wgmma_ss<T, 64>(                       \
      float(&d)[32], uint64_t da, uint64_t db, int scale_d) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"            \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TS        \
                 "." TS " " PTC_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n" \
                 : PTC_ACC32(d)                                          \
                 : "l"(da), "l"(db), "r"(scale_d));                      \
  }                                                                      \
  template <>                                                            \
  __device__ __forceinline__ void wgmma_ss<T, 128>(                      \
      float(&d)[64], uint64_t da, uint64_t db, int scale_d) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"            \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TS       \
                 "." TS " " PTC_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n" \
                 : PTC_ACC64(d)                                          \
                 : "l"(da), "l"(db), "r"(scale_d));                      \
  }                                                                      \
  template <>                                                            \
  __device__ __forceinline__ void wgmma_rs<T, 64>(                       \
      float(&d)[32], const uint32_t(&fa)[4], uint64_t db) {              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"            \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TS        \
                 "." TS " " PTC_REGS32                                   \
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"         \
                 : PTC_ACC32(d)                                          \
                 : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]),       \
                   "l"(db), "r"(1));                                     \
  }                                                                      \
  template <>                                                            \
  __device__ __forceinline__ void wgmma_rs<T, 128>(                      \
      float(&d)[64], const uint32_t(&fa)[4], uint64_t db) {              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"            \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TS       \
                 "." TS " " PTC_REGS64                                   \
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"         \
                 : PTC_ACC64(d)                                          \
                 : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]),       \
                   "l"(db), "r"(1));                                     \
  }

PTC_DEFINE_WGMMA(bf16, "bf16")
PTC_DEFINE_WGMMA(f16, "f16")

#undef PTC_DEFINE_WGMMA
#undef PTC_REGS64
#undef PTC_REGS32
#undef PTC_REGS16
#undef PTC_ACC64
#undef PTC_ACC32
#undef PTC_ACC16
#undef PTC_ACC8

// two f32 values rounded to T and packed as one 32-bit register (lo in the
// low half): an A fragment pair or a pair of adjacent output elements
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<f16>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Issue the copies of rows [row0, row0 + R) of one head into an R-row
// swizzled tile.  Source rows are `row_stride` elements apart, the head's
// D elements contiguous and 16-byte aligned.  UNROLL false issues them
// from a rolled loop, which holds one source address at a time instead
// of all of them (R * D / 8 / NT a thread: 16 at D 256 and 128 threads).
template <int D, int R, int NT, bool UNROLL = true, typename T>
__device__ __forceinline__ void load_tile(uint32_t tile, const T* g,
                                          long long row_stride, int row0) {
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int N = R * CH / NT;
  static_assert((R * CH) % NT == 0, "tile copies split evenly");
  auto copy = [&](int i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / CH;
    const int c = e % CH;
    cp_async16(tile + (c >> 3) * (R * 128) + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               g + (long long)(row0 + r) * row_stride + c * 8);
  };
  if constexpr (UNROLL) {
#pragma unroll
    for (int i = 0; i < N; ++i) copy(i);
  } else {
#pragma unroll 1
    for (int i = 0; i < N; ++i) copy(i);
  }
}

// Issue the copies of R rows of a (B, S, H) f32 statistic, one head's
// rows `H` apart, into `dst` (threads 0 .. R-1).
template <int R>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* g,
                                          int H, int row0) {
  if (threadIdx.x < R)
    cp_async4(dst + threadIdx.x * 4,
              g + (long long)(row0 + threadIdx.x) * H);
}

// Store a warpgroup's m64 x N f32 accumulator, rows [row0, row0 + 64) and
// columns [col0, col0 + N), as T into dense (B, S, H, D) `out` at (b, h):
// a thread's rows r and r + 8 times `mul_lo` and `mul_hi`.
template <int D, int N, typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[N / 2],
                                           float mul_lo, float mul_hi,
                                           int b, int S, int H, int h,
                                           int row0, int col0) {
  const int t = threadIdx.x & 127;
  const int r = row0 + 16 * (t >> 5) + ((t & 31) >> 2);
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int hh = (i >> 1) & 1;
    const float mul = hh ? mul_hi : mul_lo;
    const int row = r + 8 * hh;
    const int col = col0 + 8 * (i >> 2) + 2 * (t & 3);
    *reinterpret_cast<uint32_t*>(
        out + (((long long)b * S + row) * H + h) * D + col) =
        pack2<T>(acc[i] * mul, acc[i + 1] * mul);
  }
}

// store_rows in f32, unrounded: the same layout and products, written
// into `out`, or with ADD added into it (a caller that sums a result over
// several launches and rounds it once).  Each product is rounded before
// the add (__fmul_rn, no fused multiply-add), so adding into zeros gives
// the written values bit for bit, and rounding a written value to T gives
// store_rows' value.  ADD reads eight pairs before it writes them: a load
// issued after a store to the same tensor would wait for it, and the
// epilogue would take a trip to memory a pair.
template <int D, int N, bool ADD>
__device__ __forceinline__ void store_rows_f32(float* out,
                                               const float (&acc)[N / 2],
                                               float mul_lo, float mul_hi,
                                               int b, int S, int H, int h,
                                               int row0, int col0) {
  constexpr int G = 8;   // pairs read before they are written
  static_assert((N / 4) % G == 0, "whole groups of pairs");
  const int t = threadIdx.x & 127;
  const int r = row0 + 16 * (t >> 5) + ((t & 31) >> 2);
  auto at = [&](int i) {
    return reinterpret_cast<float2*>(
        out + (((long long)b * S + r + 8 * ((i >> 1) & 1)) * H + h) * D +
        col0 + 8 * (i >> 2) + 2 * (t & 3));
  };
#pragma unroll
  for (int i0 = 0; i0 < N / 2; i0 += 2 * G) {
    [[maybe_unused]] float2 old[G];
    if constexpr (ADD) {
#pragma unroll
      for (int j = 0; j < G; ++j) old[j] = *at(i0 + 2 * j);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int i = i0 + 2 * j;
      const float mul = ((i >> 1) & 1) ? mul_hi : mul_lo;
      float2 v = make_float2(__fmul_rn(acc[i], mul),
                             __fmul_rn(acc[i + 1], mul));
      if constexpr (ADD) {
        v.x += old[j].x;
        v.y += old[j].y;
      }
      *at(i) = v;
    }
  }
}

// The flash forward of one consumer warpgroup over its 64 q rows of a
// BQ-row tile, one BK-row K/V tile at a time: what the TPU's
// _online_step computes, shared by flash_fwd_tc.cu and
// flash_fwd_pipelined_tc.cu (only their loads differ).  Per tile:
//   S = Q K^T by wgmma (both operands K-major in shared memory),
//   x = S * scale * log2(e) in f32, masked on the causal diagonal,
//   m' = max(m, rowmax x),  p = exp2(x - m'),  c = exp2(m - m'),
//   l' = l c + rowsum p (the unrounded p),  O' = O c + T(p) V,
// P converted in place to T as the A fragments (the m64nNk16 accumulator
// layout of 16 columns is one k16 step's A layout) and V read MN-major.
// A thread owns two rows, r and r + 8: accumulator i is row
// r + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (lane & 3) + (i & 1); the
// row max takes two shuffles across the thread's quad, the sum only at
// the end (each thread keeps its share, rescaled with the max).  At head
// dim 256 O is two m64n128 accumulators (128 registers a thread).
template <typename T, int D, int BQ, int BK>
struct FwdRows {
  static constexpr int NS = BK / 2;            // score accumulators
  static constexpr int KS = BK / 16;           // k16 steps of P V
  static constexpr int NH = D == 256 ? 2 : 1;  // m64n(D / NH) outputs
  static constexpr int NO = D / 2 / NH;
  float o[NH][NO], s[NS];
  float m[2], lsum[2];   // the running max and sum share of rows r, r + 8

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int i = 0; i < NO; ++i) o[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = -INFINITY;
      lsum[hh] = 0.f;
    }
  }

  // The K/V tile of keys [c0, c0 + BK) at sK / sV against warpgroup wg's
  // rows of the q tile at sQ, whose first row is q row `row0`.  The
  // first tile holds key 0, visible to every row, so m is finite after
  // it.  Every product has retired on return.
  __device__ __forceinline__ void tile(uint32_t sQ, int wg, uint32_t sK,
                                       uint32_t sV, int c0, int row0,
                                       bool causal, float scale2) {
    const int t = threadIdx.x & 127;
    const int l = t & 31;
    const int r = row0 + 16 * (t >> 5) + (l >> 2);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, BK>(s, desc_k<BQ>(sQ, 64 * wg, kk), desc_k<BK>(sK, 0, kk),
                      kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(s);

    const bool diag = causal && c0 + BK - 1 > row0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int hh = (i >> 1) & 1;
      const int c = c0 + 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
      float x = s[i] * scale2;
      if (diag && c > r + 8 * hh) x = -INFINITY;
      s[i] = x;
      mx[hh] = fmaxf(mx[hh], x);
    }
    float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      corr[hh] = exp2f(m[hh] - mx[hh]);
      m[hh] = mx[hh];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int hh = (i >> 1) & 1;
      s[i] = exp2f(s[i] - mx[hh]);
      ps[hh] += s[i];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) lsum[hh] = lsum[hh] * corr[hh] + ps[hh];
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int i = 0; i < NO; ++i) o[j][i] *= corr[(i >> 1) & 1];
    uint32_t fp[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int mm = 0; mm < 4; ++mm)
        fp[kk][mm] = pack2<T>(s[8 * kk + 2 * mm], s[8 * kk + 2 * mm + 1]);

    // O += P V (V read transposed: the keys are the depth), D / NH
    // columns (one or two 64-column atoms) a product
    wg_fence();
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_rs<T, D / NH>(o[j], fp[kk],
                            desc_t<BK>(sV + j * (D / NH / 64) * BK * 128, kk));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int j = 0; j < NH; ++j) fence_regs(o[j]);
  }

  // out = O / l into dense (B, S, H, D) `out` at (b, h), rows
  // [row0, row0 + 64), in T, or unrounded where O is float (ring
  // attention's blocks, combined before one rounding); the base-e f32 lse
  // (m + log2 l) ln 2 into dense (B, S, H) `lse` unless it is null.
  template <typename O>
  __device__ __forceinline__ void finish(O* out, float* lse, int b, int S,
                                         int H, int h, int row0) {
    const int t = threadIdx.x & 127;
    const int l = t & 31;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 1);
      lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 2);
      lsum[hh] = fmaxf(lsum[hh], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      if constexpr (sizeof(O) == 4)
        store_rows_f32<D, D / NH, false>(out, o[j], 1.f / lsum[0],
                                         1.f / lsum[1], b, S, H, h, row0,
                                         j * (D / NH));
      else
        store_rows<D, D / NH>(out, o[j], 1.f / lsum[0], 1.f / lsum[1], b, S,
                              H, h, row0, j * (D / NH));
    }
    if (lse != nullptr && (l & 3) == 0) {
      const int r = row0 + 16 * (t >> 5) + (l >> 2);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        lse[((long long)b * S + r + 8 * hh) * H + h] =
            (m[hh] + log2f(lsum[hh])) * kLn2;
    }
  }
};

}  // namespace
