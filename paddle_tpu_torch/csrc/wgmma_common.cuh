// Shared pieces of the tensor-core kernels for Hopper (sm_90a): the
// forward of flash_fwd_tc.cu and the split backward of flash_bwd_tc.cu.
//
// Operands are 16-bit (bf16 or fp16) tiles in shared memory in the
// 128-byte swizzled layout that wgmma's descriptors describe: 8-row groups
// of 128-byte rows, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8); a head dim of 128 or 256 is two or four 64-column atoms,
// each R rows of 128 bytes.  Tiles are filled by 16-byte cp.async copies
// and read by wgmma through the async proxy, hence fence_proxy_async()
// between the copies' wait and the first product.  Products take 16-bit
// operands and sum in f32 registers; the m64nNk16 accumulator layout of
// 16 columns is the A-fragment layout of one k16 step, so a product's
// result becomes the register operand of the next (pack2).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;
constexpr float kLog2e = 1.4426950408889634f;

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
// D += A B over one k16 step; A (64 x 16 of T) from registers, B
// MN-major in shared memory.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&fa)[4],
                                         uint64_t db);

#define PTC_ACC8(d, o)                                                   \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),            \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define PTC_ACC32(d) \
  PTC_ACC8(d, 0), PTC_ACC8(d, 8), PTC_ACC8(d, 16), PTC_ACC8(d, 24)
#define PTC_ACC64(d)                                                     \
  PTC_ACC32(d), PTC_ACC8(d, 32), PTC_ACC8(d, 40), PTC_ACC8(d, 48),       \
      PTC_ACC8(d, 56)
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

// the four products of one operand type TS ("bf16" or "f16"): ss and rs
// at N = 64 and 128
#define PTC_DEFINE_WGMMA(T, TS)                                          \
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
#undef PTC_ACC64
#undef PTC_ACC32
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

}  // namespace
