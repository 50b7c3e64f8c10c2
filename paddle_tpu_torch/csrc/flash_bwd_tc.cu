// Split flash-attention backward on Hopper's tensor cores (sm_90a), bf16:
// kernels C2 and C3 of the plain C interface in flash_bwd.cu.
//
// Replaces, for bfloat16 inputs at head dims 64, 128 and 256, the split
// backward kernels of paddle_tpu/kernels/flash_attention_pallas.py:
//   C2 flash_bwd_dq_tc_kernel   <- _bwd_dq_kernel   (dQ)
//   C3 flash_bwd_dkv_tc_kernel  <- _bwd_dkv_kernel  (dK, dV)
// Both compute what _bwd_head_math computes, per (batch, head):
//   P  = exp2(scale * log2e * Q K^T - lse * log2e),  dP = dO V^T,
//   dS = P * (dP - delta),
//   dV = bf16(P)^T dO,  dK = scale * bf16(dS)^T Q,  dQ = scale * bf16(dS) K
// with bf16 operands and f32 sums in every product, P rounded to bf16
// before dV and dS before dK and dQ, as the TPU kernels round them before
// their MXU products; the start-aligned causal mask only on the diagonal
// tile, whose future keys get P = 0.  f32 inputs keep the FMA kernels of
// flash_bwd.cu (f32 on the tensor cores would be TF32, other numerics).
//
// Bound on the H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the long-context
// shape B=1, S=16384, H=16, D=64 causal, C2 does three S x S x D products
// (S, dP, dQ; 8.3e11 FLOP, 0.83 ms) and C3 four (S^T, dP^T, dV, dK;
// 1.1e12 FLOP, 1.11 ms) against 10-12 MB of operands (~4 us): both are
// bound by operations, which only the tensor cores deliver at that rate.
//
// Design.  One block per (batch, head, 64- or 128-row tile), one
// consumer warpgroup (128 threads) per 64 rows of the resident tile:
//   C3: K and V stay resident; the loop runs over the q tiles from the
//       causal diagonal on, each tile's Q, dO, lse and delta rows landing
//       in a two-stage ring.  Per q tile, wgmma computes S^T = K Q^T and
//       dP^T = V dO^T with both operands in shared memory; P^T and dS^T
//       are formed in the accumulator registers, converted to bf16 in
//       place as wgmma A fragments (the m64nNk16 accumulator layout of
//       16 columns is the A layout of one k16 step), and dV += P^T dO,
//       dK += dS^T Q run with A from registers and B = dO or Q read
//       transposed from the same shared tiles (the MN-major bit).
//       dK and dV sum in f32 registers over the whole loop.
//   C2: Q, dO and the rows' lse and delta stay resident; the loop runs
//       over the K tiles up to the diagonal (the block with the most
//       tiles starts first); per K tile S = Q K^T and dP = dO V^T by
//       wgmma, P and dS in registers, dQ += dS K with K read transposed.
// At head dim 256 the f32 dK and dV of one 64-row warpgroup would need
// 2 x 64 x 256 / 128 = 256 registers a thread, so there the two
// warpgroups of a block share one 64-row tile and split the work, each
// holding 128 output registers a thread:
//   C3: warpgroup 0 computes S^T and P^T and sums dV, warpgroup 1
//       computes dP^T, takes P^T from shared memory and sums dK;
//   C2: warpgroup 0 computes S and P, warpgroup 1 dP; both exchange
//       them through shared memory, form the same dS and each sums half
//       of dQ's 256 columns.
// Tiles are bf16 in the 128-byte swizzled layout wgmma's descriptors
// describe (8-row groups of 128-byte rows, 16-byte chunk c of row r at
// c ^ (r % 8); a head dim of 128 or 256 is two or four 64-column atoms),
// filled by 16-byte cp.async copies that the threads issue for tile t+1
// before they wait for tile t, so the fetch overlaps the tile's products.
// No atomics: every output element is summed by one thread in one order,
// so both kernels are deterministic.  The tile is a template parameter
// (square, the autotuner's flash_bwd_dq / flash_bwd_dkv candidates): 64
// at every head dim, 128 (two warpgroups) at 64.
// Warp specialisation, TMA and overlapping one tile's softmax with the
// next tile's products are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory of one launch, for either kernel: 1024 bytes of
// slack to align the tiles to the swizzle's 1024-byte period, six bf16
// BM x D tiles (two resident, two stages of two streamed), four f32 row
// vectors of BM (C3: a stage's lse and delta rows, twice; C2: its
// resident lse and delta rows in the first two) and, at D = 256, two f32
// BM x BM score tiles that the warpgroups exchange (C2: P and dP; C3:
// P^T in the first).
constexpr int tc_smem_bytes(int D, int BM) {
  return 1024 + 6 * BM * D * 2 + 4 * BM * 4 + (D == 256 ? 2 * BM * BM * 4 : 0);
}

// threads of a block: one warpgroup per 64 rows, two at D = 256
constexpr int tc_threads(int D, int BM) { return D == 256 ? 256 : 2 * BM; }

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
// both K-major; N = the B tile's rows.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// D += A B over one k16 step; A (64 x 16 bf16) from registers, B
// MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&fa)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&fa)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&fa)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Issue the copies of rows [row0, row0 + R) of one head into an R-row
// swizzled tile.  Source rows are `row_stride` elements apart, the head's
// D elements contiguous and 16-byte aligned.
template <int D, int R, int NT>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* g,
                                          long long row_stride, int row0) {
  constexpr int CH = D / 8;   // 16-byte chunks per row
  static_assert((R * CH) % NT == 0, "tile copies split evenly");
#pragma unroll
  for (int i = 0; i < R * CH / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / CH;
    const int c = e % CH;
    cp_async16(tile + (c >> 3) * (R * 128) + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               g + (long long)(row0 + r) * row_stride + c * 8);
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

struct TcArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;     // (B, S, H) base-e
  const float* delta;   // (B, S, H)
  bf16* dq;             // (B, S, H, D) dense outputs
  bf16* dk;
  bf16* dv;
  int S, H;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  int causal;
  float scale;
};

// Store a warpgroup's m64 x N f32 accumulator, rows [row0, row0 + 64) and
// columns [col0, col0 + N), times `mul`, as bf16 into dense (B, S, H, D)
// `out` at (b, h).
template <int D, int N>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[N / 2],
                                           float mul, int b, int S, int H,
                                           int h, int row0, int col0) {
  const int t = threadIdx.x & 127;
  const int r = row0 + 16 * (t >> 5) + ((t & 31) >> 2);
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int row = r + 8 * ((i >> 1) & 1);
    const int col = col0 + 8 * (i >> 2) + 2 * (t & 3);
    *reinterpret_cast<__nv_bfloat162*>(
        out + (((long long)b * S + row) * H + h) * D + col) =
        __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
  }
}

// C3 at D 64 and 128: grid (S / BM, H, B), 2 * BM threads; block kt owns
// K rows [kt BM, kt BM + BM), warpgroup wg the 64 rows from kt BM + 64 wg.
template <int D, int BM>
__device__ __forceinline__ void dkv_by_rows(const TcArgs& a) {
  constexpr int NT = 2 * BM;
  constexpr int TILE = BM * D * 2;   // bytes of one bf16 tile
  constexpr int NS = BM / 2;         // score accumulators a thread
  constexpr int NO = D / 2;          // output accumulators a thread
  constexpr int KS = BM / 16;        // k16 steps over a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + TILE, sStage = base + 2 * TILE;
  const uint32_t sRows = base + 6 * TILE;
  const float* rows =
      reinterpret_cast<const float*>(smem_raw + (sRows - raw));

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x & 127;
  const int wg = threadIdx.x >> 7;
  const int w = t >> 5;
  const int l = t & 31;
  const int k0 = kt * BM;
  const float scale2 = a.scale * kLog2e;
  const bf16* q = a.q + b * a.q_sb + (long long)h * D;
  const bf16* k = a.k + b * a.k_sb + (long long)h * D;
  const bf16* v = a.v + b * a.v_sb + (long long)h * D;
  const bf16* dout = a.dout + b * a.o_sb + (long long)h * D;
  const float* lse = a.lse + (long long)b * a.S * a.H + h;
  const float* delta = a.delta + (long long)b * a.S * a.H + h;

  const int q_first = a.causal ? kt : 0;
  const int n_it = a.S / BM - q_first;
  auto issue_stage = [&](int st, int qt) {
    const uint32_t sq = sStage + st * 2 * TILE;
    load_tile<D, BM, NT>(sq, q, a.q_ss, qt * BM);
    load_tile<D, BM, NT>(sq + TILE, dout, a.o_ss, qt * BM);
    load_rows<BM>(sRows + st * 8 * BM, lse, a.H, qt * BM);
    load_rows<BM>(sRows + st * 8 * BM + 4 * BM, delta, a.H, qt * BM);
  };
  load_tile<D, BM, NT>(sK, k, a.k_ss, k0);
  load_tile<D, BM, NT>(sV, v, a.v_ss, k0);
  issue_stage(0, q_first);
  cp_async_commit();

  float acc_k[NO], acc_v[NO], s[NS], dp[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int qt = q_first + it;
    const int st = it & 1;
    if (it + 1 < n_it) issue_stage(st ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();   // every copy but tile it + 1's has landed
    fence_proxy_async();
    __syncthreads();

    const uint32_t sQ = sStage + st * 2 * TILE;
    const uint32_t sdO = sQ + TILE;
    const float* s_lse = rows + st * 2 * BM;
    const float* s_delta = s_lse + BM;

    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 K rows
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BM>(s, desc_k<BM>(sK, 64 * wg, kk), desc_k<BM>(sQ, 0, kk),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BM>(dp, desc_k<BM>(sV, 64 * wg, kk), desc_k<BM>(sdO, 0, kk),
                   kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(s);
    fence_regs(dp);

    // accumulator i: K row 64 wg + 16 w + l / 4 + 8 ((i >> 1) & 1),
    // q column 8 (i >> 2) + 2 (l & 3) + (i & 1)
    const bool diag = a.causal && qt == kt;
    uint32_t fp[KS][4], fds[KS][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * (l & 3) + e;
        const float l2 = s_lse[c] * kLog2e;
        const float dl = s_delta[c];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          const int r = 64 * wg + 16 * w + (l >> 2) + 8 * hh;
          const float p =
              (diag && r > c) ? 0.f : exp2f(fmaf(s[i], scale2, -l2));
          s[i] = p;
          dp[i] = p * (dp[i] - dl);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        fp[kk][m] = pack_bf16(s[8 * kk + 2 * m], s[8 * kk + 2 * m + 1]);
        fds[kk][m] = pack_bf16(dp[8 * kk + 2 * m], dp[8 * kk + 2 * m + 1]);
      }

    // dV += P^T dO, dK += dS^T Q (B read transposed from the q-side tiles)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<D>(acc_v, fp[kk], desc_t<BM>(sdO, kk));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<D>(acc_k, fds[kk], desc_t<BM>(sQ, kk));
    wg_commit();
    wg_wait0();
    fence_regs(acc_v);
    fence_regs(acc_k);
    __syncthreads();   // the stage is free for the copies of tile it + 2
  }

  store_rows<D, D>(a.dk, acc_k, a.scale, b, a.S, a.H, h, k0 + 64 * wg, 0);
  store_rows<D, D>(a.dv, acc_v, 1.f, b, a.S, a.H, h, k0 + 64 * wg, 0);
}

// C2 at D 64 and 128: grid (S / BM, H, B), 2 * BM threads; block x owns
// q rows of tile S / BM - 1 - x (the longest causal scans start first),
// warpgroup wg the 64 rows from 64 wg.
template <int D, int BM>
__device__ __forceinline__ void dq_by_rows(const TcArgs& a) {
  constexpr int NT = 2 * BM;
  constexpr int TILE = BM * D * 2;
  constexpr int NS = BM / 2;
  constexpr int NO = D / 2;
  constexpr int KS = BM / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = base + TILE, sStage = base + 2 * TILE;
  const uint32_t sRows = base + 6 * TILE;
  const float* rows =
      reinterpret_cast<const float*>(smem_raw + (sRows - raw));

  const int n_t = a.S / BM;
  const int qt = n_t - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x & 127;
  const int wg = threadIdx.x >> 7;
  const int w = t >> 5;
  const int l = t & 31;
  const int q0 = qt * BM;
  const float scale2 = a.scale * kLog2e;
  const bf16* q = a.q + b * a.q_sb + (long long)h * D;
  const bf16* k = a.k + b * a.k_sb + (long long)h * D;
  const bf16* v = a.v + b * a.v_sb + (long long)h * D;
  const bf16* dout = a.dout + b * a.o_sb + (long long)h * D;
  const float* lse = a.lse + (long long)b * a.S * a.H + h;
  const float* delta = a.delta + (long long)b * a.S * a.H + h;

  const int n_it = a.causal ? qt + 1 : n_t;
  auto issue_stage = [&](int st, int kt) {
    const uint32_t sk = sStage + st * 2 * TILE;
    load_tile<D, BM, NT>(sk, k, a.k_ss, kt * BM);
    load_tile<D, BM, NT>(sk + TILE, v, a.v_ss, kt * BM);
  };
  load_tile<D, BM, NT>(sQ, q, a.q_ss, q0);
  load_tile<D, BM, NT>(sdO, dout, a.o_ss, q0);
  load_rows<BM>(sRows, lse, a.H, q0);
  load_rows<BM>(sRows + 4 * BM, delta, a.H, q0);
  issue_stage(0, 0);
  cp_async_commit();

  float acc_q[NO], s[NS], dp[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc_q[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
  // this thread's two q rows (local), their base-2 lse and delta
  const int r_lo = 64 * wg + 16 * w + (l >> 2);
  float l2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};

  for (int it = 0; it < n_it; ++it) {
    const int kt = it;
    const int st = it & 1;
    if (it + 1 < n_it) issue_stage(st ^ 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l2[hh] = rows[r_lo + 8 * hh] * kLog2e;
        dl[hh] = rows[BM + r_lo + 8 * hh];
      }
    }

    const uint32_t sK = sStage + st * 2 * TILE;
    const uint32_t sV = sK + TILE;

    // S = Q K^T and dP = dO V^T for this warpgroup's 64 q rows
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BM>(s, desc_k<BM>(sQ, 64 * wg, kk), desc_k<BM>(sK, 0, kk),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BM>(dp, desc_k<BM>(sdO, 64 * wg, kk), desc_k<BM>(sV, 0, kk),
                   kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(s);
    fence_regs(dp);

    // accumulator i: q row r_lo + 8 ((i >> 1) & 1), K column
    // 8 (i >> 2) + 2 (l & 3) + (i & 1)
    const bool diag = a.causal && kt == qt;
    uint32_t fds[KS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int hh = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
      const float p = (diag && c > r_lo + 8 * hh)
                          ? 0.f
                          : exp2f(fmaf(s[i], scale2, -l2[hh]));
      dp[i] = p * (dp[i] - dl[hh]);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        fds[kk][m] = pack_bf16(dp[8 * kk + 2 * m], dp[8 * kk + 2 * m + 1]);

    // dQ += dS K (K read transposed)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<D>(acc_q, fds[kk], desc_t<BM>(sK, kk));
    wg_commit();
    wg_wait0();
    fence_regs(acc_q);
    __syncthreads();
  }

  store_rows<D, D>(a.dq, acc_q, a.scale, b, a.S, a.H, h, q0 + 64 * wg, 0);
}

// C3 at D 256: grid (S / 64, H, B), 256 threads; block kt owns K rows
// [kt 64, kt 64 + 64), both warpgroups all of them.  Warpgroup 0 forms
// S^T and P^T, hands P^T over through shared memory and sums dV;
// warpgroup 1 forms dP^T, then dS^T from the P^T it is handed, and sums
// dK.  Each holds its sum as two m64n128 accumulators.
template <int BM>
__device__ __forceinline__ void dkv_by_halves(const TcArgs& a) {
  constexpr int D = 256;
  constexpr int NT = 256;
  constexpr int TILE = BM * D * 2;
  constexpr int NS = BM / 2;
  constexpr int KS = BM / 16;
  static_assert(BM == 64, "one 64-row tile for both warpgroups");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + TILE, sStage = base + 2 * TILE;
  const uint32_t sRows = base + 6 * TILE;
  const float* rows =
      reinterpret_cast<const float*>(smem_raw + (sRows - raw));
  // P^T, entry i of thread t at [i][t]
  float* xp = reinterpret_cast<float*>(smem_raw + (sRows + 16 * BM - raw));

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x & 127;
  const int wg = threadIdx.x >> 7;
  const int w = t >> 5;
  const int l = t & 31;
  const int k0 = kt * BM;
  const float scale2 = a.scale * kLog2e;
  const bf16* q = a.q + b * a.q_sb + (long long)h * D;
  const bf16* k = a.k + b * a.k_sb + (long long)h * D;
  const bf16* v = a.v + b * a.v_sb + (long long)h * D;
  const bf16* dout = a.dout + b * a.o_sb + (long long)h * D;
  const float* lse = a.lse + (long long)b * a.S * a.H + h;
  const float* delta = a.delta + (long long)b * a.S * a.H + h;

  const int q_first = a.causal ? kt : 0;
  const int n_it = a.S / BM - q_first;
  auto issue_stage = [&](int st, int qt) {
    const uint32_t sq = sStage + st * 2 * TILE;
    load_tile<D, BM, NT>(sq, q, a.q_ss, qt * BM);
    load_tile<D, BM, NT>(sq + TILE, dout, a.o_ss, qt * BM);
    load_rows<BM>(sRows + st * 8 * BM, lse, a.H, qt * BM);
    load_rows<BM>(sRows + st * 8 * BM + 4 * BM, delta, a.H, qt * BM);
  };
  load_tile<D, BM, NT>(sK, k, a.k_ss, k0);
  load_tile<D, BM, NT>(sV, v, a.v_ss, k0);
  issue_stage(0, q_first);
  cp_async_commit();

  // warpgroup 0: dV, warpgroup 1: dK, columns [0, 128) and [128, 256)
  float acc_lo[64], acc_hi[64], s[NS];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_lo[i] = acc_hi[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int qt = q_first + it;
    const int st = it & 1;
    if (it + 1 < n_it) issue_stage(st ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    const uint32_t sQ = sStage + st * 2 * TILE;
    const uint32_t sdO = sQ + TILE;
    const float* s_lse = rows + st * 2 * BM;
    const float* s_delta = s_lse + BM;

    // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T
    const uint32_t sA = wg ? sV : sK;
    const uint32_t sB = wg ? sdO : sQ;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BM>(s, desc_k<BM>(sA, 0, kk), desc_k<BM>(sB, 0, kk), kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // accumulator i: K row 16 w + l / 4 + 8 ((i >> 1) & 1), q column
    // 8 (i >> 2) + 2 (l & 3) + (i & 1)
    const bool diag = a.causal && qt == kt;
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
        const int r = 16 * w + (l >> 2) + 8 * ((i >> 1) & 1);
        const float p = (diag && r > c)
                            ? 0.f
                            : exp2f(fmaf(s[i], scale2, -s_lse[c] * kLog2e));
        s[i] = p;
        xp[i * 128 + t] = p;
      }
    }
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
        s[i] = xp[i * 128 + t] * (s[i] - s_delta[c]);
      }
    }
    uint32_t f[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        f[kk][m] = pack_bf16(s[8 * kk + 2 * m], s[8 * kk + 2 * m + 1]);

    // dV += P^T dO (warpgroup 0), dK += dS^T Q (warpgroup 1), B read
    // transposed, 128 columns (two 64-column atoms) at a time
    const uint32_t sO = wg ? sQ : sdO;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<128>(acc_lo, f[kk], desc_t<BM>(sO, kk));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<128>(acc_hi, f[kk], desc_t<BM>(sO + 2 * BM * 128, kk));
    wg_commit();
    wg_wait0();
    fence_regs(acc_lo);
    fence_regs(acc_hi);
    __syncthreads();   // the stage and the P^T exchange are free again
  }

  bf16* out = wg ? a.dk : a.dv;
  const float mul = wg ? a.scale : 1.f;
  store_rows<D, 128>(out, acc_lo, mul, b, a.S, a.H, h, k0, 0);
  store_rows<D, 128>(out, acc_hi, mul, b, a.S, a.H, h, k0, 128);
}

// C2 at D 256: grid (S / 64, H, B), 256 threads; block x owns q rows of
// tile S / 64 - 1 - x, both warpgroups all of them.  Warpgroup 0 forms S
// and P, warpgroup 1 dP; they exchange P and dP through shared memory,
// both form the same dS (the same f32 operations on the same values), and
// warpgroup wg sums dQ's columns [128 wg, 128 wg + 128).
template <int BM>
__device__ __forceinline__ void dq_by_halves(const TcArgs& a) {
  constexpr int D = 256;
  constexpr int NT = 256;
  constexpr int TILE = BM * D * 2;
  constexpr int NS = BM / 2;
  constexpr int KS = BM / 16;
  static_assert(BM == 64, "one 64-row tile for both warpgroups");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = base + TILE, sStage = base + 2 * TILE;
  const uint32_t sRows = base + 6 * TILE;
  const float* rows =
      reinterpret_cast<const float*>(smem_raw + (sRows - raw));
  // P (from warpgroup 0) and dP (from warpgroup 1), entry i of thread t
  // at [i][t]
  float* xp = reinterpret_cast<float*>(smem_raw + (sRows + 16 * BM - raw));
  float* xdp = xp + NS * 128;

  const int n_t = a.S / BM;
  const int qt = n_t - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x & 127;
  const int wg = threadIdx.x >> 7;
  const int w = t >> 5;
  const int l = t & 31;
  const int q0 = qt * BM;
  const float scale2 = a.scale * kLog2e;
  const bf16* q = a.q + b * a.q_sb + (long long)h * D;
  const bf16* k = a.k + b * a.k_sb + (long long)h * D;
  const bf16* v = a.v + b * a.v_sb + (long long)h * D;
  const bf16* dout = a.dout + b * a.o_sb + (long long)h * D;
  const float* lse = a.lse + (long long)b * a.S * a.H + h;
  const float* delta = a.delta + (long long)b * a.S * a.H + h;

  const int n_it = a.causal ? qt + 1 : n_t;
  auto issue_stage = [&](int st, int kt) {
    const uint32_t sk = sStage + st * 2 * TILE;
    load_tile<D, BM, NT>(sk, k, a.k_ss, kt * BM);
    load_tile<D, BM, NT>(sk + TILE, v, a.v_ss, kt * BM);
  };
  load_tile<D, BM, NT>(sQ, q, a.q_ss, q0);
  load_tile<D, BM, NT>(sdO, dout, a.o_ss, q0);
  load_rows<BM>(sRows, lse, a.H, q0);
  load_rows<BM>(sRows + 4 * BM, delta, a.H, q0);
  issue_stage(0, 0);
  cp_async_commit();

  float acc[64], s[NS];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
  // this thread's two q rows (local), their base-2 lse and delta
  const int r_lo = 16 * w + (l >> 2);
  float l2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};

  for (int it = 0; it < n_it; ++it) {
    const int kt = it;
    const int st = it & 1;
    if (it + 1 < n_it) issue_stage(st ^ 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l2[hh] = rows[r_lo + 8 * hh] * kLog2e;
        dl[hh] = rows[BM + r_lo + 8 * hh];
      }
    }

    const uint32_t sK = sStage + st * 2 * TILE;
    const uint32_t sV = sK + TILE;

    // warpgroup 0: S = Q K^T; warpgroup 1: dP = dO V^T
    const uint32_t sA = wg ? sdO : sQ;
    const uint32_t sB = wg ? sV : sK;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BM>(s, desc_k<BM>(sA, 0, kk), desc_k<BM>(sB, 0, kk), kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // accumulator i: q row r_lo + 8 ((i >> 1) & 1), K column
    // 8 (i >> 2) + 2 (l & 3) + (i & 1)
    const bool diag = a.causal && kt == qt;
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int hh = (i >> 1) & 1;
        const int c = 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
        s[i] = (diag && c > r_lo + 8 * hh)
                   ? 0.f
                   : exp2f(fmaf(s[i], scale2, -l2[hh]));
        xp[i * 128 + t] = s[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) xdp[i * 128 + t] = s[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int hh = (i >> 1) & 1;
      const float p = wg ? xp[i * 128 + t] : s[i];
      const float dpv = wg ? s[i] : xdp[i * 128 + t];
      s[i] = p * (dpv - dl[hh]);
    }
    uint32_t f[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        f[kk][m] = pack_bf16(s[8 * kk + 2 * m], s[8 * kk + 2 * m + 1]);

    // dQ[:, 128 wg : 128 wg + 128] += dS K[:, those columns] (K read
    // transposed, two of its four 64-column atoms)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<128>(acc, f[kk], desc_t<BM>(sK + wg * 2 * BM * 128, kk));
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    __syncthreads();   // the stage and the exchange are free again
  }

  store_rows<D, 128>(a.dq, acc, a.scale, b, a.S, a.H, h, q0, 128 * wg);
}

template <int D, int BM>
__global__ void __launch_bounds__(tc_threads(D, BM), 1)
flash_bwd_dkv_tc_kernel(const TcArgs a) {
  if constexpr (D == 256)
    dkv_by_halves<BM>(a);
  else
    dkv_by_rows<D, BM>(a);
}

template <int D, int BM>
__global__ void __launch_bounds__(tc_threads(D, BM), 1)
flash_bwd_dq_tc_kernel(const TcArgs a) {
  if constexpr (D == 256)
    dq_by_halves<BM>(a);
  else
    dq_by_rows<D, BM>(a);
}

template <typename Kernel>
int launch(Kernel kernel, bool& smem_set, int smem, int threads, dim3 grid,
           const TcArgs& a, cudaStream_t stream) {
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, int BM>
int dispatch(bool dkv, int B, const TcArgs& a, cudaStream_t stream) {
  static bool set_dq = false, set_dkv = false;
  const dim3 grid(a.S / BM, a.H, B);
  if (dkv)
    return launch(flash_bwd_dkv_tc_kernel<D, BM>, set_dkv,
                  tc_smem_bytes(D, BM), tc_threads(D, BM), grid, a, stream);
  return launch(flash_bwd_dq_tc_kernel<D, BM>, set_dq, tc_smem_bytes(D, BM),
                tc_threads(D, BM), grid, a, stream);
}

}  // namespace

// The instantiated (D, tile) pairs: 64 or 128 at D = 64, 64 at D = 128
// and 256.
// Every q/k/v/dout row must start on 16 bytes (the copies' unit).
// Returns the launch's cudaError_t.
int flash_bwd_tc_launch(bool dkv, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* dq, void* dk, void* dv,
                        int B, int S, int H, int D, long long q_sb,
                        long long q_ss, long long k_sb, long long k_ss,
                        long long v_sb, long long v_ss, long long o_sb,
                        long long o_ss, int causal, float scale, int block,
                        void* stream) {
  if (S <= 0 || B <= 0 || H <= 0 || block <= 0 || S % block != 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)dout;
  if ((ptrs & 15) || ((q_sb | q_ss | k_sb | k_ss | v_sb | v_ss | o_sb |
                       o_ss) & 7))
    return (int)cudaErrorMisalignedAddress;
  const TcArgs a{static_cast<const bf16*>(q),
                 static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v),
                 static_cast<const bf16*>(dout),
                 lse,
                 delta,
                 static_cast<bf16*>(dq),
                 static_cast<bf16*>(dk),
                 static_cast<bf16*>(dv),
                 S,
                 H,
                 q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss,
                 causal,
                 scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 && block == 64) return dispatch<64, 64>(dkv, B, a, st);
  if (D == 64 && block == 128) return dispatch<64, 128>(dkv, B, a, st);
  if (D == 128 && block == 64) return dispatch<128, 64>(dkv, B, a, st);
  if (D == 256 && block == 64) return dispatch<256, 64>(dkv, B, a, st);
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one launch of C2 or C3 asks for at head
// dim D and tile `block` (tc_smem_bytes).
extern "C" long long paddle_flash_bwd_tc_smem(int D, int block) {
  return tc_smem_bytes(D, block);
}
