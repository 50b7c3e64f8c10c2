// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the three backward kernels of
// paddle_tpu/kernels/flash_attention_pallas.py:
//   C1 paddle_flash_bwd      <- _bwd_kernel      (merged dQ/dK/dV)
//   C2 paddle_flash_bwd_dq   <- _bwd_dq_kernel   (split backward, dQ)
//   C3 paddle_flash_bwd_dkv  <- _bwd_dkv_kernel  (split backward, dK/dV)
// This file holds the entry points and the float32 kernels; bf16 and fp16
// calls of all three go to the tensor-core kernels of flash_bwd_tc.cu.
// Per (batch, head) they compute, from q, k, v, dO, the base-e row
// logsumexp that the forward saved and delta = rowsum(dO * O) (minus the
// lse cotangent, folded in by the caller):
//   P  = exp2(scale * log2e * Q K^T - lse * log2e)   (P recomputed, base 2)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),
//   dK = scale * dS^T Q,  dQ = scale * dS K
// with the start-aligned causal mask when asked: tiles strictly in the
// future are never visited and only the diagonal tile masks.
//
// Products: 3 x TF32 on the tensor cores.  Each f32 operand x is split
// into big = tf32(x) and small = tf32(x - big) (cvt.rna's rounding: 10
// mantissa bits, to nearest, ties away from zero), and a b is summed as
// a.small b.big + a.big b.small + a.big b.big by three
// mma.sync.m16n8k8 TF32 products into f32 registers, the small terms
// first, as CUTLASS's OpMultiplyAddFastF32 (the operator of PyTorch's f32
// memory-efficient attention).  Only small x small, about 2^-22 of each
// product, and the rounding of the small parts are lost: the results stay
// within the f32 bars of the plain version, where one TF32 product (about
// 2^-11) would not.  Operands are split in registers as each fragment is
// loaded.
//
// Design.  The TPU kernels walk a sequential grid and carry sums in VMEM
// scratch from one grid step to the next; Hopper blocks run in parallel
// in no order, so a loop inside the block takes the place of the
// sequential grid dimension.  Tiles are square, BM rows (64 or 32 up to D
// 128, 32 at D 256), f32 in shared memory with rows padded by 16 bytes:
// every fragment load of every product, along the rows or down them, is
// free of bank conflicts, and the tiles are filled by 16-byte cp.async
// copies into a two-stage ring, tile t + 1 issued while tile t computes.
//   C1/C3: one block per (batch, head, K tile) holds K and V and loops
//          over the q tiles that see it (Q, dO, lse and delta rows in the
//          ring).  Each 16-row slab of the K tile has two warps: one
//          forms S^T = K Q^T and P^T in its accumulators, hands P^T to the
//          other through shared memory (a named barrier of the pair) and
//          sums dV += P^T dO; the other forms dP^T = V dO^T, then dS^T,
//          and sums dK += dS^T Q.  P^T and dS^T feed their products from
//          the accumulators: the m16n8 accumulator holds columns (2t,
//          2t+1) where the k8 A fragment wants (t, t+4), so the k step
//          takes its columns in that permuted order and the B fragment,
//          loaded from shared memory, reads its rows in the same order.
//          C1 also writes dS^T to one shared tile (over the exchange) and
//          all warps form the q tile's dQ share, scale folded in, added
//          into an f32 (B, S, H, D) workspace by 16-byte atomics: the
//          order of those additions, and so the last bits of dQ, vary
//          from run to run.  One block barrier per q tile (C1: two).
//   C2:    one block per (batch, head, q tile) holds Q, dO and the rows'
//          lse and delta, loops over the K tiles up to the diagonal (K, V
//          in the ring; the block with the most tiles first), two warps
//          per 16 q rows, each on half of the tile's keys: S = Q K^T and
//          dP = dO V^T, dS in the accumulators, dQ += dS K; the two
//          shares are added in a fixed order at the end.  C2 and C3 are
//          deterministic.
//
// Bound on the H100 SXM (495 TFLOP/s TF32 dense, so 165 TFLOP/s for
// three products; 3.35 TB/s): at the training shape B=8, S=1024, H=16,
// D=64 causal f32 C1's five products need 5 * 2 S^2 D * B H / 2 = 4.3e10
// FLOP, 1.3e11 as TF32 products (0.260 ms; 0.642 ms on the 67 TFLOP/s
// f32 FMAs), against ~235 MB of operands (0.070 ms): bound by the tensor
// cores.  The measured times stand in PERF.md.

#include "wgmma_common.cuh"

// flash_bwd_tc.cu: bf16 / fp16 C1 (which 0), C2 (1), C3 (2)
int flash_bwd_tc_launch(int which, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* dq, float* dq_acc,
                        void* dk, void* dv,
                        int B, int S, int H, int D, long long q_sb,
                        long long q_ss, long long k_sb, long long k_ss,
                        long long v_sb, long long v_ss, long long o_sb,
                        long long o_ss, int causal, float scale, int dtype,
                        int block, void* stream);

namespace {

// ---- 3 x TF32 on mma.sync --------------------------------------------------

// TF32 rounding of finite x as cvt.rna.tf32.f32 gives it (10 mantissa
// bits, to nearest, ties away from zero), in two integer operations where
// cvt takes more: half an ulp added to the magnitude bits; the TF32
// products read only the top 19 bits, so the 13 low ones are cleared
// only where the value itself is used (x - big).
__device__ __forceinline__ uint32_t tf32_rna_bits(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// A fragment (m16 x k8) and B fragment (k8 x n8) of mma.m16n8k8, each
// value split into its big and small TF32 parts.  Lane l = 4 g + t holds
// A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) and B (t, g),
// (t + 4, g) of the k slots; accumulators (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna_bits(x) & 0xffffe000u;
  lo = tf32_rna_bits(x - __uint_as_float(hi));
}
__device__ __forceinline__ FragA frag_a(float x0, float x1, float x2,
                                        float x3) {
  FragA f;
  split_tf32(x0, f.hi[0], f.lo[0]);
  split_tf32(x1, f.hi[1], f.lo[1]);
  split_tf32(x2, f.hi[2], f.lo[2]);
  split_tf32(x3, f.hi[3], f.lo[3]);
  return f;
}
__device__ __forceinline__ FragB frag_b(float y0, float y1) {
  FragB f;
  split_tf32(y0, f.hi[0], f.lo[0]);
  split_tf32(y1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b as 3 x TF32: the cross terms first, then big x big
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// ---- padded f32 tiles ------------------------------------------------------

// Rows of a W-float tile are W + 4 floats apart: 16-byte aligned for the
// copies, and 4 banks on from the row before (W a multiple of 32), so a
// fragment read along the rows (lane g, t at row g, column t: bank
// 4 g + t) or down them in the permuted order (row 2t or 2t + 1, column
// g: bank 8 t + g or 8 t + 4 + g) touches 32 banks.
template <int W>
__device__ __forceinline__ int at(int r, int c) {
  return r * (W + 4) + c;
}

// A = rows [r0, r0 + 16) x columns [k0, k0 + 8) of a W-wide tile
template <int W>
__device__ __forceinline__ FragA load_a(const float* X, int r0, int k0,
                                        int g, int t) {
  return frag_a(X[at<W>(r0 + g, k0 + t)], X[at<W>(r0 + g + 8, k0 + t)],
                X[at<W>(r0 + g, k0 + t + 4)],
                X[at<W>(r0 + g + 8, k0 + t + 4)]);
}
// B = X^T: B[k][n] = X[n0 + n][k0 + k], rows of a W-wide tile
template <int W>
__device__ __forceinline__ FragB load_bt(const float* X, int n0, int k0,
                                         int g, int t) {
  return frag_b(X[at<W>(n0 + g, k0 + t)], X[at<W>(n0 + g, k0 + t + 4)]);
}
// B[k][n] = X[k0 + k][n0 + n] in the permuted k order of an A taken from
// an accumulator (slot t is row 2t, slot t + 4 row 2t + 1)
template <int W>
__device__ __forceinline__ FragB load_bp(const float* X, int k0, int n0,
                                         int g, int t) {
  return frag_b(X[at<W>(k0 + 2 * t, n0 + g)],
                X[at<W>(k0 + 2 * t + 1, n0 + g)]);
}
// A[m][k] = X[k0 + k][m0 + m] in the same permuted k order
template <int W>
__device__ __forceinline__ FragA load_ap_t(const float* X, int m0, int k0,
                                           int g, int t) {
  return frag_a(X[at<W>(k0 + 2 * t, m0 + g)],
                X[at<W>(k0 + 2 * t, m0 + g + 8)],
                X[at<W>(k0 + 2 * t + 1, m0 + g)],
                X[at<W>(k0 + 2 * t + 1, m0 + g + 8)]);
}
// A from an m16 x n8 accumulator, its 8 columns one k step in the
// permuted order
__device__ __forceinline__ FragA acc_a(const float (&c)[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

// acc[n] += sum_kk A(a[kk]) X[8 kk .., 8 n ..]: an output slab's share of
// one tile (dV += P^T dO, dK += dS^T Q, dQ += dS K), A from the
// accumulators a and B read down the rows of the W-wide tile X.  The
// tensor cores' adds truncate (round toward zero), so the hundreds of
// products of the whole loop chained into one accumulator would drift
// (5x the f32 bar at S = 1024); the share of one tile, BM / 8 k steps, is
// summed in fresh accumulators, 64 columns at a time, and added to acc in
// f32.
template <int NJ, int ND, int W>
__device__ __forceinline__ void acc_tile(float (&acc)[ND][4],
                                         const float (&a)[NJ][4],
                                         const float* X, int g, int t) {
  constexpr int CN = ND < 8 ? ND : 8;
#pragma unroll
  for (int c = 0; c < ND; c += CN) {
    float part[CN][4];
#pragma unroll
    for (int n = 0; n < CN; ++n)
      part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      const FragA fa = acc_a(a[kk]);
#pragma unroll
      for (int n = 0; n < CN; ++n)
        mma3(part[n], fa, load_bp<W>(X, 8 * kk, 8 * (c + n), g, t));
    }
#pragma unroll
    for (int n = 0; n < CN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c + n][e] += part[n][e];
  }
}

// Issue the 16-byte copies of rows [row0, row0 + R) of one head (D
// contiguous f32, 16-byte aligned, rows `row_stride` elements apart) into
// a padded R x D tile.
template <int D, int R, int NT>
__device__ __forceinline__ void copy_tile(float* tile, const float* g,
                                          long long row_stride, int row0) {
  constexpr int CH = D / 4;
  static_assert((R * CH) % NT == 0, "tile copies split evenly");
#pragma unroll 4
  for (int i = 0; i < R * CH / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / CH;
    const int c = e % CH;
    cp_async16(smem_u32(tile + at<D>(r, 4 * c)),
               g + (long long)(row0 + r) * row_stride + c * 4);
  }
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Store a warp's 16 x D accumulator rows (rows r, r + 8 of lane g, t) times
// `mul` into dense (B, S, H, D) f32 at (b, h), rows from row0.
template <int D>
__device__ __forceinline__ void store_slab(float* out,
                                           const float (&acc)[D / 8][4],
                                           float mul, int b, int S, int H,
                                           int h, int row0, int g, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float* row = out + (((long long)b * S + row0 + g + 8 * hh) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n + 2 * t) =
          make_float2(acc[n][2 * hh] * mul, acc[n][2 * hh + 1] * mul);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // (B, S, H) base-e
  const float* delta;   // (B, S, H)
  void* dq;             // (B, S, H, D) (C2)
  float* dq_acc;        // (B, S, H, D) f32 workspace (C1)
  void* dk;             // (B, S, H, D) (C1, C3)
  void* dv;
  int B, S, H;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  int causal;
  float scale;
};

// threads and dynamic shared memory of one launch.  C1/C3: two warps a
// 16-row slab; K, V, two stages of Q and dO (padded BM x D f32 each), the
// BM x BM P^T exchange (C1: the dS^T tile too) and two stages of the lse
// and delta rows.  C2: two warps a 16-row slab; Q, dO, two stages of K
// and V, the resident lse and delta rows.
__host__ __device__ constexpr int kv_threads(int BM) { return 4 * BM; }
// C1/C3 blocks an SM must hold: three of the 128-thread D 64 blocks (at
// most 170 registers a thread), as their shared memory allows
__host__ __device__ constexpr int kv_min_blocks(int D, int BM) {
  return D == 64 && BM == 32 ? 3 : 1;
}
__host__ __device__ constexpr int dq_threads(int BM) { return 4 * BM; }
// C2 blocks an SM must hold at D 64, as their shared memory allows (at
// most 128 registers a thread)
__host__ __device__ constexpr int dq_min_blocks(int D, int BM) {
  return D == 64 ? (BM == 64 ? 2 : 4) : 1;
}
constexpr size_t kv_smem_bytes(int D, int BM) {
  return 4 * (size_t)(6 * BM * (D + 4) + BM * (BM + 4) + 4 * BM);
}
constexpr size_t dq_smem_bytes(int D, int BM) {
  return 4 * (size_t)(6 * BM * (D + 4) + 2 * BM);
}

// C1: dQ of the q tile's rows [q0, q0 + BM) = scale dS K, dS read from the
// dS^T tile.  Warp w takes the 16 q rows from 16 (w % (BM / 16)) and half
// of D's columns, in chunks of up to 64, each added into the f32 workspace
// by 16-byte atomics: a lane holds two adjacent columns of rows g and
// g + 8 and swaps one pair with its neighbour in the quad, so that each
// adds four adjacent columns of one row.
template <int D, int BM>
__device__ __forceinline__ void dq_share(const Args& a, const float* sDS,
                                         const float* sK, int warp, int g,
                                         int t, int b, int h, int q0) {
  constexpr int SLABS = BM / 16;
  constexpr int HALF = D / 2;
  constexpr int CW = HALF < 64 ? HALF : 64;
  const int m0 = 16 * (warp % SLABS);
  const int c_first = HALF * (warp / SLABS);
  const bool odd = t & 1;
  float* row = a.dq_acc +
               (((long long)b * a.S + q0 + m0 + g + (odd ? 8 : 0)) * a.H + h) *
                   D;
#pragma unroll 1
  for (int c0 = c_first; c0 < c_first + HALF; c0 += CW) {
    float dq[CW / 8][4];
#pragma unroll
    for (int n = 0; n < CW / 8; ++n)
      dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BM / 8; ++kk) {
      const FragA fa = load_ap_t<BM>(sDS, m0, 8 * kk, g, t);
#pragma unroll
      for (int n = 0; n < CW / 8; ++n)
        mma3(dq[n], fa, load_bp<D>(sK, 8 * kk, c0 + 8 * n, g, t));
    }
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) {
      const float x0 = __shfl_xor_sync(0xffffffffu, odd ? dq[n][0] : dq[n][2], 1);
      const float x1 = __shfl_xor_sync(0xffffffffu, odd ? dq[n][1] : dq[n][3], 1);
      const float4 v = odd ? make_float4(x0, x1, dq[n][2], dq[n][3])
                           : make_float4(dq[n][0], dq[n][1], x0, x1);
      atomicAdd(reinterpret_cast<float4*>(row + c0 + 8 * n + 2 * (t & 2)),
                make_float4(v.x * a.scale, v.y * a.scale, v.z * a.scale,
                            v.w * a.scale));
    }
  }
}

// C1 (kWithDq) and C3: grid (S / BM, H, B), kv_threads(BM) threads; block
// kt owns K rows [kt BM, kt BM + BM).  Warp w works on the slab of 16 K
// rows from 16 (w % (BM / 16)): the first BM / 16 warps form P^T and sum
// dV, the others form dS^T and sum dK.
template <int D, int BM, bool kWithDq>
__global__ void __launch_bounds__(kv_threads(BM), kv_min_blocks(D, BM))
flash_bwd_kv_kernel(const Args a) {
  constexpr int NT = kv_threads(BM);
  constexpr int SLABS = BM / 16;
  constexpr int NJ = BM / 8;   // n8 tiles of a slab's scores
  constexpr int ND = D / 8;    // n8 tiles of a slab's dK or dV
  constexpr int TILE = BM * (D + 4);
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + TILE;
  float* sStage = sV + TILE;             // two stages of (Q, dO)
  float* sRows = sStage + 4 * TILE;      // two stages of (lse, delta)
  float* sX = sRows + 4 * BM;            // P^T exchange; C1: dS^T tile

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int role = warp / SLABS;   // 0: P^T and dV; 1: dS^T and dK
  const int slab = warp % SLABS;
  const int r0 = 16 * slab;
  const int k0 = kt * BM;
  const float scale2 = a.scale * kLog2e;
  const float* q =
      static_cast<const float*>(a.q) + b * a.q_sb + (long long)h * D;
  const float* k =
      static_cast<const float*>(a.k) + b * a.k_sb + (long long)h * D;
  const float* v =
      static_cast<const float*>(a.v) + b * a.v_sb + (long long)h * D;
  const float* dout =
      static_cast<const float*>(a.dout) + b * a.o_sb + (long long)h * D;
  const float* lse = a.lse + (long long)b * a.S * a.H + h;
  const float* delta = a.delta + (long long)b * a.S * a.H + h;

  const int q_first = a.causal ? kt : 0;
  const int n_it = a.S / BM - q_first;
  auto issue = [&](int st, int qt) {
    float* sq = sStage + st * 2 * TILE;
    copy_tile<D, BM, NT>(sq, q, a.q_ss, qt * BM);
    copy_tile<D, BM, NT>(sq + TILE, dout, a.o_ss, qt * BM);
    load_rows<BM>(smem_u32(sRows + st * 2 * BM), lse, a.H, qt * BM);
    load_rows<BM>(smem_u32(sRows + st * 2 * BM + BM), delta, a.H, qt * BM);
  };
  copy_tile<D, BM, NT>(sK, k, a.k_ss, k0);
  copy_tile<D, BM, NT>(sV, v, a.v_ss, k0);
  issue(0, q_first);
  cp_async_commit();

  // role 0: dV, role 1: dK, of K rows r0 + g and r0 + g + 8
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // this slab's P^T exchange: n8 tile j of lane l at float4 [j][l]
  float4* xs = reinterpret_cast<float4*>(sX + r0 * (BM + 4));
  const float* sA = role ? sV : sK;   // the slab's S^T / dP^T operand

  for (int it = 0; it < n_it; ++it) {
    const int qt = q_first + it;
    const int st = it & 1;
    cp_async_wait<0>();
    __syncthreads();   // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_it) issue(st ^ 1, qt + 1);
    cp_async_commit();
    const float* sQ = sStage + st * 2 * TILE;
    const float* sdO = sQ + TILE;
    const float* s_lse = sRows + st * 2 * BM;
    const float* s_delta = s_lse + BM;
    const float* sB = role ? sdO : sQ;
    const bool diag = a.causal && qt == kt;

    // S^T = K Q^T (role 0) or dP^T = V dO^T (role 1) over the slab's rows
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const FragA fa = load_a<D>(sA, r0, 8 * kk, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma3(s[j], fa, load_bt<D>(sB, 8 * j, 8 * kk, g, t));
    }
    if (role == 0) {
      // P^T (key row r, query column c; hidden where r > c on the diagonal)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(s_lse + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const int r = r0 + g + 8 * (e >> 1);
          const float l2 = ((e & 1) ? l.y : l.x) * kLog2e;
          s[j][e] = (diag && r > c) ? 0.f : exp2f(fmaf(s[j][e], scale2, -l2));
        }
        xs[j * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      }
      bar_arrive(1 + slab, 64);
      acc_tile<NJ, ND, D>(acc, s, sdO, g, t);   // dV += P^T dO
    } else {
      bar_sync(1 + slab, 64);   // the pair's P^T is in the exchange
      // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 p = xs[j * 32 + lane];
        const float2 dl =
            *reinterpret_cast<const float2*>(s_delta + 8 * j + 2 * t);
        s[j][0] = p.x * (s[j][0] - dl.x);
        s[j][1] = p.y * (s[j][1] - dl.y);
        s[j][2] = p.z * (s[j][2] - dl.x);
        s[j][3] = p.w * (s[j][3] - dl.y);
      }
      if constexpr (kWithDq) {
        __syncwarp();   // every lane has read the exchange it overwrites
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sX[at<BM>(r0 + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1))] =
                s[j][e];
      }
      acc_tile<NJ, ND, D>(acc, s, sQ, g, t);    // dK += dS^T Q
    }
    if constexpr (kWithDq) {
      __syncthreads();   // the dS^T tile is whole
      dq_share<D, BM>(a, sX, sK, warp, g, t, b, h, qt * BM);
    }
  }

  store_slab<D>(static_cast<float*>(role ? a.dk : a.dv), acc,
                role ? a.scale : 1.f, b, a.S, a.H, h, k0 + r0, g, t);
}

// C2: grid (S / BM, H, B), dq_threads(BM) threads; block x owns the q rows
// of tile S / BM - 1 - x (the longest causal scans start first).  Each
// 16-row q slab has two warps, each taking half of every K tile's keys:
// warp w the rows from 16 (w % SLABS) and the keys from BM / 2 (w /
// SLABS); at the end the second adds its dQ share to the first's through
// shared memory, in that fixed order.
template <int D, int BM>
__global__ void __launch_bounds__(dq_threads(BM), dq_min_blocks(D, BM))
flash_bwd_dq_kernel(const Args a) {
  constexpr int NT = dq_threads(BM);
  constexpr int SLABS = BM / 16;
  constexpr int NJ = BM / 16;   // n8 tiles of a warp's half of the keys
  constexpr int ND = D / 8;
  constexpr int TILE = BM * (D + 4);
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + TILE;
  float* sStage = sdO + TILE;            // two stages of (K, V)
  float* sRows = sStage + 4 * TILE;      // lse, delta

  const int n_t = a.S / BM;
  const int qt = n_t - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int slab = warp % SLABS;
  const int r0 = 16 * slab;
  const int c0 = BM / 2 * (warp / SLABS);   // the warp's first key
  const int q0 = qt * BM;
  const float scale2 = a.scale * kLog2e;
  const float* q =
      static_cast<const float*>(a.q) + b * a.q_sb + (long long)h * D;
  const float* k =
      static_cast<const float*>(a.k) + b * a.k_sb + (long long)h * D;
  const float* v =
      static_cast<const float*>(a.v) + b * a.v_sb + (long long)h * D;
  const float* dout =
      static_cast<const float*>(a.dout) + b * a.o_sb + (long long)h * D;
  const float* lse = a.lse + (long long)b * a.S * a.H + h;
  const float* delta = a.delta + (long long)b * a.S * a.H + h;

  const int n_it = a.causal ? qt + 1 : n_t;
  auto issue = [&](int st, int kt) {
    float* sk = sStage + st * 2 * TILE;
    copy_tile<D, BM, NT>(sk, k, a.k_ss, kt * BM);
    copy_tile<D, BM, NT>(sk + TILE, v, a.v_ss, kt * BM);
  };
  copy_tile<D, BM, NT>(sQ, q, a.q_ss, q0);
  copy_tile<D, BM, NT>(sdO, dout, a.o_ss, q0);
  load_rows<BM>(smem_u32(sRows), lse, a.H, q0);
  load_rows<BM>(smem_u32(sRows + BM), delta, a.H, q0);
  issue(0, 0);
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // this lane's two q rows: base-2 lse and delta
  float l2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};

  for (int it = 0; it < n_it; ++it) {
    const int kt = it;
    const int st = it & 1;
    cp_async_wait<0>();
    __syncthreads();   // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_it) issue(st ^ 1, kt + 1);
    cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l2[hh] = sRows[r0 + g + 8 * hh] * kLog2e;
        dl[hh] = sRows[BM + r0 + g + 8 * hh];
      }
    }
    const float* sK = sStage + st * 2 * TILE;
    const float* sV = sK + TILE;
    const bool diag = a.causal && kt == qt;

    // S = Q K^T and dP = dO V^T over this warp's 16 q rows and its keys
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const FragA fq = load_a<D>(sQ, r0, 8 * kk, g, t);
      const FragA fo = load_a<D>(sdO, r0, 8 * kk, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mma3(s[j], fq, load_bt<D>(sK, c0 + 8 * j, 8 * kk, g, t));
        mma3(dp[j], fo, load_bt<D>(sV, c0 + 8 * j, 8 * kk, g, t));
      }
    }
    // dS = P (dP - delta), query row r, key column c; hidden where c > r on
    // the diagonal
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int c = c0 + 8 * j + 2 * t + (e & 1);
        const float p = (diag && c > r0 + g + 8 * hh)
                            ? 0.f
                            : exp2f(fmaf(s[j][e], scale2, -l2[hh]));
        dp[j][e] = p * (dp[j][e] - dl[hh]);
      }
    // dQ += dS K over the warp's keys
    acc_tile<NJ, ND, D>(acc, dp, sK + c0 * (D + 4), g, t);
  }

  // the second warp of each slab hands its share over the ring, free now
  cp_async_wait<0>();
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(sStage) + slab * ND * 32 + lane;
  if (warp >= SLABS) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
      red[n * 32] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
  }
  __syncthreads();
  if (warp < SLABS) {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float4 o = red[n * 32];
      acc[n][0] += o.x;
      acc[n][1] += o.y;
      acc[n][2] += o.z;
      acc[n][3] += o.w;
    }
    store_slab<D>(static_cast<float*>(a.dq), acc, a.scale, b, a.S, a.H, h,
                  q0 + r0, g, t);
  }
}

// Opt in to > 48 KB of dynamic shared memory once per instantiation (the
// call is idempotent, so a race between threads is harmless), then launch.
template <typename Kernel>
int launch(Kernel kernel, bool& smem_set, size_t smem, int threads,
           int block_rows, const Args& a, cudaStream_t stream) {
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid(a.S / block_rows, a.H, a.B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// which: 0 = C1 merged, 1 = C2 dq, 2 = C3 dkv; float32 (the tensor-core
// kernels of flash_bwd_tc.cu take bf16 and fp16).
template <int D, int BM>
int dispatch_which(int which, const Args& a, cudaStream_t stream) {
  static bool set_merged = false, set_dq = false, set_dkv = false;
  if (which == 0)
    return launch(flash_bwd_kv_kernel<D, BM, true>, set_merged,
                  kv_smem_bytes(D, BM), kv_threads(BM), BM, a, stream);
  if (which == 1)
    return launch(flash_bwd_dq_kernel<D, BM>, set_dq, dq_smem_bytes(D, BM),
                  dq_threads(BM), BM, a, stream);
  if (which == 2)
    return launch(flash_bwd_kv_kernel<D, BM, false>, set_dkv,
                  kv_smem_bytes(D, BM), kv_threads(BM), BM, a, stream);
  return (int)cudaErrorInvalidValue;
}

// the (D, tile rows) pairs instantiated: 64 or 32 rows up to D = 128, 32
// at D = 256, where 64-row f32 tiles would need 6 x 64 KB of shared memory
bool f32_tile(int D, int block) {
  return (D == 64 || D == 128) ? (block == 64 || block == 32)
                               : (D == 256 && block == 32);
}

int dispatch_d(int which, int D, int block, const Args& a,
               cudaStream_t stream) {
  if (D == 64 && block == 64) return dispatch_which<64, 64>(which, a, stream);
  if (D == 64 && block == 32) return dispatch_which<64, 32>(which, a, stream);
  if (D == 128 && block == 64)
    return dispatch_which<128, 64>(which, a, stream);
  if (D == 128 && block == 32)
    return dispatch_which<128, 32>(which, a, stream);
  if (D == 256 && block == 32)
    return dispatch_which<256, 32>(which, a, stream);
  return (int)cudaErrorInvalidValue;
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const float* lse, const float* delta, void* dq,
        float* dq_acc, void* dk, void* dv, int B, int S, int H, int D,
        long long q_sb, long long q_ss, long long k_sb, long long k_ss,
        long long v_sb, long long v_ss, long long o_sb, long long o_ss,
        int causal, float scale, int dtype, int block, void* stream) {
  if (S <= 0 || block <= 0 || S % block != 0 || B <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q,    k,    v,    dout, lse,  delta, dq,   dq_acc, dk,
               dv,   B,    S,    H,    q_sb, q_ss,  k_sb, k_ss,   v_sb,
               v_ss, o_sb, o_ss, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 || dtype == 2)
    return flash_bwd_tc_launch(which, q, k, v, dout, lse, delta, dq, dq_acc,
                               dk, dv, B, S, H, D, q_sb, q_ss, k_sb, k_ss,
                               v_sb, v_ss, o_sb, o_ss, causal, scale, dtype,
                               block, stream);
  if (dtype == 0) return dispatch_d(which, D, block, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Common arguments: q/k/v/dout (B, S, H, D) with (H, D) dense and the given
// batch / sequence strides in elements (rows 16-byte aligned); lse
// (base-e) and delta dense (B, S, H) f32; D in {64, 128, 256}; `block` the
// tile rows (f32: 64 or 32 at D <= 128, 32 at D = 256; bf16 and fp16: 64
// or 128 at D = 64, 64 at D = 128 and 256), S a multiple of it; dtype 0 =
// float32, 1 = bfloat16, 2 = float16; `scale` the base-e softmax scale.
// Outputs are dense (B, S, H, D).  Each returns its launch's cudaError_t.

// C1: dq_acc is an f32 workspace the caller zeroes (and, in bf16 and fp16,
// casts); every kernel folds the scale in.
extern "C" int paddle_flash_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
    int B, int S, int H, int D, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    long long o_sb, long long o_ss, int causal, float scale, int dtype,
    int block, void* stream) {
  return run(0, q, k, v, dout, lse, delta, nullptr, dq_acc, dk, dv, B, S, H,
             D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal, scale,
             dtype, block, stream);
}

// C2
extern "C" int paddle_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int S, int H,
    int D, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    int causal, float scale, int dtype, int block, void* stream) {
  return run(1, q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr, B,
             S, H, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal,
             scale, dtype, block, stream);
}

// C3
extern "C" int paddle_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int S,
    int H, int D, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, long long o_sb,
    long long o_ss, int causal, float scale, int dtype, int block,
    void* stream) {
  return run(2, q, k, v, dout, lse, delta, nullptr, nullptr, dk, dv, B, S, H,
             D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal, scale,
             dtype, block, stream);
}

// Dynamic shared memory of one f32 launch of C1 (which 0), C2 (1) or C3
// (2) at head dim D and `block` tile rows; -1 where none is instantiated.
extern "C" long long paddle_flash_bwd_smem(int which, int D, int block) {
  if (!f32_tile(D, block) || which < 0 || which > 2) return -1;
  return (long long)(which == 1 ? dq_smem_bytes(D, block)
                                : kv_smem_bytes(D, block));
}
