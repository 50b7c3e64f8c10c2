// 3 x TF32 products on Hopper's tensor cores (mma.sync.m16n8k8), shared by
// the float32 flash kernels: the backward (C1, C2, C3) of flash_bwd.cu and
// the forward, kernel A (flash_fwd.cu) and kernel A' (flash_fwd_pipelined.cu),
// whose common body is flash_fwd_tf32x3 below.
//
// Each f32 operand x is split into big = tf32(x) and small = tf32(x - big)
// (cvt.rna's rounding: 10 mantissa bits, to nearest, ties away from zero),
// and a b is summed as a.small b.big + a.big b.small + a.big b.big by three
// TF32 products into f32 registers, the small terms first, as CUTLASS's
// OpMultiplyAddFastF32.  Only small x small, about 2^-22 of each product,
// and the rounding of the small parts are lost: results stay within the
// f32 bars of the plain versions, where one TF32 product (about 2^-11)
// would not.  Operands are f32 tiles in shared memory with rows padded by
// 16 bytes, filled by 16-byte cp.async copies (wgmma_common.cuh's
// wrappers) and split in registers as each fragment is loaded.
#pragma once

#include "wgmma_common.cuh"

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


// ---- the f32 flash forward (kernels A and A') ------------------------------

constexpr float kNegBig = -1e30f;
// dynamic shared memory a block may use on the H100 (227 KB)
constexpr size_t kMaxBlockSmem = 232448;

// One f32 forward launch: q/k/v (B, S, H, D) with (H, D) dense, every row
// 16-byte aligned, the given batch / sequence strides in elements; out
// dense (B, S, H, D); lse dense (B, S, H) base-e, or null.
struct FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* lse;
  int S, H;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
  int causal;
  float scale2;   // the softmax scale times log2(e)
};

// Threads of a forward block (a warp for each 16 q rows) and its dynamic
// shared memory: the scaled q tile and `stages` stages of K and V tiles,
// rows of D + 4 floats.
__host__ __device__ constexpr int fwd_threads(int BQ) { return 2 * BQ; }
__host__ __device__ constexpr size_t fwd_smem_bytes(int D, int BQ, int BK,
                                                    int stages) {
  return 4 * (size_t)(BQ + 2 * stages * BK) * (D + 4);
}

// The body of kernels A and A': softmax(q k^T scale) v over the (batch,
// head, BQ-row q tile) of grid (S / BQ - 1 - x, y, z), the tiles of the
// longest causal scans first.  K/V tiles of BK rows land in a ring of
// STAGES stages by cp.async, tile it + STAGES - 1 issued while tile it
// computes; one block barrier a tile.  The q tile is read once, times
// scale2 so the scores come out in base 2, into shared memory; at D 64
// each warp then holds its rows' split fragments in registers for every
// K tile, at D 128 and 256 (where the fragments would take 128 and 256
// registers a lane) they are split as they are read, a quarter of the
// split work of the K fragments they meet.  Warp w owns q rows [16 w,
// 16 w + 16) of the tile:
//   S = q K^T into fresh accumulators (3 x TF32); under `causal` a tile
//   whose first key lies past the warp's last row is skipped, and only a
//   tile that reaches past its first row is masked;
//   the online softmax in registers (rows g and g + 8 of lane 4 g + t;
//   the max over the quad by shuffles, each lane's share of l summed at
//   the end);
//   acc = acc corr + P V, P taken from the S accumulators as the A
//   fragment (columns 2t, 2t + 1 as k slots t, t + 4: V's rows are read
//   in that order, load_bp) and P V summed afresh for the tile (acc_tile:
//   the tensor cores' adds truncate, so a whole scan chained into acc
//   would drift).
template <int D, int BQ, int BK, int STAGES>
__device__ __forceinline__ void flash_fwd_tf32x3(const FwdArgs& a) {
  constexpr int NT = fwd_threads(BQ);
  constexpr int NJ = BK / 8;   // n8 tiles of a warp's scores
  constexpr int ND = D / 8;    // n8 tiles of its output, k8 steps of S
  constexpr int TILE = BK * (D + 4);
  constexpr bool kQRegs = D == 64;
  constexpr int CH = D / 4;    // 16-byte chunks of a row
  static_assert(BQ % 16 == 0 && BQ % BK == 0 && BK % 8 == 0 &&
                    STAGES >= 2 && (BQ * CH) % NT == 0,
                "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sRing = sQ + BQ * (D + 4);   // stage st: K at 2 st TILE, then V

  const int qt = a.S / BQ - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * warp;
  const int q0 = qt * BQ;
  const int row0 = q0 + r0;           // the warp's first q row
  const float* kb = a.k + b * a.k_sb + (long long)h * D;
  const float* vb = a.v + b * a.v_sb + (long long)h * D;
  const int n_it = a.causal ? (q0 + BQ) / BK : a.S / BK;

  // one commit group a tile, empty past the last, so the wait counts hold
  auto issue = [&](int it) {
    if (it < n_it) {
      float* st = sRing + (it % STAGES) * 2 * TILE;
      copy_tile<D, BK, NT>(st, kb, a.k_ss, it * BK);
      copy_tile<D, BK, NT>(st + TILE, vb, a.v_ss, it * BK);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) issue(it);

  {
    const float* qb = a.q + b * a.q_sb + (long long)h * D;
#pragma unroll 4
    for (int i = 0; i < BQ * CH / NT; ++i) {
      const int e = threadIdx.x + i * NT;
      const int r = e / CH;
      const int c = e % CH;
      float4 x = *reinterpret_cast<const float4*>(
          qb + (long long)(q0 + r) * a.q_ss + 4 * c);
      x.x *= a.scale2;
      x.y *= a.scale2;
      x.z *= a.scale2;
      x.w *= a.scale2;
      *reinterpret_cast<float4*>(sQ + at<D>(r, 4 * c)) = x;
    }
  }
  __syncthreads();
  FragA qf[kQRegs ? ND : 1];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) qf[kk] = load_a<D>(sQ, r0, 8 * kk, g, t);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegBig, kNegBig};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile it has landed; every warp is done with it - 1
    issue(it + STAGES - 1);
    const int c0 = it * BK;
    if (a.causal && c0 > row0 + 15) continue;   // past the warp's rows
    const float* sK = sRing + (it % STAGES) * 2 * TILE;
    const float* sV = sK + TILE;

    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      FragA fa;
      if constexpr (kQRegs)
        fa = qf[kk];
      else
        fa = load_a<D>(sQ, r0, 8 * kk, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma3(s[j], fa, load_bt<D>(sK, 8 * j, 8 * kk, g, t));
    }

    // key c hidden from row r where c > r; the row max over the quad
    const bool mask = a.causal && c0 + BK - 1 > row0;
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (mask && c0 + 8 * j + 2 * t + (e & 1) > row0 + g + 8 * (e >> 1))
          s[j][e] = kNegBig;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= corr[hh];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    acc_tile<NJ, ND, D>(acc, s, sV, g, t);   // acc += P V
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const long long o = ((long long)b * a.S + row0 + g + 8 * hh) * a.H + h;
    const float l_safe = fmaxf(l[hh], 1e-30f);
    const float inv = 1.f / l_safe;
    float* orow = a.out + o * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(acc[n][2 * hh] * inv, acc[n][2 * hh + 1] * inv);
    if (a.lse != nullptr && t == 0)
      a.lse[o] = (m[hh] + log2f(l_safe)) * kLn2;
  }
}

// Opt in to more than 48 KB of dynamic shared memory once per kernel (the
// call is idempotent, so a race between threads is harmless), then launch
// on grid (S / BQ, H, B).
template <typename Kernel>
int launch_fwd(Kernel kernel, bool& smem_set, size_t smem, int BQ, int B,
               const FwdArgs& a, cudaStream_t stream) {
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();   // leave no stale error for the next launch
      return (int)err;
    }
    smem_set = true;
  }
  if (a.S % BQ != 0) return (int)cudaErrorInvalidValue;
  dim3 grid(a.S / BQ, a.H, B);
  kernel<<<grid, fwd_threads(BQ), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
