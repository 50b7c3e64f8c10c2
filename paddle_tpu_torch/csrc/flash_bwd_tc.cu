// Flash-attention backward on Hopper's tensor cores (sm_90a), bf16 and
// fp16: kernels C1, C2 and C3 of the plain C interface in flash_bwd.cu.
//
// Replaces, for bfloat16 and float16 inputs at head dims 64, 128 and 256,
// the backward kernels of paddle_tpu/kernels/flash_attention_pallas.py:
//   C1 flash_bwd_merged_tc_kernel <- _bwd_kernel      (dQ, dK, dV)
//   C2 flash_bwd_dq_tc_kernel     <- _bwd_dq_kernel   (dQ)
//   C3 flash_bwd_dkv_tc_kernel    <- _bwd_dkv_kernel  (dK, dV)
// All compute what _bwd_head_math computes, per (batch, head):
//   P  = exp2(scale * log2e * Q K^T - lse * log2e),  dP = dO V^T,
//   dS = P * (dP - delta),
//   dV = T(P)^T dO,  dK = scale * T(dS)^T Q,  dQ = scale * T(dS) K
// with T = bf16 or fp16 (the inputs' type) operands and f32 sums in every
// product, P rounded to T before dV and dS before dK and dQ, as the TPU
// kernels round them before their MXU products; the start-aligned causal
// mask only on the diagonal tile, whose future keys get P = 0.  f32
// inputs take the 3 x TF32 kernels of flash_bwd.cu.
//
// Bound on the H100 SXM (989 TFLOP/s bf16, 3.35 TB/s), operands read and
// results written once: at the training shape B=8, S=1024, H=16, D=64
// causal C1's five products need 4.3e10 FLOP (0.0435 ms) against 118 MB
// (0.035 ms); at (1, 1024, 4, 256) 0.00543 ms; at the long-context shape
// (1, 16384, 16, 64) causal C2 does three S x S x D products (S, dP, dQ;
// 8.3e11 FLOP, 0.83 ms), C3 four (S^T, dP^T, dV, dK; 1.11 ms) and C1 five
// (1.39 ms), against 10-12 MB of operands: all bound by operations, which
// only the tensor cores deliver at that rate.
//
// Design.  One block per (batch, head, 64- or 128-row tile), one
// consumer warpgroup (128 threads) per 64 rows of the resident tile:
//   C3: K and V stay resident; the loop runs over the q tiles from the
//       causal diagonal on, each tile's Q, dO, lse and delta rows landing
//       in a two-stage ring.  Per q tile, wgmma computes S^T = K Q^T and
//       dP^T = V dO^T with both operands in shared memory; P^T and dS^T
//       are formed in the accumulator registers, converted to T in
//       place as wgmma A fragments (the m64nNk16 accumulator layout of
//       16 columns is the A layout of one k16 step), and dV += P^T dO,
//       dK += dS^T Q run with A from registers and B = dO or Q read
//       transposed from the same shared tiles (the MN-major bit).
//       dK and dV sum in f32 registers over the whole loop.
//   C1: C3's loop, and per q tile its dQ share on the tensor cores: dS^T,
//       rounded to T, goes once to a swizzled shared tile, and dQ_tile =
//       dS K is one wgmma chain a 64-column chunk of D, with A = dS read
//       MN-major from that tile and B = the resident K read MN-major; the
//       f32 result, scale folded in, is added into an f32 (B, S, H, D)
//       workspace by 16-byte vector atomics (float4 atomicAdd, sm_90),
//       one per four adjacent columns.  Against the FMA C1 that bf16
//       took before, whose products ran on f32 FMAs from f32-staged operands,
//       whose Q / dO / lse / delta were staged synchronously, whose P and
//       dS made two round trips through an f32 shared tile between four
//       block barriers, and whose dQ took one scalar atomic per element
//       and two more f32 passes in the wrapper: all five products are
//       wgmma, the q-side tiles come through C3's cp.async ring, P and
//       dS stay in registers (dS^T is written once, in T), the atomics
//       are a quarter as many, and the wrapper keeps the zeroing and the
//       cast (no scaling pass).  A 128-row K tile halves them again.
//   C2: Q, dO and the rows' lse and delta stay resident; the loop runs
//       over the K tiles up to the diagonal (the block with the most
//       tiles starts first); per K tile S = Q K^T and dP = dO V^T by
//       wgmma, P and dS in registers, dQ += dS K with K read transposed.
// At head dim 256 the f32 dK and dV of one 64-row warpgroup would need
// 2 x 64 x 256 / 128 = 256 registers a thread, so there the two
// warpgroups of a block share one 64-row tile and split the work, each
// holding 128 output registers a thread (C1 does so at D 128 too, where
// C3's rows design already uses 255 registers and dQ's chunk would
// spill):
//   C3: warpgroup 0 computes S^T and P^T and sums dV, warpgroup 1
//       computes dP^T, takes P^T from shared memory and sums dK; in C1
//       warpgroup 1 also writes dS^T and each adds half of dQ's columns;
//   C2: warpgroup 0 computes S and P, warpgroup 1 dP; both exchange
//       them through shared memory, form the same dS and each sums half
//       of dQ's 256 columns.
// Tiles are 16-bit in the 128-byte swizzled layout of wgmma_common.cuh
// (shared with the forwards), filled by 16-byte cp.async copies that the
// threads issue for tile t+1 before they wait for tile t, so the fetch
// overlaps the tile's products.  C2 and C3 use no atomics: every output
// element is summed by one thread in one order, so both are
// deterministic, as are C1's dK and dV; C1's dQ takes its additions in
// an order that varies from run to run.  The tile is a template
// parameter (square, the autotuner's flash_bwd / flash_bwd_dq /
// flash_bwd_dkv candidates): 64 at every head dim, 128 (two warpgroups)
// at 64.  Warp specialisation and TMA here are left for a later change.

#include "wgmma_common.cuh"

namespace {

// Dynamic shared memory of one launch, for either kernel: 1024 bytes of
// slack to align the tiles to the swizzle's 1024-byte period, six 16-bit
// BM x D tiles (two resident, two stages of two streamed), four f32 row
// vectors of BM (C3: a stage's lse and delta rows, twice; C2: its
// resident lse and delta rows in the first two) and, at D = 256, two f32
// BM x BM score tiles that the warpgroups exchange (C2: P and dP; C3:
// P^T in the first).
constexpr int tc_smem_bytes(int D, int BM) {
  return 1024 + 6 * BM * D * 2 + 4 * BM * 4 + (D == 256 ? 2 * BM * BM * 4 : 0);
}
// C1's: at D = 64 C3's and the 16-bit BM x BM dS^T tile that dQ reads;
// at D 128 and 256 (two warpgroups share the tile, as C3 at 256) the
// exchange of C3 at 256, whose unused second half holds the dS^T tile
constexpr int merged_tc_smem_bytes(int D, int BM) {
  return D == 64 ? tc_smem_bytes(D, BM) + BM * BM * 2
                 : tc_smem_bytes(D, BM) + (D == 256 ? 0 : 2 * BM * BM * 4);
}

// threads of a block: one warpgroup per 64 rows, two at D = 256 (C1: at
// D 128 and 256)
constexpr int tc_threads(int D, int BM) { return D == 256 ? 256 : 2 * BM; }
constexpr int merged_tc_threads(int D, int BM) {
  return D == 64 ? 2 * BM : 256;
}

template <typename T>
struct TcArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;     // (B, S, H) base-e
  const float* delta;   // (B, S, H)
  T* dq;                // (B, S, H, D) dense outputs
  float* dq_acc;        // (B, S, H, D) f32 workspace (C1); C2 adds dQ
                        // into it in place of writing dq when given
  T* dk;
  T* dv;
  float* dk_acc;        // (B, S, H, D) f32: C3 adds dK and dV into them in
  float* dv_acc;        // place of writing dk and dv when given
  int S, H;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  int causal;
  float scale;
};

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// C1: write this thread's dS^T fragments (K rows r0 and r0 + 8, the q
// tile's columns), rounded to T, into the swizzled 16-bit dS^T tile of R
// K rows (columns in 64-wide atoms R * 128 bytes apart), then make them
// visible to wgmma's reads.
template <int R, int KS>
__device__ __forceinline__ void store_ds(uint32_t tile,
                                         const uint32_t (&f)[KS][4], int r0,
                                         int l) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      const int r = r0 + 8 * (mm & 1);
      const int c = 16 * kk + 8 * (mm >> 1) + 2 * (l & 3);
      st_shared_u32(tile + (c >> 6) * (R * 128) + r * 128 +
                        ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2,
                    f[kk][mm]);
    }
  fence_proxy_async();
}

// C1: issue dQ[q0 + 64 m, + 64)[64 j, + 64) = dS K[:, 64 j, + 64) over the
// R K rows of the tile into `dq`, one wgmma chain with A = dS read
// MN-major from the dS^T tile (its atom m) and B = the resident K read
// MN-major (the caller commits and waits).
template <typename T, int R>
__device__ __forceinline__ void dq_product(float (&dq)[32], uint32_t sDS,
                                           uint32_t sK, int m, int j) {
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
    wgmma_ss_t<T, 64>(dq, desc_t<R>(sDS + m * (R * 128), kk),
                      desc_t<R>(sK + j * (R * 128), kk), kk > 0);
}

// C1: add scale times that dQ chunk into the f32 workspace by 16-byte
// atomics: a thread holds two adjacent columns of rows r and r + 8, and
// swaps one pair with its neighbour in the quad so that each adds four
// adjacent columns of one row.
template <typename T, int D>
__device__ __forceinline__ void dq_add(const TcArgs<T>& a,
                                       const float (&dq)[32], int m, int j,
                                       int b, int h, int q0) {
  const int t = threadIdx.x & 127;
  const int row = q0 + 64 * m + 16 * (t >> 5) + ((t & 31) >> 2);
  // accumulators 4 c .. 4 c + 3: columns 8 c + 2 (t & 3) + {0, 1} of rows
  // row and row + 8; an even thread adds row's four columns from
  // 8 c + 2 (t & 2), the odd one beside it row + 8's
  const bool odd = t & 1;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float* p = dq + 4 * c;
    const float x0 = __shfl_xor_sync(0xffffffffu, odd ? p[0] : p[2], 1);
    const float x1 = __shfl_xor_sync(0xffffffffu, odd ? p[1] : p[3], 1);
    const float4 v = odd ? make_float4(x0, x1, p[2], p[3])
                         : make_float4(p[0], p[1], x0, x1);
    const int r = row + (odd ? 8 : 0);
    const int col = 64 * j + 8 * c + 2 * (t & 2);
    atomicAdd(reinterpret_cast<float4*>(
                  a.dq_acc + (((long long)b * a.S + r) * a.H + h) * D + col),
              make_float4(v.x * a.scale, v.y * a.scale, v.z * a.scale,
                          v.w * a.scale));
  }
}

// C3 at D 64 and 128: grid (S / BM, H, B), 2 * BM threads; block kt owns
// K rows [kt BM, kt BM + BM), warpgroup wg the 64 rows from kt BM + 64 wg.
// With DQ (C1) each q tile's dS^T also goes to a shared tile, and
// warpgroup wg adds the tile's dQ share for its 64 q rows.  With ACC (C3
// only) dK and dV are added into the f32 dk_acc and dv_acc.
template <typename T, int D, int BM, bool DQ, bool ACC = false>
__device__ __forceinline__ void dkv_by_rows(const TcArgs<T>& a) {
  static_assert(!DQ || D == 64, "C1 takes the rows design at D 64 only");
  constexpr int NT = 2 * BM;
  constexpr int TILE = BM * D * 2;   // bytes of one 16-bit tile
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
  const uint32_t sDS = sRows + 16 * BM;   // C1's dS^T tile

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x & 127;
  const int wg = threadIdx.x >> 7;
  const int w = t >> 5;
  const int l = t & 31;
  const int k0 = kt * BM;
  const float scale2 = a.scale * kLog2e;
  const T* q = a.q + b * a.q_sb + (long long)h * D;
  const T* k = a.k + b * a.k_sb + (long long)h * D;
  const T* v = a.v + b * a.v_sb + (long long)h * D;
  const T* dout = a.dout + b * a.o_sb + (long long)h * D;
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
      wgmma_ss<T, BM>(s, desc_k<BM>(sK, 64 * wg, kk), desc_k<BM>(sQ, 0, kk),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, BM>(dp, desc_k<BM>(sV, 64 * wg, kk), desc_k<BM>(sdO, 0, kk),
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
        fp[kk][m] = pack2<T>(s[8 * kk + 2 * m], s[8 * kk + 2 * m + 1]);
        fds[kk][m] = pack2<T>(dp[8 * kk + 2 * m], dp[8 * kk + 2 * m + 1]);
      }
    float dq[DQ ? 32 : 1];
    if constexpr (DQ) {
      store_ds<BM, KS>(sDS, fds, 64 * wg + 16 * w + (l >> 2), l);
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;
      __syncthreads();   // every warpgroup's dS^T rows are in place
    }

    // dV += P^T dO, dK += dS^T Q (B read transposed from the q-side
    // tiles); C1 also dQ for this warpgroup's 64 q rows, in the same group
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<T, D>(acc_v, fp[kk], desc_t<BM>(sdO, kk));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<T, D>(acc_k, fds[kk], desc_t<BM>(sQ, kk));
    if constexpr (DQ) dq_product<T, BM>(dq, sDS, sK, wg, 0);
    wg_commit();
    wg_wait0();
    fence_regs(acc_v);
    fence_regs(acc_k);
    if constexpr (DQ) {
      fence_regs(dq);
      dq_add<T, D>(a, dq, wg, 0, b, h, qt * BM);
    }
    __syncthreads();   // the stage is free for the copies of tile it + 2
  }

  if constexpr (ACC) {
    store_rows_f32<D, D, true>(a.dk_acc, acc_k, a.scale, a.scale, b, a.S,
                               a.H, h, k0 + 64 * wg, 0);
    store_rows_f32<D, D, true>(a.dv_acc, acc_v, 1.f, 1.f, b, a.S, a.H, h,
                               k0 + 64 * wg, 0);
  } else {
    store_rows<D, D>(a.dk, acc_k, a.scale, a.scale, b, a.S, a.H, h,
                     k0 + 64 * wg, 0);
    store_rows<D, D>(a.dv, acc_v, 1.f, 1.f, b, a.S, a.H, h, k0 + 64 * wg, 0);
  }
}

// C2 at D 64 and 128: grid (S / BM, H, B), 2 * BM threads; block x owns
// q rows of tile S / BM - 1 - x (the longest causal scans start first),
// warpgroup wg the 64 rows from 64 wg.
template <typename T, int D, int BM>
__device__ __forceinline__ void dq_by_rows(const TcArgs<T>& a) {
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
  const T* q = a.q + b * a.q_sb + (long long)h * D;
  const T* k = a.k + b * a.k_sb + (long long)h * D;
  const T* v = a.v + b * a.v_sb + (long long)h * D;
  const T* dout = a.dout + b * a.o_sb + (long long)h * D;
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
      wgmma_ss<T, BM>(s, desc_k<BM>(sQ, 64 * wg, kk), desc_k<BM>(sK, 0, kk),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, BM>(dp, desc_k<BM>(sdO, 64 * wg, kk), desc_k<BM>(sV, 0, kk),
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
        fds[kk][m] = pack2<T>(dp[8 * kk + 2 * m], dp[8 * kk + 2 * m + 1]);

    // dQ += dS K (K read transposed)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<T, D>(acc_q, fds[kk], desc_t<BM>(sK, kk));
    wg_commit();
    wg_wait0();
    fence_regs(acc_q);
    __syncthreads();
  }

  if (a.dq_acc != nullptr)
    store_rows_f32<D, D, true>(a.dq_acc, acc_q, a.scale, a.scale, b, a.S,
                               a.H, h, q0 + 64 * wg, 0);
  else
    store_rows<D, D>(a.dq, acc_q, a.scale, a.scale, b, a.S, a.H, h,
                     q0 + 64 * wg, 0);
}

// C3 at D 256, C1 at D 128 and 256: grid (S / 64, H, B), 256 threads;
// block kt owns K rows [kt 64, kt 64 + 64), both warpgroups all of them.
// Warpgroup 0 forms S^T and P^T, hands P^T over through shared memory and
// sums dV; warpgroup 1 forms dP^T, then dS^T from the P^T it is handed,
// and sums dK.  Each holds its sum as D / 128 m64n128 accumulators.  With
// DQ (C1) warpgroup 1 also writes dS^T to a shared tile, and warpgroup wg
// adds the q tile's dQ share in D's columns [D / 2 wg, D / 2 (wg + 1)).
// With ACC (C3 only) dK and dV are added into the f32 dk_acc and dv_acc.
template <typename T, int D, int BM, bool DQ, bool ACC = false>
__device__ __forceinline__ void dkv_by_halves(const TcArgs<T>& a) {
  constexpr int NT = 256;
  constexpr int NA = D / 128;   // m64n128 accumulators a thread
  constexpr int TILE = BM * D * 2;
  constexpr int NS = BM / 2;
  constexpr int KS = BM / 16;
  static_assert(BM == 64 && D >= 128, "one 64-row tile for both "
                "warpgroups, 128 output columns each at least");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + TILE, sStage = base + 2 * TILE;
  const uint32_t sRows = base + 6 * TILE;
  const float* rows =
      reinterpret_cast<const float*>(smem_raw + (sRows - raw));
  // P^T, entry i of thread t at [i][t]
  float* xp = reinterpret_cast<float*>(smem_raw + (sRows + 16 * BM - raw));
  // C1's dS^T tile, in the exchange's second half
  const uint32_t sDS = sRows + 16 * BM + NS * 128 * 4;

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x & 127;
  const int wg = threadIdx.x >> 7;
  const int w = t >> 5;
  const int l = t & 31;
  const int k0 = kt * BM;
  const float scale2 = a.scale * kLog2e;
  const T* q = a.q + b * a.q_sb + (long long)h * D;
  const T* k = a.k + b * a.k_sb + (long long)h * D;
  const T* v = a.v + b * a.v_sb + (long long)h * D;
  const T* dout = a.dout + b * a.o_sb + (long long)h * D;
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

  // warpgroup 0: dV, warpgroup 1: dK, columns [128 j, 128 j + 128) in
  // acc[j]
  float acc[NA][64], s[NS];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
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
      wgmma_ss<T, BM>(s, desc_k<BM>(sA, 0, kk), desc_k<BM>(sB, 0, kk), kk > 0);
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
        f[kk][m] = pack2<T>(s[8 * kk + 2 * m], s[8 * kk + 2 * m + 1]);
    if constexpr (DQ) {
      if (wg == 1) store_ds<BM, KS>(sDS, f, 16 * w + (l >> 2), l);
    }

    // dV += P^T dO (warpgroup 0), dK += dS^T Q (warpgroup 1), B read
    // transposed, 128 columns (two 64-column atoms) at a time
    const uint32_t sO = wg ? sQ : sdO;
    wg_fence();
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_rs<T, 128>(acc[j], f[kk], desc_t<BM>(sO + j * 2 * BM * 128, kk));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int j = 0; j < NA; ++j) fence_regs(acc[j]);
    if constexpr (DQ) {
      __syncthreads();   // warpgroup 1's dS^T is in place
      for (int j = wg * D / 128; j < (wg + 1) * D / 128; ++j) {
        float dq[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[i] = 0.f;
        wg_fence();
        dq_product<T, BM>(dq, sDS, sK, 0, j);
        wg_commit();
        wg_wait0();
        fence_regs(dq);
        dq_add<T, D>(a, dq, 0, j, b, h, qt * BM);
      }
    }
    __syncthreads();   // the stage and the P^T exchange are free again
  }

  const float mul = wg ? a.scale : 1.f;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    if constexpr (ACC)
      store_rows_f32<D, 128, true>(wg ? a.dk_acc : a.dv_acc, acc[j], mul,
                                   mul, b, a.S, a.H, h, k0, 128 * j);
    else
      store_rows<D, 128>(wg ? a.dk : a.dv, acc[j], mul, mul, b, a.S, a.H, h,
                         k0, 128 * j);
  }
}

// C2 at D 256: grid (S / 64, H, B), 256 threads; block x owns q rows of
// tile S / 64 - 1 - x, both warpgroups all of them.  Warpgroup 0 forms S
// and P, warpgroup 1 dP; they exchange P and dP through shared memory,
// both form the same dS (the same f32 operations on the same values), and
// warpgroup wg sums dQ's columns [128 wg, 128 wg + 128).
template <typename T, int BM>
__device__ __forceinline__ void dq_by_halves(const TcArgs<T>& a) {
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
  const T* q = a.q + b * a.q_sb + (long long)h * D;
  const T* k = a.k + b * a.k_sb + (long long)h * D;
  const T* v = a.v + b * a.v_sb + (long long)h * D;
  const T* dout = a.dout + b * a.o_sb + (long long)h * D;
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
      wgmma_ss<T, BM>(s, desc_k<BM>(sA, 0, kk), desc_k<BM>(sB, 0, kk), kk > 0);
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
        f[kk][m] = pack2<T>(s[8 * kk + 2 * m], s[8 * kk + 2 * m + 1]);

    // dQ[:, 128 wg : 128 wg + 128] += dS K[:, those columns] (K read
    // transposed, two of its four 64-column atoms)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<T, 128>(acc, f[kk], desc_t<BM>(sK + wg * 2 * BM * 128, kk));
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    __syncthreads();   // the stage and the exchange are free again
  }

  if (a.dq_acc != nullptr)
    store_rows_f32<D, 128, true>(a.dq_acc, acc, a.scale, a.scale, b, a.S,
                                 a.H, h, q0, 128 * wg);
  else
    store_rows<D, 128>(a.dq, acc, a.scale, a.scale, b, a.S, a.H, h, q0,
                       128 * wg);
}

// C3; ACC (ring attention) adds dK and dV into f32 accumulators, an
// instantiation of its own, so that the plain C3 keeps its registers
template <typename T, int D, int BM, bool ACC>
__global__ void __launch_bounds__(tc_threads(D, BM), 1)
flash_bwd_dkv_tc_kernel(const TcArgs<T> a) {
  if constexpr (D == 256)
    dkv_by_halves<T, D, BM, false, ACC>(a);
  else
    dkv_by_rows<T, D, BM, false, ACC>(a);
}

// C1: at D 128 the rows design would spill (C3's 255 registers a thread
// and dQ's), so two warpgroups share the tile as at 256
template <typename T, int D, int BM>
__global__ void __launch_bounds__(merged_tc_threads(D, BM), 1)
flash_bwd_merged_tc_kernel(const TcArgs<T> a) {
  if constexpr (D == 64)
    dkv_by_rows<T, D, BM, true>(a);
  else
    dkv_by_halves<T, D, BM, true>(a);
}

template <typename T, int D, int BM>
__global__ void __launch_bounds__(tc_threads(D, BM), 1)
flash_bwd_dq_tc_kernel(const TcArgs<T> a) {
  if constexpr (D == 256)
    dq_by_halves<T, BM>(a);
  else
    dq_by_rows<T, D, BM>(a);
}

template <typename Kernel, typename Args>
int launch(Kernel kernel, bool& smem_set, int smem, int threads, dim3 grid,
           const Args& a, cudaStream_t stream) {
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// which: 0 = C1 merged, 1 = C2 dq, 2 = C3 dkv, 3 = C3 adding into f32
template <typename T, int D, int BM>
int dispatch(int which, int B, const TcArgs<T>& a, cudaStream_t stream) {
  static bool set_merged = false, set_dq = false, set_dkv = false,
              set_dkv_acc = false;
  const dim3 grid(a.S / BM, a.H, B);
  if (which == 0)
    return launch(flash_bwd_merged_tc_kernel<T, D, BM>, set_merged,
                  merged_tc_smem_bytes(D, BM), merged_tc_threads(D, BM), grid,
                  a, stream);
  if (which == 2)
    return launch(flash_bwd_dkv_tc_kernel<T, D, BM, false>, set_dkv,
                  tc_smem_bytes(D, BM), tc_threads(D, BM), grid, a, stream);
  if (which == 3)
    return launch(flash_bwd_dkv_tc_kernel<T, D, BM, true>, set_dkv_acc,
                  tc_smem_bytes(D, BM), tc_threads(D, BM), grid, a, stream);
  return launch(flash_bwd_dq_tc_kernel<T, D, BM>, set_dq,
                tc_smem_bytes(D, BM), tc_threads(D, BM), grid, a, stream);
}

template <typename T>
int dispatch_tiles(int which, int B, int D, int block, const void* q,
                   const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq,
                   float* dq_acc, void* dk, void* dv, int S, int H,
                   long long q_sb, long long q_ss,
                   long long k_sb, long long k_ss, long long v_sb,
                   long long v_ss, long long o_sb, long long o_ss,
                   int causal, float scale, cudaStream_t st) {
  // which 3: C3 with dk / dv the f32 accumulators
  const bool acc = which == 3;
  const TcArgs<T> a{static_cast<const T*>(q),
                    static_cast<const T*>(k),
                    static_cast<const T*>(v),
                    static_cast<const T*>(dout),
                    lse,
                    delta,
                    static_cast<T*>(dq),
                    dq_acc,
                    acc ? nullptr : static_cast<T*>(dk),
                    acc ? nullptr : static_cast<T*>(dv),
                    acc ? static_cast<float*>(dk) : nullptr,
                    acc ? static_cast<float*>(dv) : nullptr,
                    S,
                    H,
                    q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss,
                    causal,
                    scale};
  if (D == 64 && block == 64) return dispatch<T, 64, 64>(which, B, a, st);
  if (D == 64 && block == 128) return dispatch<T, 64, 128>(which, B, a, st);
  if (D == 128 && block == 64) return dispatch<T, 128, 64>(which, B, a, st);
  if (D == 256 && block == 64) return dispatch<T, 256, 64>(which, B, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// which: 0 = C1 (dq_acc an f32 workspace the caller zeroes and casts;
// scale folded in), 1 = C2 (into dq, or added into dq_acc when it is
// given), 2 = C3, 3 = C3 adding into f32 dk and dv.  The instantiated
// (D, tile) pairs: 64
// or 128 at D = 64, 64 at D = 128 and 256; dtype 1 = bfloat16, 2 =
// float16.  Every q/k/v/dout row must start on 16 bytes (the copies'
// unit).  Returns the launch's cudaError_t.
int flash_bwd_tc_launch(int which, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* dq, float* dq_acc,
                        void* dk, void* dv,
                        int B, int S, int H, int D, long long q_sb,
                        long long q_ss, long long k_sb, long long k_ss,
                        long long v_sb, long long v_ss, long long o_sb,
                        long long o_ss, int causal, float scale, int dtype,
                        int block, void* stream) {
  if (S <= 0 || B <= 0 || H <= 0 || block <= 0 || S % block != 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)dout;
  if ((ptrs & 15) || ((q_sb | q_ss | k_sb | k_ss | v_sb | v_ss | o_sb |
                       o_ss) & 7))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_tiles<bf16>(which, B, D, block, q, k, v, dout, lse,
                                delta, dq, dq_acc, dk, dv, S, H, q_sb, q_ss,
                                k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal,
                                scale, st);
  if (dtype == 2)
    return dispatch_tiles<f16>(which, B, D, block, q, k, v, dout, lse,
                               delta, dq, dq_acc, dk, dv, S, H, q_sb, q_ss,
                               k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal,
                               scale, st);
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one launch of C2 or C3 asks for at head
// dim D and tile `block` (tc_smem_bytes).
extern "C" long long paddle_flash_bwd_tc_smem(int D, int block) {
  return tc_smem_bytes(D, block);
}

// The same for C1 (merged_tc_smem_bytes).
extern "C" long long paddle_flash_bwd_merged_tc_smem(int D, int block) {
  return merged_tc_smem_bytes(D, block);
}
