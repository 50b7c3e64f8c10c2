// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the three backward kernels of
// paddle_tpu/kernels/flash_attention_pallas.py:
//   C1 paddle_flash_bwd      <- _bwd_kernel      (merged dQ/dK/dV)
//   C2 paddle_flash_bwd_dq   <- _bwd_dq_kernel   (split backward, dQ)
//   C3 paddle_flash_bwd_dkv  <- _bwd_dkv_kernel  (split backward, dK/dV)
// This file holds the entry points and the float32 kernels, on FMAs (f32
// on the tensor cores would be TF32, other numerics); bf16 and fp16 calls
// of all three go to the tensor-core kernels of flash_bwd_tc.cu.
// Per (batch, head) they compute, from q, k, v, dO, the base-e row
// logsumexp that the forward saved and delta = rowsum(dO * O) (minus the
// lse cotangent, folded in by the caller):
//   P  = exp2(scale * log2e * Q K^T - lse * log2e)   (P recomputed, base 2)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),
//   dK = scale * dS^T Q,  dQ = scale * dS K
// with the start-aligned causal mask when asked: tiles strictly in the
// future are never visited and only the diagonal tile masks.  The base-e
// lse becomes base 2 in one place, as it is staged (stage_rows).
//
// Design.  The TPU kernels walk a sequential grid and carry sums in VMEM
// scratch from one grid step to the next; Hopper blocks run in parallel
// in no order.  So a loop inside the block takes the place of the
// sequential grid dimension:
//   C1/C3: one block per (batch, head, 64-row K tile) holds K, V in shared
//          memory and dK/dV in f32 registers, and loops over the q tiles
//          that can see the K tile.  C1 also forms the tile's dQ share
//          (dS K) and adds it with f32 atomicAdd into an f32 (B, S, H, D)
//          workspace that the caller scales: the order of those
//          additions, and so the last bits of dQ, vary from run to run.
//   C2:    one block per (batch, head, 64-row q tile) holds Q, dO in shared
//          memory and dQ in f32 registers, and loops over the K tiles up to
//          the diagonal.  C2 and C3 are deterministic.
// Operands are staged in shared memory with odd row strides (no bank
// conflicts on column walks); the products are plain f32 FMAs,
// register-tiled per thread of a 16 x 16 grid, as in flash_fwd.cu.
// The tile rows BM are a template parameter beside D, chosen by the
// caller (the autotuner's flash_bwd* candidates): 64 (4 x 4 scores per
// thread) or 32 (2 x 2) up to D = 128, 32 at D = 256, where four 64-row
// f32 operand tiles alone would need 4 x 64 x 257 x 4 B = 263 KB of
// shared memory, more than the 227 KB a block may use (136 KB in all at
// 32 rows).
//
// Bound on the H100 SXM (67 TFLOP/s f32 outside the tensor cores, 3.35
// TB/s): at the training shape B=8, S=1024, H=16, D=64 causal f32 C1's
// five products need 5 * 2 S^2 D * B H / 2 = 4.3e10 FLOP (0.642 ms)
// against ~235 MB of operands (q, k, v, dO in, dq, dk, dv out, the f32 lse
// and delta rows; 0.070 ms): compute-bound.  The measured times stand in
// PERF.md.

#include <cuda_runtime.h>

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

constexpr int kThreads = 256;   // 16 x 16 threads

// the score rows (and columns) each thread owns in a BM-row tile
template <int BM>
constexpr int kPer = BM / 16;
constexpr float kLog2e = 1.4426950408889634f;

// Stage rows [row0, row0 + BM) of one head into a padded f32 tile.  Rows
// are `row_stride` elements apart; the head's D elements are contiguous.
template <int D, int BM>
__device__ __forceinline__ void stage_tile(float* tile, const float* base,
                                           long long row_stride, int row0) {
  constexpr int ld = D + 1;
  for (int e = threadIdx.x; e < BM * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    tile[r * ld + c] = base[(long long)(row0 + r) * row_stride + c];
  }
}

// The tile rows' base-2 lse and delta of one head from dense (B, S, H)
// f32.
template <int BM>
__device__ __forceinline__ void stage_rows(float* s_lse2, float* s_delta,
                                           const float* lse,
                                           const float* delta, int b, int S,
                                           int H, int h, int row0) {
  if (threadIdx.x < BM) {
    const long long o = ((long long)b * S + row0 + threadIdx.x) * H + h;
    s_lse2[threadIdx.x] = lse[o] * kLog2e;
    s_delta[threadIdx.x] = delta[o];
  }
}

// Shared-memory layout common to all three kernels: four operand tiles
// (BM x (D+1) f32 each), the P / dS tile (BM x (BM+1)) and the two row
// vectors.
template <int D, int BM>
constexpr size_t smem_bytes() {
  constexpr int bm = BM;
  return sizeof(float) *
         (size_t)(4 * bm * (D + 1) + bm * (bm + 1) + 2 * bm);
}

// s[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d]: the thread's register
// tile of a BM x BM product of two row-major shared tiles.
template <int D, int BM>
__device__ __forceinline__ void tile_abt(float (&s)[kPer<BM>][kPer<BM>],
                                         const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int ld = D + 1;
  constexpr int n = kPer<BM>;
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[n], bv[n];
#pragma unroll
    for (int i = 0; i < n; ++i) a[i] = A[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < n; ++j) bv[j] = B[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = 0; j < n; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
  }
}

// P from the raw scores: exp2(s * scale2 - lse2), zero where the diagonal
// tile's mask hides the key (local column j > local row i).
template <int BM>
__device__ __forceinline__ void probs(float (&s)[kPer<BM>][kPer<BM>],
                                      const float* s_lse2, float scale2,
                                      bool diag, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kPer<BM>; ++i) {
    const int r = ty + 16 * i;
    const float l2 = s_lse2[r];
#pragma unroll
    for (int j = 0; j < kPer<BM>; ++j) {
      const int c = tx + 16 * j;
      s[i][j] = (diag && c > r) ? 0.f : exp2f(fmaf(s[i][j], scale2, -l2));
    }
  }
}

// acc[r][c] += sum_i W[i][ty + 16 r] * X[i][tx + 16 c]: a K-side
// (BM x D) accumulation through a transposed BM x BM weight tile
// (P^T dO, dS^T Q).
template <int D, int BM>
__device__ __forceinline__ void acc_wt_x(float (&acc)[kPer<BM>][D / 16],
                                         const float* W, const float* X,
                                         int ty, int tx) {
  constexpr int ld = D + 1;
  constexpr int ldp = BM + 1;
  constexpr int n = kPer<BM>;
#pragma unroll 4
  for (int i = 0; i < BM; ++i) {
    float w[n];
#pragma unroll
    for (int r = 0; r < n; ++r) w[r] = W[i * ldp + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float x = X[i * ld + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < n; ++r) acc[r][c] = fmaf(w[r], x, acc[r][c]);
    }
  }
}

// acc[r][c] += sum_j W[ty + 16 r][j] * X[j][tx + 16 c]: a q-side
// (BM x D) product of a BM x BM weight tile and a BM x D operand (dS K).
template <int D, int BM>
__device__ __forceinline__ void acc_w_x(float (&acc)[kPer<BM>][D / 16],
                                        const float* W, const float* X,
                                        int ty, int tx) {
  constexpr int ld = D + 1;
  constexpr int ldp = BM + 1;
  constexpr int n = kPer<BM>;
#pragma unroll 4
  for (int j = 0; j < BM; ++j) {
    float w[n];
#pragma unroll
    for (int r = 0; r < n; ++r) w[r] = W[(ty + 16 * r) * ldp + j];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float x = X[j * ld + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < n; ++r) acc[r][c] = fmaf(w[r], x, acc[r][c]);
    }
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

// C1 (kWithDq) and C3: grid (S / BM, H, B), one block per K tile.
template <int D, int BM, bool kWithDq>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const Args a) {
  constexpr int ld = D + 1;
  constexpr int kCols = D / 16;
  constexpr int bm = BM;
  constexpr int ldp = bm + 1;
  constexpr int n = kPer<BM>;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + bm * ld;
  float* sQ = sV + bm * ld;
  float* sdO = sQ + bm * ld;
  float* sP = sdO + bm * ld;
  float* s_lse2 = sP + bm * ldp;
  float* s_delta = s_lse2 + bm;

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = kt * bm;
  const float scale2 = a.scale * kLog2e;
  const float* q =
      static_cast<const float*>(a.q) + b * a.q_sb + (long long)h * D;
  const float* k =
      static_cast<const float*>(a.k) + b * a.k_sb + (long long)h * D;
  const float* v =
      static_cast<const float*>(a.v) + b * a.v_sb + (long long)h * D;
  const float* dout =
      static_cast<const float*>(a.dout) + b * a.o_sb + (long long)h * D;

  stage_tile<D, BM>(sK, k, a.k_ss, k0);
  stage_tile<D, BM>(sV, v, a.v_ss, k0);

  float acc_k[n][kCols], acc_v[n][kCols];
#pragma unroll
  for (int r = 0; r < n; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  const int n_q = a.S / bm;
  for (int qt = a.causal ? kt : 0; qt < n_q; ++qt) {
    const int q0 = qt * bm;
    __syncthreads();   // the previous q tile's reads of sQ/sdO/sP are done
    stage_tile<D, BM>(sQ, q, a.q_ss, q0);
    stage_tile<D, BM>(sdO, dout, a.o_ss, q0);
    stage_rows<BM>(s_lse2, s_delta, a.lse, a.delta, b, a.S, a.H, h, q0);
    __syncthreads();

    float p[n][n], dp[n][n];
    tile_abt<D, BM>(p, sQ, sK, ty, tx);
    probs<BM>(p, s_lse2, scale2, a.causal && qt == kt, ty, tx);
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = 0; j < n; ++j)
        sP[(ty + 16 * i) * ldp + tx + 16 * j] = p[i][j];
    tile_abt<D, BM>(dp, sdO, sV, ty, tx);
    __syncthreads();   // sP holds P

    acc_wt_x<D, BM>(acc_v, sP, sdO, ty, tx);   // dV += P^T dO
    __syncthreads();   // every read of P is done
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float dl = s_delta[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < n; ++j)
        sP[(ty + 16 * i) * ldp + tx + 16 * j] = p[i][j] * (dp[i][j] - dl);
    }
    __syncthreads();   // sP holds dS

    acc_wt_x<D, BM>(acc_k, sP, sQ, ty, tx);    // dK += dS^T Q
    if (kWithDq) {
      float dq[n][kCols];
#pragma unroll
      for (int r = 0; r < n; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) dq[r][c] = 0.f;
      acc_w_x<D, BM>(dq, sP, sK, ty, tx);      // this K tile's share of dS K
#pragma unroll
      for (int r = 0; r < n; ++r) {
        float* row = a.dq_acc +
                     (((long long)b * a.S + q0 + ty + 16 * r) * a.H + h) * D;
#pragma unroll
        for (int c = 0; c < kCols; ++c) atomicAdd(row + tx + 16 * c, dq[r][c]);
      }
    }
  }

  float* dk = static_cast<float*>(a.dk);
  float* dv = static_cast<float*>(a.dv);
#pragma unroll
  for (int r = 0; r < n; ++r) {
    const long long o = (((long long)b * a.S + k0 + ty + 16 * r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[o + tx + 16 * c] = acc_k[r][c] * a.scale;
      dv[o + tx + 16 * c] = acc_v[r][c];
    }
  }
}

// C2: grid (S / BM, H, B), one block per q tile.
template <int D, int BM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Args a) {
  constexpr int ld = D + 1;
  constexpr int kCols = D / 16;
  constexpr int bm = BM;
  constexpr int ldp = bm + 1;
  constexpr int n = kPer<BM>;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + bm * ld;
  float* sQ = sV + bm * ld;
  float* sdO = sQ + bm * ld;
  float* sP = sdO + bm * ld;
  float* s_lse2 = sP + bm * ldp;
  float* s_delta = s_lse2 + bm;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qt * bm;
  const float scale2 = a.scale * kLog2e;
  const float* q =
      static_cast<const float*>(a.q) + b * a.q_sb + (long long)h * D;
  const float* k =
      static_cast<const float*>(a.k) + b * a.k_sb + (long long)h * D;
  const float* v =
      static_cast<const float*>(a.v) + b * a.v_sb + (long long)h * D;
  const float* dout =
      static_cast<const float*>(a.dout) + b * a.o_sb + (long long)h * D;

  stage_tile<D, BM>(sQ, q, a.q_ss, q0);
  stage_tile<D, BM>(sdO, dout, a.o_ss, q0);
  stage_rows<BM>(s_lse2, s_delta, a.lse, a.delta, b, a.S, a.H, h, q0);

  float acc_q[n][kCols];
#pragma unroll
  for (int r = 0; r < n; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_q[r][c] = 0.f;

  const int n_k = a.causal ? qt + 1 : a.S / bm;
  for (int kt = 0; kt < n_k; ++kt) {
    __syncthreads();   // the previous K tile's reads of sK/sV/sP are done
    stage_tile<D, BM>(sK, k, a.k_ss, kt * bm);
    stage_tile<D, BM>(sV, v, a.v_ss, kt * bm);
    __syncthreads();

    float p[n][n], dp[n][n];
    tile_abt<D, BM>(p, sQ, sK, ty, tx);
    probs<BM>(p, s_lse2, scale2, a.causal && qt == kt, ty, tx);
    tile_abt<D, BM>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float dl = s_delta[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < n; ++j)
        sP[(ty + 16 * i) * ldp + tx + 16 * j] = p[i][j] * (dp[i][j] - dl);
    }
    __syncthreads();   // sP holds dS

    acc_w_x<D, BM>(acc_q, sP, sK, ty, tx);     // dQ += dS K
  }

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int r = 0; r < n; ++r) {
    const long long o = (((long long)b * a.S + q0 + ty + 16 * r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      dq[o + tx + 16 * c] = acc_q[r][c] * a.scale;
  }
}

// Opt in to > 48 KB of dynamic shared memory once per instantiation (the
// call is idempotent, so a race between threads is harmless), then launch.
template <typename Kernel>
int launch(Kernel kernel, bool& smem_set, size_t smem, int block_rows,
           const Args& a, cudaStream_t stream) {
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid(a.S / block_rows, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// which: 0 = C1 merged, 1 = C2 dq, 2 = C3 dkv; float32 (the tensor-core
// kernels take bf16 and fp16).
template <int D, int BM>
int dispatch_which(int which, const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BM>();
  static bool set_merged = false, set_dq = false, set_dkv = false;
  if (which == 0)
    return launch(flash_bwd_kv_kernel<D, BM, true>, set_merged, smem, BM, a,
                  stream);
  if (which == 1)
    return launch(flash_bwd_dq_kernel<D, BM>, set_dq, smem, BM, a, stream);
  if (which == 2)
    return launch(flash_bwd_kv_kernel<D, BM, false>, set_dkv, smem, BM, a,
                  stream);
  return (int)cudaErrorInvalidValue;
}

// the (D, tile rows) pairs instantiated: 64 or 32 rows up to D = 128, 32
// at D = 256
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
// batch / sequence strides in elements; lse (base-e) and delta dense
// (B, S, H) f32; D in {64, 128, 256}; `block` the tile rows (f32: 64 or 32
// at D <= 128, 32 at D = 256; bf16 and fp16: 64 or 128 at D = 64, 64 at D
// = 128 and 256, rows 16-byte aligned), S a multiple of it; dtype 0 =
// float32, 1 = bfloat16, 2 = float16; `scale` the base-e softmax scale.
// Outputs are dense (B, S, H, D).  Each returns its launch's cudaError_t.

// C1: dq_acc is an f32 workspace the caller zeroes and casts; in f32 the
// caller also scales it, in bf16 and fp16 the kernel folds the scale in.
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
