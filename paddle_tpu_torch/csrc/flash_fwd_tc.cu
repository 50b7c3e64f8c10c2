// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16 and fp16,
// plain C interface for ctypes.
//
// Replaces, for bfloat16 and float16 inputs at head dims 64, 128 and 256,
// the forward kernels of paddle_tpu/kernels/flash_attention_pallas.py:
// _fwd_kernel (K/V resident), _fwd_kernel_streamed (K/V tiles streamed by
// the grid) and _fwd_kernel_pipelined (a two-stage async-copy ring).  Per
// (batch, head) it computes what their _online_step computes, tile by
// tile over K/V:
//   S = Q K^T (T operands, f32 sums), x = S * scale * log2(e) in f32,
//   m' = max(m, rowmax x),  p = exp2(x - m'),  c = exp2(m - m'),
//   l' = l c + rowsum p (the unrounded f32 p),  O' = O c + T(p) V,
// with T = bf16 or fp16 (the inputs' type): P is rounded to V's type
// before the product, as p.astype(v.dtype) does.  The output is O / l in
// T and lse = (m + log2 l) ln 2, the base-e (B, S, H) f32 row logsumexp
// that the backward (C2, C3) reads.  The start-aligned causal mask (key t
// visible to query s iff t <= s) is applied on the diagonal tiles only;
// tiles strictly in a q tile's future are never loaded.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 and fp16, 3.35 TB/s), counting
// q, k, v read once and out written once against the 4 B H D pairs of the
// two products: at the serving prefill (1, 128, 16, 64) causal 0.000313
// ms (bytes); at the training shape (8, 1024, 16, 64) causal 0.0200 ms
// (bytes; operations 0.0174 ms); at the long-context shape
// (1, 16384, 16, 64) causal 0.556 ms (operations).  Only the tensor cores
// reach the operations rate, hence wgmma.
//
// Design.  One block per (batch, head, BQ-row q tile), one consumer
// warpgroup (128 threads) per 64 q rows.  The q tile is copied once into
// swizzled shared memory; the loop runs over the BK-row K/V tiles through
// a two-stage cp.async ring, tile t + 1's copies issued before tile t is
// waited for.  Per tile, wgmma computes S = Q K^T with both operands in
// shared memory (K-major); the online softmax runs on the accumulator
// registers, where a thread of the m64nBK layout owns two rows and the
// row max and sum take two __shfl_xor_sync steps across its quad (the sum
// only once, at the end: each thread keeps its partial sum, rescaled with
// the row's max); P is converted in place to T as the A fragments of
// O += P V (the m64nNk16 accumulator layout of 16 columns is one k16
// step's A layout), with V read MN-major through the descriptor's
// transpose bit, and O is rescaled by exp2(m - m') before it.  At head dim
// 256 O is two m64n128 accumulators (128 registers a thread).  Under
// causal the q tiles with the most K tiles start first (the block index
// runs the tiles in reverse), and a warpgroup whose 64 rows all lie
// before a tile skips that tile's products.  The per-tile step and the
// epilogue are FwdRows (wgmma_common.cuh), which A' shares.  (BQ, BK) are template
// parameters, the autotuner's flash_fwd "base" candidates for these
// dtypes (_TC_FWD_BLOCKS in kernels/flash_attention_cuda.py).  Kernel A'
// (flash_fwd_pipelined_tc.cu) computes the same with TMA copies into an
// mbarrier ring that a producer of its own keeps full; overlapping one
// tile's softmax with another tile's products was tried there and lost.

#include <math.h>

#include "wgmma_common.cuh"

namespace {

// Dynamic shared memory of one launch: 1024 bytes of slack to align the
// tiles to the swizzle's 1024-byte period, the BQ x D q tile and two
// stages of the BK x D K and V tiles, all 16-bit.
constexpr int fwd_tc_smem_bytes(int D, int BQ, int BK) {
  return 1024 + BQ * D * 2 + 4 * BK * D * 2;
}

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;       // dense (B, S, H, D), T or (out_f32) float
  float* lse;      // dense (B, S, H) f32, or null
  int S, H;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
  int causal;
  float scale2;    // scale * log2(e)
  int out_f32;     // out is float, unrounded
};

// Grid (S / BQ, H, B), 2 BQ threads; block x owns q tile S / BQ - 1 - x,
// warpgroup wg its rows [64 wg, 64 wg + 64).
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(2 * BQ, 1)
flash_fwd_tc_kernel(const FwdArgs a) {
  constexpr int NT = 2 * BQ;
  constexpr int QTILE = BQ * D * 2;   // bytes of the q tile
  constexpr int KTILE = BK * D * 2;   // bytes of one K or V tile
  static_assert(BQ % BK == 0, "the causal band is whole K tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sKV = base + QTILE;

  const int n_t = a.S / BQ;
  const int qt = n_t - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wg = threadIdx.x >> 7;
  const int q0 = qt * BQ;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + (long long)h * D;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + (long long)h * D;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + (long long)h * D;

  // K tiles visited: up to the q tile's last row under causal
  const int n_it = a.causal ? (q0 + BQ) / BK : a.S / BK;
  // at D 256 the unrolled copies' addresses would spill the 128 output
  // registers a thread holds: issue them from rolled loops there
  constexpr bool UNROLL = D != 256;
  auto issue_kv = [&](int st, int kt) {
    const uint32_t sk = sKV + st * 2 * KTILE;
    load_tile<D, BK, NT, UNROLL>(sk, k, a.k_ss, kt * BK);
    load_tile<D, BK, NT, UNROLL>(sk + KTILE, v, a.v_ss, kt * BK);
  };
  load_tile<D, BQ, NT, UNROLL>(sQ, q, a.q_ss, q0);
  issue_kv(0, 0);
  cp_async_commit();

  FwdRows<T, D, BQ, BK> f;
  f.init();

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) issue_kv(st ^ 1, it + 1);
    cp_async_commit();
    cp_async_wait<1>();   // every copy but tile it + 1's has landed
    fence_proxy_async();
    __syncthreads();

    const int c0 = it * BK;
    // under causal a warpgroup whose rows all precede this tile sees none
    // of it (only at BQ > BK, the band's later tiles)
    const bool active = !a.causal || c0 <= q0 + 64 * wg + 63;
    if (active) {
      const uint32_t sK = sKV + st * 2 * KTILE;
      f.tile(sQ, wg, sK, sK + KTILE, c0, q0 + 64 * wg, a.causal, a.scale2);
    }
    __syncthreads();   // the stage is free for the copies of tile it + 2
  }

  if (a.out_f32)
    f.finish(static_cast<float*>(a.out), a.lse, b, a.S, a.H, h, q0 + 64 * wg);
  else
    f.finish(static_cast<T*>(a.out), a.lse, b, a.S, a.H, h, q0 + 64 * wg);
}

template <typename T, int D, int BQ, int BK>
int launch(const FwdArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = fwd_tc_smem_bytes(D, BQ, BK);
  // opt in to more than 48 KB of dynamic shared memory once per
  // instantiation (idempotent, so a race between threads is harmless)
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<T, D, BQ, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  flash_fwd_tc_kernel<T, D, BQ, BK>
      <<<dim3(a.S / BQ, a.H, B), 2 * BQ, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the instantiated (D, BQ, BK): (128, 128), (128, 64) and (64, 64) at
// D = 64; (128, 64) and (64, 64) at D = 128; (64, 64) and (128, 64) at 256
template <typename T>
int dispatch_tiles(int D, int bq, int bk, const FwdArgs& a, int B,
                   cudaStream_t st) {
  if (D == 64 && bq == 128 && bk == 128) return launch<T, 64, 128, 128>(a, B, st);
  if (D == 64 && bq == 128 && bk == 64) return launch<T, 64, 128, 64>(a, B, st);
  if (D == 64 && bq == 64 && bk == 64) return launch<T, 64, 64, 64>(a, B, st);
  if (D == 128 && bq == 128 && bk == 64) return launch<T, 128, 128, 64>(a, B, st);
  if (D == 128 && bq == 64 && bk == 64) return launch<T, 128, 64, 64>(a, B, st);
  if (D == 256 && bq == 64 && bk == 64) return launch<T, 256, 64, 64>(a, B, st);
  if (D == 256 && bq == 128 && bk == 64) return launch<T, 256, 128, 64>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

int run(const void* q, const void* k, const void* v, void* out, float* lse,
        int B, int S, int H, int D, long long q_sb, long long q_ss,
        long long k_sb, long long k_ss, long long v_sb, long long v_ss,
        int causal, float scale, int dtype, int block_q, int block_k,
        void* stream, int out_f32) {
  if (S <= 0 || B <= 0 || H <= 0 || block_q <= 0 || block_k <= 0 ||
      S % block_q != 0 || S % block_k != 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  if ((ptrs & 15) || ((q_sb | q_ss | k_sb | k_ss | v_sb | v_ss) & 7))
    return (int)cudaErrorMisalignedAddress;
  const FwdArgs a{q,    k,    v,    out,  lse,  S,      H,
                  q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,   causal,
                  scale * kLog2e, out_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch_tiles<bf16>(D, block_q, block_k, a, B, st);
  if (dtype == 2) return dispatch_tiles<f16>(D, block_q, block_k, a, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v: (B, S, H, D) with (H, D) dense, every row starting on 16 bytes,
// and the given batch / sequence strides in elements; out: dense
// (B, S, H, D); lse: dense (B, S, H) f32 or NULL.  dtype 1 = bfloat16,
// 2 = float16.  S must be a multiple of block_q and block_k.  `scale` is
// the base-e softmax scale.  Returns the launch's cudaError_t.
extern "C" int paddle_flash_fwd_tc(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int S, int H, int D, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    int causal, float scale, int dtype, int block_q, int block_k,
    void* stream) {
  return run(q, k, v, out, lse, B, S, H, D, q_sb, q_ss, k_sb, k_ss, v_sb,
             v_ss, causal, scale, dtype, block_q, block_k, stream, 0);
}

// The same with `out` a dense (B, S, H, D) float32 tensor: O / l
// unrounded (ring attention combines its blocks before one rounding).
extern "C" int paddle_flash_fwd_tc_f32out(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int S, int H, int D, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    int causal, float scale, int dtype, int block_q, int block_k,
    void* stream) {
  return run(q, k, v, out, lse, B, S, H, D, q_sb, q_ss, k_sb, k_ss, v_sb,
             v_ss, causal, scale, dtype, block_q, block_k, stream, 1);
}

// Bytes of dynamic shared memory one launch asks for at head dim D and
// tiles (block_q, block_k) (fwd_tc_smem_bytes).
extern "C" long long paddle_flash_fwd_tc_smem(int D, int block_q,
                                              int block_k) {
  return fwd_tc_smem_bytes(D, block_q, block_k);
}
