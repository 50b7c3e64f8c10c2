// Flash-attention forward with pipelined K/V tiles for Hopper (sm_90a),
// plain C interface for ctypes: kernel A' for float32 inputs (bf16 and
// fp16 take flash_fwd_pipelined_tc.cu).
//
// Replaces paddle_tpu/kernels/flash_attention_pallas.py:_fwd_kernel_pipelined
// (the `pipelined` variant of the flash_fwd autotune family).  It computes
// what kernel A (flash_fwd.cu) computes: softmax(q k^T * scale) v per
// (batch, head) over (B, S, H, D) tensors in the model's native layout,
// with a start-aligned causal mask when asked, and the base-e row
// logsumexp (B, S, H) when `lse` is given.
//
// Design.  The TPU kernel keeps K/V in HBM and double-buffers block_k-row
// chunks into VMEM with async copies, issuing the copy of chunk i+1 before
// it waits for chunk i, so the fetch overlaps the softmax chain
// (flash_attention_pallas.py:555-572).  Here the explicit multi-stage copy
// is a cp.async ring as deep as shared memory allows: three stages of K
// and V tiles where they fit a block's 232,448 bytes beside the q tile,
// else two (kernel A keeps two at every tile, so two of its blocks share
// an SM at D 64), the copy of tile kt + stages - 1 in flight while tile kt
// computes.  As at :541, under `causal` the scan stops after the diagonal
// band, kend = (qt + 1) * BQ / BK.  Everything else is kernel A's body
// (flash_fwd_tf32x3 of tf32x3_common.cuh): one warp each 16 q rows, S =
// q K^T and P V as 3 x TF32 mma.sync products into fresh accumulators, the
// online softmax in f32 registers in base 2, the mask only where a tile
// reaches past a warp's first row.  The tile shape (block_q, block_k) is
// a template parameter: (64, 32), (64, 64), (128, 64) or (128, 128).
//
// Bound on the H100 SXM (3.35 TB/s; 165 TFLOP/s for three TF32 products a
// product): as kernel A, it must read q, k, v and write out once (32 MiB
// at B=8, S=1024, H=16, D=64 f32, 0.010 ms) and do 4 S^2 D / 2 FLOP per
// (batch, head) causal (17.2 GFLOP there, 0.104 ms as 3 x TF32, 0.257 ms
// on the f32 FMAs): bound by the tensor cores.  Its measured times stand
// in PERF.md beside the bound.

#include "tf32x3_common.cuh"

namespace {

// three stages where they fit a block, else two
__host__ __device__ constexpr int pipelined_stages(int D, int BQ, int BK) {
  return fwd_smem_bytes(D, BQ, BK, 3) <= kMaxBlockSmem ? 3 : 2;
}
__host__ __device__ constexpr size_t pipelined_smem(int D, int BQ, int BK) {
  return fwd_smem_bytes(D, BQ, BK, pipelined_stages(D, BQ, BK));
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(fwd_threads(BQ))
flash_fwd_pipelined_kernel(const FwdArgs a) {
  flash_fwd_tf32x3<D, BQ, BK, pipelined_stages(D, BQ, BK)>(a);
}

template <int D, int BQ, int BK>
int launch(const FwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = pipelined_smem(D, BQ, BK);
  if constexpr (smem > kMaxBlockSmem) {
    // the wrapper's gate refuses this tile; no kernel is built for it
    return (int)cudaErrorInvalidConfiguration;
  } else {
    static bool smem_set = false;
    return launch_fwd(flash_fwd_pipelined_kernel<D, BQ, BK>, smem_set, smem,
                      BQ, B, a, stream);
  }
}

// the (block_q, block_k) pairs instantiated at each D
template <int D>
int dispatch_blocks(int bq, int bk, const FwdArgs& a, int B,
                    cudaStream_t stream) {
  if (bq == 64 && bk == 32) return launch<D, 64, 32>(a, B, stream);
  if (bq == 64 && bk == 64) return launch<D, 64, 64>(a, B, stream);
  if (bq == 128 && bk == 64) return launch<D, 128, 64>(a, B, stream);
  if (bq == 128 && bk == 128) return launch<D, 128, 128>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

bool instantiated(int D, int bq, int bk) {
  const bool blocks = (bq == 64 && (bk == 32 || bk == 64)) ||
                      (bq == 128 && (bk == 64 || bk == 128));
  return blocks && (D == 64 || D == 128 || D == 256);
}

}  // namespace

// q/k/v: (B, S, H, D) with (H, D) dense and the given batch / sequence
// strides in elements, every row 16-byte aligned (base pointers and
// strides: the caller checks); out: dense (B, S, H, D); lse: dense
// (B, S, H) f32 or NULL.  dtype 0 = float32.  (block_q,
// block_k) one of (64, 32), (64, 64), (128, 64), (128, 128), S a multiple
// of block_q.  `scale` is the base-e softmax scale.  Returns the launch's
// cudaError_t.
extern "C" int paddle_flash_fwd_pipelined(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int S, int H, int D, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    int causal, float scale, int dtype, int block_q, int block_k,
    void* stream) {
  if (S <= 0 || B <= 0 || H <= 0 || dtype != 0 ||
      !instantiated(D, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(out),
                  lse, S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, causal,
                  scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch_blocks<64>(block_q, block_k, a, B, st);
    case 128:
      return dispatch_blocks<128>(block_q, block_k, a, B, st);
    default:
      return dispatch_blocks<256>(block_q, block_k, a, B, st);
  }
}

// The dynamic shared memory a launch of that configuration asks for, or -1
// when it is not instantiated (dtype 0 = float32 only): the wrapper's
// smem_bytes hook is held to it.
extern "C" long long paddle_flash_fwd_pipelined_smem(int D, int block_q,
                                                     int block_k,
                                                     int dtype) {
  if (!instantiated(D, block_q, block_k) || dtype != 0) return -1;
  return (long long)pipelined_smem(D, block_q, block_k);
}
