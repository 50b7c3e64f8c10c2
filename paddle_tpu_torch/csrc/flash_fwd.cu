// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes:
// kernel A, the float32 forward.  bf16 and fp16 run on the tensor cores
// (flash_fwd_tc.cu).
//
// Replaces paddle_tpu/kernels/flash_attention_pallas.py:_fwd_kernel (the
// resident FA2 forward reached through flash_attention_bshd_native) and
// :_fwd_kernel_streamed (the same with K/V streamed by the grid).  It
// computes softmax(q k^T * scale) v per (batch, head) over (B, S, H, D)
// tensors in the model's native layout, with a start-aligned causal mask
// when asked, and the base-e row logsumexp (B, S, H) when `lse` is given.
//
// Design.  The TPU kernel walks a sequential grid over q blocks with the
// whole K/V sequence resident in VMEM.  A Hopper block has at most 227 KB
// of shared memory and blocks run in parallel in no order, so here one
// thread block owns one (batch, head, 64-row q tile), one warp each 16
// rows, and loops over K/V tiles (64 rows; 32 at D 256, where two stages
// of 64-row f32 tiles would not fit beside the q tile) that a two-stage
// cp.async ring brings in while the tile before computes.  Both products,
// S = q K^T and P V, run on the tensor cores as 3 x TF32 mma.sync (each
// f32 operand split into two TF32 parts), the online softmax runs in f32
// registers in base 2 (log2(e) folded into the scale applied to the q
// tile), and P goes from the S accumulators straight into P V: the body
// is flash_fwd_tf32x3 of tf32x3_common.cuh, which kernel A'
// (flash_fwd_pipelined.cu) shares.  Under `causal`, tiles past the q
// tile's band are never loaded and only a tile that reaches past a warp's
// first row applies the mask.
//
// Bound on the H100 SXM (3.35 TB/s; 495 TFLOP/s TF32 dense, so 165 for
// three products a product): at the training shape (8, 1024, 16, 64)
// causal, 4 S^2 D / 2 FLOP a (batch, head) make 17.2 GFLOP, 0.104 ms as 3
// x TF32 (0.257 ms on the 67 TFLOP/s f32 FMAs), against 32 MiB of q, k, v
// and out (0.010 ms): bound by the tensor cores.  Its measured times
// stand in PERF.md beside these bounds.

#include "tf32x3_common.cuh"

namespace {

// kernel A's tiles: 64 q rows, 64-row K/V tiles (32 at D 256), two
// stages; 87,040, 168,960 and 199,680 bytes of shared memory at D 64, 128
// and 256, within a block's 232,448 at every head dim
constexpr int kBlockQ = 64;
constexpr int kStages = 2;
__host__ __device__ constexpr int a_block_k(int D) {
  return D == 256 ? 32 : 64;
}

template <int D>
__global__ void __launch_bounds__(fwd_threads(kBlockQ))
flash_fwd_kernel(const FwdArgs a) {
  flash_fwd_tf32x3<D, kBlockQ, a_block_k(D), kStages>(a);
}

template <int D>
int launch(const FwdArgs& a, int B, cudaStream_t stream) {
  static bool smem_set = false;
  return launch_fwd(flash_fwd_kernel<D>, smem_set,
                    fwd_smem_bytes(D, kBlockQ, a_block_k(D), kStages),
                    kBlockQ, B, a, stream);
}

}  // namespace

// q/k/v: (B, S, H, D) with (H, D) dense, rows 16-byte aligned (the caller
// copies others) and the given batch / sequence strides in elements; out:
// dense (B, S, H, D); lse: dense (B, S, H) f32 or NULL.  dtype 0 =
// float32, the only one taken (bf16 and fp16 take the tensor-core forward
// of flash_fwd_tc.cu).  S must be a multiple of 64.  `scale` is the
// base-e softmax scale.  Returns the launch's cudaError_t.
extern "C" int paddle_flash_fwd_bshd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int S, int H, int D, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    int causal, float scale, int dtype, void* stream) {
  if (S <= 0 || S % kBlockQ != 0 || B <= 0 || H <= 0 || dtype != 0)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(out),
                  lse, S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, causal,
                  scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(a, B, st);
    case 128:
      return launch<128>(a, B, st);
    case 256:
      return launch<256>(a, B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The message of a cudaError_t, for the Python wrappers' exceptions.
extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
