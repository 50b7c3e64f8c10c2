// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes:
// kernel A, the float32 forward.  bf16 and fp16 run on the tensor cores
// (flash_fwd_tc.cu).
//
// Replaces paddle_tpu/kernels/flash_attention_pallas.py:_fwd_kernel (the
// resident FA2 forward reached through flash_attention_bshd_native).  It
// computes softmax(q k^T * scale) v per (batch, head) over (B, S, H, D)
// tensors in the model's native layout, with a start-aligned causal mask
// when asked, and the base-e row logsumexp (B, S, H) when `lse` is given.
//
// Design.  The TPU kernel walks a sequential grid over q blocks with the
// whole K/V sequence resident in VMEM.  A Hopper block has at most 227 KB
// of shared memory and blocks run in parallel in no order, so here one
// thread block owns one (batch, head, 64-row q tile) and loops over 64-row
// K/V tiles staged through shared memory.  The running max / sum / output
// accumulators stay in f32 registers, and the softmax runs in base 2:
// log2(e) is folded into the scale applied to the q tile as it is staged
// (flash_attention_pallas.py:95-101).  Under `causal`, tiles strictly in
// the future of the q tile are never loaded, and only the diagonal tile
// applies the mask.  The products are plain f32 FMAs on shared-memory
// operands (register-tiled 4x4 per thread); wgmma, TMA and warp
// specialisation are left for a later change.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): at B=1, S=128, H=16, D=64 f32 the kernel must move 2 MiB of
// q/k/v/out (~0.63 us) for ~34 MFLOP causal (~0.5 us); at the training
// shape (8, 1024, 16, 64) causal 32 MiB (~10 us) against ~17 GFLOP
// (~0.26 ms), bound by operations.  Its measured times stand in PERF.md
// beside these bounds.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;     // q rows per thread block
constexpr int kBlockK = 64;     // k/v rows per shared-memory tile
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kLdP = kBlockK + 1;
constexpr float kNegBig = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// Stage rows [row0, row0 + 64) of one head into a padded f32 tile.  Rows
// are `row_stride` elements apart; the head's D elements are contiguous.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* tile, const T* base,
                                           long long row_stride, int row0,
                                           float mul) {
  constexpr int ld = D + 1;
  for (int e = threadIdx.x; e < kBlockK * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    tile[r * ld + c] =
        to_float(base[(long long)(row0 + r) * row_stride + c]) * mul;
  }
}

// Grid (S / 64, H, B); block 256 threads.  Thread (ty, tx) = (tid / 16,
// tid % 16) owns q rows ty + 16 i (i < 4) of the tile, score columns
// tx + 16 j (j < 4) of each K tile, and output columns tx + 16 c.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int H, long long q_sb,
                 long long q_ss, long long k_sb, long long k_ss,
                 long long v_sb, long long v_ss, int causal, float scale2) {
  constexpr int ld = D + 1;       // odd row stride: conflict-free columns
  constexpr int kCols = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * ld;
  float* sV = sK + kBlockK * ld;
  float* sP = sV + kBlockK * ld;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qt * kBlockQ;

  stage_tile<T, D>(sQ, q + b * q_sb + (long long)h * D, q_ss, q0, scale2);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = causal ? qt + 1 : S / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();   // the previous tile's sK/sV/sP reads are done
    stage_tile<T, D>(sK, k + b * k_sb + (long long)h * D, k_ss,
                     kt * kBlockK, 1.f);
    stage_tile<T, D>(sV, v + b * v_sb + (long long)h * D, v_ss,
                     kt * kBlockK, 1.f);
    __syncthreads();

    // scores (already in base-2 units through the scaled q tile)
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; the 16 threads of a row group share each row
    const bool diag = causal && kt == qt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (diag && tx + 16 * j > r) s[i][j] = kNegBig;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sP[r * kLdP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();   // sP complete

    // acc += P V
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = sV[j * ld + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long o = ((long long)b * S + row) * H + h;
    const float inv = 1.f / l[i];
    T* orow = out + o * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      orow[tx + 16 * c] = from_float<T>(acc[i][c] * inv);
    if (lse != nullptr && tx == 0) lse[o] = (m[i] + log2f(l[i])) * kLn2;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int H, long long q_sb, long long q_ss,
           long long k_sb, long long k_ss, long long v_sb, long long v_ss,
           int causal, float scale2, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)((kBlockQ + 2 * kBlockK) * (D + 1) +
                               kBlockQ * kLdP);
  // opt in to >48 KB of dynamic shared memory once per instantiation (the
  // call is idempotent, so a race between threads is harmless)
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid(S / kBlockQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, q_sb, q_ss,
      k_sb, k_ss, v_sb, v_ss, causal, scale2);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int H, int D, long long q_sb,
               long long q_ss, long long k_sb, long long k_ss,
               long long v_sb, long long v_ss, int causal, float scale2,
               cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, S, H, q_sb, q_ss, k_sb,
                           k_ss, v_sb, v_ss, causal, scale2, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, S, H, q_sb, q_ss, k_sb,
                            k_ss, v_sb, v_ss, causal, scale2, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, B, S, H, q_sb, q_ss, k_sb,
                            k_ss, v_sb, v_ss, causal, scale2, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v: (B, S, H, D) with (H, D) dense and the given batch / sequence
// strides in elements; out: dense (B, S, H, D); lse: dense (B, S, H) f32 or
// NULL.  dtype 0 = float32 (the only one instantiated: bf16 and fp16 take
// the tensor-core forward of flash_fwd_tc.cu).  S must be a multiple of 64.
// `scale` is the base-e softmax scale.  Returns the launch's cudaError_t.
extern "C" int paddle_flash_fwd_bshd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int S, int H, int D, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    int causal, float scale, int dtype, void* stream) {
  if (S <= 0 || S % kBlockQ != 0 || B <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  const float scale2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, lse, B, S, H, D, q_sb, q_ss, k_sb,
                             k_ss, v_sb, v_ss, causal, scale2, st);
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t, for the Python wrappers' exceptions.
extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
