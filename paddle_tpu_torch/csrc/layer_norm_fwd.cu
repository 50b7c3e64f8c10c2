// LayerNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces paddle_tpu/kernels/norm_pallas.py:_ln_fwd_kernel: for each row
// of x (R, F) it writes out = (x - mean) * rstd * gamma + beta in x's
// dtype, and the f32 row statistics mean and rstd, with the one-pass
// variance E[x^2] - mean^2 of the TPU kernel.
//
// Design.  The TPU kernel normalises a (block_rows, F) tile per grid step
// out of VMEM.  Here one warp owns one row: every lane reads 16 bytes at a
// time (8 bf16 or 4 f32 values, neighbouring lanes on neighbouring
// addresses), the two f32 sums reduce through warp shuffles, and a second
// sweep over the row (served from L1/L2) writes the output with 16-byte
// stores.  Eight rows per 256-thread block.
//
// Bound on the H100 SXM (3.35 TB/s): at the decode shape (8, 1024) bf16
// with f32 gamma/beta the kernel must move ~41 KB (~0.01 us), and at the
// prefill shape (128, 1024) ~0.53 MB (~0.16 us); launch overhead, not the
// memory, dominates both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ gamma,
                      const TW* __restrict__ beta, TX* __restrict__ out,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      int rows, int cols, float eps) {
  constexpr int V = 16 / sizeof(TX);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + (long long)row * cols;
  TX* orow = out + (long long)row * cols;

  float sum = 0.f, sq = 0.f;
  for (int c = lane * V; c < cols; c += 32 * V) {
    alignas(16) TX vx[V];
    *reinterpret_cast<uint4*>(vx) = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float f = to_float(vx[e]);
      sum += f;
      sq = fmaf(f, f, sq);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float inv_n = 1.f / (float)cols;
  const float mu = sum * inv_n;
  const float var = sq * inv_n - mu * mu;
  const float rs = rsqrtf(var + eps);

  for (int c = lane * V; c < cols; c += 32 * V) {
    alignas(16) TX vx[V];
    alignas(16) TX vo[V];
    *reinterpret_cast<uint4*>(vx) = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float xh = (to_float(vx[e]) - mu) * rs;
      vo[e] = from_float<TX>(xh * to_float(gamma[c + e]) +
                             to_float(beta[c + e]));
    }
    *reinterpret_cast<uint4*>(orow + c) = *reinterpret_cast<const uint4*>(vo);
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* g, const void* b, void* out,
           float* mean, float* rstd, int rows, int cols, float eps,
           cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_fwd_kernel<TX, TW><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(g),
      static_cast<const TW*>(b), static_cast<TX*>(out), mean, rstd, rows,
      cols, eps);
  return (int)cudaGetLastError();
}

template <typename TX>
int dispatch_w(const void* x, const void* g, const void* b, void* out,
               float* mean, float* rstd, int rows, int cols, float eps,
               int w_dtype, cudaStream_t stream) {
  if (w_dtype == 0)
    return launch<TX, float>(x, g, b, out, mean, rstd, rows, cols, eps,
                             stream);
  if (w_dtype == 1)
    return launch<TX, __nv_bfloat16>(x, g, b, out, mean, rstd, rows, cols,
                                     eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: dense (rows, cols), 16-byte aligned, cols a multiple of 8;
// gamma, beta: dense (cols,); mean, rstd: dense (rows,) f32.  dtype codes:
// 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int paddle_layer_norm_fwd(const void* x, const void* gamma,
                                     const void* beta, void* out,
                                     float* mean, float* rstd, int rows,
                                     int cols, float eps, int x_dtype,
                                     int w_dtype, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return dispatch_w<float>(x, gamma, beta, out, mean, rstd, rows, cols,
                             eps, w_dtype, st);
  if (x_dtype == 1)
    return dispatch_w<__nv_bfloat16>(x, gamma, beta, out, mean, rstd, rows,
                                     cols, eps, w_dtype, st);
  return (int)cudaErrorInvalidValue;
}
