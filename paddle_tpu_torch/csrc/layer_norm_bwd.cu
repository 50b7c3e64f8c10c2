// LayerNorm backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces paddle_tpu/kernels/norm_pallas.py:_ln_bwd_kernel.  From x
// (R, F), gamma (F,), the forward's f32 row statistics mean / rstd and the
// output cotangent dO (R, F) it computes
//   xhat = (x - mean) * rstd,  dxhat = dO * gamma,
//   dx   = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
//   dgamma = sum over all rows of dO * xhat,  dbeta = sum of dO,
// with f32 arithmetic; dx keeps x's dtype and dgamma / dbeta take gamma's.
//
// Design.  The TPU kernel carries dgamma / dbeta in its output block from
// one step of its sequential row grid to the next.  Hopper blocks run in
// no order, so each block writes the f32 partial sums of its own rows into
// a (blocks, F) workspace and a second small launch of this source adds
// the partials column by column in block order: deterministic, which
// atomics would not be.  In the first launch one warp owns four rows:
// a first sweep over each row (16-byte loads, neighbouring lanes on
// neighbouring addresses) forms the two row means through warp shuffles,
// a second sweep, column chunk by column chunk, writes dx and sums the
// chunk's dgamma / dbeta contributions in registers; the eight warps of a
// block then add theirs through shared memory in warp order.
//
// Bound on the H100 SXM (3.35 TB/s): at the training shape (8192, 1024)
// bf16 with f32 gamma the kernel must read x and dO and write dx, ~50 MB
// (~15 us); the partials add 2 MB each way.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

template <typename TX>
__device__ __forceinline__ void load16(TX (&dst)[16 / sizeof(TX)],
                                       const TX* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// Grid ceil(R / 32) blocks of 256 threads; writes dx and this block's
// dgamma / dbeta partials (rows part_g[blockIdx.x], part_b[blockIdx.x]).
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ gamma,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      const TX* __restrict__ dout, TX* __restrict__ dx,
                      float* __restrict__ part_g, float* __restrict__ part_b,
                      int rows, int cols) {
  constexpr int V = 16 / sizeof(TX);
  constexpr int kChunk = 32 * V;   // columns one warp covers per sweep step
  __shared__ float red_g[kWarps][kChunk];
  __shared__ float red_b[kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const float inv_n = 1.f / (float)cols;

  // first sweep: mean(dxhat) and mean(dxhat * xhat) of every owned row
  float mu[kRowsPerWarp], rs[kRowsPerWarp], m1[kRowsPerWarp],
      m2[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + rr;
    mu[rr] = rs[rr] = m1[rr] = m2[rr] = 0.f;
    if (row >= rows) continue;
    mu[rr] = mean[row];
    rs[rr] = rstd[row];
    const TX* xr = x + (long long)row * cols;
    const TX* dr = dout + (long long)row * cols;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * V; c < cols; c += kChunk) {
      alignas(16) TX vx[V];
      alignas(16) TX vd[V];
      load16<TX>(vx, xr + c);
      load16<TX>(vd, dr + c);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xh = (to_float(vx[e]) - mu[rr]) * rs[rr];
        const float dxh = to_float(vd[e]) * to_float(gamma[c + e]);
        s1 += dxh;
        s2 = fmaf(dxh, xh, s2);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    m1[rr] = s1 * inv_n;
    m2[rr] = s2 * inv_n;
  }

  // second sweep, one column chunk at a time: dx, and the block's partial
  // dgamma / dbeta of the chunk
  for (int c0 = 0; c0 < cols; c0 += kChunk) {
    const int c = c0 + lane * V;
    float gs[V], bs[V];
#pragma unroll
    for (int e = 0; e < V; ++e) gs[e] = bs[e] = 0.f;
    if (c < cols) {
      float g[V];
#pragma unroll
      for (int e = 0; e < V; ++e) g[e] = to_float(gamma[c + e]);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int row = row0 + rr;
        if (row >= rows) continue;
        alignas(16) TX vx[V];
        alignas(16) TX vd[V];
        alignas(16) TX vo[V];
        load16<TX>(vx, x + (long long)row * cols + c);
        load16<TX>(vd, dout + (long long)row * cols + c);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = (to_float(vx[e]) - mu[rr]) * rs[rr];
          const float d = to_float(vd[e]);
          const float dxh = d * g[e];
          vo[e] = from_float<TX>(rs[rr] * (dxh - m1[rr] - xh * m2[rr]));
          gs[e] = fmaf(d, xh, gs[e]);
          bs[e] += d;
        }
        *reinterpret_cast<uint4*>(dx + (long long)row * cols + c) =
            *reinterpret_cast<const uint4*>(vo);
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      red_g[warp][lane * V + e] = gs[e];
      red_b[warp][lane * V + e] = bs[e];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kChunk; t += kThreads) {
      if (c0 + t < cols) {
        float sg = 0.f, sb = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sg += red_g[w][t];
          sb += red_b[w][t];
        }
        part_g[(long long)blockIdx.x * cols + c0 + t] = sg;
        part_b[(long long)blockIdx.x * cols + c0 + t] = sb;
      }
    }
    __syncthreads();   // red_* are rewritten by the next chunk
  }
}

// One thread per column: the partials of every block, added in block
// order, cast to gamma's dtype.
template <typename TW>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_reduce_kernel(const float* __restrict__ part_g,
                             const float* __restrict__ part_b,
                             TW* __restrict__ dgamma, TW* __restrict__ dbeta,
                             int parts, int cols) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  float sg = 0.f, sb = 0.f;
  for (int p = 0; p < parts; ++p) {
    sg += part_g[(long long)p * cols + c];
    sb += part_b[(long long)p * cols + c];
  }
  dgamma[c] = from_float<TW>(sg);
  dbeta[c] = from_float<TW>(sb);
}

template <typename TX, typename TW>
int launch(const void* x, const void* g, const float* mean,
           const float* rstd, const void* dout, void* dx, float* part_g,
           float* part_b, void* dg, void* db, int rows, int cols, int parts,
           cudaStream_t stream) {
  layer_norm_bwd_kernel<TX, TW><<<parts, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(g), mean, rstd,
      static_cast<const TX*>(dout), static_cast<TX*>(dx), part_g, part_b,
      rows, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  layer_norm_bwd_reduce_kernel<TW>
      <<<(cols + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          part_g, part_b, static_cast<TW*>(dg), static_cast<TW*>(db), parts,
          cols);
  return (int)cudaGetLastError();
}

template <typename TX>
int dispatch_w(const void* x, const void* g, const float* mean,
               const float* rstd, const void* dout, void* dx, float* part_g,
               float* part_b, void* dg, void* db, int rows, int cols,
               int parts, int w_dtype, cudaStream_t stream) {
  if (w_dtype == 0)
    return launch<TX, float>(x, g, mean, rstd, dout, dx, part_g, part_b, dg,
                             db, rows, cols, parts, stream);
  if (w_dtype == 1)
    return launch<TX, __nv_bfloat16>(x, g, mean, rstd, dout, dx, part_g,
                                     part_b, dg, db, rows, cols, parts,
                                     stream);
  if (w_dtype == 2)
    return launch<TX, __half>(x, g, mean, rstd, dout, dx, part_g, part_b,
                              dg, db, rows, cols, parts, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Rows of the partial-sum workspace for `rows` rows of x: one per block.
extern "C" int paddle_layer_norm_bwd_parts(int rows) {
  return (rows + kRowsPerBlock - 1) / kRowsPerBlock;
}

// x, dout, dx: dense (rows, cols), 16-byte aligned, cols a multiple of 8,
// one dtype; gamma, dgamma, dbeta: dense (cols,) in gamma's dtype; mean,
// rstd: dense (rows,) f32; part_g, part_b: f32 workspaces of
// paddle_layer_norm_bwd_parts(rows) x cols.  dtype codes: 0 = float32,
// 1 = bfloat16, 2 = float16.  Returns the first failing launch's cudaError_t.
extern "C" int paddle_layer_norm_bwd(const void* x, const void* gamma,
                                     const float* mean, const float* rstd,
                                     const void* dout, void* dx,
                                     float* part_g, float* part_b,
                                     void* dgamma, void* dbeta, int rows,
                                     int cols, int x_dtype, int w_dtype,
                                     void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int parts = paddle_layer_norm_bwd_parts(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return dispatch_w<float>(x, gamma, mean, rstd, dout, dx, part_g, part_b,
                             dgamma, dbeta, rows, cols, parts, w_dtype, st);
  if (x_dtype == 1)
    return dispatch_w<__nv_bfloat16>(x, gamma, mean, rstd, dout, dx, part_g,
                                     part_b, dgamma, dbeta, rows, cols, parts,
                                     w_dtype, st);
  if (x_dtype == 2)
    return dispatch_w<__half>(x, gamma, mean, rstd, dout, dx, part_g, part_b,
                              dgamma, dbeta, rows, cols, parts, w_dtype, st);
  return (int)cudaErrorInvalidValue;
}
