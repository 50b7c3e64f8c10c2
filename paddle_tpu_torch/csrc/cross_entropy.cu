// Hard-label cross entropy over the rows of (N, V) logits for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces the three kernels of paddle_tpu/kernels/ce_pallas.py:
//   E1 paddle_ce_lse  <- _lse_kernel  (streamed one-pass logsumexp)
//   E2 paddle_ce_fwd  <- _fwd_kernel  (fused softmax-CE forward)
//   E3 paddle_ce_bwd  <- _bwd_kernel  (fused softmax-CE backward)
// For each row i of x (N, V) with label y_i:
//   lse_i  = log(sum_v exp(x_iv))                    (base e, f32)
//   nll_i  = lse_i - x[i, y_i]                       (f32)
//   dx_iv  = (exp(x_iv - lse_i) - 1[v == y_i]) * g_i (in x's dtype)
// Labels arrive clipped to [0, V) by the caller; the kernels clamp them
// again, so no label can address memory outside its row.
//
// Design.  The TPU kernels hold 8-row tiles resident in VMEM (E2, E3) or
// walk a (row block x vocab chunk) grid that carries the running (max,
// sum) in scratch along the sequential vocab axis (E1).  A Hopper block
// has no sequential grid, so here one block of 256 threads owns one row
// and a loop inside the block walks the vocabulary: each thread reads 16
// bytes at a time (8 bf16 / f16 or 4 f32 values, neighbouring threads on
// neighbouring addresses; V % 128 == 0 keeps every row 16-byte aligned)
// and keeps an online base-2 (max, sum of exp2) pair; the pairs merge
// through warp shuffles, then shared memory.  That is one read of the
// logits.  E2 adds the target logit, which one thread reads directly at
// x[i, y_i]: the TPU's iota == label masked sum exists because the TPU has
// no cheap scalar gather.  E3 is one elementwise pass: a vector load of x,
// the row's lse and g, the one-hot at column y_i, a vector store.
//
// Bound on the H100 SXM (3.35 TB/s): at the training shape (8192, 50304)
// bf16, E1 and E2 must read the 824 MB of logits once (0.246 ms); E3 reads
// them and writes as many bytes of dlogits (1.65 GB, 0.492 ms).  Each
// element costs one exp2 on the special-function units (412M per pass,
// ~0.11 ms at their rate), below the memory bound, so all three are
// memory-bound; their measured times stand in PERF.md.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegBig = -1e30f;

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

// Merge the online pair (mo, lo) into (m, l): both are (max, sum of
// exp2(x - max)) over disjoint sets of base-2 scaled logits.
__device__ __forceinline__ void merge(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  l = l * exp2f(m - mn) + lo * exp2f(mo - mn);
  m = mn;
}

// Base-e logsumexp of one row of V values, returned to every thread of
// the block.  s_m / s_l hold kWarps floats each.
template <typename T>
__device__ float row_lse(const T* __restrict__ row, int V, float* s_m,
                         float* s_l) {
  constexpr int kV = 16 / sizeof(T);
  float m = kNegBig, l = 0.f;
  for (int c = threadIdx.x * kV; c < V; c += kThreads * kV) {
    alignas(16) T v[kV];
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(row + c);
    float xs[kV];
    float vm = kNegBig;
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      xs[e] = to_float(v[e]) * kLog2e;
      vm = fmaxf(vm, xs[e]);
    }
    const float mn = fmaxf(m, vm);
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < kV; ++e) s += exp2f(xs[e] - mn);
    l = l * exp2f(m - mn) + s;
    m = mn;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    merge(m, l, __shfl_xor_sync(0xffffffffu, m, off),
          __shfl_xor_sync(0xffffffffu, l, off));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? s_m[lane] : kNegBig;
    l = lane < kWarps ? s_l[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      merge(m, l, __shfl_xor_sync(0xffffffffu, m, off),
            __shfl_xor_sync(0xffffffffu, l, off));
    if (lane == 0) s_m[0] = (m + log2f(fmaxf(l, 1e-30f))) * kLn2;
  }
  __syncthreads();
  return s_m[0];
}

__device__ __forceinline__ int clamp_label(int y, int V) {
  return y < 0 ? 0 : (y >= V ? V - 1 : y);
}

// E1: grid (N), one block per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_lse_kernel(const T* __restrict__ x, float* __restrict__ lse, int V) {
  __shared__ float s_m[kWarps], s_l[kWarps];
  const float r = row_lse(x + (long long)blockIdx.x * V, V, s_m, s_l);
  if (threadIdx.x == 0) lse[blockIdx.x] = r;
}

// E2: grid (N), one block per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ x, const int* __restrict__ y,
              float* __restrict__ nll, float* __restrict__ lse, int V) {
  __shared__ float s_m[kWarps], s_l[kWarps];
  const T* row = x + (long long)blockIdx.x * V;
  const float r = row_lse(row, V, s_m, s_l);
  if (threadIdx.x == 0) {
    const int t = clamp_label(y[blockIdx.x], V);
    lse[blockIdx.x] = r;
    nll[blockIdx.x] = r - to_float(row[t]);
  }
}

// E3: grid (N), one block per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ x, const int* __restrict__ y,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ dx, int V) {
  constexpr int kV = 16 / sizeof(T);
  const long long base = (long long)blockIdx.x * V;
  const float l2 = lse[blockIdx.x] * kLog2e;
  const float gi = g[blockIdx.x];
  const int t = clamp_label(y[blockIdx.x], V);
  for (int c = threadIdx.x * kV; c < V; c += kThreads * kV) {
    alignas(16) T v[kV];
    alignas(16) T o[kV];
    *reinterpret_cast<uint4*>(v) =
        *reinterpret_cast<const uint4*>(x + base + c);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const float p = exp2f(fmaf(to_float(v[e]), kLog2e, -l2));
      o[e] = from_float<T>((p - (c + e == t ? 1.f : 0.f)) * gi);
    }
    *reinterpret_cast<uint4*>(dx + base + c) =
        *reinterpret_cast<const uint4*>(o);
  }
}

bool bad_shape(int N, int V) { return N <= 0 || V <= 0 || V % 128 != 0; }

}  // namespace

// x: dense (N, V) logits, 16-byte aligned, V a multiple of 128; labels:
// dense (N,) int32; lse, nll, g: dense (N,) f32; dx: dense (N, V) in x's
// dtype.  dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  Each
// returns its launch's cudaError_t.

// E1
extern "C" int paddle_ce_lse(const void* x, float* lse, int N, int V,
                             int dtype, void* stream) {
  if (bad_shape(N, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    ce_lse_kernel<float><<<N, kThreads, 0, st>>>(
        static_cast<const float*>(x), lse, V);
  else if (dtype == 1)
    ce_lse_kernel<__nv_bfloat16><<<N, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), lse, V);
  else if (dtype == 2)
    ce_lse_kernel<__half><<<N, kThreads, 0, st>>>(
        static_cast<const __half*>(x), lse, V);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// E2
extern "C" int paddle_ce_fwd(const void* x, const int* labels, float* nll,
                             float* lse, int N, int V, int dtype,
                             void* stream) {
  if (bad_shape(N, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    ce_fwd_kernel<float><<<N, kThreads, 0, st>>>(
        static_cast<const float*>(x), labels, nll, lse, V);
  else if (dtype == 1)
    ce_fwd_kernel<__nv_bfloat16><<<N, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), labels, nll, lse, V);
  else if (dtype == 2)
    ce_fwd_kernel<__half><<<N, kThreads, 0, st>>>(
        static_cast<const __half*>(x), labels, nll, lse, V);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// E3
extern "C" int paddle_ce_bwd(const void* x, const int* labels,
                             const float* lse, const float* g, void* dx,
                             int N, int V, int dtype, void* stream) {
  if (bad_shape(N, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    ce_bwd_kernel<float><<<N, kThreads, 0, st>>>(
        static_cast<const float*>(x), labels, lse, g,
        static_cast<float*>(dx), V);
  else if (dtype == 1)
    ce_bwd_kernel<__nv_bfloat16><<<N, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), labels, lse, g,
        static_cast<__nv_bfloat16*>(dx), V);
  else if (dtype == 2)
    ce_bwd_kernel<__half><<<N, kThreads, 0, st>>>(
        static_cast<const __half*>(x), labels, lse, g,
        static_cast<__half*>(dx), V);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
