// Row softmax for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces paddle_tpu/kernels/norm_pallas.py:_softmax_kernel: for each row
// of x (N, F) it writes exp(x - max) / sum(exp(x - max)) in x's dtype,
// with f32 statistics.  Forward only, as the TPU kernel.
//
// Design.  The TPU kernel normalises a (block_rows, F) tile resident in
// VMEM per grid step.  Here one block of 256 threads owns one row: threads
// read it with 16-byte vector loads (F % 128 == 0 keeps every row 16-byte
// aligned), keep an online base-2 (max, sum of exp2) pair each, and merge
// the pairs through warp shuffles and shared memory.  Where the row fits
// in dynamic shared memory (F x itemsize up to 220 KB: a 50304-wide row
// is 100 KB in bf16 and 201 KB in f32), the first pass stages it there and
// the second pass, which writes the output, reads it back from shared
// memory, so device memory sees one read and one write.  A wider row is
// read a second time from device memory.
//
// Bound on the H100 SXM (3.35 TB/s): the kernel must read x and write the
// output once: at (8192, 1024) bf16 that is 33.5 MB (0.010 ms), at
// (8, 50304) bf16 1.6 MB (0.48 us), where 8 blocks on 132 SMs and the
// launch, not the memory, set the time.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegBig = -1e30f;
constexpr int kMaxStageBytes = 220 * 1024;

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

__device__ __forceinline__ void merge(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  l = l * exp2f(m - mn) + lo * exp2f(mo - mn);
  m = mn;
}

// Grid (N), one block per row.  kStaged: the row's 16-byte vectors are
// kept in dynamic shared memory between the two passes.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
softmax_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, int F) {
  constexpr int kV = 16 / sizeof(T);
  extern __shared__ uint4 s_row[];
  __shared__ float s_m[kWarps], s_l[kWarps];
  const int nvec = F / kV;
  const uint4* row = reinterpret_cast<const uint4*>(x + (long long)blockIdx.x * F);
  uint4* orow = reinterpret_cast<uint4*>(out + (long long)blockIdx.x * F);

  float m = kNegBig, l = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 raw = row[i];
    if (kStaged) s_row[i] = raw;
    const T* v = reinterpret_cast<const T*>(&raw);
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
  __syncthreads();   // also: every staged vector is in shared memory
  if (warp == 0) {
    m = lane < kWarps ? s_m[lane] : kNegBig;
    l = lane < kWarps ? s_l[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      merge(m, l, __shfl_xor_sync(0xffffffffu, m, off),
            __shfl_xor_sync(0xffffffffu, l, off));
    if (lane == 0) {
      s_m[0] = m;
      s_l[0] = l;
    }
  }
  __syncthreads();
  const float mr = s_m[0];
  const float inv = 1.f / s_l[0];

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 raw = kStaged ? s_row[i] : row[i];
    const T* v = reinterpret_cast<const T*>(&raw);
    alignas(16) T o[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e)
      o[e] = from_float<T>(exp2f(fmaf(to_float(v[e]), kLog2e, -mr)) * inv);
    orow[i] = *reinterpret_cast<const uint4*>(o);
  }
}

template <typename T>
int launch(const void* x, void* out, int N, int F, cudaStream_t stream) {
  const size_t bytes = (size_t)F * sizeof(T);
  if (bytes <= (size_t)kMaxStageBytes) {
    static bool smem_set = false;
    if (!smem_set) {
      cudaError_t err = cudaFuncSetAttribute(
          softmax_fwd_kernel<T, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStageBytes);
      if (err != cudaSuccess) return (int)err;
      smem_set = true;
    }
    softmax_fwd_kernel<T, true><<<N, kThreads, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), F);
  } else {
    softmax_fwd_kernel<T, false><<<N, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), F);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: dense (N, F), 16-byte aligned, F a multiple of 128.  dtype
// codes: 0 = float32, 1 = bfloat16, 2 = float16.  Returns the launch's
// cudaError_t.
extern "C" int paddle_softmax_fwd(const void* x, void* out, int N, int F,
                                  int dtype, void* stream) {
  if (N <= 0 || F <= 0 || F % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, N, F, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, N, F, st);
  if (dtype == 2) return launch<__half>(x, out, N, F, st);
  return (int)cudaErrorInvalidValue;
}
