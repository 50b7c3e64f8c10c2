// Row softmax for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces paddle_tpu/kernels/norm_pallas.py:_softmax_kernel: for each row
// of x (N, F) it writes exp(x - max) / sum(exp(x - max)) in x's dtype,
// with f32 statistics and base-2 exponentials.  Forward only, as the TPU
// kernel.
//
// Bound on the H100 SXM (3.35 TB/s): the kernel must read x and write the
// output once: at (8192, 1024) bf16 that is 33.5 MB (0.010 ms), at
// (8, 50304) bf16 1.6 MB (0.48 us), where 8 rows on 132 SMs and the
// launch, not the memory, set the time.
//
// Design.  A row is cut into packs of 8 columns (16 bytes of a 16-bit x,
// two 16-byte words of f32), and a group of G threads owns a row: thread t
// holds packs t, t + G, ... in registers, NP of them at most (a template
// parameter), as kernel B (layer_norm_fwd.cu) holds its rows.  Every load
// of the row is issued before the first reduction.  Each thread forms its
// own base-2 pair (max m, sum of exp2(x log2e - m)), keeping the exp2
// values in registers; the group merges the pairs through warp shuffles
// (and, above one warp, a few shared-memory words, once), and each thread
// scales its exp2 values by exp2(m - M) / L and writes them with 16-byte
// stores.  So x is read once and the output written once, one exp2 an
// element.  The launch plan (host side, below): with many rows (>=
// kManyRows) and F <= 1024, or F <= 256, one warp owns a row (4 rows a
// block); with few rows, or F up to 4096, 128 threads own a row; up to F
// = kPlanMaxCols = 8192, 256 threads.
//
// Rows past the register plan take softmax_fwd_kernel_staged, the first
// port's design: one block a row (256 threads, or 1024 where there are
// fewer rows than SMs), an online (max, sum) sweep, four 16-byte loads a
// thread at a time, that stages the row in dynamic shared memory where it
// fits (F x itemsize up to 220 KB: a 50304-wide row is 100 KB in bf16 and
// 201 KB in f32), and an output sweep that reads it back from there (else
// a second time from device memory).
//
// What the register plan does about the first port's faults at the
// hidden width: one 256-thread block a row left half its threads without
// a 16-byte vector at F = 1024 in bf16, and each row paid two
// __syncthreads reductions across 8192 blocks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPack = 8;             // columns of one pack
constexpr int kMaxNP = 4;            // packs a thread holds at most
constexpr int kManyRows = 1024;      // rows from which a warp owns a row
constexpr int kFewRows = 132;        // rows below which a wide row gets
                                     // 1024 threads (one block an SM)
constexpr int kPlanMaxCols = kPack * kMaxNP * kThreads;   // 8192
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

// 8 consecutive elements of T, moved with 16-byte loads and stores (one
// for a 16-bit T, two for f32)
template <typename T>
struct Pack {
  static constexpr int kWords = sizeof(T) * kPack / 16;
  alignas(16) T v[kPack];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      reinterpret_cast<uint4*>(v)[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(v)[i];
  }
  __device__ __forceinline__ float operator[](int e) const {
    return to_float(v[e]);
  }
};

// (m, l) <- the pair of the union of two parts: a base-2 max and the sum
// of exp2 of each element less that max
__device__ __forceinline__ void merge(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  l = l * exp2f(m - mn) + lo * exp2f(mo - mn);
  m = mn;
}

__device__ __forceinline__ void warp_merge(float& m, float& l) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    merge(m, l, __shfl_xor_sync(0xffffffffu, m, off),
          __shfl_xor_sync(0xffffffffu, l, off));
}

// Grid: one block per 4 rows when G == 32 (a warp each), else one block
// of G threads per row.
template <typename T, int G, int NP>
__global__ void __launch_bounds__(kThreads)
softmax_fwd_kernel_rows(const T* __restrict__ x, T* __restrict__ out,
                        int rows, int F) {
  constexpr int kW = G / 32;         // warps a row
  __shared__ float red[kW][2];
  const int t = threadIdx.x % G;
  const int row = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  // a row's threads leave together: with G > 32 the block is one row
  if (row >= rows) return;
  const int packs = F / kPack;
  const long long base = (long long)row * F;

  Pack<T> xv[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = t + i * G;
    if (p < packs) xv[i].load(x + base + p * kPack);
  }
  // max of x log2e is log2e times max of x: the rounded product is
  // monotone in x
  float xm = kNegBig;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (t + i * G < packs) {
#pragma unroll
      for (int e = 0; e < kPack; ++e) xm = fmaxf(xm, xv[i][e]);
    }
  }
  float m = t < packs ? xm * kLog2e : kNegBig;
  float ev[NP][kPack];
  float l = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (t + i * G < packs) {
#pragma unroll
      for (int e = 0; e < kPack; ++e) {
        ev[i][e] = exp2f(fmaf(xv[i][e], kLog2e, -m));
        l += ev[i][e];
      }
    }
  }
  const float mt = m;
  warp_merge(m, l);
  if (kW > 1) {
    const int warp = (threadIdx.x % G) >> 5;
    if ((threadIdx.x & 31) == 0) {
      red[warp][0] = m;
      red[warp][1] = l;
    }
    __syncthreads();
    m = red[0][0];
    l = red[0][1];
#pragma unroll
    for (int w = 1; w < kW; ++w) merge(m, l, red[w][0], red[w][1]);
  }
  const float c = exp2f(mt - m) * (1.f / l);

#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = t + i * G;
    if (p < packs) {
      Pack<T> o;
#pragma unroll
      for (int e = 0; e < kPack; ++e) o.v[e] = from_float<T>(ev[i][e] * c);
      o.store(out + base + p * kPack);
    }
  }
}

// Rows past the register plan: grid (N), one block of kT threads per row.
// kStaged: the row's 16-byte vectors are kept in dynamic shared memory
// between the two sweeps.  A thread issues kU loads before it reduces
// them, so a few rows each on its own SM keep enough bytes in flight.
template <typename T, bool kStaged, int kT>
__global__ void __launch_bounds__(kT)
softmax_fwd_kernel_staged(const T* __restrict__ x, T* __restrict__ out,
                          int F) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kU = 4;
  constexpr int kNW = kT / 32;
  extern __shared__ uint4 s_row[];
  __shared__ float s_m[kNW], s_l[kNW];
  const int nvec = F / kV;
  const uint4* row = reinterpret_cast<const uint4*>(x + (long long)blockIdx.x * F);
  uint4* orow = reinterpret_cast<uint4*>(out + (long long)blockIdx.x * F);

  float m = kNegBig, l = 0.f;
  for (int i0 = threadIdx.x; i0 < nvec; i0 += kT * kU) {
    uint4 raw[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (i0 + u * kT < nvec) raw[u] = row[i0 + u * kT];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (i0 + u * kT >= nvec) break;
      if (kStaged) s_row[i0 + u * kT] = raw[u];
      const T* v = reinterpret_cast<const T*>(&raw[u]);
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
  }
  warp_merge(m, l);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();   // also: every staged vector is in shared memory
  if (warp == 0) {
    m = lane < kNW ? s_m[lane] : kNegBig;
    l = lane < kNW ? s_l[lane] : 0.f;
    warp_merge(m, l);
    if (lane == 0) {
      s_m[0] = m;
      s_l[0] = l;
    }
  }
  __syncthreads();
  const float mr = s_m[0];
  const float inv = 1.f / s_l[0];

  for (int i = threadIdx.x; i < nvec; i += kT) {
    const uint4 raw = kStaged ? s_row[i] : row[i];
    const T* v = reinterpret_cast<const T*>(&raw);
    alignas(16) T o[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e)
      o[e] = from_float<T>(exp2f(fmaf(to_float(v[e]), kLog2e, -mr)) * inv);
    orow[i] = *reinterpret_cast<const uint4*>(o);
  }
}

template <typename T, int G, int NP>
int launch_rows(const void* x, void* out, int N, int F, cudaStream_t stream) {
  const int rows_per_block = G == 32 ? 4 : 1;
  const int blocks = (N + rows_per_block - 1) / rows_per_block;
  softmax_fwd_kernel_rows<T, G, NP><<<blocks, G * rows_per_block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), N, F);
  return (int)cudaGetLastError();
}

template <typename T, int kT>
int launch_staged(const void* x, void* out, int N, int F,
                  cudaStream_t stream) {
  const size_t bytes = (size_t)F * sizeof(T);
  if (bytes <= (size_t)kMaxStageBytes) {
    static bool smem_set = false;
    if (!smem_set) {
      cudaError_t err = cudaFuncSetAttribute(
          softmax_fwd_kernel_staged<T, true, kT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStageBytes);
      if (err != cudaSuccess) return (int)err;
      smem_set = true;
    }
    softmax_fwd_kernel_staged<T, true, kT><<<N, kT, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), F);
  } else {
    softmax_fwd_kernel_staged<T, false, kT><<<N, kT, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), F);
  }
  return (int)cudaGetLastError();
}

// The launch plan of the head note: threads per row and packs a thread.
template <typename T>
int launch(const void* x, void* out, int N, int F, cudaStream_t st) {
  const int packs = F / kPack;
  if (packs <= 32 * kMaxNP && (N >= kManyRows || packs <= 32)) {
    if (packs <= 32) return launch_rows<T, 32, 1>(x, out, N, F, st);
    if (packs <= 64) return launch_rows<T, 32, 2>(x, out, N, F, st);
    return launch_rows<T, 32, 4>(x, out, N, F, st);
  }
  if (packs <= 128 * kMaxNP) {
    if (packs <= 128) return launch_rows<T, 128, 1>(x, out, N, F, st);
    if (packs <= 256) return launch_rows<T, 128, 2>(x, out, N, F, st);
    return launch_rows<T, 128, 4>(x, out, N, F, st);
  }
  if (F <= kPlanMaxCols) return launch_rows<T, 256, 4>(x, out, N, F, st);
  // fewer rows than SMs: a row gets a block of 1024 threads
  if (N < kFewRows) return launch_staged<T, 1024>(x, out, N, F, st);
  return launch_staged<T, kThreads>(x, out, N, F, st);
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
