// LayerNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces paddle_tpu/kernels/norm_pallas.py:_ln_fwd_kernel: for each row
// of x (R, F) it writes out = (x - mean) * rstd * gamma + beta in x's
// dtype, and the f32 row statistics mean and rstd, with the one-pass
// variance E[x^2] - mean^2 of the TPU kernel and f32 arithmetic.
//
// Bound on the H100 SXM (3.35 TB/s): the kernel must read x once and
// write out once, plus gamma, beta and the statistics.  At the training
// shape (8192, 1024) bf16 with f32 gamma / beta that is 33.6 MB, 10.0 us;
// at the decode shape (8, 1024) 41 KB, 0.012 us, so there the launch and
// one round trip to memory are all that is left.
//
// Design.  A row is cut into packs of 8 columns (16 bytes of a 16-bit x,
// two 16-byte words of f32), and a group of G threads owns a row: thread t
// holds packs t, t + G, ... in registers, NP of them at most (a template
// parameter).  Every 16-byte load of the row's x, gamma and beta is issued
// before the first sum; mean and rstd come from those registers (warp
// shuffles, then a few shared-memory words across the group's warps), and
// out is written from them with 16-byte stores.  So x is read from device
// memory once, and gamma / beta are read with 16-byte vector loads.  The
// launch plan (host side, below): with many rows (>= kManyRows) and F <=
// 1024 one warp owns a row (G = 32, NP <= 4, 4 rows a block); with few
// rows, as at decode (8) and prefill (128), or wider rows, a row gets 128
// threads (G = 128: one pack a thread at F = 1024, so the 8 decode rows
// sit on 8 SMs and a call is one load round, one reduction and one store)
// or, above F = 4096, 256.  The register plan ends at F = kPlanMaxCols =
// 8192 (NP = 4 at G = 256); wider rows take layer_norm_fwd_stream_kernel,
// one warp a row sweeping it twice (the second read from L1/L2).
//
// What this design does about the first port's faults: x was read twice
// (a statistics sweep and an output sweep) with about one 16-byte load in
// flight per sweep and lane, gamma / beta were read one element at a time,
// and the decode shape ran as one block on one SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPack = 8;             // columns of one pack
constexpr int kMaxNP = 4;            // packs a thread holds at most
constexpr int kManyRows = 1024;      // rows from which a warp owns a row
constexpr int kPlanMaxCols = kPack * kMaxNP * kThreads;   // 8192

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Grid: one block per 4 rows when WPR == 1 (a warp each), else one block
// of 32 * WPR threads per row.
template <typename TX, typename TW, int WPR, int NP>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ gamma,
                      const TW* __restrict__ beta, TX* __restrict__ out,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      int rows, int cols, float eps,
                      unsigned int* __restrict__ launches) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1u);
  constexpr int G = 32 * WPR;
  __shared__ float red[WPR][2];
  const int t = threadIdx.x % G;
  const int row = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  // a row's threads leave together: with WPR > 1 the block is one row
  if (row >= rows) return;
  const int packs = cols / kPack;
  const long long base = (long long)row * cols;

  Pack<TX> xv[NP];
  Pack<TW> gv[NP], bv[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = t + i * G;
    if (p < packs) {
      xv[i].load(x + base + p * kPack);
      gv[i].load(gamma + p * kPack);
      bv[i].load(beta + p * kPack);
    }
  }
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (t + i * G < packs) {
#pragma unroll
      for (int e = 0; e < kPack; ++e) {
        const float f = xv[i][e];
        sum += f;
        sq = fmaf(f, f, sq);
      }
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  if (WPR > 1) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red[warp][0] = sum;
      red[warp][1] = sq;
    }
    __syncthreads();
    sum = sq = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) {
      sum += red[w][0];
      sq += red[w][1];
    }
  }
  const float inv_n = 1.f / (float)cols;
  const float mu = sum * inv_n;
  const float var = sq * inv_n - mu * mu;
  const float rs = rsqrtf(var + eps);

#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = t + i * G;
    if (p < packs) {
      Pack<TX> o;
#pragma unroll
      for (int e = 0; e < kPack; ++e) {
        const float xh = (xv[i][e] - mu) * rs;
        o.v[e] = from_float<TX>(xh * gv[i][e] + bv[i][e]);
      }
      o.store(out + base + p * kPack);
    }
  }
  if (t == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// Rows wider than the register plan: one warp per row, a statistics sweep
// and an output sweep over its packs.  8 rows a block.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_stream_kernel(const TX* __restrict__ x,
                             const TW* __restrict__ gamma,
                             const TW* __restrict__ beta, TX* __restrict__ out,
                             float* __restrict__ mean,
                             float* __restrict__ rstd, int rows, int cols,
                             float eps, unsigned int* __restrict__ launches) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1u);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int packs = cols / kPack;
  const long long base = (long long)row * cols;
  float sum = 0.f, sq = 0.f;
  for (int p = lane; p < packs; p += 32) {
    Pack<TX> xv;
    xv.load(x + base + p * kPack);
#pragma unroll
    for (int e = 0; e < kPack; ++e) {
      const float f = xv[e];
      sum += f;
      sq = fmaf(f, f, sq);
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float inv_n = 1.f / (float)cols;
  const float mu = sum * inv_n;
  const float var = sq * inv_n - mu * mu;
  const float rs = rsqrtf(var + eps);
  for (int p = lane; p < packs; p += 32) {
    Pack<TX> xv, o;
    Pack<TW> gv, bv;
    xv.load(x + base + p * kPack);
    gv.load(gamma + p * kPack);
    bv.load(beta + p * kPack);
#pragma unroll
    for (int e = 0; e < kPack; ++e) {
      const float xh = (xv[e] - mu) * rs;
      o.v[e] = from_float<TX>(xh * gv[e] + bv[e]);
    }
    o.store(out + base + p * kPack);
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

struct Args {
  const void* x;
  const void* g;
  const void* b;
  void* out;
  float* mean;
  float* rstd;
  int rows, cols;
  float eps;
  unsigned int* launches;
  cudaStream_t stream;
};

template <typename TX, typename TW, int WPR, int NP>
int launch_reg(const Args& a) {
  const int rows_per_block = WPR == 1 ? 4 : 1;
  const int blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  layer_norm_fwd_kernel<TX, TW, WPR, NP>
      <<<blocks, 32 * WPR * rows_per_block, 0, a.stream>>>(
          static_cast<const TX*>(a.x), static_cast<const TW*>(a.g),
          static_cast<const TW*>(a.b), static_cast<TX*>(a.out), a.mean,
          a.rstd, a.rows, a.cols, a.eps, a.launches);
  return (int)cudaGetLastError();
}

// The launch plan of the head note: threads per row and packs a thread.
template <typename TX, typename TW>
int launch(const Args& a) {
  const int packs = a.cols / kPack;
  if (packs <= 32 * kMaxNP && (a.rows >= kManyRows || packs <= 32)) {
    if (packs <= 32) return launch_reg<TX, TW, 1, 1>(a);
    if (packs <= 64) return launch_reg<TX, TW, 1, 2>(a);
    return launch_reg<TX, TW, 1, 4>(a);
  }
  if (packs <= 128 * kMaxNP) {
    if (packs <= 128) return launch_reg<TX, TW, 4, 1>(a);
    if (packs <= 256) return launch_reg<TX, TW, 4, 2>(a);
    return launch_reg<TX, TW, 4, 4>(a);
  }
  if (a.cols <= kPlanMaxCols) return launch_reg<TX, TW, 8, 4>(a);
  const int blocks = (a.rows + kThreads / 32 - 1) / (kThreads / 32);
  layer_norm_fwd_stream_kernel<TX, TW><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TW*>(a.g),
      static_cast<const TW*>(a.b), static_cast<TX*>(a.out), a.mean, a.rstd,
      a.rows, a.cols, a.eps, a.launches);
  return (int)cudaGetLastError();
}

template <typename TX>
int dispatch_w(const Args& a, int w_dtype) {
  if (w_dtype == 0) return launch<TX, float>(a);
  if (w_dtype == 1) return launch<TX, __nv_bfloat16>(a);
  if (w_dtype == 2) return launch<TX, __half>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: dense (rows, cols), 16-byte aligned, cols a multiple of 8;
// gamma, beta: dense (cols,), 16-byte aligned; mean, rstd: dense (rows,)
// f32.  dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  launches:
// a device counter the kernel adds one to (block 0, thread 0), so that
// launches replayed from a CUDA graph are counted too.  Returns the
// launch's cudaError_t.
extern "C" int paddle_layer_norm_fwd(const void* x, const void* gamma,
                                     const void* beta, void* out,
                                     float* mean, float* rstd, int rows,
                                     int cols, float eps, int x_dtype,
                                     int w_dtype, unsigned int* launches,
                                     void* stream) {
  if (rows <= 0 || cols <= 0 || cols % kPack != 0 || launches == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{x, gamma, beta, out, mean, rstd, rows, cols, eps, launches,
               static_cast<cudaStream_t>(stream)};
  if (x_dtype == 0) return dispatch_w<float>(a, w_dtype);
  if (x_dtype == 1) return dispatch_w<__nv_bfloat16>(a, w_dtype);
  if (x_dtype == 2) return dispatch_w<__half>(a, w_dtype);
  return (int)cudaErrorInvalidValue;
}
