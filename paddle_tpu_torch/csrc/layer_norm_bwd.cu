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
// Bound on the H100 SXM (3.35 TB/s): read x and dO once, write dx once,
// plus gamma, the statistics and the two parameter grads.  At the training
// shape (8192, 1024) bf16 with f32 gamma that is 50.4 MB, 15.0 us; at
// (8, 1024) 62 KB, 0.018 us, where launches and one round trip to memory
// are all that is left.
//
// Design.  The TPU kernel carries dgamma / dbeta in its output block from
// one step of its sequential row grid to the next.  Hopper blocks run in
// no order, so the work is two launches:
//   layer_norm_bwd_kernel, the rows pass.  A row is cut into packs of 8
//     columns and a group of G threads owns a row, thread t holding packs
//     t, t + G, ... (NP at most, a template parameter): one warp a row up
//     to F = 1024 (blocks of 128 threads, 4 rows at a time), 128 threads
//     up to 4096, 256 up to kPlanMaxCols = 8192.  The grid is as many
//     blocks as the device holds at once (the occupancy API), and each
//     block owns a fixed set of rows, every (grid x groups)-th row from its
//     own first one, so the order of every sum is fixed.  For each row a
//     thread issues all its 16-byte loads of x, dO and gamma before the
//     first sum, forms the two row means from registers (warp shuffles,
//     then shared memory across the group's warps), writes dx from
//     registers and adds dO * xhat and dO into f32 dgamma / dbeta partials
//     that stay in its registers across all its rows.  At the end the
//     block's groups add their partials in shared memory, in group order,
//     into the block's row of an f32 (parts, F) workspace.  x and dO are
//     read from device memory once.
//   layer_norm_bwd_reduce_kernel adds the parts: a block of 1024 threads
//     per 8 columns (128 blocks at F = 1024), each thread summing every
//     128th part of one column in order, then a fixed tree of shuffles and
//     shared memory over the block; the result is cast to gamma's dtype.
//     No atomics anywhere: dgamma and dbeta are bit-identical from one
//     call to the next on one device.
// Rows wider than the plan take layer_norm_bwd_stream_kernel, four rows a
// warp, each swept twice, writing one part per 32 rows.
//
// What this design does about the first port's faults: x and dO were each
// read twice, a block of 32 rows gave (8192, 1024) 256 blocks at about a
// quarter of the SMs' threads, and the 256 parts were added by 4 blocks on
// 4 SMs, one thread per column walking every part in series.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPack = 8;             // columns of one pack
constexpr int kMaxNP = 4;            // packs a thread holds at most
constexpr int kPlanMaxCols = kPack * kMaxNP * kThreads;   // 8192
constexpr int kStreamRowsPerBlock = kWarps * 4;           // 32
constexpr int kReduceCols = 8;       // columns of one reduce block
constexpr int kReduceThreads = 1024;

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

// Warps per row of the rows pass at ``cols`` columns (cols <= 8192), and
// threads per block: groups of a row's threads, 128 threads a block up to
// 4 warps a row (4 rows of a warp each at F <= 1024), else 256.
__host__ __device__ constexpr int warps_per_row(int cols) {
  return cols <= 32 * kPack * kMaxNP ? 1 : cols <= 128 * kPack * kMaxNP ? 4
                                                                        : 8;
}
__host__ __device__ constexpr int block_threads(int wpr) {
  return wpr <= 4 ? 128 : 256;
}

// Grid: the parts' count of blocks; writes dx and the block's dgamma /
// dbeta partials (rows part_g[blockIdx.x], part_b[blockIdx.x]).
template <typename TX, typename TW, int WPR, int NP>
__global__ void __launch_bounds__(block_threads(WPR))
layer_norm_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ gamma,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      const TX* __restrict__ dout, TX* __restrict__ dx,
                      float* __restrict__ part_g, float* __restrict__ part_b,
                      int rows, int cols) {
  constexpr int G = 32 * WPR;
  constexpr int kBlock = block_threads(WPR);
  constexpr int kGroups = kBlock / G;
  // (s1, s2) of each warp, two buffers by row-step parity: the step after
  // next rewrites one only after the next step's barrier
  __shared__ float red[2][kBlock / 32][2];
  __shared__ float comb[kBlock * kPack];
  const int t = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int warp = threadIdx.x >> 5;
  const int packs = cols / kPack;
  const float inv_n = 1.f / (float)cols;

  float gp[NP][kPack], bp[NP][kPack];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int e = 0; e < kPack; ++e) gp[i][e] = bp[i][e] = 0.f;

  // every group of the block walks the same number of steps, so the
  // barriers of WPR > 1 are reached by all threads
  const int stride = gridDim.x * kGroups;
  int step = 0;
  for (int row0 = blockIdx.x * kGroups; row0 < rows; row0 += stride, ++step) {
    const int row = row0 + grp;
    const bool live = row < rows;
    const long long base = (long long)row * cols;
    Pack<TX> xv[NP], dv[NP];
    Pack<TW> gv[NP];
    float mu = 0.f, rs = 0.f;
    if (live) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int p = t + i * G;
        if (p < packs) {
          xv[i].load(x + base + p * kPack);
          dv[i].load(dout + base + p * kPack);
          gv[i].load(gamma + p * kPack);
        }
      }
      mu = mean[row];
      rs = rstd[row];
    }
    float s1 = 0.f, s2 = 0.f;
    if (live) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        if (t + i * G < packs) {
#pragma unroll
          for (int e = 0; e < kPack; ++e) {
            const float xh = (xv[i][e] - mu) * rs;
            const float dxh = dv[i][e] * gv[i][e];
            s1 += dxh;
            s2 = fmaf(dxh, xh, s2);
          }
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (WPR > 1) {
      float(*r)[2] = red[step & 1];
      if ((threadIdx.x & 31) == 0) {
        r[warp][0] = s1;
        r[warp][1] = s2;
      }
      __syncthreads();
      s1 = s2 = 0.f;
#pragma unroll
      for (int w = 0; w < WPR; ++w) {
        s1 += r[grp * WPR + w][0];
        s2 += r[grp * WPR + w][1];
      }
    }
    if (!live) continue;
    const float m1 = s1 * inv_n, m2 = s2 * inv_n;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = t + i * G;
      if (p < packs) {
        Pack<TX> o;
#pragma unroll
        for (int e = 0; e < kPack; ++e) {
          const float xh = (xv[i][e] - mu) * rs;
          const float d = dv[i][e];
          const float dxh = d * gv[i][e];
          o.v[e] = from_float<TX>(rs * (dxh - m1 - xh * m2));
          gp[i][e] = fmaf(d, xh, gp[i][e]);
          bp[i][e] += d;
        }
        o.store(dx + base + p * kPack);
      }
    }
  }

  // the groups' partials, added in group order, one pack slot at a time:
  // slot i covers columns i * G * 8 + [0, G * 8)
  float* pg = part_g + (long long)blockIdx.x * cols;
  float* pb = part_b + (long long)blockIdx.x * cols;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
#pragma unroll
      for (int e = 0; e < kPack; ++e)
        comb[grp * G * kPack + t * kPack + e] = which ? bp[i][e] : gp[i][e];
      __syncthreads();
      for (int c = threadIdx.x; c < G * kPack; c += kBlock) {
        const int col = i * G * kPack + c;
        if (col < cols) {
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < kGroups; ++k) s += comb[k * G * kPack + c];
          (which ? pb : pg)[col] = s;
        }
      }
      __syncthreads();   // comb is rewritten next
    }
  }
}

// Rows wider than the register plan: a warp owns four rows; a first sweep
// over each forms its two means, a second, pack by pack, writes dx and
// sums the pack's dgamma / dbeta over the warp's rows; the 8 warps add
// theirs through shared memory in warp order.  Grid ceil(R / 32).
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_stream_kernel(const TX* __restrict__ x,
                             const TW* __restrict__ gamma,
                             const float* __restrict__ mean,
                             const float* __restrict__ rstd,
                             const TX* __restrict__ dout,
                             TX* __restrict__ dx, float* __restrict__ part_g,
                             float* __restrict__ part_b, int rows, int cols) {
  constexpr int kRows = kStreamRowsPerBlock / kWarps;
  constexpr int kChunk = 32 * kPack;   // columns one warp covers a step
  __shared__ float red_g[kWarps][kChunk];
  __shared__ float red_b[kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kStreamRowsPerBlock + warp * kRows;
  const int packs = cols / kPack;
  const float inv_n = 1.f / (float)cols;

  float mu[kRows], rs[kRows], m1[kRows], m2[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int row = row0 + rr;
    mu[rr] = rs[rr] = m1[rr] = m2[rr] = 0.f;
    if (row >= rows) continue;
    mu[rr] = mean[row];
    rs[rr] = rstd[row];
    const long long base = (long long)row * cols;
    float s1 = 0.f, s2 = 0.f;
    for (int p = lane; p < packs; p += 32) {
      Pack<TX> xv, dv;
      Pack<TW> gv;
      xv.load(x + base + p * kPack);
      dv.load(dout + base + p * kPack);
      gv.load(gamma + p * kPack);
#pragma unroll
      for (int e = 0; e < kPack; ++e) {
        const float xh = (xv[e] - mu[rr]) * rs[rr];
        const float dxh = dv[e] * gv[e];
        s1 += dxh;
        s2 = fmaf(dxh, xh, s2);
      }
    }
    m1[rr] = warp_sum(s1) * inv_n;
    m2[rr] = warp_sum(s2) * inv_n;
  }

  for (int p0 = 0; p0 < packs; p0 += 32) {
    const int p = p0 + lane;
    float gs[kPack], bs[kPack];
#pragma unroll
    for (int e = 0; e < kPack; ++e) gs[e] = bs[e] = 0.f;
    if (p < packs) {
      Pack<TW> gv;
      gv.load(gamma + p * kPack);
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const int row = row0 + rr;
        if (row >= rows) continue;
        const long long off = (long long)row * cols + p * kPack;
        Pack<TX> xv, dv, o;
        xv.load(x + off);
        dv.load(dout + off);
#pragma unroll
        for (int e = 0; e < kPack; ++e) {
          const float xh = (xv[e] - mu[rr]) * rs[rr];
          const float d = dv[e];
          const float dxh = d * gv[e];
          o.v[e] = from_float<TX>(rs[rr] * (dxh - m1[rr] - xh * m2[rr]));
          gs[e] = fmaf(d, xh, gs[e]);
          bs[e] += d;
        }
        o.store(dx + off);
      }
    }
#pragma unroll
    for (int e = 0; e < kPack; ++e) {
      red_g[warp][lane * kPack + e] = gs[e];
      red_b[warp][lane * kPack + e] = bs[e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kChunk; c += kThreads) {
      const int col = p0 * kPack + c;
      if (col < cols) {
        float sg = 0.f, sb = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sg += red_g[w][c];
          sb += red_b[w][c];
        }
        part_g[(long long)blockIdx.x * cols + col] = sg;
        part_b[(long long)blockIdx.x * cols + col] = sb;
      }
    }
    __syncthreads();   // red_* are rewritten by the next chunk
  }
}

// A block per kReduceCols = 8 columns.  Lane l of a warp takes column
// l % 8 of the block's and, of every 128 parts, part 4 * warp + l / 8: it
// adds its parts in order; a warp then adds its four lanes of a column
// (shuffles), and warp 0 the 32 warps' sums, eight to a lane, then the
// four lanes' (shuffles again): a fixed tree, so a fixed order.  The sum
// is cast to gamma's dtype.
template <typename TW>
__global__ void __launch_bounds__(kReduceThreads)
layer_norm_bwd_reduce_kernel(const float* __restrict__ part_g,
                             const float* __restrict__ part_b,
                             TW* __restrict__ dgamma, TW* __restrict__ dbeta,
                             int parts, int cols) {
  constexpr int kRWarps = kReduceThreads / 32;
  constexpr int kLanesPerCol = 32 / kReduceCols;            // 4
  constexpr int kPartStep = kRWarps * kLanesPerCol;         // 128
  __shared__ float sg[kRWarps][kReduceCols], sb[kRWarps][kReduceCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kReduceCols + lane % kReduceCols;
  float g = 0.f, b = 0.f;
  if (c < cols) {
#pragma unroll 4
    for (int p = warp * kLanesPerCol + lane / kReduceCols; p < parts;
         p += kPartStep) {
      g += part_g[(long long)p * cols + c];
      b += part_b[(long long)p * cols + c];
    }
  }
#pragma unroll
  for (int off = kReduceCols; off < 32; off <<= 1) {
    g += __shfl_xor_sync(0xffffffffu, g, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (lane < kReduceCols) {
    sg[warp][lane] = g;
    sb[warp][lane] = b;
  }
  __syncthreads();
  if (warp != 0) return;
  g = b = 0.f;
#pragma unroll
  for (int k = 0; k < kRWarps / kLanesPerCol; ++k) {
    const int w = lane / kReduceCols * (kRWarps / kLanesPerCol) + k;
    g += sg[w][lane % kReduceCols];
    b += sb[w][lane % kReduceCols];
  }
#pragma unroll
  for (int off = kReduceCols; off < 32; off <<= 1) {
    g += __shfl_xor_sync(0xffffffffu, g, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (lane < kReduceCols && c < cols) {
    dgamma[c] = from_float<TW>(g);
    dbeta[c] = from_float<TW>(b);
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return 132;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      return 132;
    cached[dev] = n;
  }
  return cached[dev];
}

// The rows pass's launch plan at ``cols`` columns (cols <= kPlanMaxCols):
// the instantiation (threads a row, packs a thread), its block and the
// rows a block holds at once.
template <typename TX, typename TW>
struct Plan {
  void (*kernel)(const TX*, const TW*, const float*, const float*, const TX*,
                 TX*, float*, float*, int, int);
  int threads, groups;
};

template <typename TX, typename TW, int WPR, int NP>
Plan<TX, TW> plan_of() {
  return {&layer_norm_bwd_kernel<TX, TW, WPR, NP>, block_threads(WPR),
          block_threads(WPR) / (32 * WPR)};
}

template <typename TX, typename TW>
Plan<TX, TW> plan_for(int cols) {
  const int packs = cols / kPack;
  if (warps_per_row(cols) == 1)
    return packs <= 32   ? plan_of<TX, TW, 1, 1>()
           : packs <= 64 ? plan_of<TX, TW, 1, 2>()
                         : plan_of<TX, TW, 1, 4>();
  if (warps_per_row(cols) == 4)
    return packs <= 256 ? plan_of<TX, TW, 4, 2>() : plan_of<TX, TW, 4, 4>();
  return plan_of<TX, TW, 8, 4>();
}

// One part per block of the rows pass: as many blocks as its rows need,
// at most as many as the device holds at once (so every block owns about
// the same number of rows); one per 32 rows beyond the register plan.
template <typename TX, typename TW>
int parts_for(int rows, int cols) {
  if (cols > kPlanMaxCols)
    return (rows + kStreamRowsPerBlock - 1) / kStreamRowsPerBlock;
  const Plan<TX, TW> plan = plan_for<TX, TW>(cols);
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, plan.kernel, plan.threads, 0) != cudaSuccess ||
      per_sm <= 0)
    per_sm = 1;
  const int blocks = (rows + plan.groups - 1) / plan.groups;
  const int cap = per_sm * sm_count();
  return blocks < cap ? blocks : cap;
}

struct Args {
  const void* x;
  const void* g;
  const float* mean;
  const float* rstd;
  const void* dout;
  void* dx;
  float* part_g;
  float* part_b;
  void* dg;
  void* db;
  int rows, cols;
  cudaStream_t stream;
};

// The rows pass of the plan, then the parts' reduction.
template <typename TX, typename TW>
int launch(const Args& a) {
  const int parts = parts_for<TX, TW>(a.rows, a.cols);
  if (a.cols > kPlanMaxCols) {
    layer_norm_bwd_stream_kernel<TX, TW><<<parts, kThreads, 0, a.stream>>>(
        static_cast<const TX*>(a.x), static_cast<const TW*>(a.g), a.mean,
        a.rstd, static_cast<const TX*>(a.dout), static_cast<TX*>(a.dx),
        a.part_g, a.part_b, a.rows, a.cols);
  } else {
    const Plan<TX, TW> plan = plan_for<TX, TW>(a.cols);
    plan.kernel<<<parts, plan.threads, 0, a.stream>>>(
        static_cast<const TX*>(a.x), static_cast<const TW*>(a.g), a.mean,
        a.rstd, static_cast<const TX*>(a.dout), static_cast<TX*>(a.dx),
        a.part_g, a.part_b, a.rows, a.cols);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  layer_norm_bwd_reduce_kernel<TW>
      <<<(a.cols + kReduceCols - 1) / kReduceCols, kReduceThreads, 0,
         a.stream>>>(a.part_g, a.part_b, static_cast<TW*>(a.dg),
                     static_cast<TW*>(a.db), parts, a.cols);
  return (int)cudaGetLastError();
}

// ``fn<TX, TW>(args...)`` for the dtype codes 0 = float32, 1 = bfloat16,
// 2 = float16; -1 for an unknown code.
template <template <typename, typename> class F, typename... A>
int by_dtypes(int x_dtype, int w_dtype, A... args) {
  switch (x_dtype * 3 + w_dtype) {
    case 0: return F<float, float>::run(args...);
    case 1: return F<float, __nv_bfloat16>::run(args...);
    case 2: return F<float, __half>::run(args...);
    case 3: return F<__nv_bfloat16, float>::run(args...);
    case 4: return F<__nv_bfloat16, __nv_bfloat16>::run(args...);
    case 5: return F<__nv_bfloat16, __half>::run(args...);
    case 6: return F<__half, float>::run(args...);
    case 7: return F<__half, __nv_bfloat16>::run(args...);
    case 8: return F<__half, __half>::run(args...);
  }
  return -1;
}

template <typename TX, typename TW>
struct Parts {
  static int run(int rows, int cols) { return parts_for<TX, TW>(rows, cols); }
};
template <typename TX, typename TW>
struct Launch {
  static int run(const Args& a) { return launch<TX, TW>(a); }
};

bool valid(int rows, int cols, int x_dtype, int w_dtype) {
  return rows > 0 && cols > 0 && cols % kPack == 0 && x_dtype >= 0 &&
         x_dtype < 3 && w_dtype >= 0 && w_dtype < 3;
}

}  // namespace

// Rows of the f32 partial-sum workspace for `rows` rows of `cols` columns
// of these dtypes: one per block of the rows pass (at most as many blocks
// as the current device holds at once), or one per 32 rows beyond the
// register plan; 0 for arguments the kernels refuse.
extern "C" int paddle_layer_norm_bwd_parts(int rows, int cols, int x_dtype,
                                           int w_dtype) {
  if (!valid(rows, cols, x_dtype, w_dtype)) return 0;
  return by_dtypes<Parts>(x_dtype, w_dtype, rows, cols);
}

// x, dout, dx: dense (rows, cols), 16-byte aligned, cols a multiple of 8,
// one dtype; gamma, dgamma, dbeta: dense (cols,) in gamma's dtype, gamma
// 16-byte aligned; mean, rstd: dense (rows,) f32; part_g, part_b: f32
// workspaces of paddle_layer_norm_bwd_parts(rows, cols, x_dtype, w_dtype)
// x cols.  dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  Returns
// the first failing launch's cudaError_t.
extern "C" int paddle_layer_norm_bwd(const void* x, const void* gamma,
                                     const float* mean, const float* rstd,
                                     const void* dout, void* dx,
                                     float* part_g, float* part_b,
                                     void* dgamma, void* dbeta, int rows,
                                     int cols, int x_dtype, int w_dtype,
                                     void* stream) {
  if (!valid(rows, cols, x_dtype, w_dtype))
    return (int)cudaErrorInvalidValue;
  const Args a{x,      gamma,  mean,   rstd,   dout, dx,   part_g,
               part_b, dgamma, dbeta,  rows,   cols,
               static_cast<cudaStream_t>(stream)};
  return by_dtypes<Launch>(x_dtype, w_dtype, a);
}
