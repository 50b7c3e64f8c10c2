// Flash-attention forward with pipelined K/V tiles for Hopper (sm_90a),
// plain C interface for ctypes: kernel A' for float32 inputs (bf16 and
// fp16 take flash_fwd_pipelined_tc.cu, on the tensor cores; f32 there
// would be TF32, other numerics).
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
// (flash_attention_pallas.py:555-572).  Here one thread block owns one
// (batch, head, BQ-row q tile); its K/V tiles land in a two-stage ring in
// shared memory through cp.async 16-byte copies, one commit group per tile:
// the copy of tile kt+1 is issued, then `cp.async.wait_group 1` waits for
// tile kt alone, and the products of tile kt run while kt+1 is in flight.
// Rows are padded by 16 bytes so every row stays 16-byte aligned;
// operands are read 16 bytes at a time, which keeps the padded rows free
// of bank conflicts.  As at :541, under `causal` the
// scan stops after the diagonal band, kend = (qt + 1) * BQ / BK, and every
// visited tile applies the mask (a compare per score, no separate
// mask-free loop).  The statistics are A's: f32 (m, l, acc) in registers,
// the softmax in base 2 with log2(e) folded into the scale applied to the
// raw q.k product (the TPU kernel's order), and the base-e lse.  Products
// are plain f32 FMAs.  The tile shape is a
// template parameter; 4 * BQ threads, each owning 4 q rows, BK / 16 score
// columns and D / 16 output columns.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): as kernel A, it must read q, k, v and write out once (16 MiB at
// B=8, S=1024, H=16, D=64 f32, 5 us) and do 4 S^2 D / 2 FLOP per (batch,
// head) causal (0.257 ms there): bound by operations.  Its measured times
// stand in PERF.md beside the bound.

#include <cuda_runtime.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// elements in 16 bytes: the cp.async chunk, the row padding and the width
// of one shared-memory read
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// Dynamic shared memory of one launch: the q tile and two stages of K and
// V in the input dtype (rows of D + kVec elements), then the f32 P tile.
constexpr size_t smem_bytes(int elem, int D, int BQ, int BK) {
  return (size_t)(BQ + 4 * BK) * (D + 16 / elem) * elem +
         (size_t)BQ * (BK + 1) * sizeof(float);
}

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// 16 bytes of shared memory as floats
__device__ __forceinline__ void load_vec(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the async copies of rows [row0, row0 + ROWS) of one head into a
// padded tile (row stride D + kVec).  Source rows are `row_stride`
// elements apart, the head's D elements contiguous and 16-byte aligned.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void copy_tile_async(T* tile, const T* base,
                                                long long row_stride,
                                                int row0) {
  constexpr int kChunks = D / kVec<T>;   // 16-byte chunks per row
  constexpr int ld = D + kVec<T>;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += NT) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    cp_async16(tile + r * ld + c * kVec<T>,
               base + (long long)(row0 + r) * row_stride + c * kVec<T>);
  }
}

// Grid (S / BQ, H, B); block 4 * BQ threads.  Thread (ty, tx) = (tid / 16,
// tid % 16) owns q rows ty + (BQ / 4) i (i < 4), score columns tx + 16 j
// (j < BK / 16) of each K tile, and output columns tx + 16 c (c < D / 16).
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(4 * BQ)
flash_fwd_pipelined_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int S, int H,
                           long long q_sb, long long q_ss, long long k_sb,
                           long long k_ss, long long v_sb, long long v_ss,
                           int causal, float scale2) {
  constexpr int NT = 4 * BQ;
  constexpr int TY = BQ / 4;         // row groups; rows ty + TY * i
  constexpr int ld = D + kVec<T>;    // padded row stride of every tile
  constexpr int ldp = BK + 1;        // odd row stride of the P tile
  constexpr int NJ = BK / 16;        // score columns per thread
  constexpr int NC = D / 16;         // output columns per thread
  constexpr int V = kVec<T>;
  static_assert(BQ % BK == 0 && BK % 16 == 0 && D % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BQ * ld;              // stages 0 and 1
  T* sV = sK + 2 * BK * ld;          // stages 0 and 1
  float* sP = reinterpret_cast<float*>(sV + 2 * BK * ld);

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qt * BQ;
  const T* kb = k + b * k_sb + (long long)h * D;
  const T* vb = v + b * v_sb + (long long)h * D;

  // prologue: the q tile and K/V tile 0 in one commit group
  copy_tile_async<T, D, BQ, NT>(sQ, q + b * q_sb + (long long)h * D, q_ss,
                                q0);
  copy_tile_async<T, D, BK, NT>(sK, kb, k_ss, 0);
  copy_tile_async<T, D, BK, NT>(sV, vb, v_ss, 0);
  cp_async_commit();

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // under causal, the tiles up to the end of the q tile's band
  const int kend = causal ? (qt + 1) * (BQ / BK) : S / BK;
  for (int kt = 0; kt < kend; ++kt) {
    const int slot = kt & 1;
    if (kt + 1 < kend) {
      // prefetch tile kt+1 into the other stage (last read in iteration
      // kt-1, which ended in a barrier), then wait for tile kt alone
      copy_tile_async<T, D, BK, NT>(sK + (slot ^ 1) * BK * ld, kb, k_ss,
                                    (kt + 1) * BK);
      copy_tile_async<T, D, BK, NT>(sV + (slot ^ 1) * BK * ld, vb, v_ss,
                                    (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile kt (and the q tile) visible to every thread
    const T* tK = sK + slot * BK * ld;
    const T* tV = sV + slot * BK * ld;

    // raw scores q . k over D, 16 bytes of each operand per read
    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += V) {
      float qv[4][V];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec(sQ + (ty + TY * i) * ld + d, qv[i]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float kv[V];
        load_vec(tK + (tx + 16 * j) * ld + d, kv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < V; ++e) s[i][j] = fmaf(qv[i][e], kv[e], s[i][j]);
      }
    }

    // base-2 logits, the mask on every visited tile, online softmax; the
    // 16 threads of a row group share each row
    const int c0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + TY * i;
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float x = s[i][j] * scale2;
        if (causal && c0 + tx + 16 * j > q0 + r) x = kNegBig;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sP[r * ldp + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();   // sP complete

    // acc += P V
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + TY * i) * ldp + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = to_float(tV[j * ld + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
    __syncthreads();   // reads of this stage and of sP done before reuse
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + TY * i;
    const long long o = ((long long)b * S + row) * H + h;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / l_safe;
    T* orow = out + o * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      orow[tx + 16 * c] = from_float<T>(acc[i][c] * inv);
    if (lse != nullptr && tx == 0) lse[o] = (m[i] + log2f(l_safe)) * kLn2;
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int B, S, H;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
  int causal;
  float scale2;
};

template <typename T, int D, int BQ, int BK>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes((int)sizeof(T), D, BQ, BK);
  // opt in to > 48 KB of dynamic shared memory once per instantiation (the
  // call is idempotent, so a race between threads is harmless)
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_pipelined_kernel<T, D, BQ, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();   // leave no stale error for the next launch
      return (int)err;
    }
    smem_set = true;
  }
  if (a.S % BQ != 0) return (int)cudaErrorInvalidValue;
  dim3 grid(a.S / BQ, a.H, a.B);
  flash_fwd_pipelined_kernel<T, D, BQ, BK><<<grid, 4 * BQ, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.S, a.H,
      a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.causal, a.scale2);
  return (int)cudaGetLastError();
}

// the (block_q, block_k) pairs instantiated at each D and dtype
template <typename T, int D>
int dispatch_blocks(int bq, int bk, const Args& a, cudaStream_t stream) {
  if (bq == 64 && bk == 32) return launch<T, D, 64, 32>(a, stream);
  if (bq == 64 && bk == 64) return launch<T, D, 64, 64>(a, stream);
  if (bq == 128 && bk == 64) return launch<T, D, 128, 64>(a, stream);
  if (bq == 128 && bk == 128) return launch<T, D, 128, 128>(a, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_d(int D, int bq, int bk, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 64:
      return dispatch_blocks<T, 64>(bq, bk, a, stream);
    case 128:
      return dispatch_blocks<T, 128>(bq, bk, a, stream);
    case 256:
      return dispatch_blocks<T, 256>(bq, bk, a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  if (S <= 0 || B <= 0 || H <= 0 || !instantiated(D, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  const Args a{q,    k,    v,    out,  lse,  B,      S,
               H,    q_sb, q_ss, k_sb, k_ss, v_sb,   v_ss,
               causal, scale * 1.4426950408889634f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(D, block_q, block_k, a, st);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory a launch of that configuration asks for, or -1
// when it is not instantiated (dtype 0 = float32 only): the wrapper's
// smem_bytes hook is held to it.
extern "C" long long paddle_flash_fwd_pipelined_smem(int D, int block_q,
                                                     int block_k,
                                                     int dtype) {
  if (!instantiated(D, block_q, block_k) || dtype != 0) return -1;
  return (long long)smem_bytes(4, D, block_q, block_k);
}
