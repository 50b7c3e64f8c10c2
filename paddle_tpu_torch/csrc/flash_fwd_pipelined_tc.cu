// Pipelined flash-attention forward on Hopper's tensor cores (sm_90a),
// bf16 and fp16, plain C interface for ctypes: kernel A' for 16-bit
// inputs (flash_fwd_pipelined.cu keeps it for f32).
//
// Replaces paddle_tpu/kernels/flash_attention_pallas.py:
// _fwd_kernel_pipelined (the `pipelined` variant of the flash_fwd
// autotune family) for bfloat16 and float16 inputs at head dims 64, 128
// and 256.  Per (batch, head) it computes what its _online_step computes,
// tile by tile over K/V:
//   S = Q K^T (T operands, f32 sums), x = S * scale * log2(e) in f32,
//   m' = max(m, rowmax x),  p = exp2(x - m'),  c = exp2(m - m'),
//   l' = l c + rowsum p (the unrounded f32 p),  O' = O c + T(p) V,
// with P rounded to V's type T before the product, as p.astype(v.dtype)
// does (flash_attention_pallas.py:329); out = O / l in T and the base-e
// f32 lse (B, S, H) when asked.  Under causal the scan stops after the
// diagonal band, kend = (qt + 1) BQ / BK (:541), and only the diagonal
// tiles mask (key t visible to query s iff t <= s).
//
// Bound on the H100 SXM (989 TFLOP/s bf16 and fp16, 3.35 TB/s), q, k, v
// read and out written once against the two products over the visible
// pairs: (1, 128, 16, 64) causal 0.000313 ms (bytes); (8, 1024, 16, 64)
// causal 0.0200 ms (bytes; operations 0.0174); (1, 16384, 2, 64) causal
// 0.0695 ms and (1, 16384, 16, 64) 0.556 ms (operations).  Only the
// tensor cores reach the operations rate.
//
// Design.  The TPU kernel keeps K/V in HBM and double-buffers K/V chunks
// into VMEM with explicit async copies (:545-572).  On Hopper that ring
// is TMA copies into shared memory guarded by mbarriers (tma_common.cuh),
// fed by a producer of its own.  Against the FMA kernel that bf16 took
// before (flash_fwd_pipelined.cu, now f32 only), each of its faults has
// an answer:
//   - products on f32 FMAs: S = Q K^T runs on wgmma with both operands in
//     shared memory and O += P V with P from registers (the m64nNk16
//     accumulator layout of 16 columns is the A layout of one k16 step),
//     V read MN-major through the descriptor's transpose bit;
//   - P through an f32 shared tile between two block barriers: the
//     online softmax runs in the accumulator registers (a thread owns two
//     rows; row max and sum take two shuffles across its quad), and P is
//     converted in place to T as the A fragments;
//   - the computing threads issuing the copies, one tile in flight and a
//     block barrier a tile: one block per (batch, head, BQ-row q tile)
//     holds BQ / 64 consumer warpgroups and a producer (one warp beside
//     one warpgroup; beside two a warpgroup that hands its registers to
//     them with setmaxnreg), whose first thread loads the q tile once and
//     keeps a ring of STAGES (2 to 4) K/V slots full, each slot one
//     `cp.async.bulk.tensor` box of 64 columns by BK rows a 64-column
//     atom, completing on the slot's "full" barrier.  A consumer warp
//     arrives on the slot's "empty" barrier once its wgmma.wait_group
//     has retired the products that read it; the producer waits for that
//     before refilling the slot.  No block barrier after the set-up.
// The consumers' per-tile step and epilogue are FwdRows
// (wgmma_common.cuh), the tensor-core forward's own: only the loads
// differ.  The producer issues exactly the tiles the consumers read (the
// same kend).  Under causal the q tiles with the most K tiles start first (the
// block index runs them in reverse), and a warpgroup whose 64 rows all
// precede a tile skips that tile's products but still takes part in the
// ring.  At head dim 256 O is two m64n128 accumulators (128 registers a
// thread).  Overlapping a tile's softmax with the previous tile's P V in
// one warpgroup (S of tile t and P V of tile t - 1 in flight together,
// O rescaled after both) was tried: 5-57% slower on the H100 at every
// measured shape (PERF.md), so each tile's products are waited for in
// turn and the two warpgroups of a 128-row tile overlap each other.  The
// tensor maps are 4-D over (D, H, S, B) with the tensors' own strides, so
// q, k and v may be slices of one fused projection; they are encoded per
// call by the host and passed as __grid_constant__ parameters.  (BQ, BK)
// are the autotuner's A' tiles (_PIPELINED_BLOCKS in
// kernels/flash_attention_cuda.py); STAGES is the most that fit in shared
// memory, up to 4, and a tile that does not fit two is refused.

#include <math.h>

#include "tma_common.cuh"
#include "wgmma_common.cuh"

namespace {

// the dynamic shared memory a block may use on the H100 (opt-in)
constexpr int kSmemLimit = 232448;
// bytes of slack to align the tiles to the swizzle's 1024-byte period,
// and of the barriers after them
constexpr int kAlign = 1024;
constexpr int kBarBytes = 256;

// K/V slots of the ring: as many as fit, at most 4; fewer than 2 means
// the tile does not fit (pipelined_tc_smem_bytes then exceeds the limit)
__host__ __device__ constexpr int pipelined_tc_stages(int D, int BQ,
                                                     int BK) {
  const int fit = (kSmemLimit - kAlign - kBarBytes - BQ * D * 2) /
                  (4 * BK * D);
  return fit > 4 ? 4 : (fit < 2 ? 2 : fit);
}
// Dynamic shared memory of one launch: the slack, the 16-bit BQ x D q
// tile, STAGES slots of the BK x D K and V tiles, the barriers.
__host__ __device__ constexpr int pipelined_tc_smem_bytes(int D, int BQ,
                                                         int BK) {
  return kAlign + BQ * D * 2 + pipelined_tc_stages(D, BQ, BK) * 4 * BK * D +
         kBarBytes;
}

// Threads of the producer: one warp beside one consumer warpgroup; a
// whole warpgroup beside two, which gives its registers to the consumers
// (setmaxnreg): the register file is split over the SM's four
// partitions, so with a ninth warp the launch allows 168 registers a
// thread, with twelve warps the consumers take 232 and the producer 40.
__host__ __device__ constexpr int producer_threads(int BQ) {
  return BQ == 128 ? 128 : 32;
}

struct PipeArgs {
  void* out;       // dense (B, S, H, D), T or (out_f32) float
  float* lse;      // dense (B, S, H) f32, or null
  int S, H;
  int causal;
  float scale2;    // scale * log2(e)
  int out_f32;     // out is float, unrounded
};

// Grid (S / BQ, H, B), 2 BQ + producer_threads(BQ) threads: warpgroup
// wg < BQ / 64 consumes q rows [64 wg, 64 wg + 64) of tile S / BQ - 1 - x,
// the threads after them produce.
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(2 * BQ + producer_threads(BQ), 1)
flash_fwd_pipelined_tc_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const PipeArgs a) {
  constexpr int NC = BQ / 64;          // consumer warpgroups
  constexpr int STAGES = pipelined_tc_stages(D, BQ, BK);
  constexpr int QTILE = BQ * D * 2;    // bytes of the q tile
  constexpr int KTILE = BK * D * 2;    // bytes of one K or V tile
  static_assert(BQ % BK == 0, "the causal band is whole K tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sKV = base + QTILE;
  // barriers: full[STAGES], empty[STAGES], q
  const uint32_t bars = sKV + STAGES * 2 * KTILE;
  const uint32_t qbar = bars + 16 * STAGES;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };

  const int n_t = a.S / BQ;
  const int qt = n_t - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  // K tiles visited: up to the q tile's last row under causal
  const int n_it = a.causal ? (q0 + BQ) / BK : a.S / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * NC);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NC) {
    // producer: its first thread issues every copy
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 128 * NC) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(qbar, QTILE);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(sQ + c * BQ * 128, &tq, qbar, 64 * c, h, q0, b);
      for (int it = 0; it < n_it; ++it) {
        const int st = it % STAGES;
        mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(st), 2 * KTILE);
        const uint32_t sK = sKV + st * 2 * KTILE;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sK + c * BK * 128, &tk, full(st), 64 * c, h, it * BK,
                      b);
          tma_load_4d(sK + KTILE + c * BK * 128, &tv, full(st), 64 * c, h,
                      it * BK, b);
        }
      }
    }
    return;
  }

  // consumers
  if constexpr (NC == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x >> 7;
  const int l = threadIdx.x & 31;
  FwdRows<T, D, BQ, BK> f;
  f.init();

  mbar_wait(qbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES;
    mbar_wait(full(st), (it / STAGES) & 1);

    const int c0 = it * BK;
    // under causal a warpgroup whose rows all precede this tile sees none
    // of it (only at BQ > BK, the band's later tiles)
    const bool active = !a.causal || c0 <= q0 + 64 * wg + 63;
    if (active) {
      const uint32_t sK = sKV + st * 2 * KTILE;
      f.tile(sQ, wg, sK, sK + KTILE, c0, q0 + 64 * wg, a.causal, a.scale2);
    }
    // this warp's products that read the slot have retired: release it
    __syncwarp();
    if (l == 0) mbar_arrive(empty(st));
  }

  if (a.out_f32)
    f.finish(static_cast<float*>(a.out), a.lse, b, a.S, a.H, h, q0 + 64 * wg);
  else
    f.finish(static_cast<T*>(a.out), a.lse, b, a.S, a.H, h, q0 + 64 * wg);
}

struct Maps {
  CUtensorMap q, k, v;
};

template <typename T, int D, int BQ, int BK>
int launch(const Maps& mp, const PipeArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = pipelined_tc_smem_bytes(D, BQ, BK);
  if constexpr (smem > kSmemLimit) {
    return (int)cudaErrorInvalidValue;   // refused: two slots do not fit
  } else {
    // opt in to more than 48 KB of dynamic shared memory once per
    // instantiation (idempotent, so a race between threads is harmless)
    static bool smem_set = false;
    if (!smem_set) {
      cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_pipelined_tc_kernel<T, D, BQ, BK>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      smem_set = true;
    }
    flash_fwd_pipelined_tc_kernel<T, D, BQ, BK>
        <<<dim3(a.S / BQ, a.H, B), 2 * BQ + producer_threads(BQ), smem,
           stream>>>(mp.q, mp.k, mp.v, a);
    return (int)cudaGetLastError();
  }
}

template <typename T, int D>
int dispatch_blocks(int bq, int bk, const Maps& mp, const PipeArgs& a,
                    int B, cudaStream_t st) {
  if (bq == 64 && bk == 32) return launch<T, D, 64, 32>(mp, a, B, st);
  if (bq == 64 && bk == 64) return launch<T, D, 64, 64>(mp, a, B, st);
  if (bq == 128 && bk == 64) return launch<T, D, 128, 64>(mp, a, B, st);
  if (bq == 128 && bk == 128) return launch<T, D, 128, 128>(mp, a, B, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_d(int D, int bq, int bk, const Maps& mp, const PipeArgs& a,
               int B, cudaStream_t st) {
  if (D == 64) return dispatch_blocks<T, 64>(bq, bk, mp, a, B, st);
  if (D == 128) return dispatch_blocks<T, 128>(bq, bk, mp, a, B, st);
  if (D == 256) return dispatch_blocks<T, 256>(bq, bk, mp, a, B, st);
  return (int)cudaErrorInvalidValue;
}

bool instantiated(int D, int bq, int bk) {
  const bool blocks = (bq == 64 && (bk == 32 || bk == 64)) ||
                      (bq == 128 && (bk == 64 || bk == 128));
  return blocks && (D == 64 || D == 128 || D == 256);
}

int run(const void* q, const void* k, const void* v, void* out, float* lse,
        int B, int S, int H, int D, long long q_sb, long long q_ss,
        long long k_sb, long long k_ss, long long v_sb, long long v_ss,
        int causal, float scale, int dtype, int block_q, int block_k,
        void* stream, int out_f32) {
  if (S <= 0 || B <= 0 || H <= 0 || !instantiated(D, block_q, block_k) ||
      S % block_q != 0 || (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  if ((ptrs & 15) || ((q_sb | q_ss | k_sb | k_ss | v_sb | v_ss) & 7))
    return (int)cudaErrorMisalignedAddress;
  Maps mp;
  int err = encode_rows_map(&mp.q, q, dtype, B, S, H, D, q_ss, q_sb, block_q);
  if (err == 0)
    err = encode_rows_map(&mp.k, k, dtype, B, S, H, D, k_ss, k_sb, block_k);
  if (err == 0)
    err = encode_rows_map(&mp.v, v, dtype, B, S, H, D, v_ss, v_sb, block_k);
  if (err != 0) return err;
  const PipeArgs a{out, lse, S, H, causal, scale * kLog2e, out_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch_d<bf16>(D, block_q, block_k, mp, a, B, st);
  return dispatch_d<f16>(D, block_q, block_k, mp, a, B, st);
}

}  // namespace

// q/k/v: (B, S, H, D) with (H, D) dense and the given batch / sequence
// strides in elements, base pointers and strides multiples of 16 bytes
// (the tensor maps' rule: the caller copies what is not); out: dense
// (B, S, H, D); lse: dense (B, S, H) f32 or NULL.  dtype 1 = bfloat16,
// 2 = float16.  (block_q, block_k) one of (64, 32), (64, 64), (128, 64),
// (128, 128), S a multiple of block_q.  `scale` is the base-e softmax
// scale.  Returns the tensor maps' or the launch's cudaError_t.
extern "C" int paddle_flash_fwd_pipelined_tc(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int S, int H, int D, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    int causal, float scale, int dtype, int block_q, int block_k,
    void* stream) {
  return run(q, k, v, out, lse, B, S, H, D, q_sb, q_ss, k_sb, k_ss, v_sb,
             v_ss, causal, scale, dtype, block_q, block_k, stream, 0);
}

// The same with `out` a dense (B, S, H, D) float32 tensor: O / l
// unrounded (ring attention combines its blocks before one rounding).
extern "C" int paddle_flash_fwd_pipelined_tc_f32out(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int S, int H, int D, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    int causal, float scale, int dtype, int block_q, int block_k,
    void* stream) {
  return run(q, k, v, out, lse, B, S, H, D, q_sb, q_ss, k_sb, k_ss, v_sb,
             v_ss, causal, scale, dtype, block_q, block_k, stream, 1);
}

// Bytes of dynamic shared memory one launch asks for at head dim D and
// tiles (block_q, block_k) (pipelined_tc_smem_bytes: more than a block
// may use when two K/V slots do not fit, and then it is refused), or -1
// when that configuration is not instantiated.
extern "C" long long paddle_flash_fwd_pipelined_tc_smem(int D, int block_q,
                                                        int block_k) {
  if (!instantiated(D, block_q, block_k)) return -1;
  return pipelined_tc_smem_bytes(D, block_q, block_k);
}
