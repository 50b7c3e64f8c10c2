// Hopper's Tensor Memory Accelerator (TMA) and shared-memory barriers
// (mbarrier), as the warp-specialised kernels use them (sm_90a): the
// device side of a ring of tiles that one producer thread fills with
// tensor copies and consumer warps drain, and the host side that encodes
// a tensor map.
//
// A tile lands in the 128-byte swizzled layout of wgmma_common.cuh: the
// map's box is 64 columns (128 bytes) by R rows, copied with
// CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned atom, which stores
// the 16-byte chunk c of row r at chunk c ^ (r % 8), what wgmma's
// descriptors read.  A head dim of 128 or 256 is two or four such boxes.
//
// Barriers count arrivals and, for a copy, bytes: a "full" barrier of a
// ring slot expects one arrival (the producer's arrive.expect_tx, which
// also sets the bytes in flight) and completes when the copies' bytes
// have landed; an "empty" barrier expects one arrival from each consumer
// warp.  A wait names the parity of the phase it waits for: a barrier
// starts in phase 0, so waiting for parity 1 passes at once, which is how
// a producer finds every slot free on its first round.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// the barriers' initialisation visible to every thread and to the
// async proxy (the copies) before first use
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}
// Copy the box at coordinates (c0, c1, c2, c3) of a 4-D map into shared
// memory at `dst`; its bytes complete on barrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so
// the library links no libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of a (B, S, H, D) 16-bit tensor with dense (H, D) and the given
// sequence and batch strides (elements), read in boxes of 64 columns by
// `rows` rows of one (batch, head), 128-byte swizzled.  dtype 1 = bf16,
// 2 = fp16.  Returns a cudaError_t: cudaErrorNotSupported without the
// driver's encoder, cudaErrorInvalidValue when it refuses the layout
// (bases and strides must be multiples of 16 bytes).
inline int encode_rows_map(CUtensorMap* map, const void* base, int dtype,
                           int B, int S, int H, int D, long long ss,
                           long long sb, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  // one batch: its stride is never stepped, so any packed value will do
  if (B == 1) sb = (long long)S * ss;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map,
         dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
         4, const_cast<void*>(base), dims, strides, box, step,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

}  // namespace
