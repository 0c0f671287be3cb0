// Hopper (sm_90a) building blocks of the TMA + wgmma kernels
// (conv3x3_sm90.cu, attention_sm90.cu, geglu_ff_sm90.cu,
// attention_f32_sm90.cu, attention_bf16_wide_sm90.cu, attention_cm*_sm90.cu,
// winograd_sm90.cu) and of the bulk-copy ones (groupnorm_sm90.cu,
// probe_copy_sm90.cu): mbarriers, TMA tensor loads, bulk copies in and out,
// wgmma descriptors and fences, register reallocation, TMA tensor stores,
// and on the host the encoding of TMA tensor maps.
//
// cuTensorMapEncodeTiled is a driver-API function. The library links only
// the CUDA runtime, so it is reached through the runtime's driver entry
// point (cudaGetDriverEntryPointByVersion, or cudaGetDriverEntryPoint before
// CUDA 12.5), once per process; no -lcuda on the link line.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing is linked)
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace cpd {

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---- TMA: tiled tensor loads into shared memory, completion on an mbarrier ----

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- TMA: tiled tensor stores from shared memory, in bulk groups ----

// make this thread's writes to shared memory visible to the async proxy,
// before a TMA store reads them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the box at (c0, c1) of `map` from shared memory; the parts of the box
// outside the tensor are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's committed stores have read their shared memory (READ) or
// completed, all but the newest N groups
template <int N, bool READ>
__device__ __forceinline__ void tma_store_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_prefetch_desc(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- bulk copies (non-tensor TMA): contiguous bytes into shared memory ----

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned; completion on `bar` (which must expect them)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16) from shared `src` to global `dst`, both 16-byte
// aligned, in this thread's current bulk group (tma_store_commit /
// tma_store_wait track it)
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// ---- wgmma ----

// Shared-memory matrix descriptor of a tile in the 128-byte swizzle layout
// that a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 128 bytes
// (64 bf16), 8-row atoms of 1024 bytes. K-major operands: lbo unused (16),
// sbo = 1024 (the next 8 rows); advancing K by 16 elements adds 32 bytes to
// the start address. MN-major operands: lbo = the byte stride between
// 64-element groups along MN, sbo = 1024 (the next 8 rows along K). The tile
// base must be 1024-byte aligned (base offset 0).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFFull) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them (emits no instruction).
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- host: TMA tensor maps ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of rank R over elements of `dtype` (dims innermost first, byte
// strides of dims 1..R-1) with 128-byte swizzle (or `swizzle`) and zero fill
// outside the tensor. Returns a cudaError_t: cudaErrorInvalidValue when the
// map cannot be encoded (an address or stride that is not a multiple of 16
// bytes, a box too large).
template <int R>
inline int encode_map(CUtensorMap* map, CUtensorMapDataType dtype, const void* base,
                      const uint64_t (&dims)[R], const uint64_t (&strides)[R - 1],
                      const uint32_t (&box)[R],
                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  cuuint64_t d[R], s[R > 1 ? R - 1 : 1];
  cuuint32_t b[R], e[R];
  for (int i = 0; i < R; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i < R - 1) s[i] = strides[i];
  }
  CUresult res = fn(map, dtype, R, const_cast<void*>(base), d, s, b, e,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int R>
inline int encode_bf16_map(CUtensorMap* map, const void* base, const uint64_t (&dims)[R],
                           const uint64_t (&strides)[R - 1], const uint32_t (&box)[R]) {
  return encode_map<R>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box);
}

template <int R>
inline int encode_f32_map(CUtensorMap* map, const void* base, const uint64_t (&dims)[R],
                          const uint64_t (&strides)[R - 1], const uint32_t (&box)[R]) {
  return encode_map<R>(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, dims, strides, box);
}

}  // namespace cpd
