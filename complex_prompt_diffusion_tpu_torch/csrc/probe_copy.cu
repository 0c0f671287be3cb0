// K9: the streaming-copy probe. Copies an [N, HW, C] bf16 tensor in tiles
// of `rows` rows (one block a tile), to measure the rate at which this card
// streams a plane through a kernel, against the nominal 3.35 TB/s that the
// "bytes" bounds of the other kernels use.
//
// Replaces the TPU probe kernels scripts/perf_gn7.py:36 make (_copy_kernel
// :24: an NHWC copy over (n, hw / ch) blocks, with and without a round trip
// through f32) and scripts/perf_gn8.py:29 make (the same copy with
// multi-buffered DMA, buffer_count 0 / 3 / 4 / 8).
//   * convert: each bf16 goes to f32 and back (the GroupNorm's conversion);
//   * stages = 1: every thread loads 16 bytes and stores them, plainly;
//     stages = S > 1: a ring of S 16-byte slots a thread in shared memory,
//     kept full with cp.async, so S - 1 loads are in flight behind the one
//     being stored (CUDA rather than Triton: the depth is the variable).
// A tile is `rows` whole rows, so it is contiguous: 16-byte accesses,
// consecutive threads on consecutive addresses.
//
// What bounds it: bytes, one read and one write of the tensor. The probe now
// runs probe_copy_sm90.cu (shares of each tile over a persistent grid, bulk
// copies through a ring); this first body stays as its replaced body
// (ops/probes/stream.py: stream_copy_prior), timed beside it.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 through_f32(uint4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __float22bfloat162_rn(__bfloat1622float2(h[i]));
  return v;
}

template <int STAGES, bool CONVERT>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, long long tile) {
  // tile: 16-byte chunks of one tile; block (k, n) copies tile n * gridDim.x + k
  const long long t0 = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * tile;
  const uint4* src = x + t0;
  uint4* dst = y + t0;
  const int tid = threadIdx.x;
  if constexpr (STAGES == 1) {
    for (long long i = tid; i < tile; i += kThreads) {
      uint4 v = src[i];
      if constexpr (CONVERT) v = through_f32(v);
      dst[i] = v;
    }
  } else {
    __shared__ uint4 ring[STAGES][kThreads];  // slot s of this thread: ring[s][tid]
    const int n = tile > tid ? (int)((tile - tid + kThreads - 1) / kThreads) : 0;  // my chunks
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      if (st < n) cpd::cp_async16(&ring[st][tid], src + tid + (long long)st * kThreads, true);
      cpd::cp_async_commit();
    }
    int slot = 0;
    for (int it = 0; it < n; ++it) {
      cpd::cp_async_wait<STAGES - 1>();  // this thread's chunk `it` (group `it`) has landed
      uint4 v = ring[slot][tid];
      if constexpr (CONVERT) v = through_f32(v);
      dst[tid + (long long)it * kThreads] = v;
      asm volatile("" ::: "memory");  // the slot is read before it is refilled
      const int nx = it + STAGES;
      if (nx < n) cpd::cp_async16(&ring[slot][tid], src + tid + (long long)nx * kThreads, true);
      cpd::cp_async_commit();
      slot = slot + 1 == STAGES ? 0 : slot + 1;
    }
  }
}

template <int STAGES, bool CONVERT>
int launch(const void* x, void* y, int tiles_per_sample, int N, long long tile, cudaStream_t s) {
  copy_kernel<STAGES, CONVERT><<<dim3(tiles_per_sample, N), kThreads, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), tile);
  return (int)cudaGetLastError();
}

template <bool CONVERT>
int by_stages(const void* x, void* y, int tiles, int N, long long tile, int stages,
              cudaStream_t s) {
  switch (stages) {
    case 1:
      return launch<1, CONVERT>(x, y, tiles, N, tile, s);
    case 3:
      return launch<3, CONVERT>(x, y, tiles, N, tile, s);
    case 4:
      return launch<4, CONVERT>(x, y, tiles, N, tile, s);
    case 8:
      return launch<8, CONVERT>(x, y, tiles, N, tile, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [N, HW, C] bf16 contiguous, 16-byte aligned; rows divides HW and
// rows * C is a multiple of 8 (whole 16-byte chunks a tile); stages 1, 3,
// 4 or 8; convert 0 or 1.
extern "C" int cpd_probe_copy_bf16(const void* x, void* y, int N, int HW, int C, int rows,
                                   int convert, int stages, void* stream) {
  if (N <= 0 || rows <= 0 || HW % rows != 0 || ((long long)rows * C) % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long tile = (long long)rows * C / 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return convert ? by_stages<true>(x, y, HW / rows, N, tile, stages, s)
                 : by_stages<false>(x, y, HW / rows, N, tile, stages, s);
}
