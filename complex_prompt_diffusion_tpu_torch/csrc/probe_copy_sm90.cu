// K9 on Hopper: the streaming-copy probe. Copies an [N, HW, C] bf16 tensor
// in tiles of `rows` whole rows, plainly or with every value taken through
// f32 and back, to read the rate at which this card streams a plane through
// a kernel (the "bytes" bounds of the other kernels assume 3.35 TB/s).
//
// Replaces the TPU probe kernels scripts/perf_gn7.py:36 make (_copy_kernel
// :24: grid (n, hw / rows), block [1, rows, C], passthrough or f32 convert)
// and scripts/perf_gn8.py:29 make (the same copy with pl.Buffered(buffer
// count)). The knobs keep their meaning: `rows` is the unit of work one TPU
// block was, `stages` the depth of the load pipeline.
//
// What bounds it: bytes, one read and one write of the tensor. The first
// body (probe_copy.cu, kept as the replaced body) ran one block a tile, as
// the TPU grid did: at rows = 4096 on [8, 4096, 320] that is 8 blocks on 132
// SMs, and its 4096-row f32 mode took 6.4x Tensor.copy_. Design:
//   * A tile is cut into `split` contiguous shares (their bounds in 16-byte
//     units: k * units / split), so that tiles x split fills every SM; small
//     tiles keep split = 1. A persistent grid of `grid` blocks walks the
//     shares: block g takes shares g, g + grid, ... (consecutive blocks on
//     consecutive bytes). The CTAs that share a tile exchange nothing, so no
//     cluster is launched: a cluster would only constrain their scheduling.
//   * A block streams its shares in chunks of at most `slot` bytes (each
//     share is chunks_per_share chunks, the last one shorter) through a ring
//     of STAGES slots in shared memory: one thread issues cp.async.bulk
//     global -> shared, completing on the slot's mbarrier, then
//     cp.async.bulk shared -> global from the landed slot; a slot is loaded
//     again once the bulk-group wait says its store has read it. The ring
//     runs on across a block's shares. `stages` = 1 waits for each store's
//     read before the next load; deeper rings keep STAGES - 1 loads in
//     flight behind the one being stored.
//   * convert: the block's threads take each landed slot through f32 and
//     back in place (16 bytes a thread a step), fence the writes to the
//     async proxy and meet at a barrier before the store is issued.
//   * The plan (ops/probes/stream.py: copy_plan) gives split, slot, the
//     chunks of a share and the grid (blocks an SM x 132), so that every
//     SM keeps about 128 KB of loads and stores in flight at every depth.
// Shares and chunks cover the tensor exactly once, so the output is the
// input's bits (bit-exact, in both modes).

#include "sm90.cuh"

namespace {

struct CopyArgs {
  long long tile_bytes;  // one tile: rows x C x 2, a multiple of 16
  long long units;       // tile_bytes / 16
  long long items;       // shares: tiles x split
  int split;             // shares a tile
  int slot;              // bytes of a ring slot (a multiple of 16)
  int chunks;            // chunks a share
};

// chunk j of this block (over its shares, in order) -> byte offset and size
__device__ __forceinline__ void chunk_at(const CopyArgs& a, long long j, long long& off,
                                         uint32_t& bytes) {
  const long long item = blockIdx.x + (j / a.chunks) * (long long)gridDim.x;
  const int part = (int)(j % a.chunks);
  const long long tile = item / a.split;
  const int k = (int)(item - tile * a.split);
  const long long lo = k * a.units / a.split * 16;
  const long long hi = (k + 1) * a.units / a.split * 16;
  off = tile * a.tile_bytes + lo + (long long)part * a.slot;
  const long long left = hi - lo - (long long)part * a.slot;
  bytes = (uint32_t)(left < a.slot ? left : a.slot);
}

__device__ __forceinline__ uint4 through_f32(uint4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __float22bfloat162_rn(__bfloat1622float2(h[i]));
  return v;
}

template <int STAGES, bool CONVERT>
__global__ void __launch_bounds__(CONVERT ? 128 : 32)
copy_bulk_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ y,
                 CopyArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * a.slot);
  const long long mine = (a.items - blockIdx.x + gridDim.x - 1) / gridDim.x;  // my shares
  const long long n = mine * a.chunks;                                       // my chunks
  const bool issuer = threadIdx.x == 0;

  if (issuer) {
    for (int s = 0; s < STAGES; ++s) cpd::mbar_init(&full[s], 1);
    cpd::fence_barrier_init();
  }
  if constexpr (CONVERT) __syncthreads();

  // chunk j goes into slot j % STAGES; its load completes phase j / STAGES
  // of that slot's barrier
  auto load = [&](long long j) {
    long long off;
    uint32_t bytes;
    chunk_at(a, j, off, bytes);
    const int s = (int)(j % STAGES);
    cpd::mbar_expect_tx(&full[s], bytes);
    cpd::bulk_load(smem + s * a.slot, x + off, bytes, &full[s]);
  };
  if (issuer)
    for (long long j = 0; j < STAGES && j < n; ++j) load(j);
  if (!CONVERT && !issuer) return;

  for (long long j = 0; j < n; ++j) {
    const int s = (int)(j % STAGES);
    cpd::mbar_wait(&full[s], (uint32_t)((j / STAGES) & 1));
    long long off;
    uint32_t bytes;
    chunk_at(a, j, off, bytes);
    if constexpr (CONVERT) {
      uint4* v = reinterpret_cast<uint4*>(smem + s * a.slot);
      for (uint32_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) v[i] = through_f32(v[i]);
      cpd::fence_async_shared();  // the writes, to the bulk store's (async) proxy
      __syncthreads();
    }
    if (issuer) {
      cpd::bulk_store(y + off, smem + s * a.slot, bytes);
      cpd::tma_store_commit();
      if constexpr (STAGES == 1) {
        if (j + 1 < n) {
          cpd::tma_store_wait<0, true>();  // this store has read the only slot
          load(j + 1);
        }
      } else if (j >= 1 && j - 1 + STAGES < n) {
        cpd::tma_store_wait<1, true>();  // the store of chunk j - 1 has read its slot
        load(j - 1 + STAGES);
      }
    }
  }
  if (issuer) cpd::tma_store_wait<0, false>();  // every store has landed
}

template <int STAGES, bool CONVERT>
int launch(const void* x, void* y, const CopyArgs& a, int grid, cudaStream_t s) {
  auto kernel = copy_bulk_kernel<STAGES, CONVERT>;
  const int smem = STAGES * a.slot + STAGES * 8;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, CONVERT ? 128 : 32, smem, s>>>(static_cast<const unsigned char*>(x),
                                                static_cast<unsigned char*>(y), a);
  return (int)cudaGetLastError();
}

template <bool CONVERT>
int by_stages(const void* x, void* y, const CopyArgs& a, int grid, int stages, cudaStream_t s) {
  switch (stages) {
    case 1:
      return launch<1, CONVERT>(x, y, a, grid, s);
    case 3:
      return launch<3, CONVERT>(x, y, a, grid, s);
    case 4:
      return launch<4, CONVERT>(x, y, a, grid, s);
    case 8:
      return launch<8, CONVERT>(x, y, a, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: the tensor's bytes, contiguous, 16-byte aligned: `tiles` tiles of
// tile_bytes (a multiple of 16) each. The plan (ops/probes/stream.py:
// copy_plan): `split` shares a tile, chunks of at most `slot` bytes (a
// multiple of 16, at most 32 KB), `chunks` of them a share, enough to hold
// the largest share while the smallest still fills its last one; `grid`
// blocks; stages 1, 3, 4 or 8; convert 0 or 1. Sets *launched to the
// kernels launched (1).
extern "C" int cpd_probe_copy_sm90_bf16(const void* x, void* y, long long tiles,
                                        long long tile_bytes, int split, int slot, int chunks,
                                        int grid, int stages, int convert, int* launched,
                                        void* stream) {
  *launched = 0;
  if (tiles <= 0 || tile_bytes <= 0 || tile_bytes % 16 || split < 1 ||
      split > tile_bytes / 16 || slot < 16 || slot % 16 || slot > 32768 || chunks < 1 ||
      grid < 1 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return (int)cudaErrorInvalidValue;
  const long long units = tile_bytes / 16;
  const long long big = (units + split - 1) / split * 16, small = units / split * 16;
  if ((long long)chunks * slot < big || (long long)(chunks - 1) * slot >= small ||
      grid > tiles * split)
    return (int)cudaErrorInvalidValue;
  const CopyArgs a{tile_bytes, units, tiles * split, split, slot, chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = convert ? by_stages<true>(x, y, a, grid, stages, s)
                          : by_stages<false>(x, y, a, grid, stages, s);
  if (err == 0) *launched = 1;
  return err;
}
