// K2 on Hopper: the GEGLU feed-forward of the UNet transformer blocks,
//   [v | g] = x W1 + b1,  out = (v * gelu_erf(g)) W2 + b2   (bf16 in and out),
// as two TMA + wgmma GEMMs.
//
// Replaces the TPU kernel complex_prompt_diffusion_tpu/ops/mlp.py::_ff_kernel
// (reached through _ff_pallas / geglu_ff). Rounding as the TPU kernel: f32
// accumulation, the bias added in f32, the hidden rounded to the input dtype
// before the second product, the output rounded once at the end; the erf is
// the TPU kernel's own (Abramowitz-Stegun 7.1.26, |error| < 1.5e-7).
//
// Layouts, all read where they lie: x [M, C], W1 [C, 2*H4] (value columns,
// then gate columns), b1 [2*H4], W2 [H4, C], b2 [C], row-major; the hidden
// [M, H4] and out [M, C] fresh and contiguous. Both weights are MN-major B
// operands of wgmma (their columns are contiguous), so no transposed copy is
// made.
//
// What bounds it on the H100: 24 M C^2 flops (C = 320..1280, H4 = 4C) over
// 2 (2 M C + 12 C^2) bytes: the tensor cores. A single fused launch would
// have to keep a [128, C] f32 output tile on chip while it streams the
// hidden through (640 KB at C = 1280), so there are two launches and the
// [M, H4] bf16 hidden goes through memory once each way. That costs little:
// at M32768 C320, GEMM1 is 0.054 ms of tensor work against 0.031 ms of its
// own bytes, GEMM2 0.027 ms of work against 0.031 ms (the 84 MB hidden is
// read back), a two-launch floor about 5% above the fused bound; less at the
// wider rows. The first body (mma.sync m16n8k16, 128 x 64 tiles, a 3-stage
// cp.async ring) re-read each 128-row slab of x once per 64 value-and-gate
// columns (20 times at C = 320) and ran at 11-18% of the bound, slower than
// two cuBLAS GEMMs at three of four shapes. Design:
//   * One persistent kernel per GEMM: a block on each SM walks the work
//     units (row tile, column tile, K split) with the column tile fastest,
//     so the blocks in flight share A's rows and the hidden (84 MB at
//     M32768, more than the L2) is read from memory once.
//   * A ring of 3-6 stages with full and empty mbarriers: one producer
//     thread issues TMA loads with 128-byte swizzle (A: a {64, rows} box of
//     x or the hidden; B: {64, 64} boxes of the weight, 8 KB each,
//     zero-filled past the matrix), and keeps loading the next unit's
//     k-steps while the consumers finish the last. Consumer warpgroups run
//     wgmma m64nNk16, one group in flight, B read MN-major through the
//     descriptor (LBO = one 64-column box).
//   * GEMM1 (GEGLU=true): a unit is 128 rows by BN value columns AND the
//     BN gate columns H4 further on, two accumulators over the same A
//     fragments; the epilogue adds b1, gates (the erf's reciprocal and
//     exponential on the MUFU), rounds to bf16 in registers and writes
//     only the [M, H4] hidden.
//   * GEMM2: out = hidden W2 + b2, BN of 64..256 columns.
//   * Both cooperative: the two consumer warpgroups share a unit, 64 rows
//     each.
//   * The bf16 output tile goes out through shared memory: each consumer
//     warpgroup writes its 64 rows into {64, 64} boxes in the 128-byte
//     swizzle (conflict-free 4-byte stores), and one of its threads issues
//     TMA stores (clipped at the tensor's edges) and moves on to the next
//     unit while they drain; it waits for the boxes to be read only before
//     the next epilogue writes them. Written from registers, each warp
//     store touched 8 rows of 16 bytes, and the epilogue held the tensor
//     cores idle for longer (on the H100: GEMM1 0.207 -> 0.144 ms at M32768
//     C320, the whole call 0.281 -> 0.208).
//   * Tile widths and split-K come from the host's plan (ops/mlp.py:
//     geglu_plan): where the tiles cannot fill 132 SMs (M <= 512), K is
//     split; each split writes its f32 partial tile (GEGLU: value and gate)
//     to a workspace and geglu_splitk_reduce_kernel sums the splits in
//     split order, adds the bias (and gates) and rounds once: no atomics,
//     the same bits on every run.
// Measured on the H100 (tools/geglu_plans.py, tree_ab; PERF.md section 6):
// GEMM1's epilogue sets its pace at C = 320 (5 k-steps a unit); an IEEE
// reciprocal in the erf (__frcp_rn) cost 17% of the whole call at M32768
// against the MUFU's (__fdividef). Tried and dropped, each slower or no
// faster at every row: GEMM1 ping-pong (each consumer warpgroup its own
// 64-row units, mainloops in turns on two mbarriers; without that order the
// second warpgroup waited on full barriers a ring lap ahead and hung), the
// weight slice resident in shared memory for a block's units, and two
// accumulator sets with one unit's epilogue issued under the next unit's
// products (ptxas serialised the wgmmas: C7518, a wait in a divergent path).
// Units with the row tile fastest read the hidden from memory once per
// column tile (GEMM2 at M32768 then took 2x its time).

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;       // reduction elements a k-step (one 128-byte row)
constexpr int BOX_N = 64;    // columns of one B box
constexpr int THREADS = 384;  // warpgroup 0: producer; 1, 2: consumers
constexpr int B_BOX_BYTES = BK * BOX_N * 2;

// a unit is 128 rows, 64 for each consumer warpgroup
template <int BN, bool GEGLU>
struct Cfg {
  static constexpr int BM = 128;  // rows a unit
  static constexpr int NBOX = BN / BOX_N;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = (GEGLU ? 2 : 1) * NBOX * B_BOX_BYTES;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the bf16 output tile, staged for its TMA store: per consumer warpgroup
  // NBOX boxes of 64 rows x 64 columns (8 KB each)
  static constexpr int OUT_BYTES = BM * BN * 2;
  static constexpr int ROOM = 232448 - 2048 - OUT_BYTES;
  // as many stages as the rest of 227 KB holds, up to 6
  static constexpr int STAGES = ROOM / STAGE < 6 ? ROOM / STAGE : 6;
  static constexpr int SMEM = 1024 + STAGES * STAGE + OUT_BYTES + 2 * STAGES * 8;
  static_assert(BN % BOX_N == 0 && STAGES >= 3 && SMEM <= 232448, "tile of one block");
};

struct Args {
  int M, N, K;     // rows, output columns (GEGLU: value columns), reduction
  int gate_off;    // GEGLU: the gate block's first column in B (= N)
  int m_tiles, n_tiles, ksteps, splits, steps_per_split;
};

// unit u -> (row tile, column tile, split, its k-steps kb .. ke - 1). Column
// tiles vary fastest, so the blocks in flight share rows of A: the [M, H4]
// hidden, which at M32768 is larger than the L2, is read from memory once
// and not once per column tile.
__device__ __forceinline__ void decode(const Args& a, int u, int& mt, int& nt, int& split,
                                       int& kb, int& ke) {
  nt = u % a.n_tiles;
  const int rest = u / a.n_tiles;
  mt = rest % a.m_tiles;
  split = rest / a.m_tiles;
  kb = split * a.steps_per_split;
  ke = min(a.ksteps, kb + a.steps_per_split);
}

// erf by Abramowitz-Stegun 7.1.26 (|error| < 1.5e-7, below bf16's
// resolution; the TPU kernel's own erf), with the reciprocal and the
// exponential on the MUFU
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = __fdividef(1.f, fmaf(0.3275911f, ax, 1.f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  return copysignf(1.f - poly * __expf(-ax * ax), x);
}

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.f + erf_as(z * 0.70710678118654752f));
}

template <int BN, bool GEGLU>
__global__ void __launch_bounds__(THREADS, 1)
geglu_gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap tout, const bf16* __restrict__ bias,
                       float* __restrict__ ws, Args a) {
  typedef Cfg<BN, GEGLU> C;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: [A BM x 64][value boxes][gate boxes], each piece 1024-aligned;
  // then the output tile, then the barriers
  unsigned char* out_tile = ring + STAGES * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tile + C::OUT_BYTES);
  uint64_t* empty = full + STAGES;
  const int units = a.m_tiles * a.n_tiles * a.splits;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      cpd::mbar_init(&full[s], 1);
      cpd::mbar_init(&empty[s], 256);
    }
    cpd::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    cpd::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      cpd::tma_prefetch_desc(&ta);
      cpd::tma_prefetch_desc(&tb);
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int mt, nt, kb, ke, split;
        decode(a, u, mt, nt, split, kb, ke);
        for (int i = kb; i < ke; ++i, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) cpd::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* st = ring + s * C::STAGE;
          cpd::mbar_expect_tx(&full[s], C::STAGE);
          cpd::tma_load_2d(st, &ta, &full[s], i * BK, mt * C::BM);
#pragma unroll
          for (int nb = 0; nb < C::NBOX; ++nb) {
            cpd::tma_load_2d(st + C::A_BYTES + nb * B_BOX_BYTES, &tb, &full[s],
                             nt * BN + nb * BOX_N, i * BK);
            if constexpr (GEGLU)
              cpd::tma_load_2d(st + C::A_BYTES + (C::NBOX + nb) * B_BOX_BYTES, &tb, &full[s],
                               a.gate_off + nt * BN + nb * BOX_N, i * BK);
          }
        }
      }
    }
    return;
  }

  cpd::reg_alloc<240>();
  const int cw = wg - 1;  // this warpgroup's rows: 64 cw .. 64 cw + 63 of a unit
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  typedef float Acc[BN / 2];
  typedef float GAcc[GEGLU ? BN / 2 : 1];

  // this warpgroup's 64 x BN part of the output tile, and the thread that
  // issues its TMA stores
  unsigned char* my_out = out_tile + cw * 64 * BN * 2;
  const bool leader = (threadIdx.x & 127) == 0;

  // epilogue of an unsplit unit: thread rows warp * 16 + g (+ 8) of this
  // warpgroup's 64, columns 8 j + 2 t4 (+ 1) of the tile; the bias (and
  // the gate) in f32, rounded to bf16 into the staged tile in the 128-byte
  // swizzle of the store's boxes (16-byte chunk j % 8 of row r at chunk
  // (j % 8) ^ (r % 8): a warp's 32 stores hit 32 banks), then the leader
  // stores the boxes by TMA (clipped at the tensor's edges) and the
  // warpgroup goes on to its next unit while they drain
  auto epilogue_out = [&](int mt, int nt, Acc& av, GAcc& ag) {
    if (leader) cpd::tma_store_wait<0, true>();  // the last unit's boxes are read
    cpd::named_barrier(1 + cw, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = nt * BN + j * 8 + 2 * t4;
      if (col >= a.N) continue;  // past the tensor: the store clips it
      const float bv0 = cpd::to_f32(bias[col]), bv1 = cpd::to_f32(bias[col + 1]);
      float bg0 = 0.f, bg1 = 0.f;
      if constexpr (GEGLU) {
        bg0 = cpd::to_f32(bias[a.gate_off + col]);
        bg1 = cpd::to_f32(bias[a.gate_off + col + 1]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + half * 8 + g;  // r % 8 == g
        float y0 = av[4 * j + 2 * half] + bv0, y1 = av[4 * j + 2 * half + 1] + bv1;
        if constexpr (GEGLU) {
          y0 *= gelu_erf(ag[4 * j + 2 * half] + bg0);
          y1 *= gelu_erf(ag[4 * j + 2 * half + 1] + bg1);
        }
        *reinterpret_cast<uint32_t*>(my_out + (j / 8) * (64 * 128) + r * 128 +
                                     (((j & 7) ^ g) * 16) + 4 * t4) = cpd::pack_bf16(y0, y1);
      }
    }
    cpd::fence_async_shared();
    cpd::named_barrier(1 + cw, 128);
    if (leader) {
      const int row = mt * C::BM + cw * 64;
      if (row < a.M) {
#pragma unroll
        for (int b = 0; b < C::NBOX; ++b)
          if (nt * BN + b * BOX_N < a.N)
            cpd::tma_store_2d(&tout, my_out + b * (64 * 128), nt * BN + b * BOX_N, row);
      }
      cpd::tma_store_commit();
    }
  };

  // epilogue of a split unit: its f32 partial tile (GEGLU: value and gate)
  // into the workspace, for the reduce
  auto epilogue_ws = [&](int mt, int nt, int split, Acc& av, GAcc& ag) {
    const int r0 = mt * C::BM + cw * 64 + warp * 16 + g;
    const int W = GEGLU ? 2 * a.N : a.N;  // workspace row length
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = nt * BN + j * 8 + 2 * t4;
      if (col >= a.N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + half * 8;
        if (row >= a.M) continue;
        float* w = ws + ((long long)split * a.M + row) * W + col;
        *reinterpret_cast<float2*>(w) = make_float2(av[4 * j + 2 * half], av[4 * j + 2 * half + 1]);
        if constexpr (GEGLU)
          *reinterpret_cast<float2*>(w + a.N) =
              make_float2(ag[4 * j + 2 * half], ag[4 * j + 2 * half + 1]);
      }
    }
  };

  // the products of k-step i (ring slot `it`) into av (and ag)
  auto issue = [&](int it, int i, int kb, Acc& av, GAcc& ag) {
    const int s = it % STAGES;
    cpd::mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* sa = ring + s * C::STAGE + cw * 64 * 128;
    const unsigned char* sb = ring + s * C::STAGE + C::A_BYTES;
    cpd::fence_regs(av);
    if constexpr (GEGLU) cpd::fence_regs(ag);
    cpd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = cpd::desc_sw128(sa + kk * 32, 16, 1024);
      const int accumulate = i > kb || kk > 0;
      cpd::Wgmma<BN>::ss_bmn(av, da, cpd::desc_sw128(sb + kk * 16 * 128, B_BOX_BYTES, 1024),
                             accumulate);
      if constexpr (GEGLU)
        cpd::Wgmma<BN>::ss_bmn(
            ag, da, cpd::desc_sw128(sb + C::NBOX * B_BOX_BYTES + kk * 16 * 128, B_BOX_BYTES, 1024),
            accumulate);
    }
    cpd::wgmma_commit();
  };

  Acc acc;
  GAcc gacc;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (GEGLU ? BN / 2 : 1); ++i) gacc[i] = 0.f;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int mt, nt, kb, ke, split;
    decode(a, u, mt, nt, split, kb, ke);
    for (int i = kb; i < ke; ++i, ++it) {
      issue(it, i, kb, acc, gacc);
      cpd::wgmma_wait<1>();  // the group of the previous k-step has retired
      cpd::fence_regs(acc);
      if constexpr (GEGLU) cpd::fence_regs(gacc);
      if (i > kb) cpd::mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    cpd::wgmma_wait<0>();
    cpd::fence_regs(acc);
    if constexpr (GEGLU) cpd::fence_regs(gacc);
    cpd::mbar_arrive(&empty[(it - 1) % STAGES]);
    if (a.splits == 1)
      epilogue_out(mt, nt, acc, gacc);
    else
      epilogue_ws(mt, nt, split, acc, gacc);
  }
  if (leader) cpd::tma_store_wait<0, false>();  // the last stores have landed
}

// out[r, c] = bf16(sum over splits s = 0, 1, .. of ws[s][r][c], in that order,
// + bias[c]); GEGLU: the value sum + b1 times gelu(the gate sum + b1[N + c]),
// the gate partials N columns further on in each workspace row
template <bool GEGLU>
__global__ void geglu_splitk_reduce_kernel(const float* __restrict__ ws,
                                           const bf16* __restrict__ bias, bf16* __restrict__ out,
                                           int M, int N, int splits) {
  const int W = GEGLU ? 2 * N : N;
  const long long n4 = (long long)M * N / 4;
  const long long split_stride = (long long)M * W;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 4;
    const long long row = e / N;
    const int col = (int)(e - row * N);
    const float* p = ws + row * W + col;
    float4 v = *reinterpret_cast<const float4*>(p);
    float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (GEGLU) z = *reinterpret_cast<const float4*>(p + N);
    for (int s = 1; s < splits; ++s) {
      const float4 t = *reinterpret_cast<const float4*>(p + s * split_stride);
      v.x += t.x;
      v.y += t.y;
      v.z += t.z;
      v.w += t.w;
      if constexpr (GEGLU) {
        const float4 tg = *reinterpret_cast<const float4*>(p + s * split_stride + N);
        z.x += tg.x;
        z.y += tg.y;
        z.z += tg.z;
        z.w += tg.w;
      }
    }
    float y[4] = {v.x + cpd::to_f32(bias[col]), v.y + cpd::to_f32(bias[col + 1]),
                  v.z + cpd::to_f32(bias[col + 2]), v.w + cpd::to_f32(bias[col + 3])};
    if constexpr (GEGLU) {
      const float zz[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) y[k] *= gelu_erf(zz[k] + cpd::to_f32(bias[N + col + k]));
    }
    uint2 o;
    o.x = cpd::pack_bf16(y[0], y[1]);
    o.y = cpd::pack_bf16(y[2], y[3]);
    *reinterpret_cast<uint2*>(out + e) = o;
  }
}

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return v;
  }();
  return n;
}

// launches the GEMM (and its reduce when K is split), adding each launch to
// *launched
template <int BN, bool GEGLU>
int launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tout,
                const void* bias, void* out, void* ws, const Args& a, cudaStream_t stream,
                int* launched) {
  typedef Cfg<BN, GEGLU> C;
  auto kernel = geglu_gemm_sm90_kernel<BN, GEGLU>;
  static bool attr_set = false;  // one card a process
  if (!attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInitializationError;
  const long long units = (long long)a.m_tiles * a.n_tiles * a.splits;
  const int grid = (int)(units < sms ? units : sms);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(ta, tb, tout, static_cast<const bf16*>(bias),
                                             static_cast<float*>(ws), a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  if (a.splits == 1) return 0;
  const long long n4 = (long long)a.M * a.N / 4;
  const int blocks = (int)min((n4 + 255) / 256, (long long)sms * 8);
  geglu_splitk_reduce_kernel<GEGLU><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const bf16*>(bias), static_cast<bf16*>(out),
      a.M, a.N, a.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

// the plan of one GEMM: M x N outputs over K, tiles of 128 x bn, K cut into
// `splits` runs of steps_per_split k-steps of 64 (every run non-empty)
bool make_args(Args* a, int M, int N, int K, int bm, int bn, int splits, int steps_per_split) {
  const int ksteps = (K + BK - 1) / BK;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || bn <= 0 || splits < 1 ||
      steps_per_split < 1 || (long long)splits * steps_per_split < ksteps ||
      (long long)(splits - 1) * steps_per_split >= ksteps)
    return false;
  *a = Args{M, N, K, N, (M + bm - 1) / bm, (N + bn - 1) / bn, ksteps, splits, steps_per_split};
  return (long long)a->m_tiles * a->n_tiles * a->splits < (1LL << 31);
}

}  // namespace

// x [M, C], w1 [C, 2*H4], b1 [2*H4], w2 [H4, C], b2 [C]; hidden [M, H4] and
// out [M, C]: bf16, contiguous, 16-byte aligned; C % 8 == 0, H4 % 8 == 0.
// ws1: splits1 x M x 2*H4 f32 when splits1 > 1, ws2: splits2 x M x C f32
// when splits2 > 1 (else unused). The plan: GEMM1 tiles of 128 rows x bn1
// value columns (64 or 128), K = C cut into splits1 runs of steps1 k-steps;
// GEMM2 tiles of 128 x bn2 columns (64, 128, 192 or 256), K = H4 in splits2
// runs of steps2. Launches GEMM1 (+ its reduce), then GEMM2 (+ its reduce),
// and sets *launched to the number of kernels it launched.
extern "C" int cpd_geglu_ff_sm90_bf16(const void* x, const void* w1, const void* b1,
                                      const void* w2, const void* b2, void* hidden, void* out,
                                      void* ws1, void* ws2, int M, int C, int H4, int bn1,
                                      int splits1, int steps1, int bn2, int splits2, int steps2,
                                      int* launched, void* stream) {
  *launched = 0;
  Args a1, a2;
  if (!make_args(&a1, M, H4, C, 128, bn1, splits1, steps1) ||
      !make_args(&a2, M, C, H4, 128, bn2, splits2, steps2))
    return (int)cudaErrorInvalidValue;
  a1.gate_off = H4;
  // loads: x and the hidden in {64, 128} boxes, the weights in {64, 64};
  // stores: the hidden and out in {64, 64} boxes (a warpgroup's rows)
  CUtensorMap tx, tw1, th, tw2, th_st, tout_st;
  int err = cpd::encode_bf16_map<2>(&tx, x, {(uint64_t)C, (uint64_t)M}, {(uint64_t)C * 2},
                                    {(uint32_t)BK, 128u});
  if (!err)
    err = cpd::encode_bf16_map<2>(&tw1, w1, {(uint64_t)2 * H4, (uint64_t)C},
                                  {(uint64_t)4 * H4}, {(uint32_t)BOX_N, (uint32_t)BK});
  if (!err)
    err = cpd::encode_bf16_map<2>(&th, hidden, {(uint64_t)H4, (uint64_t)M}, {(uint64_t)H4 * 2},
                                  {(uint32_t)BK, 128u});
  if (!err)
    err = cpd::encode_bf16_map<2>(&tw2, w2, {(uint64_t)C, (uint64_t)H4}, {(uint64_t)C * 2},
                                  {(uint32_t)BOX_N, (uint32_t)BK});
  if (!err)
    err = cpd::encode_bf16_map<2>(&th_st, hidden, {(uint64_t)H4, (uint64_t)M},
                                  {(uint64_t)H4 * 2}, {(uint32_t)BOX_N, 64u});
  if (!err)
    err = cpd::encode_bf16_map<2>(&tout_st, out, {(uint64_t)C, (uint64_t)M}, {(uint64_t)C * 2},
                                  {(uint32_t)BOX_N, 64u});
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn1) {
    case 64: err = launch_gemm<64, true>(tx, tw1, th_st, b1, hidden, ws1, a1, st, launched); break;
    case 128: err = launch_gemm<128, true>(tx, tw1, th_st, b1, hidden, ws1, a1, st, launched); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  switch (bn2) {
    case 64: return launch_gemm<64, false>(th, tw2, tout_st, b2, out, ws2, a2, st, launched);
    case 128: return launch_gemm<128, false>(th, tw2, tout_st, b2, out, ws2, a2, st, launched);
    case 192: return launch_gemm<192, false>(th, tw2, tout_st, b2, out, ws2, a2, st, launched);
    case 256: return launch_gemm<256, false>(th, tw2, tout_st, b2, out, ws2, a2, st, launched);
    default: return (int)cudaErrorInvalidValue;
  }
}
