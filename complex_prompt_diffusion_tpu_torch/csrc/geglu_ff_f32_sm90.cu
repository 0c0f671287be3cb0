// K2 on Hopper in f32: the GEGLU feed-forward of an f32 UNet's transformer
// blocks,
//   [v | g] = x W1 + b1,  out = (v * gelu_erf(g)) W2 + b2   (f32 in and out),
// as two persistent 3xTF32 GEMMs on wgmma (tf32x3.cuh).
//
// Replaces the TPU kernel complex_prompt_diffusion_tpu/ops/mlp.py::_ff_kernel
// in f32 (reached through _ff_pallas / geglu_ff). Rounding as the TPU kernel:
// f32 products and sums, the biases added in f32, the hidden kept in f32
// (the kernel's cast to x's dtype is no rounding in f32), the output written
// once; the erf is the TPU kernel's own (Abramowitz-Stegun 7.1.26, |error| <
// 1.5e-7), as in the bf16 body (geglu_ff_sm90.cu).
//
// What bounds it on the H100: 24 M C^2 flops (C = 320..1280, H4 = 4C) over
// 4 (2 M C + 12 C^2) bytes. Exact f32 rules out one TF32 product (about
// 1e-3 relative); on the FMA units (67 TFLOP/s) the b1 step's M8192 C320 call
// is 0.30 ms. Three TF32 products a product (each operand split into hi and
// lo, tf32x3.cuh) run at 495 / 3 TFLOP/s: 0.12 ms there.
//
// Layouts, all read where they lie: x [M, C], W1 [C, 2*H4] (value columns,
// then gate columns), b1 [2*H4], W2 [H4, C], b2 [C], row-major f32; the
// hidden [M, H4] and out [M, C] fresh and contiguous. TF32 wgmma takes
// K-major operands only: x and the hidden are K-major as they lie, the
// weights MN-major. The weights are not copied (a split, transposed copy
// made each call would move twice their bytes: ~0.03 ms at C = 1280): the
// producer lands each weight tile as it lies ([32 k][columns], no swizzle)
// and the consumers transpose it while they split it into hi and lo
// (split_mnmajor), as K5's f32 body does with a d-major K.
// Design (the bf16 body's structure):
//   * One persistent kernel per GEMM: a block on each SM walks the work
//     units (128-row tile, column tile, K split) with the column tile
//     fastest, so the blocks in flight share A's rows.
//   * A producer thread lands, per k-step of 32 reduction elements, A's
//     {32, 128} box (x or the hidden, 128-byte swizzle) and B's weight
//     box(es) into a 4-stage ring; it runs on into the next unit's k-steps
//     while the consumers finish a unit.
//   * Two consumer warpgroups of 64 rows each (tf32x3::consume_unit): B
//     split and transposed into one of three split buffers, A's fragments
//     split in registers, three wgmma m64n128k8 .tf32 products a step of 8,
//     a fresh accumulator per run of tx::kFold k-steps folded into the f32
//     sum.
//   * GEMM1 (GEGLU = true): a unit is 128 rows by 64 value columns AND the 64
//     gate columns H4 further on, one 128-wide B tile (value rows 0-63, gate
//     rows 64-127), so one product covers both; the epilogue adds b1, gates
//     and writes the [M, H4] f32 hidden. GEMM2: out = hidden W2 + b2, 128
//     columns a unit.
//   * Split-K from the host's plan (ops/mlp.py: geglu_plan(..., float32)):
//     each split writes its f32 partial tile (GEGLU: value and gate) to a
//     workspace, and geglu_f32_reduce_kernel sums the splits in split order,
//     adds the bias (and gates): no atomics, the same bits on every run.

#include "tf32x3.cuh"

namespace {

namespace tx = cpd::tf32x3;

constexpr int BM = 128;      // rows a unit (64 for each consumer warpgroup)
constexpr int BNT = 128;     // B tile rows (GEGLU: 64 value + 64 gate columns)
constexpr int BK = tx::KB;   // reduction elements a k-step (one 128-byte row)
constexpr int THREADS = 384;  // warpgroup 0: producer; 1, 2: consumers
constexpr int A_BYTES = BM * BK * 4;
constexpr int B_BYTES = BNT * BK * 4;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int STAGES = 4;
constexpr int SPLIT_BYTES = 3 * 2 * BNT * 128;  // three split buffers of B, hi and lo
constexpr int SMEM = 1024 + STAGES * STAGE + SPLIT_BYTES + 2 * STAGES * 8;
static_assert(SMEM <= 232448, "shared memory of one block");

struct Args {
  int M, N;        // rows, output columns (GEGLU: value columns = H4)
  int gate_off;    // GEGLU: the gate block's first column in W1 (= N)
  int m_tiles, n_tiles, ksteps, splits, steps_per_split;
};

// output columns of a unit: GEGLU 64 value columns (and their gates), else 128
__host__ __device__ constexpr int unit_cols(bool geglu) { return geglu ? 64 : 128; }

__device__ __forceinline__ void decode(const Args& a, int u, int& mt, int& nt, int& split,
                                       int& kb, int& ke) {
  nt = u % a.n_tiles;
  const int rest = u / a.n_tiles;
  mt = rest % a.m_tiles;
  split = rest / a.m_tiles;
  kb = split * a.steps_per_split;
  ke = min(a.ksteps, kb + a.steps_per_split);
}

// erf by Abramowitz-Stegun 7.1.26 (the TPU kernel's own), with the
// reciprocal and the exponential on the MUFU, as in the bf16 body
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

template <bool GEGLU>
__global__ void __launch_bounds__(THREADS, 1)
geglu_gemm_f32_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tb,
                           const float* __restrict__ bias, float* __restrict__ out,
                           float* __restrict__ ws, Args a) {
  constexpr int UC = unit_cols(GEGLU);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sbuf = ring + STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sbuf + SPLIT_BYTES);
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
          unsigned char* st = ring + s * STAGE;
          cpd::mbar_expect_tx(&full[s], STAGE);
          cpd::tma_load_2d(st, &ta, &full[s], i * BK, mt * BM);
          if constexpr (GEGLU) {
            cpd::tma_load_2d(st + A_BYTES, &tb, &full[s], nt * UC, i * BK);
            cpd::tma_load_2d(st + A_BYTES + B_BYTES / 2, &tb, &full[s], a.gate_off + nt * UC,
                             i * BK);
          } else {
            cpd::tma_load_2d(st + A_BYTES, &tb, &full[s], nt * UC, i * BK);
          }
        }
      }
    }
    return;
  }

  cpd::reg_alloc<240>();
  const int ct = threadIdx.x - 128;  // consumer thread 0 .. 255
  const int cw = ct >> 7;            // this warpgroup's rows: 64 cw .. 64 cw + 63 of a unit
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  auto split_b = [](const unsigned char* raw, unsigned char* hi, unsigned char* lo, int t) {
    tx::split_mnmajor<BNT, GEGLU ? 64 : 128, 256>(reinterpret_cast<const float*>(raw), hi, lo,
                                                  t);
  };

  float acc[BNT / 2], t[BNT / 2];
  tx::AFrag f0, f1;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int mt, nt, kb, ke, split;
    decode(a, u, mt, nt, split, kb, ke);
    tx::consume_unit<BNT, STAGES, STAGE, A_BYTES>(ring, sbuf, full, empty, ke - kb, it, acc, t,
                                                  f0, f1, cw, ct, split_b);
    // epilogue: thread rows 16 warp + g (+ 8) of this warpgroup's 64; columns
    // 8 j + 2 t4 (+ 1) of the tile, j < 8 the value (GEGLU) and j + 8 its gate
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * BM + cw * 64 + warp * 16 + g + half * 8;
      if (row >= a.M) continue;
#pragma unroll
      for (int j = 0; j < UC / 8; ++j) {
        const int col = nt * UC + j * 8 + 2 * t4;
        if (col >= a.N) continue;  // a.N % 8 == 0: col + 1 < a.N as well
        float y0 = acc[4 * j + 2 * half], y1 = acc[4 * j + 2 * half + 1];
        if (a.splits > 1) {
          float* w = ws + ((long long)split * a.M + row) * (GEGLU ? 2 * a.N : a.N) + col;
          *reinterpret_cast<float2*>(w) = make_float2(y0, y1);
          if constexpr (GEGLU)
            *reinterpret_cast<float2*>(w + a.N) =
                make_float2(acc[4 * (j + 8) + 2 * half], acc[4 * (j + 8) + 2 * half + 1]);
          continue;
        }
        y0 += bias[col];
        y1 += bias[col + 1];
        if constexpr (GEGLU) {
          y0 *= gelu_erf(acc[4 * (j + 8) + 2 * half] + bias[a.gate_off + col]);
          y1 *= gelu_erf(acc[4 * (j + 8) + 2 * half + 1] + bias[a.gate_off + col + 1]);
        }
        *reinterpret_cast<float2*>(out + (long long)row * a.N + col) = make_float2(y0, y1);
      }
    }
  }
}

// out[r, c] = sum over splits s = 0, 1, .. of ws[s][r][c], in that order, +
// bias[c]; GEGLU: the value sum + b1 times gelu(the gate sum + b1[N + c]),
// the gate partials N columns further on in each workspace row
template <bool GEGLU>
__global__ void geglu_f32_reduce_kernel(const float* __restrict__ ws,
                                        const float* __restrict__ bias, float* __restrict__ out,
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
    float4 y = make_float4(v.x + bias[col], v.y + bias[col + 1], v.z + bias[col + 2],
                           v.w + bias[col + 3]);
    if constexpr (GEGLU) {
      y.x *= gelu_erf(z.x + bias[N + col]);
      y.y *= gelu_erf(z.y + bias[N + col + 1]);
      y.z *= gelu_erf(z.z + bias[N + col + 2]);
      y.w *= gelu_erf(z.w + bias[N + col + 3]);
    }
    *reinterpret_cast<float4*>(out + e) = y;
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
template <bool GEGLU>
int launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const float* bias, float* out,
                float* ws, const Args& a, cudaStream_t stream, int* launched) {
  auto kernel = geglu_gemm_f32_sm90_kernel<GEGLU>;
  static bool attr_set = false;  // one card a process
  if (!attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInitializationError;
  const long long units = (long long)a.m_tiles * a.n_tiles * a.splits;
  const int grid = (int)(units < sms ? units : sms);
  kernel<<<grid, THREADS, SMEM, stream>>>(ta, tb, bias, out, ws, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  if (a.splits == 1) return 0;
  const long long n4 = (long long)a.M * a.N / 4;
  const int blocks = (int)min((n4 + 255) / 256, (long long)sms * 8);
  geglu_f32_reduce_kernel<GEGLU><<<blocks, 256, 0, stream>>>(ws, bias, out, a.M, a.N, a.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

// one GEMM's plan: M x N outputs over K in units of 128 rows x `cols`
// columns, K cut into `splits` runs of steps_per_split k-steps of 32 (every
// run non-empty)
bool make_args(Args* a, int M, int N, int K, int cols, int splits, int steps_per_split) {
  const int ksteps = (K + BK - 1) / BK;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || splits < 1 || steps_per_split < 1 ||
      (long long)splits * steps_per_split < ksteps ||
      (long long)(splits - 1) * steps_per_split >= ksteps)
    return false;
  *a = Args{M, N, N, (M + BM - 1) / BM, (N + cols - 1) / cols, ksteps, splits, steps_per_split};
  return (long long)a->m_tiles * a->n_tiles * a->splits < (1LL << 31);
}

int encode_f32(CUtensorMap* map, const void* base, uint64_t inner, uint64_t rows,
               uint32_t box_inner, uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  return cpd::encode_map<2>(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, {inner, rows},
                            {inner * 4}, {box_inner, box_rows}, swizzle);
}

}  // namespace

// x [M, C], w1 [C, 2*H4], b1 [2*H4], w2 [H4, C], b2 [C]; hidden [M, H4] and
// out [M, C]: f32, contiguous, 16-byte aligned; C % 8 == 0, H4 % 8 == 0.
// ws1: splits1 x M x 2*H4 f32 when splits1 > 1, ws2: splits2 x M x C f32
// when splits2 > 1 (else unused). The plan: GEMM1 units of 128 rows x 64
// value (and 64 gate) columns, K = C in splits1 runs of steps1 k-steps of
// 32; GEMM2 units of 128 x 128 columns, K = H4 in splits2 runs of steps2;
// both fold their accumulators every tx::kFold k-steps. Launches GEMM1 (+
// its reduce), then GEMM2 (+ its reduce), and sets *launched to the number
// of kernels it launched.
extern "C" int cpd_geglu_ff_f32_sm90(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* hidden, void* out,
                                     void* ws1, void* ws2, int M, int C, int H4, int splits1,
                                     int steps1, int splits2, int steps2, int* launched,
                                     void* stream) {
  *launched = 0;
  Args a1, a2;
  if (!make_args(&a1, M, H4, C, unit_cols(true), splits1, steps1) ||
      !make_args(&a2, M, C, H4, unit_cols(false), splits2, steps2))
    return (int)cudaErrorInvalidValue;
  a1.gate_off = H4;
  // A: x and the hidden in {32, 128} boxes, 128-byte swizzle (K-major as
  // they lie); B: the weights as they lie, W1 in {64, 32} boxes (value,
  // gate), W2 in {128, 32}, no swizzle (the consumers transpose them)
  CUtensorMap tx1, tw1, th, tw2;
  int err = encode_f32(&tx1, x, C, M, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = encode_f32(&tw1, w1, 2 * (uint64_t)H4, C, 64, BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!err) err = encode_f32(&th, hidden, H4, M, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = encode_f32(&tw2, w2, C, H4, 128, BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_gemm<true>(tx1, tw1, static_cast<const float*>(b1), static_cast<float*>(hidden),
                          static_cast<float*>(ws1), a1, st, launched);
  if (err) return err;
  return launch_gemm<false>(th, tw2, static_cast<const float*>(b2), static_cast<float*>(out),
                            static_cast<float*>(ws2), a2, st, launched);
}
