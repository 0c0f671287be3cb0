// K4 on Hopper in f32: the 3x3 stride-1 'same' convolution of an f32 UNet
// and of the exact VAE decode, y = conv3x3(x, w) + b, as a persistent
// implicit GEMM of three TF32 products a product on wgmma (tf32x3.cuh).
//
// Replaces the TPU kernel complex_prompt_diffusion_tpu/ops/conv.py::_kernel
// in f32 (nine shifted [M, C] x [C, Co] matmuls, f32 accumulation, the bias
// added in f32) for the convs ops/conv.py routes here: C % 4 == 0 and any
// Co (past the narrow bodies' Co <= 8 or C <= 16), among them all 22 3x3
// convs of a batch-1 f32 UNet call (UNet batch 2 on the 32^2 and 16^2 planes,
// C 320 .. 2560, Co 640 or 1280), the exact decode's convs on a 16^2 or 32^2
// plane, the convs of a UNet at CompVis LDM-VQ-4's widths (Co = 672 on the
// 16^2 plane) and the tiny config's 32 -> 32 and 96 -> 32. conv3x3.cu's FMA
// body (conv3x3_f32_kernel) keeps the f32 widths with C % 4 != 0 and is the
// body this one replaced.
//
// Layouts (as the bf16 body, conv3x3_sm90.cu): x NHWC [B, H, W, C]; the
// weight a row-major [Co, 9C] matrix with column (dy * 3 + dx) * C + c (the
// port's [Co, C, 3, 3] weight in channels_last memory, read in place); y
// NHWC [B, H, W, Co]. The bias is added in f32 with no rounding.
//
// What bounds it on the H100: 2 M Co 9C flops (M = B H W); at B1 32^2
// 512->512 4.83 GFLOP, 0.072 ms on the FMA units (67 TFLOP/s), where the
// FMA body ran 0.29 ms (slower than cuDNN's 0.22 and its own plain twin's
// 0.26, H100 80GB HBM3 at 700 W) with 64 x 64 tiles fed 16 reduction
// columns a stage. Three TF32 products a product run at 495 / 3 TFLOP/s:
// 0.029 ms there. Design:
//   * GEMM view M x Co x 9C, K in (tap, channel) order in k-steps of one
//     tap and 32 channels (one 128-byte row of f32): 9 ceil(C / 32) of them,
//     a tap's last chunk partly past C where C % 32 != 0. A unit is 128 pixels
//     of one image (a Wt x Ht rectangle: 32 x 4 at W = 32, 16 x 8 at W = 16,
//     8 x 16 else) by 128 output channels, for one K split.
//   * A: one 4-D TMA box {32 channels, Wt, Ht, 1} at (c0, w0 + dx - 1,
//     h0 + dy - 1, b), 128-byte swizzle: a pixel's 32 channels are one
//     128-byte row, and TMA's zero fill outside the tensor is the 'same'
//     padding, and, per dimension, zeros for the channels >= C of a tap's
//     last chunk. The consumers split A's fragments in registers.
//   * B: a 3-D box {32, 1, 128} of the weight viewed as [Co, 9, Cw] (Cw >= C
//     its channel stride: a channel slice of a wider weight is read in
//     place), K-major as it lies (rows past Co and channels >= C
//     zero-filled, whatever Cw > C holds there), split element
//     by element into hi and lo tiles (split_kmajor).
//   * The rest is tf32x3::consume_unit: a 4-stage ring fed by one producer
//     thread, two consumer warpgroups of 64 pixels, three wgmma m64n128k8
//     .tf32 products a step of 8 from a fresh accumulator per run of
//     tx::kFold k-steps, folded into an f32 sum. K reaches 9C = 23040 in the
//     UNet (2560 channels on the 16^2 plane): the fold keeps the tensor
//     cores' accumulation to kFold x 32 terms.
//   * Persistent blocks, one an SM, walk the units with the channel tile
//     fastest; split-K from the host's plan (ops/conv.py: conv3x3_plan(...,
//     float32)): each split writes its f32 partial tile to a workspace and
//     conv3x3_f32_reduce_kernel sums the splits in split order and adds the
//     bias: the same bits on every run.

#include "tf32x3.cuh"

namespace {

namespace tx = cpd::tf32x3;

constexpr int BM = 128;      // output pixels a unit
constexpr int BN = 128;      // output channels a unit
constexpr int BK = tx::KB;   // channels a k-step (one 128-byte row of f32)
constexpr int THREADS = 384;  // warpgroup 0: producer; 1, 2: consumers
constexpr int A_BYTES = BM * BK * 4;
constexpr int B_BYTES = BN * BK * 4;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int STAGES = 4;
constexpr int SPLIT_BYTES = 3 * 2 * BN * 128;
constexpr int SMEM = 1024 + STAGES * STAGE + SPLIT_BYTES + 2 * STAGES * 8;
static_assert(SMEM <= 232448, "shared memory of one block");

struct Plan {
  int B, H, W, C, Co;
  int wt, ht;  // the pixel rectangle of a unit (wt * ht == BM)
  int tiles_w, tiles_h, m_tiles, n_tiles;
  int ksteps;  // 9 * ceil(C / 32)
  int splits, steps_per_split;
};

__device__ __forceinline__ void decode(const Plan& p, int u, int& b, int& h0, int& w0, int& nt,
                                       int& split, int& kb, int& ke) {
  nt = u % p.n_tiles;
  int rest = u / p.n_tiles;
  const int mt = rest % p.m_tiles;
  split = rest / p.m_tiles;
  w0 = (mt % p.tiles_w) * p.wt;
  rest = mt / p.tiles_w;
  h0 = (rest % p.tiles_h) * p.ht;
  b = rest / p.tiles_h;
  kb = split * p.steps_per_split;
  ke = min(p.ksteps, kb + p.steps_per_split);
}

__global__ void __launch_bounds__(THREADS, 1)
conv3x3_f32_sm90_kernel(const __grid_constant__ CUtensorMap tmx,
                        const __grid_constant__ CUtensorMap tmw, const float* __restrict__ bias,
                        float* __restrict__ y, float* __restrict__ ws, Plan p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sbuf = ring + STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sbuf + SPLIT_BYTES);
  uint64_t* empty = full + STAGES;
  const int units = p.m_tiles * p.n_tiles * p.splits;
  const int chunks = (p.C + BK - 1) / BK;  // a tap's k-steps, the last partly past C
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
      cpd::tma_prefetch_desc(&tmx);
      cpd::tma_prefetch_desc(&tmw);
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int b, h0, w0, nt, split, kb, ke;
        decode(p, u, b, h0, w0, nt, split, kb, ke);
        for (int i = kb; i < ke; ++i, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) cpd::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          const int tap = i / chunks;
          const int c0 = (i - tap * chunks) * BK;
          const int dy = tap / 3, dx = tap - 3 * (tap / 3);
          unsigned char* st = ring + s * STAGE;
          cpd::mbar_expect_tx(&full[s], STAGE);
          cpd::tma_load_4d(st, &tmx, &full[s], c0, w0 + dx - 1, h0 + dy - 1, b);
          cpd::tma_load_3d(st + A_BYTES, &tmw, &full[s], c0, tap, nt * BN);
        }
      }
    }
    return;
  }

  cpd::reg_alloc<240>();
  const int ct = threadIdx.x - 128;  // consumer thread 0 .. 255
  const int cw = ct >> 7;            // this warpgroup's pixels: 64 cw .. 64 cw + 63 of a unit
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  auto split_b = [](const unsigned char* raw, unsigned char* hi, unsigned char* lo, int t) {
    tx::split_kmajor<BN, 256>(raw, hi, lo, t);
  };
  const long long M = (long long)p.B * p.H * p.W;

  float acc[BN / 2], t[BN / 2];
  tx::AFrag f0, f1;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int b, h0, w0, nt, split, kb, ke;
    decode(p, u, b, h0, w0, nt, split, kb, ke);
    tx::consume_unit<BN, STAGES, STAGE, A_BYTES>(ring, sbuf, full, empty, ke - kb, it, acc, t,
                                                 f0, f1, cw, ct, split_b);
    // epilogue: pixels r = 64 cw + 16 warp + g (+ 8) of the unit, channels
    // 8 j + 2 t4 (+ 1) of its 128
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = cw * 64 + warp * 16 + g + half * 8;
      const int hh = h0 + r / p.wt, ww = w0 + r % p.wt;
      if (hh >= p.H || ww >= p.W) continue;
      const long long pix = ((long long)b * p.H + hh) * p.W + ww;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = nt * BN + j * 8 + 2 * t4;
        if (col >= p.Co) continue;
        const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        if ((p.Co & 1) == 0) {  // col + 1 < Co, and the pair is 8-byte aligned
          if (p.splits == 1)
            *reinterpret_cast<float2*>(y + pix * p.Co + col) =
                make_float2(v0 + bias[col], v1 + bias[col + 1]);
          else
            *reinterpret_cast<float2*>(ws + ((long long)split * M + pix) * p.Co + col) =
                make_float2(v0, v1);
        } else {  // an odd Co: element by element, the column past Co dropped
          for (int e = 0; e < 2 && col + e < p.Co; ++e) {
            const float v = e ? v1 : v0;
            if (p.splits == 1)
              y[pix * p.Co + col + e] = v + bias[col + e];
            else
              ws[((long long)split * M + pix) * p.Co + col + e] = v;
          }
        }
      }
    }
  }
}

// y[i] = sum over splits s = 0, 1, .. of ws[s][i], in that order, + bias
__global__ void conv3x3_f32_reduce_kernel(const float* __restrict__ ws,
                                          const float* __restrict__ bias, float* __restrict__ y,
                                          long long n4, int Co, int splits) {
  const long long stride = n4 * 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 acc = reinterpret_cast<const float4*>(ws)[i];
    for (int s = 1; s < splits; ++s) {
      const float4 v = reinterpret_cast<const float4*>(ws + s * stride)[i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    const int c = (int)((i * 4) % Co);
    reinterpret_cast<float4*>(y)[i] =
        make_float4(acc.x + bias[c], acc.y + bias[c + 1], acc.z + bias[c + 2], acc.w + bias[c + 3]);
  }
}

// The same for Co % 4 != 0, element by element
__global__ void conv3x3_f32_reduce1_kernel(const float* __restrict__ ws,
                                           const float* __restrict__ bias, float* __restrict__ y,
                                           long long n, int Co, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = ws[i];
    for (int s = 1; s < splits; ++s) acc += ws[s * n + i];
    y[i] = acc + bias[(int)(i % Co)];
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

}  // namespace

// x: [B, H, W, C] f32, w: [Co, 3, 3, C] f32 with strides (9 Cw, 3 Cw, Cw, 1)
// (row-major [Co, 9C] when Cw == C; a channel slice of a [Co, Cw, 3, 3]
// channels_last weight, read in place, otherwise), bias: [Co] f32; y: [B,
// H, W, Co] f32; ws: splits x B*H*W x Co f32 when splits > 1 (else unused).
// x, y, ws contiguous; x, w 16-byte aligned. C % 4 == 0 (the maps' 16-byte
// strides), any Co, Cw >= C, Cw % 4 == 0.
// The plan: a unit is wt x ht pixels (wt * ht == 128) by 128 channels, K is
// cut into `splits` runs of steps_per_split of the 9 ceil(C / 32) k-steps of
// (tap, 32 channels), every run non-empty; accumulators fold every tx::kFold k-steps. Launches
// the GEMM, and the reduce when K is split.
extern "C" int cpd_conv3x3_f32_sm90(const void* x, const void* w, const void* bias, void* y,
                                    void* ws, int B, int H, int W, int C, int Co, int Cw, int wt,
                                    int ht, int splits, int steps_per_split, void* stream) {
  const int ksteps = 9 * ((C + BK - 1) / BK);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 4 || Cw < C || Cw % 4 ||
      wt * ht != BM ||
      wt > 256 || ht > 256 || splits < 1 || steps_per_split < 1 ||
      (long long)splits * steps_per_split < ksteps ||
      (long long)(splits - 1) * steps_per_split >= ksteps ||
      (long long)B * H * W * Co >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  Plan p{B, H, W, C, Co, wt, ht, (W + wt - 1) / wt, (H + ht - 1) / ht, 0, (Co + BN - 1) / BN,
         ksteps, splits, steps_per_split};
  p.m_tiles = B * p.tiles_h * p.tiles_w;
  const long long units = (long long)p.m_tiles * p.n_tiles * splits;
  if (units >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  CUtensorMap tmx, tmw;
  int err = cpd::encode_f32_map<4>(
      &tmx, x, {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B},
      {(uint64_t)C * 4, (uint64_t)W * C * 4, (uint64_t)H * W * C * 4},
      {(uint32_t)BK, (uint32_t)wt, (uint32_t)ht, 1u});
  if (err) return err;
  err = cpd::encode_f32_map<3>(&tmw, w, {(uint64_t)C, 9, (uint64_t)Co},
                               {(uint64_t)Cw * 4, (uint64_t)9 * Cw * 4},
                               {(uint32_t)BK, 1u, (uint32_t)BN});
  if (err) return err;
  auto kernel = conv3x3_f32_sm90_kernel;
  static bool attr_set = false;  // one card a process
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInitializationError;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (int)(units < sms ? units : sms);
  kernel<<<grid, THREADS, SMEM, st>>>(tmx, tmw, static_cast<const float*>(bias),
                                      static_cast<float*>(y), static_cast<float*>(ws), p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long n = (long long)B * H * W * Co;
  if (Co % 4 == 0) {
    const long long n4 = n / 4;
    const int blocks = (int)min((n4 + 255) / 256, (long long)sms * 8);
    conv3x3_f32_reduce_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                                      static_cast<const float*>(bias),
                                                      static_cast<float*>(y), n4, Co, splits);
  } else {
    const int blocks = (int)min((n + 255) / 256, (long long)sms * 8);
    conv3x3_f32_reduce1_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                                       static_cast<const float*>(bias),
                                                       static_cast<float*>(y), n, Co, splits);
  }
  return (int)cudaGetLastError();
}
