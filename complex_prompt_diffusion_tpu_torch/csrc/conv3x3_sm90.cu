// K4 on Hopper: bf16 3x3 stride-1 'same' convolution, y = conv3x3(x, w) + b,
// as an implicit GEMM fed by TMA into wgmma.
//
// Replaces the TPU kernel complex_prompt_diffusion_tpu/ops/conv.py::_kernel
// (nine shifted [M, C] x [C, Co] matmuls over an H-padded flat plane, f32
// accumulation, the bias added in f32, one rounding) for the bf16 convs with
// C % 8 == 0 and any Co that ops/conv.py routes here (past the narrow bodies'
// Co <= 8 or C <= 16): all 22 3x3 convs of a batch-1 SD-1.5 UNet call (UNet
// batch 2 on the 32^2 and 16^2 planes, C 320 .. 2560, Co 640 or 1280) and
// those of a UNet at CompVis LDM-VQ-4's widths (C 224 .. 1568, Co 224 .. 896,
// with C % 64 == 32). csrc/conv3x3.cu keeps the bf16 widths with C % 8 != 0.
//
// Layouts: x NHWC [B, H, W, C]; the weight a row-major [Co, 9C] matrix with
// column (dy * 3 + dx) * C + c (the port's [Co, C, 3, 3] weight in
// channels_last memory, read in place); y NHWC [B, H, W, Co].
//
// What bounds it on the H100: 2 * M * Co * 9C flops (M = B*H*W), 15.1 GFLOP
// at 32^2 640->640 and at 16^2 1280->1280, ~15 us of tensor-core time at
// 989 TFLOP/s, against 4-9 us of HBM traffic: the tensor cores, if the card
// is filled. The mma.sync body (conv3x3.cu: mma.sync fed by ldmatrix, every
// thread computing tap, halo predicate and address of every 16-byte chunk)
// ran 2.3-4.1x slower than cuDNN. Design:
//   * GEMM view M x Co x 9C, K ordered (tap, channel) in k-steps of one tap
//     and 64 channels: 9 ceil(C / 64) of them, a tap's last chunk partly
//     past C where C % 64 != 0. An output tile is BM = 128 pixels of one image, a
//     Wt x Ht rectangle (32 x 4 at W = 32, 16 x 8 at W = 16, 8 x 16 else),
//     by BN = 128 output channels.
//   * A: one 4-D TMA box {64 channels, Wt, Ht, 1} at (c0, w0 + dx - 1,
//     h0 + dy - 1, b) over x. TMA zero-fills coordinates outside the tensor,
//     which is exactly the 'same' padding: no masks, no padded copy, no
//     address math in the threads. The fill is per dimension, so the
//     channels >= C of a tap's last chunk land as zeros too (never the next
//     pixel's channels): a width off the 64-channel tile costs one partly
//     zero k-step a tap, not another body. With the 128-byte swizzle a pixel's 64
//     channels are one 128-byte row, so the box lands as the K-major
//     [128][64] tile that wgmma reads through a descriptor.
//   * B: a 3-D TMA box {64, 1, 128} of the weight viewed as [Co, 9, Cw]
//     (channel, tap, output channel; Cw >= C the weight's channel stride),
//     i.e. 64 channels of one tap for 128 output channels, K-major already;
//     rows past Co and channels >= C (even where Cw > C holds a neighbour's
//     channels there) are zero-filled. Cw > C reads a channel slice of a wider
//     weight in place (the UNet's split in_convs take the two halves of one
//     [Co, Ca + Cb, 3, 3] weight: no copy of either a call).
//   * A ring of STAGES stages (32 KB each) with full and empty mbarriers:
//     one producer thread issues the loads, two consumer warpgroups each run
//     wgmma m64n128k16 on 64 of the 128 rows, one wgmma group in flight
//     (a stage is released when the group after it has been issued and the
//     one reading it has retired).
//   * The grids are small (80 and 40 tiles at the two shapes above on 132
//     SMs), so K is split over the k-steps by the host's plan (ops/conv.py:
//     conv3x3_plan). With one split the epilogue adds the bias in f32 and
//     rounds once to bf16; with more, each split writes its f32 partial tile
//     to a workspace and conv3x3_splitk_reduce_kernel sums the splits in
//     split order, adds the bias and rounds once: the same input gives the
//     same bits on every run (no atomics).

#include <chrono>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;  // output pixels a tile
constexpr int BN = 128;  // output channels a tile
constexpr int BK = 64;   // channels a k-step (one 128-byte swizzle row)
constexpr int STAGES = 4;
constexpr int THREADS = 384;  // warpgroup 0: producer; 1, 2: consumers
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * 8;

struct Plan {
  int B, H, W, C, Co;
  int wt, ht;       // the pixel rectangle of a tile (wt * ht == BM)
  int tiles_w, tiles_h;
  int ksteps;       // 9 * ceil(C / 64)
  int steps_per_split;
};

template <typename BiasT>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                    const BiasT* __restrict__ bias, bf16* __restrict__ y,
                    float* __restrict__ ws, Plan p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sA = smem;                     // [STAGES][BM][64], swizzled
  unsigned char* sB = smem + STAGES * A_BYTES;  // [STAGES][BN][64], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + STAGES * B_BYTES);
  uint64_t* empty = full + STAGES;

  const int n0 = blockIdx.x * BN;
  int mt = blockIdx.y;  // (b, tile row, tile column)
  const int tw_i = mt % p.tiles_w;
  mt /= p.tiles_w;
  const int th_i = mt % p.tiles_h;
  const int b = mt / p.tiles_h;
  const int w0 = tw_i * p.wt, h0 = th_i * p.ht;
  const int split = blockIdx.z;
  const int k_begin = split * p.steps_per_split;
  const int k_end = min(p.ksteps, k_begin + p.steps_per_split);
  const int nsteps = k_end - k_begin;
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
    // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      cpd::tma_prefetch_desc(&tx);
      cpd::tma_prefetch_desc(&tw);
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) cpd::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        const int t = k_begin + i;
        const int tap = t / chunks;
        const int c0 = (t - tap * chunks) * BK;
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
        cpd::mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
        cpd::tma_load_4d(sA + s * A_BYTES, &tx, &full[s], c0, w0 + dx - 1, h0 + dy - 1, b);
        cpd::tma_load_3d(sB + s * B_BYTES, &tw, &full[s], c0, tap, n0);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns tile rows 64 cw .. 64 cw + 63
  const int cw = wg - 1;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nsteps; ++i) {
    const int s = i % STAGES;
    cpd::mbar_wait(&full[s], (i / STAGES) & 1);
    const unsigned char* a = sA + s * A_BYTES + cw * 64 * 128;
    const unsigned char* bt = sB + s * B_BYTES;
    cpd::fence_regs(acc);
    cpd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      cpd::Wgmma<BN>::ss(acc, cpd::desc_sw128(a + kk * 32, 16, 1024),
                         cpd::desc_sw128(bt + kk * 32, 16, 1024), 1);
    cpd::wgmma_commit();
    cpd::wgmma_wait<1>();  // the group of step i - 1 has retired
    cpd::fence_regs(acc);
    if (i > 0) cpd::mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  cpd::wgmma_wait<0>();
  cpd::fence_regs(acc);

  // epilogue: thread rows r = 16 warp + g (+ 8) of this warpgroup's 64,
  // columns 8 j + 2 t4 (+ 1)
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const long long M = (long long)p.B * p.H * p.W;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = cw * 64 + warp * 16 + g + half * 8;
    const int hh = h0 + r / p.wt, ww = w0 + r % p.wt;
    if (hh >= p.H || ww >= p.W) continue;
    const long long pix = ((long long)b * p.H + hh) * p.W + ww;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t4;
      if (col >= p.Co) continue;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if ((p.Co & 1) == 0) {  // col + 1 < Co, and the pair is 4-byte aligned
        if (gridDim.z == 1) {
          *reinterpret_cast<uint32_t*>(y + pix * p.Co + col) =
              cpd::pack_bf16(v0 + cpd::to_f32(bias[col]), v1 + cpd::to_f32(bias[col + 1]));
        } else {
          *reinterpret_cast<float2*>(ws + ((long long)split * M + pix) * p.Co + col) =
              make_float2(v0, v1);
        }
      } else {  // an odd Co: element by element, the column past Co dropped
        for (int e = 0; e < 2 && col + e < p.Co; ++e) {
          const float v = e ? v1 : v0;
          if (gridDim.z == 1)
            y[pix * p.Co + col + e] = cpd::from_f32<bf16>(v + cpd::to_f32(bias[col + e]));
          else
            ws[((long long)split * M + pix) * p.Co + col + e] = v;
        }
      }
    }
  }
}

// y[i] = bf16(sum over splits s = 0, 1, .. of ws[s][i], in that order, + bias)
template <typename BiasT>
__global__ void conv3x3_splitk_reduce_kernel(const float* __restrict__ ws,
                                             const BiasT* __restrict__ bias,
                                             bf16* __restrict__ y, long long n4, int Co,
                                             int splits) {
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
    uint2 out;
    out.x = cpd::pack_bf16(acc.x + cpd::to_f32(bias[c]), acc.y + cpd::to_f32(bias[c + 1]));
    out.y = cpd::pack_bf16(acc.z + cpd::to_f32(bias[c + 2]), acc.w + cpd::to_f32(bias[c + 3]));
    reinterpret_cast<uint2*>(y)[i] = out;
  }
}

// The same for Co % 4 != 0, element by element: y[i] = bf16(sum over splits
// of ws[s][i] + bias[i % Co])
template <typename BiasT>
__global__ void conv3x3_splitk_reduce1_kernel(const float* __restrict__ ws,
                                              const BiasT* __restrict__ bias,
                                              bf16* __restrict__ y, long long n, int Co,
                                              int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = ws[i];
    for (int s = 1; s < splits; ++s) acc += ws[s * n + i];
    y[i] = cpd::from_f32<bf16>(acc + cpd::to_f32(bias[(int)(i % Co)]));
  }
}

template <typename BiasT>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, const void* bias, void* y, void* ws,
           const Plan& p, int splits, cudaStream_t stream) {
  auto kernel = conv3x3_sm90_kernel<BiasT>;
  static bool attr_set = false;  // one card a process
  if (!attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((p.Co + BN - 1) / BN, p.B * p.tiles_h * p.tiles_w, splits);
  kernel<<<grid, THREADS, SMEM, stream>>>(tx, tw, static_cast<const BiasT*>(bias),
                                          static_cast<bf16*>(y), static_cast<float*>(ws), p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)p.B * p.H * p.W * p.Co;
  if (p.Co % 4 == 0) {
    const long long n4 = n / 4;
    const int blocks = (int)min((n4 + 255) / 256, 132LL * 8);
    conv3x3_splitk_reduce_kernel<BiasT><<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<const BiasT*>(bias), static_cast<bf16*>(y), n4,
        p.Co, splits);
  } else {
    const int blocks = (int)min((n + 255) / 256, 132LL * 8);
    conv3x3_splitk_reduce1_kernel<BiasT><<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<const BiasT*>(bias), static_cast<bf16*>(y), n,
        p.Co, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [B, H, W, C] bf16, w: [Co, 3, 3, C] bf16 with strides (9 Cw, 3 Cw, Cw,
// 1) (row-major [Co, 9C] when Cw == C; a channel slice of a [Co, Cw, 3, 3]
// channels_last weight otherwise), bias: [Co] bf16, or f32 when
// bias_is_f32; y: [B, H, W, Co] bf16; ws: splits x B*H*W x Co f32 when
// splits > 1 (else unused). x, y, ws contiguous; x, w 16-byte aligned. C %
// 8 == 0 (the maps' 16-byte strides), any Co, Cw >= C, Cw % 8 == 0. The
// plan: a tile is wt x ht pixels (wt * ht == 128), K is cut into `splits`
// runs of steps_per_split of the 9 ceil(C / 64) k-steps of (tap, 64
// channels); every run non-empty.
extern "C" int cpd_conv3x3_sm90_bf16(const void* x, const void* w, const void* bias,
                                     int bias_is_f32, void* y, void* ws, int B, int H, int W,
                                     int C, int Co, int Cw, int wt, int ht, int splits,
                                     int steps_per_split, void* stream) {
  const int ksteps = 9 * ((C + BK - 1) / BK);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 8 || Cw < C || Cw % 8 ||
      wt * ht != BM ||
      wt > 256 || ht > 256 || splits < 1 || steps_per_split < 1 ||
      (long long)splits * steps_per_split < ksteps ||
      (long long)(splits - 1) * steps_per_split >= ksteps ||
      (long long)B * H * W * Co >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  Plan p{B, H, W, C, Co, wt, ht, (W + wt - 1) / wt, (H + ht - 1) / ht, ksteps, steps_per_split};
  if ((long long)B * p.tiles_h * p.tiles_w > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  int err = cpd::encode_bf16_map<4>(
      &tx, x, {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B},
      {(uint64_t)C * 2, (uint64_t)W * C * 2, (uint64_t)H * W * C * 2},
      {(uint32_t)BK, (uint32_t)wt, (uint32_t)ht, 1u});
  if (err) return err;
  err = cpd::encode_bf16_map<3>(&tw, w, {(uint64_t)C, 9, (uint64_t)Co},
                                {(uint64_t)Cw * 2, (uint64_t)9 * Cw * 2},
                                {(uint32_t)BK, 1u, (uint32_t)BN});
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bias_is_f32 ? launch<float>(tx, tw, bias, y, ws, p, splits, st)
                     : launch<bf16>(tx, tw, bias, y, ws, p, splits, st);
}

// Host cost of encoding one TMA tensor map (the 4-D map of a conv input),
// averaged over `iters` encodes: written to *ns_per_encode.
extern "C" int cpd_tmap_encode_bench(int iters, double* ns_per_encode, const void* base) {
  if (iters <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  cudaEvent_t dummy;  // keep the runtime initialised before timing
  if (cudaEventCreate(&dummy) != cudaSuccess) return (int)cudaErrorInitializationError;
  cudaEventDestroy(dummy);
  int err = 0;
  auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters && !err; ++i)
    err = cpd::encode_bf16_map<4>(&m, base, {640, 32, 32, 2}, {1280, 1280 * 32, 1280 * 32 * 32},
                                  {64, 32, 4, 1});
  auto t1 = std::chrono::steady_clock::now();
  *ns_per_encode = std::chrono::duration<double, std::nano>(t1 - t0).count() / iters;
  return err;
}
