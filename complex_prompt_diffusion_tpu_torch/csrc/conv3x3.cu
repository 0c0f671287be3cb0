// K4: 3x3 stride-1 'same' convolution, y = conv3x3(x, w) + b, bf16 or f32
// in and out.
//
// Replaces the TPU kernel complex_prompt_diffusion_tpu/ops/conv.py::_kernel
// (nine shifted [M, C] x [C, Co] matmuls over an H-padded flat plane with
// row masks). The port sends it the same convs as the JAX dispatch
// (models/layers.py: batch <= 4 on 16^2..32^2 planes), less the bf16 convs
// with C % 64 == 0 and Co % 64 == 0, which ops/conv.py routes to the TMA +
// wgmma body in conv3x3_sm90.cu (the 22 3x3 convs per UNet call of the
// batch-1 render among them). This file keeps the rest: bf16 convs of other
// widths (C = 4 at the UNet's and the VAE decoder's conv_in, Co = 4 at the
// UNet's out conv) and, in f32, the exact VAE decode's convs on a 16x16 or
// 32x32 latent. Rounding matches the TPU kernel: products accumulated in
// f32, the bias added in f32, one rounding to the activation dtype.
//
// Layouts: x is NHWC [B, H, W, C]; the weight is the port's conv weight
// [Co, C, 3, 3] in channels_last memory, i.e. a row-major [Co, 9C] matrix
// whose column k = (dy * 3 + dx) * C + c (the transpose of the HWIO
// [9C, Co] matrix, read in place: no copy per call); y is NHWC [B, H, W, Co].
//
// Design: an implicit GEMM, M = B*H*W output pixels, N = Co, K = 9*C. The
// A tile (64 pixels x 64 reduction columns) is gathered straight from x:
// for C % 8 == 0 every 8-element chunk lies inside one tap, so it is one
// 16-byte cp.async whose source pixel (h + dy - 1, w + dx - 1) is
// predicated, and a chunk of the halo is zero-filled by the copy itself:
// no padded copy of x and no row masks. Other C (the UNet's conv_in, C = 4)
// take an element-by-element gather. The B tile is 64 output channels x 64
// columns of the weight. Tiles pass through a 3-stage cp.async ring
// (rows padded by 8 elements so ldmatrix hits distinct banks) into
// mma.sync m16n8k16 (bf16 in, f32 accumulate) with ldmatrix operands; the
// epilogue adds the bias (bf16 or f32, widened in the kernel) and stores
// bf16 pairs. Every edge is masked: any
// M, any Co, any C >= 1. Measured on the H100 (A/B of two builds), 64
// reduction columns a stage beat 32 by 0.82x summed over the ten batch-1
// shapes; 128-row tiles and 2 or 4 stages lost, 128-channel tiles tied.
//
// What bounds it on the H100 at batch 1 (UNet batch 2): 2 * M * Co * 9C
// flops, 15.1 GFLOP at both 32^2 640->640 (M = 2048) and 16^2 1280->1280
// (M = 512), i.e. ~15 us of tensor-core time at 989 TFLOP/s, against 12.6
// and 30 MB of bytes (mostly the weights), 4 and 9 us at 3.35 TB/s: the
// tensor cores bound it. The grids are small, so the tile is narrow:
// 64 x 64 output tiles (128 threads, 2 x 2 warps of 32 x 32) give 320 and
// 160 blocks on 132 SMs, where 128 x 128 tiles would leave 52 and 92 SMs
// idle. The full 9C reduction stays in one block (no split-K partials).
// Each ldmatrix fragment feeds two MMAs, so shared-memory bandwidth is the
// likely limit (no profiler of the card confirms it); the kernel runs 2-3x
// slower than cuDNN at these shapes. Not yet: wgmma, TMA, a persistent
// schedule.
//
// f32 (conv3x3_f32_kernel): the same implicit GEMM with exact f32 FMAs on
// the CUDA cores (no TF32, as the exact decode asks): 64 x 64 output tiles,
// 16 reduction columns a stage, each of 256 threads holding 4 x 4 outputs;
// the next stage is gathered into registers (element by element, masked, so
// any C and Co) while the current one is multiplied out of shared memory.

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// Block tile: BM output pixels x BN output channels, BK reduction columns a
// stage, STAGES stages; (BM / 32) x (BN / 32) warps of 32 x 32.

template <int BM_, int BN_, int BK_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int WARPS_N = BN / 32;
  static constexpr int THREADS = 32 * (BM / 32) * WARPS_N;
  static constexpr int LD = BK + 8;  // padded shared-memory row
  static constexpr int STAGE_A = BM * LD, STAGE_B = BN * LD;
  static constexpr int SMEM = STAGES * (STAGE_A + STAGE_B) * (int)sizeof(bf16);
  // each thread moves the 8-column chunk (tid % CPR) * 8 of the rows
  // tid / CPR + i * RPP of both tiles
  static constexpr int CPR = BK / 8, RPP = THREADS / CPR;
  static constexpr int A_ROWS = BM / RPP, B_ROWS = BN / RPP;
};
typedef Tile<64, 64, 64, 3> Cfg;  // the tile the launcher uses

struct Shape {
  int H, W, C, Co, M, K;
};

// This thread's A rows (output pixels) and B rows (output channels), fixed
// for the block's life.
template <class T>
struct Rows {
  const bf16* px[T::A_ROWS];  // x at (b, h, w, 0) of each pixel
  int h[T::A_ROWS], w[T::A_ROWS];
  bool m_ok[T::A_ROWS];
  const bf16* wrow[T::B_ROWS];  // weight row of each output channel
  bool n_ok[T::B_ROWS];
};

// One k-tile (columns k0 .. k0 + BK - 1) of A and B into a stage.
template <class T, bool kVec>
__device__ __forceinline__ void load_stage(bf16* sA, bf16* sB, const bf16* x, const Rows<T>& rw,
                                           const Shape& s, int k0) {
  const int r = threadIdx.x / T::CPR;
  const int c = (threadIdx.x % T::CPR) * 8;
  if constexpr (kVec) {
    const int k = k0 + c;
    const bool k_ok = k < s.K;
    const int tap = k / s.C;
    const int ch = k - tap * s.C;
    const int dy = tap / 3 - 1;
    const int dx = tap - (tap / 3) * 3 - 1;
    const long long shift = ((long long)dy * s.W + dx) * s.C + ch;
#pragma unroll
    for (int i = 0; i < T::A_ROWS; ++i) {
      const int hi = rw.h[i] + dy;
      const int wi = rw.w[i] + dx;
      const bool ok = k_ok && rw.m_ok[i] && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
      cpd::cp_async16(sA + (r + i * T::RPP) * T::LD + c, ok ? rw.px[i] + shift : x, ok);
    }
#pragma unroll
    for (int i = 0; i < T::B_ROWS; ++i) {
      const bool ok = k_ok && rw.n_ok[i];
      cpd::cp_async16(sB + (r + i * T::RPP) * T::LD + c, ok ? rw.wrow[i] + k : x, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = k0 + c + e;
      const bool k_ok = k < s.K;
      const int tap = k / s.C;
      const int ch = k - tap * s.C;
      const int dy = tap / 3 - 1;
      const int dx = tap - (tap / 3) * 3 - 1;
#pragma unroll
      for (int i = 0; i < T::A_ROWS; ++i) {
        const int hi = rw.h[i] + dy;
        const int wi = rw.w[i] + dx;
        const bool ok = k_ok && rw.m_ok[i] && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
        sA[(r + i * T::RPP) * T::LD + c + e] =
            ok ? rw.px[i][((long long)dy * s.W + dx) * s.C + ch] : zero;
      }
#pragma unroll
      for (int i = 0; i < T::B_ROWS; ++i)
        sB[(r + i * T::RPP) * T::LD + c + e] = k_ok && rw.n_ok[i] ? rw.wrow[i][k] : zero;
    }
  }
}

template <class T, bool kVec, typename BiasT>
__global__ void __launch_bounds__(T::THREADS)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                    const BiasT* __restrict__ bias, bf16* __restrict__ y, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [STAGES][BM][LD]
  bf16* sB = sA + T::STAGES * T::STAGE_A;    // [STAGES][BN][LD]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / T::WARPS_N;
  const int wn = warp % T::WARPS_N;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int n0 = blockIdx.x * T::BN;
  const int m0 = blockIdx.y * T::BM;
  const int ktiles = (s.K + T::BK - 1) / T::BK;

  Rows<T> rw;
  const int hw = s.H * s.W;
#pragma unroll
  for (int i = 0; i < T::A_ROWS; ++i) {
    const int m = m0 + threadIdx.x / T::CPR + i * T::RPP;
    rw.m_ok[i] = m < s.M;
    const int mm = rw.m_ok[i] ? m : 0;
    const int p = mm - (mm / hw) * hw;
    rw.h[i] = p / s.W;
    rw.w[i] = p - rw.h[i] * s.W;
    rw.px[i] = x + (long long)mm * s.C;
  }
#pragma unroll
  for (int i = 0; i < T::B_ROWS; ++i) {
    const int n = n0 + threadIdx.x / T::CPR + i * T::RPP;
    rw.n_ok[i] = n < s.Co;
    rw.wrow[i] = wt + (long long)(rw.n_ok[i] ? n : 0) * s.K;
  }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < T::STAGES - 1; ++st) {
    if (st < ktiles)
      load_stage<T, kVec>(sA + st * T::STAGE_A, sB + st * T::STAGE_B, x, rw, s, st * T::BK);
    cpd::cp_async_commit();
  }

  // ldmatrix lane addressing: A [m][k] and B [n][k], both non-transposed
  const int a_row = wm * 32 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = wn * 32 + ((lane >> 4) << 3) + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 8;

  for (int kt = 0; kt < ktiles; ++kt) {
    cpd::cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // tile kt landed; everyone is done with tile kt - 1
    const int pf = kt + T::STAGES - 1;
    if (pf < ktiles) {
      const int st = pf % T::STAGES;
      load_stage<T, kVec>(sA + st * T::STAGE_A, sB + st * T::STAGE_B, x, rw, s, pf * T::BK);
    }
    cpd::cp_async_commit();

    const int st = kt % T::STAGES;
    const bf16* tA = sA + st * T::STAGE_A;
    const bf16* tB = sB + st * T::STAGE_B;
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        cpd::ldmatrix_x4(af[i], tA + (a_row + i * 16) * T::LD + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bfr[4];
        cpd::ldmatrix_x4(bfr, tB + (b_row + np * 16) * T::LD + kk * 16 + b_col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          cpd::mma_16816(acc[i][2 * np], af[i], bfr[0], bfr[1]);
          cpd::mma_16816(acc[i][2 * np + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
  }
  cpd::cp_async_wait<0>();

  // epilogue: rows g and g + 8 of each m16 tile, column pair 2*t4 of each n8
  // tile; bias in f32, one rounding
  const bool pairs = (s.Co & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t4;
      if (col >= s.Co) continue;
      const bool two = col + 1 < s.Co;
      const float b0 = cpd::to_f32(bias[col]);
      const float b1 = two ? cpd::to_f32(bias[col + 1]) : 0.f;
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int row = m0 + wm * 32 + i * 16 + g + hrow * 8;
        if (row >= s.M) continue;
        const float y0 = acc[i][j][2 * hrow] + b0;
        const float y1 = acc[i][j][2 * hrow + 1] + b1;
        bf16* dst = y + (long long)row * s.Co + col;
        if (pairs && two) {
          *reinterpret_cast<uint32_t*>(dst) = cpd::pack_bf16(y0, y1);
        } else {
          dst[0] = __float2bfloat16(y0);
          if (two) dst[1] = __float2bfloat16(y1);
        }
      }
    }
  }
}

template <bool kVec, typename BiasT>
int launch_bf16(const void* x, const void* w, const void* bias, void* y, const Shape& s,
                cudaStream_t stream) {
  auto kernel = conv3x3_bf16_kernel<Cfg, kVec, BiasT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s.Co + Cfg::BN - 1) / Cfg::BN, (s.M + Cfg::BM - 1) / Cfg::BM);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const BiasT*>(bias),
      static_cast<bf16*>(y), s);
  return (int)cudaGetLastError();
}

// ---- f32: CUDA-core FMAs ----

constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;
constexpr int F_LD = F_BM + 4;  // padded shared-memory row (16-byte aligned float4 reads)
constexpr int F_ROWS = F_BM * F_BK / F_THREADS;  // A (and B) elements a thread gathers

__global__ void __launch_bounds__(F_THREADS)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   const float* __restrict__ bias, float* __restrict__ y, Shape s) {
  __shared__ __align__(16) float sA[2][F_BK][F_LD];  // [k][pixel]
  __shared__ __align__(16) float sB[2][F_BK][F_LD];  // [k][output channel]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * F_BN, m0 = blockIdx.y * F_BM;
  const int ktiles = (s.K + F_BK - 1) / F_BK;
  // gather role: reduction column kl of the rows r0 + 16 i (consecutive
  // threads read consecutive channels, so the loads coalesce)
  const int kl = threadIdx.x % F_BK, r0 = threadIdx.x / F_BK;
  const int hw = s.H * s.W;
  const float* px[F_ROWS];
  int ph[F_ROWS], pw[F_ROWS];
  bool m_ok[F_ROWS], n_ok[F_ROWS];
  const float* wrow[F_ROWS];
#pragma unroll
  for (int i = 0; i < F_ROWS; ++i) {
    const int m = m0 + r0 + 16 * i;
    m_ok[i] = m < s.M;
    const int mm = m_ok[i] ? m : 0;
    const int p = mm - (mm / hw) * hw;
    ph[i] = p / s.W;
    pw[i] = p - ph[i] * s.W;
    px[i] = x + (long long)mm * s.C;
    const int n = n0 + r0 + 16 * i;
    n_ok[i] = n < s.Co;
    wrow[i] = wt + (long long)(n_ok[i] ? n : 0) * s.K;
  }
  float ra[F_ROWS], rb[F_ROWS];
  auto gather = [&](int k0) {
    const int k = k0 + kl;
    const bool k_ok = k < s.K;
    const int tap = k_ok ? k / s.C : 0;
    const int ch = k - tap * s.C;
    const int dy = tap / 3 - 1;
    const int dx = tap - (tap / 3) * 3 - 1;
#pragma unroll
    for (int i = 0; i < F_ROWS; ++i) {
      const int hi = ph[i] + dy, wi = pw[i] + dx;
      const bool ok = k_ok && m_ok[i] && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
      ra[i] = ok ? px[i][((long long)dy * s.W + dx) * s.C + ch] : 0.f;
      rb[i] = k_ok && n_ok[i] ? wrow[i][k] : 0.f;
    }
  };
  auto store = [&](int st) {
#pragma unroll
    for (int i = 0; i < F_ROWS; ++i) {
      sA[st][kl][r0 + 16 * i] = ra[i];
      sB[st][kl][r0 + 16 * i] = rb[i];
    }
  };

  float acc[4][4] = {};
  gather(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ktiles) gather((kt + 1) * F_BK);
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[st][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sB[st][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < ktiles) store(st ^ 1);
    __syncthreads();  // stage st ^ 1 is full; everyone is done with stage st
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= s.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < s.Co) y[(long long)row * s.Co + col] = acc[i][j] + bias[col];
    }
  }
}

bool shape_ok(int B, int H, int W, int C, int Co) {
  return B > 0 && H > 0 && W > 0 && C > 0 && Co > 0 && (long long)B * H * W < (1LL << 31) &&
         9LL * C < (1LL << 31);
}

}  // namespace

// x: [B, H, W, C] bf16, w: [Co, 3, 3, C] bf16 (row-major [Co, 9C]),
// bias: [Co] bf16, or f32 when bias_is_f32, y: [B, H, W, Co] bf16; all
// contiguous, 16-byte aligned.
extern "C" int cpd_conv3x3_bf16(const void* x, const void* w, const void* bias, int bias_is_f32,
                                void* y, int B, int H, int W, int C, int Co, void* stream) {
  if (!shape_ok(B, H, W, C, Co)) return (int)cudaErrorInvalidValue;
  const Shape s{H, W, C, Co, B * H * W, 9 * C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 8 == 0)
    return bias_is_f32 ? launch_bf16<true, float>(x, w, bias, y, s, st)
                       : launch_bf16<true, bf16>(x, w, bias, y, s, st);
  return bias_is_f32 ? launch_bf16<false, float>(x, w, bias, y, s, st)
                     : launch_bf16<false, bf16>(x, w, bias, y, s, st);
}

// x: [B, H, W, C] f32, w: [Co, 3, 3, C] f32, bias: [Co] f32, y: [B, H, W,
// Co] f32; all contiguous.
extern "C" int cpd_conv3x3_f32(const void* x, const void* w, const void* bias, void* y, int B,
                               int H, int W, int C, int Co, void* stream) {
  if (!shape_ok(B, H, W, C, Co)) return (int)cudaErrorInvalidValue;
  const Shape s{H, W, C, Co, B * H * W, 9 * C};
  dim3 grid((Co + F_BN - 1) / F_BN, (s.M + F_BM - 1) / F_BM);
  conv3x3_f32_kernel<<<grid, F_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(y), s);
  return (int)cudaGetLastError();
}
