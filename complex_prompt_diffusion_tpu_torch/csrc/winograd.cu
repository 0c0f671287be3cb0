// K6: 3x3 stride-1 'same' convolution + bias via Winograd F(2x2,3x3), bf16 or
// f32 in and out, NHWC.
//
// Replaces the TPU kernel complex_prompt_diffusion_tpu/ops/probes/
// winograd.py::_wino_kernel: an opt-in probe that no layer dispatches, here
// as there. Each 2x2 output tile costs 16 multiplies per (input, output)
// channel pair instead of the direct conv's 36: with V = B^T d B the
// transform of the tile's 4x4 input patch d and U = G g G^T the transform of
// the 3x3 weight (made by the wrapper, [16, C, Co]), the 16 products M_ij =
// V_ij [tiles, C] x U_ij [C, Co] give the tile as Y = A^T M A.
//
// What bounds it on the H100: 2 * 16 * tiles * C * Co flops (at B2 32^2
// 640->640: 6.7 GFLOP, 7 us of tensor-core time at 989 TFLOP/s) against the
// bytes of x, U (16 * C * Co elements, 1.8x the direct conv's weight) and
// y: 13.1 MB of U alone there, 4 us at 3.35 TB/s; the operations bound it,
// but only 2.25x below the direct conv, and the input transform is CUDA-core
// work that the direct conv does not have. What the TPU kernel is for is
// that the transformed tiles never reach device memory; that is kept. Its
// layout tricks (phase planes, a junk column, flat shifts) are not: a block
// gathers its 4x4 patches with their halo straight from NHWC x, as K4
// gathers its taps, and zero-fills what lies outside the plane.
//
// Design, bf16: a block owns 32 tiles x 64 output channels and walks C in
// chunks of 32. Per chunk each of the 256 threads gathers one tile's 4x4
// patch for 4 channels (sixteen 8-byte loads into registers, started before
// the previous chunk's products), transforms it in f32 (adds only), rounds V
// once to bf16 and stores the 16 positions to shared memory, while cp.async
// brings the chunk's slab of U; both are double buffered. Then warp w takes
// positions 2w and 2w+1: two [32 x 32] x [32 x 64] products on the tensor
// cores (mma.sync m16n8k16, f32 accumulate; V read with ldmatrix, U [c][co]
// with ldmatrix.trans), 128 accumulators a thread. The TPU kernel folds A^T M A into four running
// sums as each product retires; on tensor cores that would cost 36 MMAs per
// tile instead of 16, so the 16 M_ij stay apart until the end, go through
// shared memory once (f32), and each thread then forms the four outputs of
// a (tile, channel pair), adds the bias in f32 and stores bf16 pairs. Shared
// memory: 2 x (40 KB V + 72 KB U) = 224 KB, one block per SM.
//
// f32: exact FMAs on the CUDA cores (no TF32): 16 tiles x 64 channels a
// block, chunks of 16 input channels, the 256 threads as 16 positions x 16
// threads of 4 tiles x 16 channels each; same gather, transform and
// epilogue. Single-buffered.
// This first body keeps the shapes outside the Hopper bodies' rule
// (ops/probes/winograd.py: k6_body); for bf16 with C and Co multiples of
// 64, winograd_sm90.cu (TMA + wgmma, the patch shared between neighbouring
// tiles, each transform serving 128 output channels) replaced it, for f32
// with C % 32 == Co % 64 == 0 winograd_f32_sm90.cu (the same on 3xTF32
// wgmma), and it stays callable there as wino3x3_prior.

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

struct WShape {
  int H, W, C, Co, TH, TW, T;  // T = B * TH * TW tiles
};

// B^T applied to a 4-vector: (a0 - a2, a1 + a2, a2 - a1, a1 - a3)
__device__ __forceinline__ void butterfly(float& a0, float& a1, float& a2, float& a3) {
  const float b0 = a0 - a2, b1 = a1 + a2, b2 = a2 - a1, b3 = a1 - a3;
  a0 = b0;
  a1 = b1;
  a2 = b2;
  a3 = b3;
}

// d[k][l] (a 4x4 patch of one channel) -> V = B^T d B in place: V[i][j]
__device__ __forceinline__ void input_transform(float (&d)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) butterfly(d[k][0], d[k][1], d[k][2], d[k][3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) butterfly(d[0][j], d[1][j], d[2][j], d[3][j]);
}

// m[i*4+j] -> the tile's four outputs y[a*2+b] = (A^T M A)[a][b]
__device__ __forceinline__ void output_transform(const float (&m)[16], float (&y)[4]) {
  float t0[4], t1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t0[j] = m[j] + m[4 + j] + m[8 + j];
    t1[j] = m[4 + j] - m[8 + j] - m[12 + j];
  }
  y[0] = t0[0] + t0[1] + t0[2];
  y[1] = t0[1] - t0[2] - t0[3];
  y[2] = t1[0] + t1[1] + t1[2];
  y[3] = t1[1] - t1[2] - t1[3];
}

struct TilePos {
  int b, ti, tj;
};

__device__ __forceinline__ TilePos tile_pos(int tile, const WShape& s) {
  const int per = s.TH * s.TW;
  TilePos p;
  p.b = tile / per;
  const int rem = tile - p.b * per;
  p.ti = rem / s.TW;
  p.tj = rem - p.ti * s.TW;
  return p;
}

// ---- bf16: tensor cores ----

constexpr int W_BT = 32;        // tiles per block
constexpr int W_BN = 64;        // output channels per block
constexpr int W_BK = 32;        // input channels per stage
constexpr int W_THREADS = 256;  // 8 warps x 2 positions
constexpr int W_LDV = W_BK + 8;
constexpr int W_LDU = W_BN + 8;
constexpr int W_STAGE_V = 16 * W_BT * W_LDV;  // elements
constexpr int W_STAGE_U = 16 * W_BK * W_LDU;
constexpr int W_LDM = W_BN + 4;  // f32 row of the epilogue's M tile
constexpr int W_SMEM = 2 * (W_STAGE_V + W_STAGE_U) * (int)sizeof(bf16);
static_assert(16 * W_BT * W_LDM * (int)sizeof(float) <= W_SMEM, "the M tile reuses the stages");
static_assert(W_SMEM <= 232448, "a block may use 227 KB of shared memory");

__global__ void __launch_bounds__(W_THREADS, 1)
wino3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u,
                    const float* __restrict__ bias, bf16* __restrict__ y, WShape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sV = reinterpret_cast<bf16*>(smem);  // [2][16][W_BT][W_LDV]
  bf16* sU = sV + 2 * W_STAGE_V;             // [2][16][W_BK][W_LDU]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int n0 = blockIdx.x * W_BN;
  const int t0 = blockIdx.y * W_BT;
  const int kchunks = (s.C + W_BK - 1) / W_BK;

  // gather role: the patch of tile gt for the channels gc .. gc + 3
  const int gt = tid >> 3;
  const int gc = (tid & 7) * 4;
  const bool t_ok = t0 + gt < s.T;
  const TilePos gp = tile_pos(t_ok ? t0 + gt : 0, s);
  const int h0 = 2 * gp.ti - 1, w0 = 2 * gp.tj - 1;
  const bf16* xb = x + (long long)gp.b * s.H * s.W * s.C;

  // The patch is gathered into registers before a chunk's products and
  // transformed after them, so the loads' latency hides behind the MMAs.
  uint2 raw[4][4];
  auto gather = [&](int c0) {
    const int c = c0 + gc;
    const bool c_ok = t_ok && c < s.C;  // C % 8 == 0: the 4 channels are valid together
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int hi = h0 + k, wi = w0 + l;
        const bool ok = c_ok && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
        raw[k][l] = make_uint2(0u, 0u);
        if (ok)
          raw[k][l] = *reinterpret_cast<const uint2*>(xb + ((long long)hi * s.W + wi) * s.C + c);
      }
    }
  };
  auto transform_store = [&](bf16* dst) {
    float d[4][4][4];  // [channel][k][l]
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const float2 lo =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[k][l].x));
        const float2 hi2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[k][l].y));
        d[0][k][l] = lo.x;
        d[1][k][l] = lo.y;
        d[2][k][l] = hi2.x;
        d[3][k][l] = hi2.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) input_transform(d[e]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint2 out;
        out.x = cpd::pack_bf16(d[0][i][j], d[1][i][j]);
        out.y = cpd::pack_bf16(d[2][i][j], d[3][i][j]);
        *reinterpret_cast<uint2*>(dst + ((i * 4 + j) * W_BT + gt) * W_LDV + gc) = out;
      }
    }
  };

  auto load_u = [&](bf16* dst, int c0) {
    constexpr int kChunks = W_BN / 8;
    for (int idx = tid; idx < 16 * W_BK * kChunks; idx += W_THREADS) {
      const int cc = (idx % kChunks) * 8;
      const int r = (idx / kChunks) % W_BK;
      const int p = idx / (kChunks * W_BK);
      const bool ok = c0 + r < s.C && n0 + cc < s.Co;  // Co % 8 == 0
      cpd::cp_async16(dst + (p * W_BK + r) * W_LDU + cc,
                      ok ? u + ((long long)p * s.C + c0 + r) * s.Co + n0 + cc : u, ok);
    }
  };

  float acc[2][2][8][4];  // [position of this warp][m16 tile][n8 tile]
#pragma unroll
  for (int pp = 0; pp < 2; ++pp)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[pp][i][j][0] = acc[pp][i][j][1] = acc[pp][i][j][2] =
                                      acc[pp][i][j][3] = 0.f;

  // ldmatrix lane addressing: V [tile][c] is A [m][k]; U [c][co] is B stored
  // [k][n], read with .trans
  const int a_row = lane & 15;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (((lane >> 3) & 1) << 3) + (lane & 7);
  const int b_col = (lane >> 4) * 8;

  load_u(sU, 0);
  cpd::cp_async_commit();
  gather(0);
  transform_store(sV);

  for (int kc = 0; kc < kchunks; ++kc) {
    const int cur = kc & 1;
    const bool more = kc + 1 < kchunks;
    if (more) {
      load_u(sU + (cur ^ 1) * W_STAGE_U, (kc + 1) * W_BK);
      cpd::cp_async_commit();
      gather((kc + 1) * W_BK);
      cpd::cp_async_wait<1>();
    } else {
      cpd::cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's U landed and its V is written
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const int p = warp * 2 + pp;
      const bf16* tV = sV + cur * W_STAGE_V + p * W_BT * W_LDV;
      const bf16* tU = sU + cur * W_STAGE_U + p * W_BK * W_LDU;
#pragma unroll
      for (int kk = 0; kk < W_BK / 16; ++kk) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          cpd::ldmatrix_x4(af[i], tV + (i * 16 + a_row) * W_LDV + kk * 16 + a_col);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bfr[4];
          cpd::ldmatrix_x4_trans(bfr, tU + (kk * 16 + b_row) * W_LDU + np * 16 + b_col);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            cpd::mma_16816(acc[pp][i][2 * np], af[i], bfr[0], bfr[1]);
            cpd::mma_16816(acc[pp][i][2 * np + 1], af[i], bfr[2], bfr[3]);
          }
        }
      }
    }
    // the other stage's readers finished before the previous round's last barrier
    if (more) transform_store(sV + (cur ^ 1) * W_STAGE_V);
    __syncthreads();  // this stage is overwritten in the next round
  }

  // M to shared memory (f32), then the output transform per (tile, channel pair)
  float* sM = reinterpret_cast<float*>(smem);  // [16][W_BT][W_LDM]
#pragma unroll
  for (int pp = 0; pp < 2; ++pp) {
    const int p = warp * 2 + pp;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hrow = 0; hrow < 2; ++hrow)
          *reinterpret_cast<float2*>(sM + (p * W_BT + i * 16 + g + hrow * 8) * W_LDM + j * 8 +
                                     2 * t4) =
              make_float2(acc[pp][i][j][2 * hrow], acc[pp][i][j][2 * hrow + 1]);
  }
  __syncthreads();
  for (int unit = tid; unit < W_BT * (W_BN / 2); unit += W_THREADS) {
    const int tl = unit / (W_BN / 2);
    const int cp = (unit - tl * (W_BN / 2)) * 2;
    const int n = n0 + cp;
    if (t0 + tl >= s.T || n >= s.Co) continue;
    float m0[16], m1[16], y0[4], y1[4];
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const float2 mv = *reinterpret_cast<const float2*>(sM + (p * W_BT + tl) * W_LDM + cp);
      m0[p] = mv.x;
      m1[p] = mv.y;
    }
    output_transform(m0, y0);
    output_transform(m1, y1);
    const float b0 = bias[n], b1 = bias[n + 1];
    const TilePos tp = tile_pos(t0 + tl, s);
    bf16* dst = y + (((long long)tp.b * s.H + 2 * tp.ti) * s.W + 2 * tp.tj) * s.Co + n;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb)
        *reinterpret_cast<uint32_t*>(dst + ((long long)a * s.W + bb) * s.Co) =
            cpd::pack_bf16(y0[a * 2 + bb] + b0, y1[a * 2 + bb] + b1);
  }
}

// ---- f32: CUDA-core FMAs ----

constexpr int WF_BT = 16;        // tiles per block
constexpr int WF_BN = 64;        // output channels per block
constexpr int WF_BK = 16;        // input channels per chunk
constexpr int WF_THREADS = 256;  // 16 positions x (4 tile groups x 4 channel groups)
constexpr int WF_LDV = WF_BK + 1;
constexpr int WF_LDM = WF_BN + 4;
constexpr int WF_V = 16 * WF_BT * WF_LDV;  // floats
constexpr int WF_U = 16 * WF_BK * WF_BN;
constexpr int WF_SMEM = (WF_V + WF_U) * (int)sizeof(float);
static_assert(16 * WF_BT * WF_LDM <= WF_V + WF_U, "the M tile reuses the staging space");

__global__ void __launch_bounds__(WF_THREADS)
wino3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ u,
                   const float* __restrict__ bias, float* __restrict__ y, WShape s) {
  extern __shared__ __align__(16) float fsm[];
  float* sV = fsm;         // [16][WF_BT][WF_LDV]
  float* sU = fsm + WF_V;  // [16][WF_BK][WF_BN]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * WF_BN;
  const int t0 = blockIdx.y * WF_BT;
  const int kchunks = (s.C + WF_BK - 1) / WF_BK;

  // gather role: the patch of tile gt for channel gc (consecutive threads
  // read consecutive channels)
  const int gt = tid >> 4;
  const int gc = tid & 15;
  const bool t_ok = t0 + gt < s.T;
  const TilePos gp = tile_pos(t_ok ? t0 + gt : 0, s);
  const int h0 = 2 * gp.ti - 1, w0 = 2 * gp.tj - 1;
  const float* xb = x + (long long)gp.b * s.H * s.W * s.C;

  // product role: position p, tiles tq*4 .. +3, channels m*16 + cq*4 .. +3
  const int p = tid >> 4;
  const int tq = (tid >> 2) & 3;
  const int cq = tid & 3;
  float acc[4][4][4];  // [tile][m][channel]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][m][e] = 0.f;

  for (int kc = 0; kc < kchunks; ++kc) {
    const int c0 = kc * WF_BK;
    __syncthreads();  // the previous chunk's readers are done
    {
      const int c = c0 + gc;
      const bool c_ok = t_ok && c < s.C;
      float d[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int hi = h0 + k, wi = w0 + l;
          const bool ok = c_ok && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
          d[k][l] = ok ? xb[((long long)hi * s.W + wi) * s.C + c] : 0.f;
        }
      input_transform(d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sV[((i * 4 + j) * WF_BT + gt) * WF_LDV + gc] = d[i][j];
    }
    for (int idx = tid; idx < 16 * WF_BK * (WF_BN / 4); idx += WF_THREADS) {
      const int cc = (idx % (WF_BN / 4)) * 4;
      const int r = (idx / (WF_BN / 4)) % WF_BK;
      const int pu = idx / ((WF_BN / 4) * WF_BK);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + r < s.C && n0 + cc < s.Co)  // Co % 4 == 0
        val = *reinterpret_cast<const float4*>(u + ((long long)pu * s.C + c0 + r) * s.Co + n0 +
                                               cc);
      *reinterpret_cast<float4*>(sU + (pu * WF_BK + r) * WF_BN + cc) = val;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WF_BK; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sV[(p * WF_BT + tq * 4 + i) * WF_LDV + k];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 bv =
            *reinterpret_cast<const float4*>(sU + (p * WF_BK + k) * WF_BN + m * 16 + cq * 4);
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][m][e] = fmaf(a[i], bb[e], acc[i][m][e]);
      }
    }
  }

  __syncthreads();
  float* sM = fsm;  // [16][WF_BT][WF_LDM]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      *reinterpret_cast<float4*>(sM + (p * WF_BT + tq * 4 + i) * WF_LDM + m * 16 + cq * 4) =
          make_float4(acc[i][m][0], acc[i][m][1], acc[i][m][2], acc[i][m][3]);
  __syncthreads();
  for (int unit = tid; unit < WF_BT * WF_BN; unit += WF_THREADS) {
    const int tl = unit / WF_BN;
    const int cn = unit - tl * WF_BN;
    const int n = n0 + cn;
    if (t0 + tl >= s.T || n >= s.Co) continue;
    float mm[16], yy[4];
#pragma unroll
    for (int pp = 0; pp < 16; ++pp) mm[pp] = sM[(pp * WF_BT + tl) * WF_LDM + cn];
    output_transform(mm, yy);
    const float bn = bias[n];
    const TilePos tp = tile_pos(t0 + tl, s);
    float* dst = y + (((long long)tp.b * s.H + 2 * tp.ti) * s.W + 2 * tp.tj) * s.Co + n;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) dst[((long long)a * s.W + bb) * s.Co] = yy[a * 2 + bb] + bn;
  }
}

bool shape_ok(int B, int H, int W, int C, int Co) {
  return B > 0 && C > 0 && Co > 0 && H >= 2 && W >= 2 && H % 2 == 0 && W % 2 == 0 &&
         (long long)B * H * W < (1LL << 31);
}

}  // namespace

// x: [B, H, W, C], u: [16, C, Co] (U = G g G^T, position i*4+j major), y:
// [B, H, W, Co], all bf16 and contiguous, 16-byte aligned, C % 8 == 0 and
// Co % 8 == 0; bias: [Co] f32.
extern "C" int cpd_wino3x3_bf16(const void* x, const void* u, const void* bias, void* y, int B,
                                int H, int W, int C, int Co, void* stream) {
  if (!shape_ok(B, H, W, C, Co) || C % 8 != 0 || Co % 8 != 0) return (int)cudaErrorInvalidValue;
  const WShape s{H, W, C, Co, H / 2, W / 2, B * (H / 2) * (W / 2)};
  cudaError_t err = cudaFuncSetAttribute(wino3x3_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Co + W_BN - 1) / W_BN, (s.T + W_BT - 1) / W_BT);
  wino3x3_bf16_kernel<<<grid, W_THREADS, W_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(u), static_cast<const float*>(bias),
      static_cast<bf16*>(y), s);
  return (int)cudaGetLastError();
}

// The same in f32 (Co % 4 == 0, any C).
extern "C" int cpd_wino3x3_f32(const void* x, const void* u, const void* bias, void* y, int B,
                               int H, int W, int C, int Co, void* stream) {
  if (!shape_ok(B, H, W, C, Co) || Co % 4 != 0) return (int)cudaErrorInvalidValue;
  const WShape s{H, W, C, Co, H / 2, W / 2, B * (H / 2) * (W / 2)};
  cudaError_t err = cudaFuncSetAttribute(wino3x3_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WF_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Co + WF_BN - 1) / WF_BN, (s.T + WF_BT - 1) / WF_BT);
  wino3x3_f32_kernel<<<grid, WF_THREADS, WF_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(bias), static_cast<float*>(y), s);
  return (int)cudaGetLastError();
}
