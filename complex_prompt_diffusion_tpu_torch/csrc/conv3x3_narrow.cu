// K4's narrow bodies: 3x3 stride-1 'same' convolution, y = conv3x3(x, w) + b,
// bf16 or f32 in and out, for the convs whose output or input is a few
// channels wide.
//
// Replaces the TPU kernel complex_prompt_diffusion_tpu/ops/conv.py::_kernel
// (nine shifted [M, C] x [C, Co] matmuls, f32 accumulation, the bias added in
// f32, one rounding) at the widths ops/conv.py routes here (k4_body
// "narrow"): Co <= 8 (the UNet's out conv, Co = 4; the VAE encoder's conv_out,
// Co = 8) and C <= 16 (the UNet's conv_in, C = 4, 5 or 9; the VAE decoder's
// conv_in, C = 4), inside the JAX gate (batch <= 4 on 16^2..32^2 planes). The
// body it replaced at these widths, csrc/conv3x3.cu (an implicit GEMM of
// 64 x 64 output tiles), stays built for the other widths it takes and
// is timed beside this one. Rounding is the TPU kernel's in both dtypes:
// exact products (bf16 x bf16 is exact in f32; f32 by FMAs, no TF32)
// accumulated in f32, the bias added in f32 at the end, one rounding.
//
// Layouts: x NHWC [B, H, W, C]; the weight a row-major [Co, 9C] matrix with
// column (dy * 3 + dx) * C + c (the port's [Co, C, 3, 3] weight in
// channels_last memory); y NHWC [B, H, W, Co].
//
// What bounds them on the H100: bytes. 2 M Co 9C flops are a few MFLOP
// (B2 16^2 320->4: 11.8 MFLOP, 0.2 us at the f32 FMA rate) against the
// plane read once (B2 16^2 x 320 f32: 0.66 MB, 0.2 us at 3.35 TB/s) or the
// output written once (B2 32^2 x 320 bf16: 1.3 MB, 0.4 us); at these sizes a
// launch and one pass of latencies set the time. The replaced body tiled the
// output 64 x 64: at Co = 4 that is 8 blocks on 132 SMs, each walking K = 2880
// in 180 steps with 60 of its 64 columns padding (f32 B2 16^2 320->4: 0.1760
// ms against cuDNN's 0.0770; this body 0.0059, PERF.md section 6). Design:
//   * Narrow Co (conv3x3_narrow_co_kernel): a block takes PX output pixels
//     (2 or 4; the host picks 4 where that still gives two blocks an SM) and
//     all Co (a tile as narrow as Co: CO = 4 or 8 accumulators a pixel).
//     The K = 9C reduction is cut into segments of one tap and 32 x VEC
//     channels (VEC: one 16-byte vector a lane); the block's 8 warps take
//     the segments in turn, each lane FMAs its VEC channels of the PX
//     pixels against the Co weight rows (read from L1: every block reads
//     the same few KB), a warp's lanes then fold by a shuffle tree, and the
//     warps' partials are summed in warp order in shared memory: K is split
//     over 8 warps x M / PX blocks (256 or more blocks at every shape the
//     paths launch) with a fixed order, so repeats give the same bits, and x
//     is read with 16-byte loads along its channels (9 taps from L1/L2: the
//     plane is at most 4 MB).
//   * Narrow C (conv3x3_narrow_c_kernel): a block takes 32 pixels (TH rows of
//     TW = 32, 16 or 8) by 64 output channels, 128 threads. Its (TH + 2) x
//     (TW + 2) x C neighbourhood of x (zero outside the plane) is read once
//     into shared memory as f32, transposed so that a row of pixels of one
//     channel is contiguous, and the block's 64 rows of the weight, 9C x 64
//     f32, stay resident there; the loads of both go out 18 a thread before
//     their stores (a loop of load, then store, paid a round trip each).
//     Each thread holds 4 pixels x 4 output channels: for each (dy, c) two
//     vector loads bring its 4 pixels' x and their halo, and the three dx
//     taps' 4-channel weight vectors make 48 FMAs of them, where one
//     channel pair a thread had made shared-memory loads the limit (a
//     quarter of the FMAs). y goes out 4 channels a store along Co.

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CO_WARPS = 8;   // warps of a narrow-Co block
constexpr int C_THREADS = 128;  // threads of a narrow-C block
constexpr int C_CO = 64;         // its output channels
constexpr int C_PX = 32;         // its pixels: TH rows of TW
constexpr int C_LDW = C_CO + 4;  // its weight rows in shared memory (16-byte aligned)
constexpr int C_BATCH = 18;      // loads a thread has in flight while it stages
constexpr int MAX_NARROW_C = 16;

// VEC consecutive elements at p (VEC * sizeof(T) bytes, aligned to that
// when VEC > 1) as f32
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = cpd::to_f32(*p);
  } else if constexpr (sizeof(T) == 2) {
    static_assert(VEC == 8, "bf16 vectors are 8 wide");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    static_assert(VEC == 4, "f32 vectors are 4 wide");
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  }
}

// Narrow Co: block blockIdx.x takes output pixels PX blockIdx.x .. + PX - 1
// (flattened over B, H, W) and all Co <= CO channels; warp w the K segments
// w, w + 8, .. (segment s: tap s / segs, channels (s % segs) 32 VEC + VEC
// lane ..).
template <typename T, typename BiasT, int CO, int PX, int VEC>
__global__ void __launch_bounds__(CO_WARPS * 32)
conv3x3_narrow_co_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                         const BiasT* __restrict__ bias, T* __restrict__ y, int M, int H, int W,
                         int C, int Co) {
  __shared__ float red[CO_WARPS][PX][CO];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = H * W;
  const long long K = 9LL * C;
  int pb[PX], ph[PX], pw[PX];
  bool pok[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int m = blockIdx.x * PX + p;
    pok[p] = m < M;
    const int mm = pok[p] ? m : 0;
    pb[p] = mm / hw;
    ph[p] = (mm - pb[p] * hw) / W;
    pw[p] = mm - pb[p] * hw - ph[p] * W;
  }
  float acc[PX][CO];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[p][o] = 0.f;
  const int segs = (C + 32 * VEC - 1) / (32 * VEC);
  for (int s = warp; s < 9 * segs; s += CO_WARPS) {
    const int tap = s / segs;
    const int c = (s - tap * segs) * 32 * VEC + lane * VEC;
    if (c >= C) continue;
    const int dy = tap / 3 - 1, dx = tap - (tap / 3) * 3 - 1;
    float xv[PX][VEC];
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int hi = ph[p] + dy, wi = pw[p] + dx;
      if (pok[p] && hi >= 0 && hi < H && wi >= 0 && wi < W) {
        load_vec<T, VEC>(x + (((long long)pb[p] * H + hi) * W + wi) * C + c, xv[p]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) xv[p][v] = 0.f;
      }
    }
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      if (o >= Co) break;
      float wv[VEC];
      load_vec<T, VEC>(wt + o * K + (long long)tap * C + c, wv);
#pragma unroll
      for (int p = 0; p < PX; ++p)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[p][o] = fmaf(xv[p][v], wv[v], acc[p][o]);
    }
  }
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      const float v = cpd::warp_sum(acc[p][o]);
      if (lane == 0) red[warp][p][o] = v;
    }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < PX * CO) {
    const int p = t / CO, o = t - p * CO;
    if (o < Co && (long long)blockIdx.x * PX + p < M) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < CO_WARPS; ++w) v += red[w][p][o];
      v += cpd::to_f32(bias[o]);
      y[((long long)blockIdx.x * PX + p) * Co + o] = cpd::from_f32<T>(v);
    }
  }
}

// Narrow C: block (blockIdx.x, blockIdx.y) takes output channels 64
// blockIdx.x .. + 63 of the TH x TW pixel tile blockIdx.y (32 pixels: b,
// rows h0 .. h0 + TH - 1, columns w0 ..); thread t the 4 channels n0 + 4 (t
// % 16) .. + 3 of the tile's 4 pixels 4 (t / 16) .. + 3 in row-major order
// (one row: TW is a multiple of 4).
template <typename T, typename BiasT, int TW>
__global__ void __launch_bounds__(C_THREADS)
conv3x3_narrow_c_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                        const BiasT* __restrict__ bias, T* __restrict__ y, int H, int W, int C,
                        int Co) {
  constexpr int TH = C_PX / TW;
  constexpr int XW = TW + 4;  // a row of the neighbourhood: TW + 2 pixels, padded to 16 bytes
  extern __shared__ __align__(16) float sm[];
  const int K = 9 * C;
  float* sW = sm;              // [9C][C_LDW]: weight column k of channel n0 + co at k C_LDW + co
  float* sX = sm + K * C_LDW;  // [TH + 2][C][XW]: x at (h0 - 1 + row, w0 - 1 + col, c)
  const int n0 = blockIdx.x * C_CO;
  const int segs = (W + TW - 1) / TW, hts = (H + TH - 1) / TH;
  int r = blockIdx.y;
  const int sg = r % segs;
  r /= segs;
  const int h0 = (r % hts) * TH, b = r / hts;
  const int w0 = sg * TW;
  // The block's weights (64 rows of 9C: one contiguous span) and
  // neighbourhood, C_BATCH loads a thread in flight before their stores.
  // Quotients by K, by a row and by C as f32 products by the reciprocal:
  // exact here (numerators below 2^14, the nearest boundary 1 / (2 K) away)
  const int row = (TW + 2) * C, nw = C_CO * K, nx = (TH + 2) * row;
  const float rK = 1.f / (float)K, rRow = 1.f / (float)row, rC = 1.f / (float)C;
  const T* wb = wt + (long long)n0 * K;
  const int wvalid = min(C_CO, Co - n0) * K;
  for (int e0 = threadIdx.x; e0 < nw; e0 += C_BATCH * C_THREADS) {
    float v[C_BATCH];
#pragma unroll
    for (int j = 0; j < C_BATCH; ++j) {
      const int e = e0 + j * C_THREADS;
      v[j] = e < wvalid ? cpd::to_f32(wb[e]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < C_BATCH; ++j) {
      const int e = e0 + j * C_THREADS;
      const int co = (int)(((float)e + 0.5f) * rK), k = e - co * K;
      if (e < nw) sW[k * C_LDW + co] = v[j];
    }
  }
  for (int e0 = threadIdx.x; e0 < nx; e0 += C_BATCH * C_THREADS) {
    float v[C_BATCH];
    int at[C_BATCH];
#pragma unroll
    for (int j = 0; j < C_BATCH; ++j) {
      const int e = e0 + j * C_THREADS;
      const int dy = (int)(((float)e + 0.5f) * rRow), rem = e - dy * row;
      const int col = (int)(((float)rem + 0.5f) * rC), c = rem - col * C;
      const int hi = h0 + dy - 1, wi = w0 + col - 1;
      v[j] = e < nx && hi >= 0 && hi < H && wi >= 0 && wi < W
                 ? cpd::to_f32(x[(((long long)b * H + hi) * W + wi) * C + c])
                 : 0.f;
      at[j] = (dy * C + c) * XW + col;
    }
#pragma unroll
    for (int j = 0; j < C_BATCH; ++j)
      if (e0 + j * C_THREADS < nx) sX[at[j]] = v[j];
  }
  __syncthreads();
  const int cq = threadIdx.x & 15, pg = threadIdx.x >> 4;
  const int gr = 4 * pg / TW, gc = 4 * pg - gr * TW;  // the thread's row and first column
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  // each (dy, c): the 6 x values of the thread's 4 pixels and their halo
  // (two loads) serve the three dx taps' 4 x 4 products
  for (int dy = 0; dy < 3; ++dy) {
    const float* xr = sX + (gr + dy) * C * XW + gc;
    const float* wr = sW + dy * 3 * C * C_LDW + 4 * cq;
    for (int c = 0; c < C; ++c) {
      const float4 xa = *reinterpret_cast<const float4*>(xr + c * XW);
      const float2 xb = *reinterpret_cast<const float2*>(xr + c * XW + 4);
      const float xs[6] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y};
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4 w4 = *reinterpret_cast<const float4*>(wr + (dx * C + c) * C_LDW);
        const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(xs[p + dx], wq[q], acc[p][q]);
      }
    }
  }
  const int n = n0 + 4 * cq, h = h0 + gr;
  if (n >= Co || h >= H) return;
  float bq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bq[q] = n + q < Co ? cpd::to_f32(bias[n + q]) : 0.f;
  const bool four = n + 3 < Co && Co % 4 == 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int wi = w0 + gc + p;
    if (wi >= W) continue;
    T* dst = y + (((long long)b * H + h) * W + wi) * Co + n;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = acc[p][q] + bq[q];
    if (four) {  // the 4 channels as one 8- or 16-byte store
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint2*>(dst) = make_uint2(cpd::pack_bf16(v[0], v[1]),
                                                    cpd::pack_bf16(v[2], v[3]));
      else
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (n + q < Co) dst[q] = cpd::from_f32<T>(v[q]);
    }
  }
}

template <typename T, typename BiasT, int CO, int PX>
int launch_co(const T* x, const T* w, const BiasT* bias, T* y, int M, int H, int W, int C,
              int Co, cudaStream_t st) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const dim3 grid((M + PX - 1) / PX);
  const bool vec = C % VEC == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16) == 0;
  if (vec)
    conv3x3_narrow_co_kernel<T, BiasT, CO, PX, VEC><<<grid, CO_WARPS * 32, 0, st>>>(
        x, w, bias, y, M, H, W, C, Co);
  else
    conv3x3_narrow_co_kernel<T, BiasT, CO, PX, 1><<<grid, CO_WARPS * 32, 0, st>>>(
        x, w, bias, y, M, H, W, C, Co);
  return (int)cudaGetLastError();
}

template <typename T, typename BiasT, int TW>
int launch_c(const T* x, const T* w, const BiasT* bias, T* y, int B, int H, int W, int C, int Co,
             cudaStream_t st) {
  constexpr int TH = C_PX / TW, XW = TW + 4;
  const int smem = (9 * C * C_LDW + (TH + 2) * C * XW) * (int)sizeof(float);
  const long long tiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((Co + C_CO - 1) / C_CO, (unsigned)tiles);
  conv3x3_narrow_c_kernel<T, BiasT, TW><<<grid, C_THREADS, smem, st>>>(x, w, bias, y, H, W, C,
                                                                       Co);
  return (int)cudaGetLastError();
}

template <typename T, typename BiasT>
int launch(const void* xv, const void* wv, const void* bv, void* yv, int B, int H, int W, int C,
           int Co, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const BiasT* bias = static_cast<const BiasT*>(bv);
  T* y = static_cast<T*>(yv);
  const int M = B * H * W;
  if (Co <= 8) {
    // four pixels a block where that leaves two blocks an SM, else two
    const bool four = M / 4 >= 2 * 132;
    if (Co <= 4)
      return four ? launch_co<T, BiasT, 4, 4>(x, w, bias, y, M, H, W, C, Co, st)
                  : launch_co<T, BiasT, 4, 2>(x, w, bias, y, M, H, W, C, Co, st);
    return four ? launch_co<T, BiasT, 8, 4>(x, w, bias, y, M, H, W, C, Co, st)
                : launch_co<T, BiasT, 8, 2>(x, w, bias, y, M, H, W, C, Co, st);
  }
  if (W >= 32) return launch_c<T, BiasT, 32>(x, w, bias, y, B, H, W, C, Co, st);
  if (W >= 16) return launch_c<T, BiasT, 16>(x, w, bias, y, B, H, W, C, Co, st);
  return launch_c<T, BiasT, 8>(x, w, bias, y, B, H, W, C, Co, st);
}

}  // namespace

// x: [B, H, W, C], w: [Co, 3, 3, C] (row-major [Co, 9C]) and y: [B, H, W,
// Co], f32 if is_f32 else bf16; bias: [Co] f32 when bias_is_f32 (always for
// f32), else bf16. All contiguous. Co <= 8 (narrow Co) or C <= 16 (narrow
// C); anything else is refused. One launch.
extern "C" int cpd_conv3x3_narrow(const void* x, const void* w, const void* bias, int bias_is_f32,
                                  int is_f32, void* y, int B, int H, int W, int C, int Co,
                                  void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || (Co > 8 && C > MAX_NARROW_C) ||
      (long long)B * H * W >= (1LL << 31) || (is_f32 && !bias_is_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) return launch<float, float>(x, w, bias, y, B, H, W, C, Co, st);
  return bias_is_f32 ? launch<bf16, float>(x, w, bias, y, B, H, W, C, Co, st)
                     : launch<bf16, bf16>(x, w, bias, y, B, H, W, C, Co, st);
}
