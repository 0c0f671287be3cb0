// K1: non-causal softmax attention, out = softmax(scale * Q K^T) V: the
// bf16 body for 256 < d <= 512 and the f32 body.
//
// Replaces the TPU kernel complex_prompt_diffusion_tpu/ops/attention.py::
// _attn_kernel (streaming kernel; the VAE mid-block, one head, d = 512,
// S = 4096: f32 in the exact decode, bf16 in the bf16 decode and encode).
// bf16 with d <= 256 (the UNet self-attention, _onepass_kernel) runs the
// TMA + wgmma body in attention_sm90.cu; the mma.sync body for those
// head dims (attention_bf16.cuh) is launched only by the probe K7.
//
// Operands are read straight from the [B, S, H*D] layout the port's
// attention() receives (any batch/row stride, unit column stride), so no
// head split or transpose is materialised; the output is a fresh
// contiguous [B, Sq, H*D].
//
// Design: FlashAttention-2 style tiling with an online softmax (running max
// m, running sum l, f32 accumulator O that is rescaled by exp2(m_old -
// m_new) at each KV tile).
//   * bf16 with 256 < d <= 512 (the bf16 VAE mid-block): the head dim is
//     split across 8 warps; see attention_bf16_wide_kernel below.
//   * f32 (the exact VAE decode): no TF32 — CUDA-core FMAs, tiled like an
//     SGEMM. 256 threads, 64 query rows x 64 keys per tile; each thread
//     computes a 4x4 block of S from float4 reads of Q^T and K^T (so 16
//     FMAs per two shared-memory loads) and keeps 4 rows x 32 columns of O
//     in registers (d <= 512). Q^T stays in shared memory for the block's
//     life; K and V are staged in head-dim slices.
// Not yet for these two: wgmma, TMA, warp specialisation.
//
// The f32 kernel lives in attention_f32.cuh, which the probe kernel K7
// (probe_attention.cu) also instantiates with pieces of the work removed;
// attention_bf16.cuh provides the tile loader the wide kernel shares.

#include "attention_bf16.cuh"
#include "attention_f32.cuh"

namespace {

// ---- bf16, 256 < d <= 512: the VAE mid-block (one head, d = 512) ----
//
// The d <= 256 kernel keeps one warp's 16 rows of S, P and O in registers;
// at d = 512 a 64-row f32 O tile is 128 KB and a 64-key K or V tile 64 KB,
// so that design does not carry over. Here the head dim is split across
// warps: 8 warps share a 64-row query tile and each owns a 64-column slice
// of O (64 x 64 f32 = 128 accumulators a thread). Per 32-key KV tile:
//   1. S = Q K^T once for the block: warp w computes the 16 x 16 piece
//      (rows 16 (w % 4), keys 16 (w / 4)) over all of d and writes it,
//      scaled and masked, to shared memory (f32);
//   2. four threads per row update the running max and sum, write P (bf16)
//      and the rescale factor alpha to shared memory;
//   3. every warp rescales its O slice by alpha and adds P V[:, slice],
//      with P as the ldmatrix A operand and V through ldmatrix.trans.
// The whole Q tile (66.5 KB) stays in shared memory and 32-key K/V tiles
// are double-buffered with cp.async (4 x 33 KB): 214.5 KB of the 227 KB a
// block may use, so one block per SM. 32-key tiles (not 64) are what keeps
// the double buffers inside that budget. The score step reuses each
// ldmatrix fragment for only two MMAs, so it is bound by shared-memory
// bandwidth rather than by the tensor cores; wgmma, which reads its
// operands from shared memory itself, is the next step.
constexpr int kWM = 64;         // query rows per block
constexpr int kWN = 32;         // keys per KV tile
constexpr int kWThreads = 256;  // 8 warps
constexpr int kWD = 512;        // padded head dim
constexpr int kWLd = kWD + 8;   // Q/K/V row in shared memory
constexpr int kWLdS = kWN + 4;  // f32 score row
constexpr int kWLdP = kWN + 8;  // bf16 probability row
constexpr int kWSmem = (kWM + 4 * kWN) * kWLd * (int)sizeof(bf16) +
                       kWM * kWLdS * (int)sizeof(float) + kWM * kWLdP * (int)sizeof(bf16) +
                       kWM * (int)sizeof(float);

__global__ void __launch_bounds__(kWThreads, 1)
attention_bf16_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Sq,
                           int Skv, int D, long long qbs, long long qrs, long long kbs,
                           long long krs, long long vbs, long long vrs, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);                    // [kWM][kWLd]
  bf16* sK = sQ + kWM * kWLd;                                  // [2][kWN][kWLd]
  bf16* sV = sK + 2 * kWN * kWLd;                              // [2][kWN][kWLd]
  float* sS = reinterpret_cast<float*>(sV + 2 * kWN * kWLd);   // [kWM][kWLdS]
  bf16* sP = reinterpret_cast<bf16*>(sS + kWM * kWLdS);        // [kWM][kWLdP]
  float* sAlpha = reinterpret_cast<float*>(sP + kWM * kWLdP);  // [kWM]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kWM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bf16* qb = q + b * qbs + (long long)h * D;
  const bf16* kb = k + b * kbs + (long long)h * D;
  const bf16* vb = v + b * vbs + (long long)h * D;
  const int ntiles = (Skv + kWN - 1) / kWN;
  const int dk = (D + 15) / 16;  // 16-wide steps of the score product

  load_tile_async<kWD, kWLd, kWThreads>(sQ, qb, qrs, q0, Sq, D, kWM);
  cpd::cp_async_commit();
  load_tile_async<kWD, kWLd, kWThreads>(sK, kb, krs, 0, Skv, D, kWN);
  load_tile_async<kWD, kWLd, kWThreads>(sV, vb, vrs, 0, Skv, D, kWN);
  cpd::cp_async_commit();

  // step 1: this warp's 16 x 16 piece of S
  const int smi = warp & 3;
  const int snh = warp >> 2;
  const int a_row = smi * 16 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = snh * 16 + ((lane >> 4) << 3) + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 8;
  // step 2: this thread's row and 8 keys; the running max and sum are kept
  // (identically) by the 4 threads of a row
  const int srow = threadIdx.x >> 2;
  const int spart = threadIdx.x & 3;
  float m_run = -INFINITY, l_run = 0.f;
  // step 3: this warp's O columns
  const int dcol0 = warp * 64;
  const int v_row = (((lane >> 3) & 1) << 3) + (lane & 7);
  const int v_col = (lane >> 4) * 8;
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntiles) {
      const int nb = buf ^ 1;
      load_tile_async<kWD, kWLd, kWThreads>(sK + nb * kWN * kWLd, kb, krs, (j + 1) * kWN, Skv,
                                            D, kWN);
      load_tile_async<kWD, kWLd, kWThreads>(sV + nb * kWN * kWLd, vb, vrs, (j + 1) * kWN, Skv,
                                            D, kWN);
      cpd::cp_async_commit();
      cpd::cp_async_wait<1>();
    } else {
      cpd::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + buf * kWN * kWLd;
    const bf16* tV = sV + buf * kWN * kWLd;

    // 1. S piece over all of d
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int kk = 0; kk < dk; ++kk) {
      uint32_t qa[4], kf[4];
      cpd::ldmatrix_x4(qa, sQ + a_row * kWLd + kk * 16 + a_col);
      cpd::ldmatrix_x4(kf, tK + b_row * kWLd + kk * 16 + b_col);
      cpd::mma_16816(s[0], qa, kf[0], kf[1]);
      cpd::mma_16816(s[1], qa, kf[2], kf[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = snh * 16 + n * 8 + 2 * t4;
      const int key = j * kWN + col;
      const int r = smi * 16 + g;
      const bool ok0 = key < Skv, ok1 = key + 1 < Skv;
      *reinterpret_cast<float2*>(sS + r * kWLdS + col) =
          make_float2(ok0 ? s[n][0] * scale_log2 : -INFINITY,
                      ok1 ? s[n][1] * scale_log2 : -INFINITY);
      *reinterpret_cast<float2*>(sS + (r + 8) * kWLdS + col) =
          make_float2(ok0 ? s[n][2] * scale_log2 : -INFINITY,
                      ok1 ? s[n][3] * scale_log2 : -INFINITY);
    }
    __syncthreads();

    // 2. online softmax: row srow, keys spart * 8 ..
    {
      const float4 lo = *reinterpret_cast<const float4*>(sS + srow * kWLdS + spart * 8);
      const float4 hi = *reinterpret_cast<const float4*>(sS + srow * kWLdS + spart * 8 + 4);
      float sv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      float mx = m_run;
#pragma unroll
      for (int e = 0; e < 8; ++e) mx = fmaxf(mx, sv[e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m_run - mx);
      float ps = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sv[e] = exp2f(sv[e] - mx);
        ps += sv[e];
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l_run = l_run * alpha + ps;
      m_run = mx;
      uint4 pk;
      pk.x = cpd::pack_bf16(sv[0], sv[1]);
      pk.y = cpd::pack_bf16(sv[2], sv[3]);
      pk.z = cpd::pack_bf16(sv[4], sv[5]);
      pk.w = cpd::pack_bf16(sv[6], sv[7]);
      *reinterpret_cast<uint4*>(sP + srow * kWLdP + spart * 8) = pk;
      if (spart == 0) sAlpha[srow] = alpha;
    }
    __syncthreads();

    // 3. O[:, slice] = alpha O[:, slice] + P V[:, slice]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a0 = sAlpha[i * 16 + g];
      const float a1 = sAlpha[i * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[i][n][0] *= a0;
        acc[i][n][1] *= a0;
        acc[i][n][2] *= a1;
        acc[i][n][3] *= a1;
      }
    }
    if (dcol0 < D) {
#pragma unroll
      for (int kk = 0; kk < kWN / 16; ++kk) {
        uint32_t vf[4][4];
#pragma unroll
        for (int np = 0; np < 4; ++np)
          cpd::ldmatrix_x4_trans(vf[np], tV + (kk * 16 + v_row) * kWLd + dcol0 + np * 16 + v_col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t pa[4];
          cpd::ldmatrix_x4(pa, sP + (i * 16 + (lane & 15)) * kWLdP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            cpd::mma_16816(acc[i][2 * np], pa, vf[np][0], vf[np][1]);
            cpd::mma_16816(acc[i][2 * np + 1], pa, vf[np][2], vf[np][3]);
          }
        }
      }
    }
    __syncthreads();  // this K/V buffer is refilled next tile; sS, sP, sAlpha too
  }

  // out = O / l
  if (spart == 0) sAlpha[srow] = 1.f / l_run;
  __syncthreads();
  const long long ors = (long long)H * D;
  bf16* ob = o + (long long)b * Sq * ors + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r0 = q0 + i * 16 + g;
    const float inv0 = sAlpha[i * 16 + g];
    const float inv1 = sAlpha[i * 16 + g + 8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = dcol0 + n * 8 + 2 * t4;
      if (col >= D) continue;
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)r0 * ors + col) =
            cpd::pack_bf16(acc[i][n][0] * inv0, acc[i][n][1] * inv0);
      if (r0 + 8 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + 8) * ors + col) =
            cpd::pack_bf16(acc[i][n][2] * inv1, acc[i][n][3] * inv1);
    }
  }
}

int launch_bf16_wide(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                     int Skv, int D, long long qbs, long long qrs, long long kbs, long long krs,
                     long long vbs, long long vrs, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kWM - 1) / kWM, B * H);
  attention_bf16_wide_kernel<<<grid, kWThreads, kWSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cpd_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                  int H, int Sq, int Skv, int D, long long qbs, long long qrs,
                                  long long kbs, long long krs, long long vbs, long long vrs,
                                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 == 0 && D > 256 && D <= kWD)
    return launch_bf16_wide(q, k, v, o, B, H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs, scale, s);
  return (int)cudaErrorInvalidValue;  // d <= 256: attention_sm90.cu
}

extern "C" int cpd_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                                 int H, int Sq, int Skv, int D, long long qbs, long long qrs,
                                 long long kbs, long long krs, long long vbs, long long vrs,
                                 float scale, void* stream) {
  return launch_f32_body<kFull>(q, k, v, o, B, H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs,
                                scale * 1.4426950408889634f, static_cast<cudaStream_t>(stream));
}
