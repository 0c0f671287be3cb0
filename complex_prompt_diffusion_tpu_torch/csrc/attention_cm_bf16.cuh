// The bf16 body of K5 (csrc/attention_cm.cu): attention over operands whose
// sequence axis is the contiguous one (the design notes are at the top of
// attention_cm.cu). attention_cm.cu instantiates the attention (MODE kFull);
// the probe kernel K7 (csrc/probe_attention.cu) instantiates MODE kScores:
// the same tile loads and score MMAs, every score tile handed to sink(), and
// sc * S[:, key 0] written on every head-dim row. Mode and sink() are those
// of attention_bf16.cuh. The code sits in namespace cm beside K1's body.
#pragma once

#include "attention_bf16.cuh"

namespace {
namespace cm {

// element strides of one operand: batch, head, and x = the head-dim stride
// (d-major) or the key-row stride (canonical K)
struct Strides {
  long long b, h, x;
};

constexpr int kB = 64;          // query rows per block, and keys per KV tile
constexpr int kThreads = 128;   // 4 warps x 16 query rows
constexpr int kLdS = kB + 8;    // row of a [d][s] tile: ldmatrix rows hit distinct banks

// Copies of a [DP][64] tile of a d-major operand (rows = head dims, columns
// = sequence positions s0 ..) into shared memory; rows >= D and positions
// >= s_valid are zero-filled.
template <int DP>
__device__ __forceinline__ void load_dmajor_async(bf16* dst, const bf16* src, long long sd,
                                                  int s0, int s_valid, int D) {
  constexpr int kChunks = kB / 8;
  for (int idx = threadIdx.x; idx < DP * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const bool ok = r < D && s0 + c < s_valid;
    cpd::cp_async16(dst + r * kLdS + c, ok ? src + (long long)r * sd + s0 + c : src, ok);
  }
}

// Copies of a [64][DP] tile of a canonical K (rows = keys row0 .., columns =
// head dims) with row stride LD; rows >= rows_valid and columns >= D are
// zero-filled.
template <int DP, int LD>
__device__ __forceinline__ void load_canon_async(bf16* dst, const bf16* src, long long rstride,
                                                 int row0, int rows_valid, int D) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < kB * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const int gr = row0 + r;
    const bool ok = gr < rows_valid && c < D;
    cpd::cp_async16(dst + r * LD + c, ok ? src + (long long)gr * rstride + c : src, ok);
  }
}

template <int DP, bool KCANON, int MODE>
__global__ void __launch_bounds__(kThreads)
attention_cm_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Sq,
                         int Skv, int D, Strides qs, Strides ks, Strides vs, Strides os,
                         float scale_log2, float* sink_ptr) {
  static_assert(MODE == kFull || MODE == kScores, "K5's body has the full and scores modes");
  constexpr int LDC = DP + 8;  // row of a canonical K tile
  constexpr int NT = DP / 8;   // n-tiles of the O accumulator
  constexpr int KT = kB / 8;   // n-tiles of the score accumulator
  constexpr int kKTile = KCANON ? kB * LDC : DP * kLdS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [DP][kLdS]; the output tile after the loop
  bf16* sK = sQ + DP * kLdS;                 // [2][kKTile]
  bf16* sV = sK + 2 * kKTile;                // [2][DP][kLdS]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int t4 = lane & 3;  // accumulator column pair
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const int ntiles = (Skv + kB - 1) / kB;

  auto load_kv = [&](int buf, int key0) {
    if constexpr (KCANON)
      load_canon_async<DP, LDC>(sK + buf * kKTile, kb, ks.x, key0, Skv, D);
    else
      load_dmajor_async<DP>(sK + buf * kKTile, kb, ks.x, key0, Skv, D);
    load_dmajor_async<DP>(sV + buf * DP * kLdS, vb, vs.x, key0, Skv, D);
  };

  load_dmajor_async<DP>(sQ, qb, qs.x, q0, Sq, D);
  cpd::cp_async_commit();
  load_kv(0, 0);
  cpd::cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the running sums
  float key0_0 = 0.f, key0_1 = 0.f;      // sc * S[row, key 0] (the scores mode)

  // ldmatrix lane addressing. "t": a tile stored [k][m] or [k][n] (the
  // contraction index on rows), read with .trans; "n": stored [n][k].
  const int at_row = (lane & 7) + ((lane >> 4) << 3);  // Q as A: k (head dim) row
  const int at_col = warp * 16 + ((lane >> 3) & 1) * 8;  //         m (query) column
  const int bt_row = (((lane >> 3) & 1) << 3) + (lane & 7);  // d-major K as B: k row
  const int bt_col = (lane >> 4) * 8;                        //                 n column
  const int bn_row = ((lane >> 4) << 3) + (lane & 7);  // canonical K, and V: n row
  const int bn_col = ((lane >> 3) & 1) * 8;            //                     k column

  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntiles) {
      load_kv(buf ^ 1, (j + 1) * kB);
      cpd::cp_async_commit();
      cpd::cp_async_wait<1>();
    } else {
      cpd::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + buf * kKTile;
    const bf16* tV = sV + buf * DP * kLdS;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[KT][4];
#pragma unroll
    for (int i = 0; i < KT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t qa[4];
      cpd::ldmatrix_x4_trans(qa, sQ + (kk * 16 + at_row) * kLdS + at_col);
#pragma unroll
      for (int np = 0; np < KT / 2; ++np) {
        uint32_t kf[4];
        if constexpr (KCANON)
          cpd::ldmatrix_x4(kf, tK + (np * 16 + bn_row) * LDC + kk * 16 + bn_col);
        else
          cpd::ldmatrix_x4_trans(kf, tK + (kk * 16 + bt_row) * kLdS + np * 16 + bt_col);
        cpd::mma_16816(s[2 * np], qa, kf[0], kf[1]);
        cpd::mma_16816(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    if constexpr (MODE == kScores) {
      if (j == 0) {  // key 0: column 0 of n-tile 0, held by t4 == 0
        key0_0 = s[0][0] * scale_log2;
        key0_1 = s[0][2] * scale_log2;
      }
      sink(s, sink_ptr);
      __syncthreads();  // this buffer is refilled two tiles later
      continue;
    }

    // online softmax in registers (rows g and g + 8 of this warp)
    const int key0 = j * kB + 2 * t4;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = key0 + i * 8 + e < Skv;
        s[i][e] = ok ? s[i][e] * scale_log2 : -INFINITY;
        s[i][2 + e] = ok ? s[i][2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[i][e]);
        mx1 = fmaxf(mx1, s[i][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0);
    const float alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
    uint32_t pa[KT / 2][4];  // P as the A operand of the PV product
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const float p0 = exp2f(s[i][0] - mx0);
      const float p1 = exp2f(s[i][1] - mx0);
      const float p2 = exp2f(s[i][2] - mx1);
      const float p3 = exp2f(s[i][3] - mx1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pa[i / 2][(i & 1) * 2 + 0] = cpd::pack_bf16(p0, p1);
      pa[i / 2][(i & 1) * 2 + 1] = cpd::pack_bf16(p2, p3);
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      acc[i][0] *= alpha0;
      acc[i][1] *= alpha0;
      acc[i][2] *= alpha1;
      acc[i][3] *= alpha1;
    }

    // O += P V: the V tile [d][key] is [n][k]
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vf[4];
        cpd::ldmatrix_x4(vf, tV + (np * 16 + bn_row) * kLdS + kk * 16 + bn_col);
        cpd::mma_16816(acc[2 * np], pa[kk], vf[0], vf[1]);
        cpd::mma_16816(acc[2 * np + 1], pa[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles later
  }

  // out = O / l, with l summed over the quad that shares a row; transposed
  // through shared memory (the Q tile is no longer read) to [d][query]
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  bf16* sO = sQ;
  const int qr = warp * 16 + g;
  if constexpr (MODE == kScores) {
    const float w0 = __shfl_sync(0xffffffffu, key0_0, lane & ~3);
    const float w1 = __shfl_sync(0xffffffffu, key0_1, lane & ~3);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int dd = i * 8 + 2 * t4;
      sO[dd * kLdS + qr] = __float2bfloat16(w0);
      sO[(dd + 1) * kLdS + qr] = __float2bfloat16(w0);
      sO[dd * kLdS + qr + 8] = __float2bfloat16(w1);
      sO[(dd + 1) * kLdS + qr + 8] = __float2bfloat16(w1);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int dd = i * 8 + 2 * t4;
      sO[dd * kLdS + qr] = __float2bfloat16(acc[i][0] * inv0);
      sO[(dd + 1) * kLdS + qr] = __float2bfloat16(acc[i][1] * inv0);
      sO[dd * kLdS + qr + 8] = __float2bfloat16(acc[i][2] * inv1);
      sO[(dd + 1) * kLdS + qr + 8] = __float2bfloat16(acc[i][3] * inv1);
    }
  }
  __syncthreads();
  bf16* ob = o + b * os.b + h * os.h;
  for (int idx = threadIdx.x; idx < D * (kB / 8); idx += kThreads) {
    const int r = idx / (kB / 8);
    const int c = (idx - r * (kB / 8)) * 8;
    if (q0 + c < Sq)
      *reinterpret_cast<uint4*>(ob + (long long)r * os.x + q0 + c) =
          *reinterpret_cast<const uint4*>(sO + r * kLdS + c);
  }
}

template <int DP, bool KCANON, int MODE>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                int Skv, int D, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                cudaStream_t stream) {
  const int ktile = KCANON ? kB * (DP + 8) : DP * kLdS;
  const int smem = (3 * DP * kLdS + 2 * ktile) * (int)sizeof(bf16);  // Q + 2 x (K, V)
  auto kernel = attention_cm_bf16_kernel<DP, KCANON, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kB - 1) / kB, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, Sq, Skv, D, qs, ks, vs, os, scale * 1.4426950408889634f,
      nullptr);
  return (int)cudaGetLastError();
}

}  // namespace cm
}  // namespace
