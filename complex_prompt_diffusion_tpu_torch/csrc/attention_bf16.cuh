// The mma.sync bf16 body of K1: non-causal softmax attention over the
// [B, S, H*D] layout, 64 query rows a block, online softmax over KV tiles,
// both products on the tensor cores (mma.sync m16n8k16). K1 now runs the
// TMA + wgmma body of attention_sm90.cu for these head dims; this loop is
// the subject of the probe kernel K7 (csrc/probe_attention.cu), which
// instantiates it whole (MODE kFull, row-sum denominator, exp2, 64-key
// tiles: the code K1 ran until then) and with pieces removed or one design
// choice changed. attention.cu's d = 512 kernel shares its tile loader.
//
//   DP      head dim padded to the 16-wide k-step of the score product
//   DV      width of the PV product: DP, or D + 8 for a ones column past DP
//   BN      keys per KV tile (64 as K1; 128 for the probe's wider tiles)
//   MODE    what the instantiation computes (enum Mode below)
//   DENOM   the softmax denominator: row sums of P in registers (K1), or a
//           ones column in the V tile at column D, so that the PV product
//           yields l in its column D (the TPU kernels' ones-row)
//   EXP2    exp2 on scores scaled by scale * log2(e) (K1), or exp on scores
//           scaled by scale
//   UNNORM  write the unnormalized f32 accumulator [B, H, Sq, DV] (l in
//           column D) instead of O / l
//
// Every mode streams Q, K and V tiles exactly as the attention does; only
// arithmetic is removed. nvcc deletes an MMA or an exp whose result is never
// used, and an empty asm statement emits no PTX instruction that would use
// it, so an ablated mode hands what it computed to sink(): a store behind a
// branch on a pointer the compiler cannot see through (null at every
// launch).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum Mode : int {
  kFull = 0,    // out = softmax(scale * Q K^T) V
  kScores = 1,  // S = Q K^T only; out = sc * S[:, key 0] on every column
  kMax = 2,     // + the running row max; out = m, the final max of sc * S
  kExp = 3,     // + P = exp(sc * S - m) rounded to bf16; out = P[:, key 0] for the final m
  kPv = 4,      // P V only, with P[q, key] = Q[q, 0]; out = Q[:, 0] * sum_keys V
  kRowsum = 5,  // scores, max, exp and the row sum l; out = l
  kLoads = 6,   // the Q, K and V tiles only, no arithmetic; out = Q[:, 0] on every column
};

enum Denom : int { kSumRows = 0, kOnesColumn = 1 };

constexpr int kBM = 64;       // query rows per block (4 warps x 16)
constexpr int kBN = 64;       // keys per KV tile (K1)
constexpr int kThreads = 128;

// Issue the copies of a rows x DP tile of a [rows_valid, D] strided bf16
// matrix into shared memory with row stride LD, spread over NT threads;
// rows >= rows_valid and columns >= D are zero-filled (with SKIP_PAD the
// chunks at columns >= D are not touched at all).
template <int DP, int LD, int NT = kThreads, bool SKIP_PAD = false>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, long long rstride,
                                                int row0, int rows_valid, int D, int rows) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += NT) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    if (SKIP_PAD && c >= D) continue;
    const int gr = row0 + r;
    const bool ok = gr < rows_valid && c < D;
    cpd::cp_async16(dst + r * LD + c, ok ? src + (long long)gr * rstride + c : src, ok);
  }
}

// Hand values an ablated mode computed but does not output to a store the
// compiler must keep (p is null at every launch; the asm makes it opaque at
// each call, so the test cannot be hoisted out of the KV loop).
template <typename T, int N>
__device__ __forceinline__ void sink(const T (&a)[N][4], float* p) {
  asm volatile("" : "+l"(p));
  if (p != nullptr) {
    T* d = reinterpret_cast<T*>(p) + (long long)threadIdx.x * N * 4;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i * 4 + e] = a[i][e];
  }
}

template <bool EXP2>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (EXP2)
    return exp2f(x);
  else
    return expf(x);
}

// Shared memory of one block: the Q tile and two K and two V tiles
template <int DP, int BN>
constexpr int bf16_smem_bytes() {
  return (kBM + 4 * BN) * (DP + 8) * (int)sizeof(bf16);
}

template <int DP, int DV, int BN, int MODE, int DENOM, bool EXP2, bool UNNORM>
__global__ void __launch_bounds__(kThreads)
attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      typename std::conditional<UNNORM, float, bf16>::type* __restrict__ o,
                      int H, int Sq, int Skv, int D, long long qbs, long long qrs, long long kbs,
                      long long krs, long long vbs, long long vrs, float scale_log2,
                      float* sink_ptr) {
  constexpr int LD = DP + 8;   // padded row: ldmatrix rows hit distinct banks
  constexpr int NT = DV / 8;   // n-tiles of the O accumulator
  constexpr int KT = BN / 8;   // n-tiles of the score accumulator
  constexpr bool kOnes = DENOM == kOnesColumn;
  constexpr bool kQK = MODE != kPv && MODE != kLoads;                      // S = Q K^T
  constexpr bool kMaxStep = MODE == kMax || MODE == kExp || MODE == kRowsum || MODE == kFull;
  constexpr bool kExpStep = MODE == kExp || MODE == kRowsum || MODE == kFull;
  constexpr bool kSumStep = MODE == kRowsum || (MODE == kFull && !kOnes);  // l in registers
  constexpr bool kPack = MODE == kExp || MODE == kFull;                   // P to bf16
  constexpr bool kPV = MODE == kFull || MODE == kPv;                      // O += P V
  static_assert(DV == DP || DV == DP + 8, "the PV width is DP, or DP + 8 for a ones column");
  static_assert(!kOnes || MODE == kFull, "a ones column belongs to the full attention");
  static_assert(!UNNORM || (kOnes && MODE == kFull), "the unnormalized output carries l");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBM * LD;  // [2][BN][LD]
  bf16* sV = sK + 2 * BN * LD;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int t4 = lane & 3;  // accumulator column pair
  const bf16* qb = q + b * qbs + (long long)h * D;
  const bf16* kb = k + b * kbs + (long long)h * D;
  const bf16* vb = v + b * vbs + (long long)h * D;
  const int ntiles = (Skv + BN - 1) / BN;

  if constexpr (kOnes) {
    // column D of both V buffers holds ones (the columns after it zeros);
    // the V loads below never touch the chunks at columns >= D
    for (int idx = threadIdx.x; idx < 2 * BN * (DV - D) / 8; idx += kThreads) {
      const int r = idx / ((DV - D) / 8);
      const int c = D + (idx - r * ((DV - D) / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c == D) val.x = 0x3F80u;  // bf16 1.0 in the low half: column D
      *reinterpret_cast<uint4*>(sV + r * LD + c) = val;
    }
  }

  load_tile_async<DP, LD>(sQ, qb, qrs, q0, Sq, D, kBM);
  cpd::cp_async_commit();
  load_tile_async<DP, LD>(sK, kb, krs, 0, Skv, D, BN);
  load_tile_async<DP, LD, kThreads, kOnes>(sV, vb, vrs, 0, Skv, D, BN);
  cpd::cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the running sums
  float key0_0 = 0.f, key0_1 = 0.f;      // sc * S[row, key 0] (the scores and exp modes)

  // ldmatrix lane addressing
  const int a_row = warp * 16 + (lane & 15);  // Q (A operand)
  const int a_col = (lane >> 4) * 8;
  const int b_row = ((lane >> 4) << 3) + (lane & 7);  // K (B operand, non-trans)
  const int b_col = ((lane >> 3) & 1) * 8;
  const int v_row = (((lane >> 3) & 1) << 3) + (lane & 7);  // V (B operand, trans)
  const int v_col = (lane >> 4) * 8;

  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntiles) {
      const int nb = buf ^ 1;
      load_tile_async<DP, LD>(sK + nb * BN * LD, kb, krs, (j + 1) * BN, Skv, D, BN);
      load_tile_async<DP, LD, kThreads, kOnes>(sV + nb * BN * LD, vb, vrs, (j + 1) * BN, Skv,
                                               D, BN);
      cpd::cp_async_commit();
      cpd::cp_async_wait<1>();
    } else {
      cpd::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + buf * BN * LD;
    const bf16* tV = sV + buf * BN * LD;

    // S = Q K^T: 16 rows x BN keys per warp
    float s[KT][4];
    uint32_t pa[KT / 2][4];  // P as the A operand of the PV product
    if constexpr (kQK) {
#pragma unroll
      for (int i = 0; i < KT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t qa[4];
        cpd::ldmatrix_x4(qa, sQ + a_row * LD + kk * 16 + a_col);
#pragma unroll
        for (int np = 0; np < KT / 2; ++np) {
          uint32_t kf[4];
          cpd::ldmatrix_x4(kf, tK + (np * 16 + b_row) * LD + kk * 16 + b_col);
          cpd::mma_16816(s[2 * np], qa, kf[0], kf[1]);
          cpd::mma_16816(s[2 * np + 1], qa, kf[2], kf[3]);
        }
      }
    }
    if constexpr (MODE == kScores) {
      if (j == 0) {  // key 0: column 0 of n-tile 0, held by t4 == 0
        key0_0 = s[0][0] * scale_log2;
        key0_1 = s[0][2] * scale_log2;
      }
      sink(s, sink_ptr);
    }

    if constexpr (kMaxStep) {
      // online softmax in registers (rows g and g + 8 of this warp)
      const int key0 = j * BN + 2 * t4;
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
      if constexpr (MODE == kExp) {
        if (j == 0) {
          key0_0 = s[0][0];
          key0_1 = s[0][2];
        }
      }
      if constexpr (kExpStep) {
        const float alpha0 = softmax_exp<EXP2>(m0 - mx0);
        const float alpha1 = softmax_exp<EXP2>(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          const float p0 = softmax_exp<EXP2>(s[i][0] - mx0);
          const float p1 = softmax_exp<EXP2>(s[i][1] - mx0);
          const float p2 = softmax_exp<EXP2>(s[i][2] - mx1);
          const float p3 = softmax_exp<EXP2>(s[i][3] - mx1);
          if constexpr (kSumStep) {
            ps0 += p0 + p1;
            ps1 += p2 + p3;
          }
          if constexpr (kPack) {
            pa[i / 2][(i & 1) * 2 + 0] = cpd::pack_bf16(p0, p1);
            pa[i / 2][(i & 1) * 2 + 1] = cpd::pack_bf16(p2, p3);
          }
        }
        if constexpr (kSumStep) {
          l0 = l0 * alpha0 + ps0;
          l1 = l1 * alpha1 + ps1;
        }
        if constexpr (kPV) {
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            acc[i][0] *= alpha0;
            acc[i][1] *= alpha0;
            acc[i][2] *= alpha1;
            acc[i][3] *= alpha1;
          }
        }
        if constexpr (MODE == kExp) sink(pa, sink_ptr);
      } else {
        m0 = mx0;
        m1 = mx1;
      }
    }

    if constexpr (MODE == kPv) {
      // P[row, key] = Q[row, 0] for every key of the tile
      const bf16 qr0 = sQ[(warp * 16 + g) * LD];
      const bf16 qr1 = sQ[(warp * 16 + g + 8) * LD];
      const uint32_t w0 = (uint32_t)__bfloat16_as_ushort(qr0) * 0x10001u;
      const uint32_t w1 = (uint32_t)__bfloat16_as_ushort(qr1) * 0x10001u;
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        pa[i][0] = w0;
        pa[i][1] = w1;
        pa[i][2] = w0;
        pa[i][3] = w1;
      }
    }

    if constexpr (kPV) {
      // O += P V
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vf[4];
          cpd::ldmatrix_x4_trans(vf, tV + (kk * 16 + v_row) * LD + np * 16 + v_col);
          cpd::mma_16816(acc[2 * np], pa[kk], vf[0], vf[1]);
          cpd::mma_16816(acc[2 * np + 1], pa[kk], vf[2], vf[3]);
        }
        if constexpr (NT % 2 == 1) {  // the ones column's n-tile past DP
          uint32_t vf[2];
          cpd::ldmatrix_x2_trans(vf, tV + (kk * 16 + v_row) * LD + (NT - 1) * 8);
          cpd::mma_16816(acc[NT - 1], pa[kk], vf[0], vf[1]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles later
  }

  const int r0 = q0 + warp * 16 + g;
  if constexpr (UNNORM) {
    // [B, H, Sq, DV] f32: O unnormalized, l in column D
    float* ob = o + (long long)bh * Sq * DV;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int col = i * 8 + 2 * t4;
      if (r0 < Sq)
        *reinterpret_cast<float2*>(ob + (long long)r0 * DV + col) =
            make_float2(acc[i][0], acc[i][1]);
      if (r0 + 8 < Sq)
        *reinterpret_cast<float2*>(ob + (long long)(r0 + 8) * DV + col) =
            make_float2(acc[i][2], acc[i][3]);
    }
  } else if constexpr (kPV) {
    // out = O / l (the pv mode: O as it is), with l summed over the quad
    // that shares a row, or read from the ones column
    float inv0 = 1.f, inv1 = 1.f;
    if constexpr (MODE == kFull) {
      if constexpr (kOnes) {
        l0 = __shfl_sync(0xffffffffu, acc[NT - 1][0], lane & ~3);
        l1 = __shfl_sync(0xffffffffu, acc[NT - 1][2], lane & ~3);
      } else {
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      }
      inv0 = 1.f / l0;
      inv1 = 1.f / l1;
    }
    const long long ors = (long long)H * D;
    bf16* ob = o + (long long)b * Sq * ors + (long long)h * D;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int col = i * 8 + 2 * t4;
      if (col < D) {
        if (r0 < Sq)
          *reinterpret_cast<uint32_t*>(ob + (long long)r0 * ors + col) =
              cpd::pack_bf16(acc[i][0] * inv0, acc[i][1] * inv0);
        if (r0 + 8 < Sq)
          *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + 8) * ors + col) =
              cpd::pack_bf16(acc[i][2] * inv1, acc[i][3] * inv1);
      }
    }
  } else {
    // one value a row, on every column: rows g, g + 8 of this warp
    float w0, w1;
    if constexpr (MODE == kLoads) {
      w0 = __bfloat162float(sQ[(warp * 16 + g) * LD]);
      w1 = __bfloat162float(sQ[(warp * 16 + g + 8) * LD]);
    } else if constexpr (MODE == kScores || MODE == kExp) {
      w0 = __shfl_sync(0xffffffffu, key0_0, lane & ~3);
      w1 = __shfl_sync(0xffffffffu, key0_1, lane & ~3);
      if constexpr (MODE == kExp) {  // P of key 0 for the final max, as rounded for PV
        w0 = __bfloat162float(__float2bfloat16(softmax_exp<EXP2>(w0 - m0)));
        w1 = __bfloat162float(__float2bfloat16(softmax_exp<EXP2>(w1 - m1)));
      }
    } else if constexpr (MODE == kMax) {
      w0 = m0;
      w1 = m1;
    } else {  // kRowsum
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      w0 = l0;
      w1 = l1;
    }
    const long long ors = (long long)H * D;
    bf16* ob = o + (long long)b * Sq * ors + (long long)h * D;
    for (int col = 2 * t4; col < D; col += 8) {
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)r0 * ors + col) = cpd::pack_bf16(w0, w0);
      if (r0 + 8 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + 8) * ors + col) = cpd::pack_bf16(w1, w1);
    }
  }
}

template <int DP, int DV, int BN, int MODE, int DENOM, bool EXP2, bool UNNORM>
int launch_bf16_body(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                     int Skv, int D, long long qbs, long long qrs, long long kbs, long long krs,
                     long long vbs, long long vrs, float scale_log2, cudaStream_t stream) {
  typedef typename std::conditional<UNNORM, float, bf16>::type OutT;
  const int smem = bf16_smem_bytes<DP, BN>();
  auto kernel = attention_bf16_kernel<DP, DV, BN, MODE, DENOM, EXP2, UNNORM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBM - 1) / kBM, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<OutT*>(o), H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs, scale_log2, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace
