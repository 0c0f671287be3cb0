// K1's Hopper loop for bf16 with head dim d <= 256 (the design notes are at
// the top of attention_sm90.cu) as a mode template. attention_sm90.cu
// instantiates the attention at K1's choices (MODE kFull, row sums, exp2,
// BKV = k1_bkv); the probe K7 (probe_attention*.cu) instantiates it with
// pieces of the work removed or one choice changed. The producer ring, its
// tiles and the overlap of one tile's softmax with the previous tile's P V
// are the same in every instantiation; a mode drops the steps it does not
// keep and hands what it computes to sink() (attention_modes.cuh).
//
//   DV      the head dim d (a multiple of 8): the score product's depth
//           (ceil(d / 16) k-steps) and the PV width
//   BKV     keys a K/V tile: K1's 128 at d <= 128 and 64 above, or the
//           probe's other width (64 at d <= 128; 128 does not fit at d = 160)
//   MODE    enum Mode
//   DENOM   row sums of P in registers (K1), or a ones column at column d of
//           every landed V tile, so that P V yields l in its column d (the
//           TPU kernels' ones row): the PV width grows to d + 8
//   EXP2    exp2 (ex2.approx) of scores scaled by scale * log2 e (K1), or
//           __expf of scores scaled by scale
//   UNNORM  write the unnormalized f32 accumulator [B, H, Sq, d + 8] with l
//           in column d (the ones column) instead of O / l
#pragma once

#include <type_traits>

#include "attention_modes.cuh"
#include "sm90.cuh"

namespace {
namespace k1sm90 {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;       // query rows a block
constexpr int THREADS = 384;  // warpgroup 0: producer; 1, 2: consumers
constexpr int BOX = 64;       // head-dim columns a TMA box (one 128-byte row)
constexpr int SMEM_MAX = 232448;

// K1's own key tile for head dim DV
template <int DV>
constexpr int k1_bkv() {
  return (DV + BOX - 1) / BOX <= 2 ? 128 : 64;
}

template <int DV, int BKV_>
struct Cfg {
  static constexpr int NB = (DV + BOX - 1) / BOX;  // boxes across the head dim
  static constexpr int BKV = BKV_;                 // keys a K/V tile
  static constexpr int QK_STEPS = (DV + 15) / 16;  // k-steps of the score product
  static constexpr int Q_BOX = BQ * 128;           // bytes of one Q box
  static constexpr int KV_BOX = BKV * 128;         // bytes of one K or V box
  // K/V ring depth: as deep as 227 KB of shared memory allows, up to 4
  static constexpr int FIT = (SMEM_MAX - 1024 - NB * Q_BOX - 8) / (2 * NB * KV_BOX + 24);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM =
      1024 + NB * Q_BOX + 2 * STAGES * NB * KV_BOX + (1 + 3 * STAGES) * 8;
  static_assert(BKV == 64 || BKV == 128, "64- or 128-key tiles");
  static_assert(STAGES >= 2, "two K/V stages at least");
  static_assert(SMEM <= SMEM_MAX, "shared memory of one block");
};

// 2^x on the MUFU (flushes results below 2^-126 to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool EXP2>
__device__ __forceinline__ float sexp(float x) {
  if constexpr (EXP2)
    return ex2(x);
  else
    return __expf(x);
}

template <int N>
__device__ __forceinline__ void fence_pregs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

template <int DV, int BKV, int MODE, int DENOM, bool EXP2, bool UNNORM>
__global__ void __launch_bounds__(THREADS, 1)
attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      typename std::conditional<UNNORM, float, bf16>::type* __restrict__ o,
                      int H, int Sq, int Skv, int D, float scale_log2) {
  typedef Cfg<DV, BKV> C;
  constexpr int STAGES = C::STAGES;
  constexpr bool kOnes = DENOM == kOnesColumn;
  constexpr int NV = kOnes ? DV + 8 : DV;  // the PV width
  constexpr bool kQK = MODE != kPv && MODE != kLoads;                      // S = Q K^T
  constexpr bool kMaxStep = MODE == kMax || MODE == kExp || MODE == kRowsum || MODE == kFull;
  constexpr bool kExpStep = MODE == kExp || MODE == kRowsum || MODE == kFull;
  constexpr bool kSumStep = MODE == kRowsum || (MODE == kFull && !kOnes);  // l in registers
  constexpr bool kPack = MODE == kExp || MODE == kFull;                   // P to bf16
  constexpr bool kPV = MODE == kFull || MODE == kPv;                      // O += P V
  static_assert(!kOnes || MODE == kFull, "a ones column belongs to the full attention");
  static_assert(!kOnes || DV % BOX != 0, "the ones column lies in the last V box");
  static_assert(!UNNORM || kOnes, "the unnormalized output carries l from the ones column");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;                             // [NB][BQ][64]
  unsigned char* sK = sQ + C::NB * C::Q_BOX;            // [STAGES][NB][BKV][64]
  unsigned char* sV = sK + STAGES * C::NB * C::KV_BOX;  // [STAGES][NB][BKV][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * C::NB * C::KV_BOX);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (Skv + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    cpd::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      cpd::mbar_init(&k_full[s], 1);
      cpd::mbar_init(&v_full[s], 1);
      cpd::mbar_init(&empty[s], 256);
    }
    cpd::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    cpd::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      cpd::tma_prefetch_desc(&tq);
      cpd::tma_prefetch_desc(&tk);
      cpd::tma_prefetch_desc(&tv);
      cpd::mbar_expect_tx(q_full, C::NB * C::Q_BOX);
#pragma unroll
      for (int nb = 0; nb < C::NB; ++nb)
        cpd::tma_load_4d(sQ + nb * C::Q_BOX, &tq, q_full, nb * BOX, h, q0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) cpd::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        unsigned char* k_dst = sK + s * C::NB * C::KV_BOX;
        unsigned char* v_dst = sV + s * C::NB * C::KV_BOX;
        cpd::mbar_expect_tx(&k_full[s], C::NB * C::KV_BOX);
#pragma unroll
        for (int nb = 0; nb < C::NB; ++nb)
          cpd::tma_load_4d(k_dst + nb * C::KV_BOX, &tk, &k_full[s], nb * BOX, h, j * BKV, b);
        cpd::mbar_expect_tx(&v_full[s], C::NB * C::KV_BOX);
#pragma unroll
        for (int nb = 0; nb < C::NB; ++nb)
          cpd::tma_load_4d(v_dst + nb * C::KV_BOX, &tv, &v_full[s], nb * BOX, h, j * BKV, b);
      }
    }
    return;
  }

  cpd::reg_alloc<240>();
  const int cw = wg - 1;  // this warpgroup's rows: 64 cw .. 64 cw + 63 of the block
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int t4 = lane & 3;

  float acc[kPV ? NV / 2 : 1];  // O: rows 16 warp + g (+ 8), columns 8 i + 2 t4 (+ 1)
#pragma unroll
  for (int i = 0; i < (kPV ? NV / 2 : 1); ++i) acc[i] = 0.f;
  float sc[BKV / 2];  // scores of one tile, same layout with keys for columns
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of this thread's two rows
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the running sums
  float key0_0 = 0.f, key0_1 = 0.f;      // the scaled score of key 0 (scores, exp modes)
  // P of two consecutive tiles: one is written while the PV product of the
  // other may still read it
  uint32_t pa0[BKV / 16][4], pa1[BKV / 16][4];

  if constexpr (MODE == kPv) {  // P[row, key] = Q[row, 0] for every key (bf16 pairs)
    cpd::mbar_wait(q_full, 0);
    const int rr = cw * 64 + warp * 16 + (lane >> 2);  // column 0: chunk 0 at (r % 8) * 16
    const uint16_t q0b = *reinterpret_cast<const uint16_t*>(sQ + rr * 128 + ((rr & 7) << 4));
    const uint16_t q1b =
        *reinterpret_cast<const uint16_t*>(sQ + (rr + 8) * 128 + (((rr + 8) & 7) << 4));
    const uint32_t w0 = (uint32_t)q0b * 0x10001u, w1 = (uint32_t)q1b * 0x10001u;
#pragma unroll
    for (int i = 0; i < BKV / 16; ++i) {
      pa0[i][0] = pa1[i][0] = w0;
      pa0[i][1] = pa1[i][1] = w1;
      pa0[i][2] = pa1[i][2] = w0;
      pa0[i][3] = pa1[i][3] = w1;
    }
  }

  // S = Q K^T of tile j into sc, over ceil(d / 16) k-steps of 16 columns
  auto issue_qk = [&](int j) {
    cpd::mbar_wait(&k_full[j % STAGES], (j / STAGES) & 1);
    const unsigned char* tK = sK + (j % STAGES) * C::NB * C::KV_BOX;
    cpd::fence_regs(sc);
    cpd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::QK_STEPS; ++kk) {
      const int box = kk / 4, off = (kk % 4) * 32;
      cpd::Wgmma<BKV>::ss(
          sc, cpd::desc_sw128(sQ + box * C::Q_BOX + cw * 64 * 128 + off, 16, 1024),
          cpd::desc_sw128(tK + box * C::KV_BOX + off, 16, 1024), kk > 0);
    }
    cpd::wgmma_commit();
  };

  // One KV tile. On entry sc holds the scores of tile j and the PV product
  // of tile j - 1 (reading p_prev) may be in flight. The softmax of tile j
  // overlaps it; then Q K^T of tile j + 1 and P V of tile j are issued, and
  // the next scores awaited while that P V runs. A mode without P V
  // releases tile j's stage once its scores are read; one without Q K^T
  // waits for the K tile it does not read.
  auto step = [&](int j, uint32_t(&p_cur)[BKV / 16][4], uint32_t(&p_prev)[BKV / 16][4]) {
    float alpha0 = 1.f, alpha1 = 1.f;
    if constexpr (MODE == kScores) {
      if (j == 0) {  // key 0: column 0 of the tile, held by t4 == 0
        key0_0 = sc[0] * scale_log2;
        key0_1 = sc[2] * scale_log2;
      }
      sink(sc, nullptr);
    }
    if constexpr (kMaxStep) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) sc[i] *= scale_log2;
      if (j * BKV + BKV > Skv) {  // the ragged last tile: keys past S_kv to -inf
        const int key0 = j * BKV + 2 * t4;
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (key0 + i * 8 + e >= Skv) sc[4 * i + e] = sc[4 * i + 2 + e] = -INFINITY;
          }
        }
      }
      if constexpr (MODE == kExp) {
        if (j == 0) {
          key0_0 = sc[0];
          key0_1 = sc[2];
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      if constexpr (kExpStep) {
        alpha0 = sexp<EXP2>(m0 - mx0);
        alpha1 = sexp<EXP2>(m1 - mx1);
      }
      m0 = mx0;
      m1 = mx1;
    }
    if constexpr (kExpStep) {
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i) {
        const float p0 = sexp<EXP2>(sc[4 * i + 0] - m0);
        const float p1 = sexp<EXP2>(sc[4 * i + 1] - m0);
        const float p2 = sexp<EXP2>(sc[4 * i + 2] - m1);
        const float p3 = sexp<EXP2>(sc[4 * i + 3] - m1);
        if constexpr (kSumStep) {
          ps0 += p0 + p1;
          ps1 += p2 + p3;
        }
        if constexpr (kPack) {
          p_cur[i / 2][(i & 1) * 2 + 0] = cpd::pack_bf16(p0, p1);
          p_cur[i / 2][(i & 1) * 2 + 1] = cpd::pack_bf16(p2, p3);
        }
      }
      if constexpr (kSumStep) {
        l0 = l0 * alpha0 + ps0;
        l1 = l1 * alpha1 + ps1;
      }
      if constexpr (MODE == kExp) sink(p_cur, nullptr);
    }
    if constexpr (kPV) {
      if (j > 0) {  // P V of tile j - 1 has retired: O may be rescaled, its stage reused
        cpd::wgmma_wait<0>();
        cpd::fence_regs(acc);
        fence_pregs(p_prev);
        cpd::mbar_arrive(&empty[(j - 1) % STAGES]);
      }
    } else {  // tile j's scores are read (or no product reads it): its stage is free
      if constexpr (!kQK) cpd::mbar_wait(&k_full[j % STAGES], (j / STAGES) & 1);
      cpd::mbar_wait(&v_full[j % STAGES], (j / STAGES) & 1);
      cpd::mbar_arrive(&empty[j % STAGES]);
    }
    if constexpr (MODE == kFull) {
#pragma unroll
      for (int i = 0; i < NV / 8; ++i) {
        acc[4 * i + 0] *= alpha0;
        acc[4 * i + 1] *= alpha0;
        acc[4 * i + 2] *= alpha1;
        acc[4 * i + 3] *= alpha1;
      }
    }
    const bool more = j + 1 < ntiles;
    if constexpr (kQK) {
      if (more) issue_qk(j + 1);
    }
    if constexpr (kPV) {
      // O += P V: V MN-major, 64-column groups BKV * 128 bytes apart, 16 keys
      // (two 8-row atoms) a k-step
      if constexpr (MODE == kPv) cpd::mbar_wait(&k_full[j % STAGES], (j / STAGES) & 1);
      cpd::mbar_wait(&v_full[j % STAGES], (j / STAGES) & 1);
      unsigned char* tV = sV + (j % STAGES) * C::NB * C::KV_BOX;
      if constexpr (kOnes) {
        // column d of the landed tile (TMA zero-filled it) to 1: each
        // warpgroup writes its own copy of the ones, fenced to the async
        // proxy before its wgmma reads them
        const int r = threadIdx.x & 127;
        if (r < BKV) {
          constexpr int nb = DV / BOX, c = DV % BOX;
          *reinterpret_cast<uint16_t*>(tV + nb * C::KV_BOX + r * 128 +
                                       ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2) = 0x3F80u;
        }
        cpd::fence_async_shared();
        cpd::named_barrier(1 + cw, 128);
      }
      cpd::fence_regs(acc);
      fence_pregs(p_cur);
      cpd::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        cpd::Wgmma<NV>::rs(acc, p_cur[kk],
                           cpd::desc_sw128(tV + kk * 16 * 128, C::KV_BOX, 1024), 1);
      cpd::wgmma_commit();
    }
    if constexpr (kQK) {
      if (more) {
        cpd::wgmma_wait<kPV ? 1 : 0>();  // the scores of tile j + 1 (P V of tile j may run on)
        cpd::fence_regs(sc);
      }
    }
  };

  cpd::mbar_wait(q_full, 0);
  if constexpr (kQK) {
    issue_qk(0);
    cpd::wgmma_wait<0>();
    cpd::fence_regs(sc);
  }
  for (int j = 0; j < ntiles; j += 2) {
    step(j, pa0, pa1);
    if (j + 1 < ntiles) step(j + 1, pa1, pa0);
  }
  if constexpr (kPV) {
    cpd::wgmma_wait<0>();
    cpd::fence_regs(acc);
  }

  const int r0 = q0 + cw * 64 + warp * 16 + (lane >> 2);
  if constexpr (UNNORM) {
    // [B, H, Sq, NV] f32: O unnormalized, l in column d
    float* ob = o + (long long)bh * Sq * NV;
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
      const int col = i * 8 + 2 * t4;
      if (r0 < Sq)
        *reinterpret_cast<float2*>(ob + (long long)r0 * NV + col) =
            make_float2(acc[4 * i + 0], acc[4 * i + 1]);
      if (r0 + 8 < Sq)
        *reinterpret_cast<float2*>(ob + (long long)(r0 + 8) * NV + col) =
            make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  } else if constexpr (kPV) {
    // out = O / l (the pv mode: O as it is), l summed over the quad that
    // shares a row, or read from the ones column; rows past Sq and columns
    // past D not stored
    float inv0 = 1.f, inv1 = 1.f;
    if constexpr (MODE == kFull) {
      if constexpr (kOnes) {
        l0 = __shfl_sync(0xffffffffu, acc[4 * (DV / 8) + 0], lane & ~3);
        l1 = __shfl_sync(0xffffffffu, acc[4 * (DV / 8) + 2], lane & ~3);
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
    for (int i = 0; i < DV / 8; ++i) {
      const int col = i * 8 + 2 * t4;
      if (col < D) {
        if (r0 < Sq)
          *reinterpret_cast<uint32_t*>(ob + (long long)r0 * ors + col) =
              cpd::pack_bf16(acc[4 * i + 0] * inv0, acc[4 * i + 1] * inv0);
        if (r0 + 8 < Sq)
          *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + 8) * ors + col) =
              cpd::pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
      }
    }
  } else {
    // one value a row, on every column: rows r0, r0 + 8
    float w0, w1;
    if constexpr (MODE == kLoads) {
      const int rr = cw * 64 + warp * 16 + (lane >> 2);  // Q[row, 0] as it landed
      w0 = __bfloat162float(
          *reinterpret_cast<const bf16*>(sQ + rr * 128 + ((rr & 7) << 4)));
      w1 = __bfloat162float(
          *reinterpret_cast<const bf16*>(sQ + (rr + 8) * 128 + (((rr + 8) & 7) << 4)));
    } else if constexpr (MODE == kScores || MODE == kExp) {
      w0 = __shfl_sync(0xffffffffu, key0_0, lane & ~3);
      w1 = __shfl_sync(0xffffffffu, key0_1, lane & ~3);
      if constexpr (MODE == kExp) {  // P of key 0 for the final max, as rounded for P V
        w0 = __bfloat162float(__float2bfloat16(sexp<EXP2>(w0 - m0)));
        w1 = __bfloat162float(__float2bfloat16(sexp<EXP2>(w1 - m1)));
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
        *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + 8) * ors + col) =
            cpd::pack_bf16(w1, w1);
    }
  }
}

// rank-4 map (D, H, S, B) over one operand, box {64, 1, rows, 1}
inline int encode_operand(CUtensorMap* map, const void* base, int B, int H, int S, int D,
                          long long bstride, long long rstride, int rows) {
  return cpd::encode_bf16_map<4>(
      map, base, {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B},
      {(uint64_t)D * 2, (uint64_t)rstride * 2, (uint64_t)bstride * 2},
      {(uint32_t)BOX, 1u, (uint32_t)rows, 1u});
}

// one launch over q [B, Sq, H*D], k and v [B, Skv, H*D] (batch and row
// strides in elements); o a fresh [B, Sq, H*D] bf16, or [B, H, Sq, D + 8]
// f32 with UNNORM. scale_log2: scale * log2 e with EXP2, else scale. The
// dynamic shared memory is raised once a process (one card a process).
template <int DV, int BKV, int MODE, int DENOM, bool EXP2, bool UNNORM>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Skv,
           int D, long long qbs, long long qrs, long long kbs, long long krs, long long vbs,
           long long vrs, float scale_log2, cudaStream_t stream) {
  typedef Cfg<DV, BKV> C;
  typedef typename std::conditional<UNNORM, float, bf16>::type OutT;
  CUtensorMap tq, tk, tv;
  int err = encode_operand(&tq, q, B, H, Sq, D, qbs, qrs, BQ);
  if (!err) err = encode_operand(&tk, k, B, H, Skv, D, kbs, krs, BKV);
  if (!err) err = encode_operand(&tv, v, B, H, Skv, D, vbs, vrs, BKV);
  if (err) return err;
  auto kernel = attention_sm90_kernel<DV, BKV, MODE, DENOM, EXP2, UNNORM>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, static_cast<OutT*>(o), H, Sq, Skv, D,
                                             scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace k1sm90
}  // namespace
