// The fused 3xTF32 attention body: exact-f32 softmax attention,
// out = softmax(scale * Q K^T) V, for head dims up to 160, on the TF32
// tensor cores with three products per product. One kernel template over
// three operand layouts:
//   * kDmajorK (K5's hdbs mode): Q, K, V and O d-major, [B, H, D, S] views
//     with unit stride along S (attention_cm_f32_sm90.cu);
//   * kCanonK (K5's kcanon mode): Q, V and O d-major, K canonical
//     [B, H, Skv, D] with unit stride along D (attention_cm_f32_sm90.cu);
//   * kRows (K1): Q, K and V [B, S, H*D] rows with unit column stride, O a
//     contiguous [B, Sq, H*D] (attention_f32_fused_sm90.cu).
// MODE kFull is the attention; kScores (kRows only, the probe K7's f32
// scores mode, probe_attention.cu) keeps the loads, Q's and K's splits and
// the score products, hands every score tile to sink() and writes
// sc * S[:, key 0] on every column.
//
// What bounds it on the H100: 4 B H Sq Skv d flops. Exact f32 rules out one
// TF32 product (about 1e-3 relative); the FMA units give 67 TFLOP/s. Here,
// as in K1's unfused 3xTF32 body (attention_f32_sm90.cu), each operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), and a product a b is
// a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 accumulation: three TF32
// products, at 495 / 3 TFLOP/s.
//
// TF32 wgmma takes K-major operands only. Design:
//   * a producer warpgroup whose one thread lands f32 tiles by TMA (rank-4
//     maps, no swizzle): Q once, then K and V tiles of BKV keys into a
//     landing buffer, the next tile's while the consumers compute on this
//     one;
//   * one or two consumer warpgroups (64 query rows each) that split what
//     landed into TF32 hi and lo tiles in shared memory, in the K-major
//     128-byte-swizzled layout wgmma reads: Q to [q][d] (a d-major Q
//     transposed once, a row Q as it lies), K to [keys][d] (a d-major K
//     transposed, a canonical or row K as it lies), V to [d][keys] (a
//     d-major V as it lies, a row V transposed: it is the K-major B of
//     P V);
//   * S = Q K^T by wgmma m64nBKVk8 (tf32) from shared memory, three
//     products a k-step; the online softmax in registers, f32;
//   * O += P V with P split into hi and lo in registers as the A operand
//     (wgmma's tf32 register fragment holds columns t and t + 4 of an 8-key
//     step where the score accumulator holds keys 2t and 2t + 1, so the V
//     split writes the keys of each 8-key group in the order 0 2 4 6 1 3 5
//     7, and the fragment is the accumulator's registers as they lie);
//   * each tile's P V goes into a fresh accumulator that f32 adds fold into
//     O (rescaled by the softmax's alpha): the tensor cores' accumulation
//     never carries a sum across tiles (carried over K = 4096, K1's first
//     3xTF32 form missed the f32 tolerance);
//   * the accumulator holds [q][d]: a d-major output is staged transposed
//     in Q's space (dead by then) and written with 16-byte stores along S; a
//     row output is written from registers, lane pairs trading halves so
//     that each thread stores 4 consecutive columns of one row (16 bytes).
// Shared memory sets the tiles (CfgF; ops/attention.py: k5_config and
// k1_f32_config): Q's hi and lo for BQ rows, one split K and V tile, one
// landed K and V tile. d <= 80: 128 queries, 64-key tiles; d <= 128: 128
// queries, 32 keys; d <= 160: 64 queries, 32 keys. Above 160 no such block
// fits 227 KB: those head dims take the unfused 3xTF32 kernels of
// attention_f32_sm90.cu.
#pragma once

#include "attention_modes.cuh"
#include "sm90.cuh"

namespace {
namespace f32x3 {

constexpr int SMEM_MAX = 232448;
constexpr int KB = 32;  // f32 elements of a 128-byte row: a K-major box's width
constexpr int FUSED_MAX_D = 160;

enum Layout : int { kDmajorK = 0, kCanonK = 1, kRows = 2 };

template <int DV>
struct CfgF {
  static constexpr int DR = (DV + KB - 1) / KB * KB;  // columns of the K-major Q and K tiles
  static constexpr int NKB = DR / KB;                 // their 32-column boxes
  static constexpr int BQ = DV <= 128 ? 128 : 64;     // query rows a block
  static constexpr int NCW = BQ / 64;                 // consumer warpgroups
  static constexpr int THREADS = 128 * (1 + NCW);
  static constexpr int NC = 128 * NCW;                // consumer threads
  static constexpr int BKV = DV <= 80 ? 64 : 32;      // keys a tile
  static constexpr int NVB = BKV / KB;                // 32-key boxes of a V tile
  static constexpr int QK_STEPS = DV / 8;
  static constexpr int Q_PART = BQ * 128;   // one 32-column box of Q hi or lo, [BQ][32]
  static constexpr int K_PART = BKV * 128;  // of K hi or lo, [BKV][32]
  static constexpr int V_PART = DV * 128;   // one 32-key box of V hi or lo, [DV][32]
  static constexpr int Q_BYTES = 2 * NKB * Q_PART;  // hi boxes, then lo boxes
  static constexpr int K_BYTES = 2 * NKB * K_PART;
  static constexpr int V_BYTES = 2 * NVB * V_PART;
  static constexpr int RAW = BKV * DV * 4;  // one landed K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + K_BYTES + V_BYTES + 2 * RAW + 3 * 8;
  static_assert(DV % 8 == 0 && DV <= FUSED_MAX_D, "a fused width");
  static_assert(SMEM <= SMEM_MAX, "shared memory of one block");
  static_assert(BQ * DV * 4 <= K_BYTES + V_BYTES, "Q lands in the split K and V tiles' space");
  static_assert(DV * BQ * 4 <= Q_BYTES, "the output is staged in Q's space");
};

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// hi and lo of 4 consecutive K-major elements (row r, columns 4 c4 ..) into
// 32-column boxes of `part` bytes, 128-byte rows, chunk c at c ^ (r % 8); the
// lo tile starts `lo_off` bytes after the hi tile
__device__ __forceinline__ void store_split(unsigned char* base, int part, int lo_off, int r,
                                            int c4, float4 x) {
  const int off = (c4 >> 3) * part + r * 128 + (((c4 & 7) ^ (r & 7)) << 4);
  uint4 hi, lo;
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(base + off) = hi;
  *reinterpret_cast<uint4*>(base + lo_off + off) = lo;
}

template <int N>
__device__ __forceinline__ void fence_pregs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// element strides of the output: batch, head, and the head dim (d-major
// layouts) or the query row (kRows)
struct OStrides {
  long long b, h, x;
};

template <int DV, int LAYOUT, int MODE>
__global__ void __launch_bounds__(CfgF<DV>::THREADS, 1)
attention_f32x3_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                       OStrides os, int H, int Sq, int Skv, int D, float scale_log2) {
  typedef CfgF<DV> C;
  constexpr int BQ = C::BQ, BKV = C::BKV, NC = C::NC;
  constexpr bool kRowQ = LAYOUT == kRows;             // Q [q][d] as it lands
  constexpr bool kRowK = LAYOUT != kDmajorK;          // K [keys][d] as it lands
  constexpr bool kRowV = LAYOUT == kRows;             // V [keys][d] as it lands
  constexpr bool kPV = MODE == kFull;
  static_assert(MODE == kFull || (MODE == kScores && LAYOUT == kRows),
                "the fused body has the full mode, and the scores mode on rows");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;              // hi [NKB][BQ][32], then lo
  unsigned char* sK = sQ + C::Q_BYTES;   // hi [NKB][BKV][32], then lo
  unsigned char* sV = sK + C::K_BYTES;   // hi [NVB][DV][32 keys], then lo
  float* rawK = reinterpret_cast<float*>(sV + C::V_BYTES);  // [DV][BKV], or [BKV][DV] (kRowK)
  float* rawV = rawK + BKV * DV;                            // [DV][BKV], or [BKV][DV] (kRowV)
  uint64_t* q_full = reinterpret_cast<uint64_t*>(rawV + BKV * DV);
  uint64_t* land_full = q_full + 1;
  uint64_t* land_empty = land_full + 1;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (Skv + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    cpd::mbar_init(q_full, 1);
    cpd::mbar_init(land_full, 1);
    cpd::mbar_init(land_empty, NC);
    cpd::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    cpd::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      cpd::tma_prefetch_desc(&tq);
      cpd::tma_prefetch_desc(&tk);
      cpd::tma_prefetch_desc(&tv);
      // Q lands in the split tiles' space, free until the first split
      cpd::mbar_expect_tx(q_full, BQ * DV * 4);
      if constexpr (kRowQ)
        cpd::tma_load_4d(sK, &tq, q_full, 0, q0, h, b);
      else
        cpd::tma_load_4d(sK, &tq, q_full, q0, 0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        if (j > 0) cpd::mbar_wait(land_empty, (j - 1) & 1);
        cpd::mbar_expect_tx(land_full, 2 * C::RAW);
        if constexpr (kRowK)
          cpd::tma_load_4d(rawK, &tk, land_full, 0, j * BKV, h, b);
        else
          cpd::tma_load_4d(rawK, &tk, land_full, j * BKV, 0, h, b);
        if constexpr (kRowV)
          cpd::tma_load_4d(rawV, &tv, land_full, 0, j * BKV, h, b);
        else
          cpd::tma_load_4d(rawV, &tv, land_full, j * BKV, 0, h, b);
      }
    }
    return;
  }

  cpd::reg_alloc<240>();
  const int ct = threadIdx.x - 128;  // consumer thread 0 .. NC - 1
  const int cw = ct >> 7;            // this warpgroup's rows: 64 cw .. 64 cw + 63 of the block
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int t4 = lane & 3;

  // Q -> K-major [BQ][DV] hi and lo
  cpd::mbar_wait(q_full, 0);
  {
    const float* rq = reinterpret_cast<const float*>(sK);
    if constexpr (kRowQ) {  // [BQ][DV] as it lies
      for (int idx = ct; idx < BQ * (DV / 4); idx += NC) {
        const int r = idx / (DV / 4), c4 = idx % (DV / 4);
        store_split(sQ, C::Q_PART, C::NKB * C::Q_PART, r, c4,
                    *reinterpret_cast<const float4*>(rq + r * DV + 4 * c4));
      }
    } else {  // [DV][BQ] -> transposed
      for (int idx = ct; idx < BQ * (DV / 4); idx += NC) {
        const int r = idx % BQ, c4 = idx / BQ;
        const float4 x = make_float4(rq[(4 * c4) * BQ + r], rq[(4 * c4 + 1) * BQ + r],
                                     rq[(4 * c4 + 2) * BQ + r], rq[(4 * c4 + 3) * BQ + r]);
        store_split(sQ, C::Q_PART, C::NKB * C::Q_PART, r, c4, x);
      }
    }
  }
  cpd::fence_async_shared();
  cpd::named_barrier(1, NC);

  float acc[DV / 2];  // O: rows 16 warp + g (+ 8), columns 8 i + 2 t4 (+ 1)
  float t[DV / 2];    // one tile's P V
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float sc[BKV / 2];
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;
  float key0_0 = 0.f, key0_1 = 0.f;  // sc * S[row, key 0] (the scores mode)
  uint32_t ph[BKV / 8][4], pl[BKV / 8][4];

  for (int j = 0; j < ntiles; ++j) {
    cpd::mbar_wait(land_full, j & 1);
    if (j > 0) cpd::named_barrier(1, NC);  // every warpgroup is done with tile j - 1's split tiles
    if constexpr (kRowK) {  // [BKV][DV] -> hi and lo as they lie
      for (int idx = ct; idx < BKV * (DV / 4); idx += NC) {
        const int r = idx / (DV / 4), c4 = idx % (DV / 4);
        store_split(sK, C::K_PART, C::NKB * C::K_PART, r, c4,
                    *reinterpret_cast<const float4*>(rawK + r * DV + 4 * c4));
      }
    } else {  // [DV][BKV] -> transposed
      for (int idx = ct; idx < BKV * (DV / 4); idx += NC) {
        const int r = idx % BKV, c4 = idx / BKV;
        const float4 x =
            make_float4(rawK[(4 * c4) * BKV + r], rawK[(4 * c4 + 1) * BKV + r],
                        rawK[(4 * c4 + 2) * BKV + r], rawK[(4 * c4 + 3) * BKV + r]);
        store_split(sK, C::K_PART, C::NKB * C::K_PART, r, c4, x);
      }
    }
    // V -> [DV][keys] hi and lo, each 8-key group as keys 0 2 4 6 1 3 5 7
    if constexpr (kPV && kRowV) {  // [BKV][DV] -> transposed
      for (int idx = ct; idx < DV * (BKV / 8); idx += NC) {
        const int r = idx % DV, g8 = idx / DV;
        const float* x = rawV + (8 * g8) * DV + r;
        store_split(sV, C::V_PART, C::NVB * C::V_PART, r, 2 * g8,
                    make_float4(x[0], x[2 * DV], x[4 * DV], x[6 * DV]));
        store_split(sV, C::V_PART, C::NVB * C::V_PART, r, 2 * g8 + 1,
                    make_float4(x[DV], x[3 * DV], x[5 * DV], x[7 * DV]));
      }
    } else if constexpr (kPV) {  // [DV][BKV] as it lies
      for (int idx = ct; idx < DV * (BKV / 8); idx += NC) {
        const int r = idx / (BKV / 8), g8 = idx % (BKV / 8);
        const float4 a = *reinterpret_cast<const float4*>(rawV + r * BKV + 8 * g8);
        const float4 c = *reinterpret_cast<const float4*>(rawV + r * BKV + 8 * g8 + 4);
        store_split(sV, C::V_PART, C::NVB * C::V_PART, r, 2 * g8,
                    make_float4(a.x, a.z, c.x, c.z));
        store_split(sV, C::V_PART, C::NVB * C::V_PART, r, 2 * g8 + 1,
                    make_float4(a.y, a.w, c.y, c.w));
      }
    }
    cpd::fence_async_shared();
    cpd::mbar_arrive(land_empty);  // the landed tiles are read: the next may land
    cpd::named_barrier(1, NC);

    // S = Q K^T, three TF32 products a k-step of 8 head dims
    cpd::fence_regs(sc);
    cpd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::QK_STEPS; ++kk) {
      const int box = kk / 4, off = (kk % 4) * 32;
      const unsigned char* qa = sQ + box * C::Q_PART + cw * 64 * 128 + off;
      const unsigned char* kb = sK + box * C::K_PART + off;
      const uint64_t ah = cpd::desc_sw128(qa, 16, 1024);
      const uint64_t al = cpd::desc_sw128(qa + C::NKB * C::Q_PART, 16, 1024);
      const uint64_t bh = cpd::desc_sw128(kb, 16, 1024);
      const uint64_t bl = cpd::desc_sw128(kb + C::NKB * C::K_PART, 16, 1024);
      cpd::WgmmaTf32<BKV>::ss(sc, al, bh, kk > 0);
      cpd::WgmmaTf32<BKV>::ss(sc, ah, bl, 1);
      cpd::WgmmaTf32<BKV>::ss(sc, ah, bh, 1);
    }
    cpd::wgmma_commit();
    cpd::wgmma_wait<0>();
    cpd::fence_regs(sc);

    if constexpr (MODE == kScores) {
      if (j == 0) {  // key 0: column 0 of the tile, held by t4 == 0
        key0_0 = sc[0] * scale_log2;
        key0_1 = sc[2] * scale_log2;
      }
      sink(sc, nullptr);
      continue;
    }

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
    const float alpha0 = exp2f(m0 - mx0);
    const float alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) {
      const float p0 = exp2f(sc[4 * i + 0] - mx0);  // row g, key 8 i + 2 t4
      const float p1 = exp2f(sc[4 * i + 1] - mx0);  // row g, key 8 i + 2 t4 + 1
      const float p2 = exp2f(sc[4 * i + 2] - mx1);  // row g + 8
      const float p3 = exp2f(sc[4 * i + 3] - mx1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      // the m64k8 fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4),
      // with position t holding key 2 t and t + 4 key 2 t + 1
      split(p0, ph[i][0], pl[i][0]);
      split(p2, ph[i][1], pl[i][1]);
      split(p1, ph[i][2], pl[i][2]);
      split(p3, ph[i][3], pl[i][3]);
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;

    // t = P V, three TF32 products a k-step of 8 keys; V K-major, 32 bytes a k-step
    cpd::fence_regs(t);
    fence_pregs(ph);
    fence_pregs(pl);
    cpd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 8; ++kk) {
      const unsigned char* vb = sV + (kk / 4) * C::V_PART + (kk % 4) * 32;
      const uint64_t bh = cpd::desc_sw128(vb, 16, 1024);
      const uint64_t bl = cpd::desc_sw128(vb + C::NVB * C::V_PART, 16, 1024);
      cpd::WgmmaTf32<DV>::rs(t, pl[kk], bh, kk > 0);
      cpd::WgmmaTf32<DV>::rs(t, ph[kk], bl, 1);
      cpd::WgmmaTf32<DV>::rs(t, ph[kk], bh, 1);
    }
    cpd::wgmma_commit();
    cpd::wgmma_wait<0>();
    cpd::fence_regs(t);
    fence_pregs(ph);
    fence_pregs(pl);
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      acc[4 * i + 0] = acc[4 * i + 0] * alpha0 + t[4 * i + 0];
      acc[4 * i + 1] = acc[4 * i + 1] * alpha0 + t[4 * i + 1];
      acc[4 * i + 2] = acc[4 * i + 2] * alpha1 + t[4 * i + 2];
      acc[4 * i + 3] = acc[4 * i + 3] * alpha1 + t[4 * i + 3];
    }
  }

  if constexpr (MODE == kScores) {  // one value a row, on every column
    const float w0 = __shfl_sync(0xffffffffu, key0_0, lane & ~3);
    const float w1 = __shfl_sync(0xffffffffu, key0_1, lane & ~3);
    const int r0 = q0 + cw * 64 + warp * 16 + (lane >> 2);
    float* ob = o + b * os.b + h * os.h;
    for (int col = 2 * t4; col < D; col += 8) {
      if (r0 < Sq) *reinterpret_cast<float2*>(ob + r0 * os.x + col) = make_float2(w0, w0);
      if (r0 + 8 < Sq)
        *reinterpret_cast<float2*>(ob + (r0 + 8) * os.x + col) = make_float2(w1, w1);
    }
    return;
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if constexpr (LAYOUT == kRows) {
    // out = O / l from registers: lane pairs (t4, t4 ^ 1) trade halves, the
    // even lane then holding columns 8 i + 2 t4 .. + 3 of row g, the odd one
    // the same 4 columns of row g + 8; D % 4 == 0, so a chunk is in or out whole
    const bool odd = t4 & 1;
    const int r = q0 + cw * 64 + warp * 16 + (lane >> 2) + (odd ? 8 : 0);
    float* orow = o + b * os.b + h * os.h + (long long)r * os.x;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const float a0 = acc[4 * i + 0] * inv0, a1 = acc[4 * i + 1] * inv0;
      const float a2 = acc[4 * i + 2] * inv1, a3 = acc[4 * i + 3] * inv1;
      const float x0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : a2, 1);
      const float x1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : a3, 1);
      const int col = i * 8 + 2 * (t4 & ~1);
      if (col < D && r < Sq)
        *reinterpret_cast<float4*>(orow + col) =
            odd ? make_float4(x0, x1, a2, a3) : make_float4(a0, a1, x0, x1);
    }
  } else {
    // out = O / l, transposed through Q's space: [DV][BQ] f32, row d's
    // 16-byte chunk c at c ^ (d % 8)
    cpd::named_barrier(1, NC);  // every warpgroup's products have read Q
    float* st = reinterpret_cast<float*>(sQ);
    const int r0 = cw * 64 + warp * 16 + (lane >> 2);
    auto put = [&](int d, int r, float x) {
      st[d * BQ + ((((r >> 2) ^ (d & 7))) << 2) + (r & 3)] = x;
    };
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const int d = i * 8 + 2 * t4;
      put(d, r0, acc[4 * i + 0] * inv0);
      put(d + 1, r0, acc[4 * i + 1] * inv0);
      put(d, r0 + 8, acc[4 * i + 2] * inv1);
      put(d + 1, r0 + 8, acc[4 * i + 3] * inv1);
    }
    cpd::named_barrier(1, NC);
    float* ob = o + b * os.b + h * os.h + q0;
    for (int idx = ct; idx < DV * (BQ / 4); idx += NC) {
      const int d = idx / (BQ / 4), c = idx % (BQ / 4);
      if (d < D && q0 + 4 * c < Sq)  // Sq % 4 == 0: a chunk is in or out whole
        *reinterpret_cast<float4*>(ob + d * os.x + 4 * c) =
            *reinterpret_cast<const float4*>(st + d * BQ + ((c ^ (d & 7)) << 2));
    }
  }
}

// rank-4 f32 map (inner, rows, H, B): inner unit stride, the others at the
// given element strides; box {box_inner, box_rows, 1, 1}, no swizzle
inline int encode(CUtensorMap* map, const void* base, int inner, int rows, int H, int B,
                  long long rstride, long long hstride, long long bstride, int box_inner,
                  int box_rows) {
  return cpd::encode_map<4>(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base,
                            {(uint64_t)inner, (uint64_t)rows, (uint64_t)H, (uint64_t)B},
                            {(uint64_t)rstride * 4, (uint64_t)hstride * 4, (uint64_t)bstride * 4},
                            {(uint32_t)box_inner, (uint32_t)box_rows, 1u, 1u},
                            CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Q, K and V [B, S, H*D] rows (row and batch strides in elements) -> the
// maps of kRows: (D, S, H, B), boxes {DV, BQ or BKV, 1, 1}, Q's first
template <int DV>
int encode_rows(CUtensorMap (&maps)[3], const void* q, const void* k, const void* v, int B,
                int H, int Sq, int Skv, int D, long long qbs, long long qrs, long long kbs,
                long long krs, long long vbs, long long vrs) {
  typedef CfgF<DV> C;
  int err = encode(&maps[0], q, D, Sq, H, B, qrs, D, qbs, DV, C::BQ);
  if (!err) err = encode(&maps[1], k, D, Skv, H, B, krs, D, kbs, DV, C::BKV);
  if (!err) err = encode(&maps[2], v, D, Skv, H, B, vrs, D, vbs, DV, C::BKV);
  return err;
}

// one launch of the kernel over B * H (batch, head) pairs, the dynamic
// shared memory raised once a process (one card a process)
template <int DV, int LAYOUT, int MODE>
int launch_kernel(const CUtensorMap (&maps)[3], float* o, OStrides os, int B, int H, int Sq,
                  int Skv, int D, float scale_log2, cudaStream_t stream) {
  typedef CfgF<DV> C;
  auto kernel = attention_f32x3_kernel<DV, LAYOUT, MODE>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Sq + C::BQ - 1) / C::BQ, B * H);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(maps[0], maps[1], maps[2], o, os, H, Sq, Skv,
                                                D, scale_log2);
  return (int)cudaGetLastError();
}

// the fused width for head dim D (ops/attention.py: _K5_F32_DV), 0 above
// FUSED_MAX_D or for D % 4 != 0
inline int width_of(int D) {
  static const int widths[] = {16, 32, 40, 48, 64, 80, 96, 128, 160};
  if (D <= 0 || D % 4 || D > FUSED_MAX_D) return 0;
  for (int w : widths)
    if (w >= D) return w;
  return 0;
}

// out[0..3]: query rows a block, keys a tile, 1 (one split tile and one
// landed tile), shared-memory bytes of width DV
inline void config_of(int DV, int* out) {
#define CPD_F32X3_CFG(W)                                                              \
  case W:                                                                            \
    out[0] = CfgF<W>::BQ, out[1] = CfgF<W>::BKV, out[2] = 1, out[3] = CfgF<W>::SMEM; \
    break;
  switch (DV) {
    CPD_F32X3_CFG(16)
    CPD_F32X3_CFG(32)
    CPD_F32X3_CFG(40)
    CPD_F32X3_CFG(48)
    CPD_F32X3_CFG(64)
    CPD_F32X3_CFG(80)
    CPD_F32X3_CFG(96)
    CPD_F32X3_CFG(128)
    CPD_F32X3_CFG(160)
  }
#undef CPD_F32X3_CFG
}

}  // namespace f32x3
}  // namespace
