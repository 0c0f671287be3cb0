// K5's Hopper loop for bf16 (the design notes are at the top of
// attention_cm_sm90.cu) with the mode as a template parameter:
// attention_cm_sm90.cu instantiates the attention (MODE kFull); the probe
// K7 (probe_attention.cu) instantiates MODE kScores: the same tile loads
// and score products, every score tile handed to sink()
// (attention_modes.cuh), each stage released once its V has landed, and
// sc * S[:, key 0] written on every head-dim row.
#pragma once

#include "attention_modes.cuh"
#include "sm90.cuh"

namespace {
namespace k5sm90 {


typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;       // query rows a block
constexpr int THREADS = 384;  // warpgroup 0: producer; 1, 2: consumers
constexpr int BOX = 64;       // elements along a box's inner dimension (128 bytes)
constexpr int SMEM_MAX = 232448;

template <int DV, bool KCANON>
struct Cfg {
  static constexpr int DR = (DV + 15) / 16 * 16;  // rows of a d-major box: the score k-steps' depth
  static constexpr int QK_STEPS = DR / 16;
  static constexpr int BKV = DV <= 128 ? 128 : 64;  // keys a K/V tile
  static constexpr int NSB = BKV / BOX;             // 64-key boxes of a d-major tile
  static constexpr int NDB = (DV + BOX - 1) / BOX;  // 64-column boxes of a canonical K tile
  static constexpr int Q_BOX = DR * 128;            // one Q box [DR][64 queries]
  static constexpr int K_BOX = KCANON ? BKV * 128 : DR * 128;  // [BKV][64 d] or [DR][64 keys]
  static constexpr int K_BYTES = (KCANON ? NDB : NSB) * K_BOX;
  static constexpr int V_BOX = DV * 128;            // one V box [DV][64 keys]
  static constexpr int V_BYTES = NSB * V_BOX;
  static constexpr int Q_BYTES = (BQ / BOX) * Q_BOX;
  // K/V ring depth: as deep as 227 KB of shared memory allows, up to 4
  static constexpr int FIT = (SMEM_MAX - 1024 - Q_BYTES - 8) / (K_BYTES + V_BYTES + 24);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) + (1 + 3 * STAGES) * 8;
  static_assert(STAGES >= 2, "two K/V stages at least");
  static_assert(SMEM <= SMEM_MAX, "shared memory of one block");
  static_assert(DV * 128 <= Q_BOX, "the output tile is staged in its warpgroup's Q box");
};

// 2^x on the MUFU (flushes results below 2^-126 to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void fence_pregs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// element strides of the output: batch, head, head dim
struct OStrides {
  long long b, h, d;
};

template <int DV, bool KCANON, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
attention_cm_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                         OStrides os, int H, int Sq, int Skv, int D, float scale_log2) {
  typedef Cfg<DV, KCANON> C;
  constexpr int BKV = C::BKV, STAGES = C::STAGES;
  static_assert(MODE == kFull || MODE == kScores, "K5's body has the full and scores modes");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;                          // [2][DR][64]
  unsigned char* sK = sQ + C::Q_BYTES;               // [STAGES][K_BYTES]
  unsigned char* sV = sK + STAGES * C::K_BYTES;      // [STAGES][NSB][DV][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * C::V_BYTES);
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
      cpd::mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < BQ / BOX; ++c)
        cpd::tma_load_4d(sQ + c * C::Q_BOX, &tq, q_full, q0 + c * BOX, 0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) cpd::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        unsigned char* k_dst = sK + s * C::K_BYTES;
        unsigned char* v_dst = sV + s * C::V_BYTES;
        cpd::mbar_expect_tx(&k_full[s], C::K_BYTES);
        if constexpr (KCANON) {
#pragma unroll
          for (int nb = 0; nb < C::NDB; ++nb)
            cpd::tma_load_4d(k_dst + nb * C::K_BOX, &tk, &k_full[s], nb * BOX, j * BKV, h, b);
        } else {
#pragma unroll
          for (int sb = 0; sb < C::NSB; ++sb)
            cpd::tma_load_4d(k_dst + sb * C::K_BOX, &tk, &k_full[s], j * BKV + sb * BOX, 0, h, b);
        }
        cpd::mbar_expect_tx(&v_full[s], C::V_BYTES);
#pragma unroll
        for (int sb = 0; sb < C::NSB; ++sb)
          cpd::tma_load_4d(v_dst + sb * C::V_BOX, &tv, &v_full[s], j * BKV + sb * BOX, 0, h, b);
      }
    }
    return;
  }

  cpd::reg_alloc<240>();
  const int cw = wg - 1;  // this warpgroup's rows: 64 cw .. 64 cw + 63 of the block
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int t4 = lane & 3;
  unsigned char* myQ = sQ + cw * C::Q_BOX;  // this warpgroup's 64 queries, [DR][64]

  float acc[DV / 2];  // O: rows 16 warp + g (+ 8), columns 8 i + 2 t4 (+ 1)
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float sc[BKV / 2];  // scores of one tile, same layout with keys for columns
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of this thread's two rows
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the running sums
  float key0_0 = 0.f, key0_1 = 0.f;      // sc * S[row, key 0] (the scores mode)
  // P of two consecutive tiles: one is written while the PV product of the
  // other may still read it
  uint32_t pa0[BKV / 16][4], pa1[BKV / 16][4];

  // S = Q K^T of tile j into sc, over DR / 16 k-steps of 16 head dims: Q
  // MN-major (16 rows of its [DR][64] box a k-step); K K-major (32 bytes
  // into a 64-column box) or MN-major (its 64-key boxes K_BOX apart)
  auto issue_qk = [&](int j) {
    cpd::mbar_wait(&k_full[j % STAGES], (j / STAGES) & 1);
    const unsigned char* tK = sK + (j % STAGES) * C::K_BYTES;
    cpd::fence_regs(sc);
    cpd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::QK_STEPS; ++kk) {
      const uint64_t da = cpd::desc_sw128(myQ + kk * 2048, C::Q_BOX, 1024);
      if constexpr (KCANON) {
        const int box = kk / 4, off = (kk % 4) * 32;
        cpd::Wgmma<BKV>::ss_amn(sc, da, cpd::desc_sw128(tK + box * C::K_BOX + off, 16, 1024),
                                kk > 0);
      } else {
        cpd::Wgmma<BKV>::ss_mn(sc, da, cpd::desc_sw128(tK + kk * 2048, C::K_BOX, 1024), kk > 0);
      }
    }
    cpd::wgmma_commit();
  };

  // One KV tile. On entry sc holds the scores of tile j and the PV product
  // of tile j - 1 (reading p_prev) may be in flight. The softmax of tile j
  // overlaps it; then Q K^T of tile j + 1 and P V of tile j are issued, and
  // the next scores awaited while that P V runs.
  auto step = [&](int j, uint32_t(&p_cur)[BKV / 16][4], uint32_t(&p_prev)[BKV / 16][4]) {
    if constexpr (MODE == kScores) {
      // the scores mode: tile j's scores to sink(), key 0's kept; the stage
      // is free once V has landed, then Q K^T of tile j + 1
      if (j == 0) {
        key0_0 = sc[0] * scale_log2;
        key0_1 = sc[2] * scale_log2;
      }
      sink(sc, nullptr);
      cpd::mbar_wait(&v_full[j % STAGES], (j / STAGES) & 1);
      cpd::mbar_arrive(&empty[j % STAGES]);
      if (j + 1 < ntiles) {
        issue_qk(j + 1);
        cpd::wgmma_wait<0>();
        cpd::fence_regs(sc);
      }
      return;
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
    const float alpha0 = ex2(m0 - mx0);
    const float alpha1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) {
      const float p0 = ex2(sc[4 * i + 0] - mx0);
      const float p1 = ex2(sc[4 * i + 1] - mx0);
      const float p2 = ex2(sc[4 * i + 2] - mx1);
      const float p3 = ex2(sc[4 * i + 3] - mx1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      p_cur[i / 2][(i & 1) * 2 + 0] = cpd::pack_bf16(p0, p1);
      p_cur[i / 2][(i & 1) * 2 + 1] = cpd::pack_bf16(p2, p3);
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
    if (j > 0) {  // P V of tile j - 1 has retired: O may be rescaled, its stage reused
      cpd::wgmma_wait<0>();
      cpd::fence_regs(acc);
      fence_pregs(p_prev);
      cpd::mbar_arrive(&empty[(j - 1) % STAGES]);
    }
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      acc[4 * i + 0] *= alpha0;
      acc[4 * i + 1] *= alpha0;
      acc[4 * i + 2] *= alpha1;
      acc[4 * i + 3] *= alpha1;
    }
    const bool more = j + 1 < ntiles;
    if (more) issue_qk(j + 1);
    // O += P V: V K-major ([DV][64 keys] boxes), 16 keys (32 bytes) a k-step
    cpd::mbar_wait(&v_full[j % STAGES], (j / STAGES) & 1);
    const unsigned char* tV = sV + (j % STAGES) * C::V_BYTES;
    cpd::fence_regs(acc);
    fence_pregs(p_cur);
    cpd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const int box = kk / 4, off = (kk % 4) * 32;
      cpd::Wgmma<DV>::rs_bk(acc, p_cur[kk], cpd::desc_sw128(tV + box * C::V_BOX + off, 16, 1024),
                            1);
    }
    cpd::wgmma_commit();
    if (more) {
      cpd::wgmma_wait<1>();  // the scores of tile j + 1 (P V of tile j may run on)
      cpd::fence_regs(sc);
    }
  };

  cpd::mbar_wait(q_full, 0);
  issue_qk(0);
  cpd::wgmma_wait<0>();
  cpd::fence_regs(sc);
  for (int j = 0; j < ntiles; j += 2) {
    step(j, pa0, pa1);
    if (j + 1 < ntiles) step(j + 1, pa1, pa0);
  }
  cpd::wgmma_wait<0>();
  cpd::fence_regs(acc);

  if constexpr (MODE == kScores) {  // sc * S[q, key 0] on every head-dim row
    const float w0 = __shfl_sync(0xffffffffu, key0_0, lane & ~3);
    const float w1 = __shfl_sync(0xffffffffu, key0_1, lane & ~3);
    const int r = q0 + cw * 64 + warp * 16 + (lane >> 2);
    bf16* ob = o + b * os.b + h * os.h;
    for (int d = t4; d < D; d += 4) {
      if (r < Sq) ob[d * os.d + r] = __float2bfloat16(w0);
      if (r + 8 < Sq) ob[d * os.d + r + 8] = __float2bfloat16(w1);
    }
    return;
  }

  // out = O / l, transposed: row d of this warpgroup's [DV][64 queries]
  // tile is 128 bytes in myQ, its 16-byte chunk c at c ^ (d % 8) (the
  // 128-byte swizzle, so a warp's stores and loads spread over the banks)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8 of the 64
  bf16* st = reinterpret_cast<bf16*>(myQ);
  auto put = [&](int d, int r, float x) {
    st[d * 64 + ((((r >> 3) ^ (d & 7))) << 3) + (r & 7)] = __float2bfloat16(x);
  };
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    const int d = i * 8 + 2 * t4;
    put(d, r0, acc[4 * i + 0] * inv0);
    put(d + 1, r0, acc[4 * i + 1] * inv0);
    put(d, r0 + 8, acc[4 * i + 2] * inv1);
    put(d + 1, r0 + 8, acc[4 * i + 3] * inv1);
  }
  const int qw = q0 + cw * 64;  // this warpgroup's first query
  cpd::named_barrier(1 + cw, 128);
  bf16* ob = o + b * os.b + h * os.h + qw;
  for (int idx = threadIdx.x & 127; idx < DV * 8; idx += 128) {
    const int d = idx >> 3, c = idx & 7;
    if (d < D && qw + c * 8 < Sq)  // Sq % 8 == 0: a chunk is in or out whole
      *reinterpret_cast<uint4*>(ob + d * os.d + c * 8) =
          *reinterpret_cast<const uint4*>(st + d * 64 + ((c ^ (d & 7)) << 3));
  }
}

// rank-4 bf16 map (inner, rows, H, B): inner unit stride, the others at
// the given element strides; box {64, box_rows, 1, 1}, 128-byte swizzle
inline int encode(CUtensorMap* map, const void* base, int inner, int rows, int H, int B,
                  long long rstride, long long hstride, long long bstride, int box_rows) {
  return cpd::encode_bf16_map<4>(
      map, base, {(uint64_t)inner, (uint64_t)rows, (uint64_t)H, (uint64_t)B},
      {(uint64_t)rstride * 2, (uint64_t)hstride * 2, (uint64_t)bstride * 2},
      {(uint32_t)BOX, (uint32_t)box_rows, 1u, 1u});
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, Sq, Skv, D;
  long long q_sb, q_sh, q_sd, k_sb, k_sh, k_sx, v_sb, v_sh, v_sd, o_sb, o_sh, o_sd;
  float scale_log2;
};

template <int DV, bool KCANON, int MODE>
int launch(const Args& a, cudaStream_t stream) {
  typedef Cfg<DV, KCANON> C;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, a.q, a.Sq, a.D, a.H, a.B, a.q_sd, a.q_sh, a.q_sb, C::DR);
  if (!err)
    err = KCANON ? encode(&tk, a.k, a.D, a.Skv, a.H, a.B, a.k_sx, a.k_sh, a.k_sb, C::BKV)
                 : encode(&tk, a.k, a.Skv, a.D, a.H, a.B, a.k_sx, a.k_sh, a.k_sb, C::DR);
  if (!err) err = encode(&tv, a.v, a.Skv, a.D, a.H, a.B, a.v_sd, a.v_sh, a.v_sb, DV);
  if (err) return err;
  auto kernel = attention_cm_sm90_kernel<DV, KCANON, MODE>;
  static bool attr_set = false;  // one card a process
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, static_cast<bf16*>(a.o),
                                             OStrides{a.o_sb, a.o_sh, a.o_sd}, a.H, a.Sq, a.Skv,
                                             a.D, a.scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace k5sm90
}  // namespace
