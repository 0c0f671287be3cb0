// K1 on Hopper, bf16 with head dim d <= 256: non-causal softmax attention,
// out = softmax(scale * Q K^T) V, over the [B, S, H*D] layout, with TMA
// loads and wgmma in a warp-specialised block.
//
// Replaces the TPU kernels complex_prompt_diffusion_tpu/ops/attention.py::
// _onepass_kernel (UNet self-attention: bf16, S_kv 256..4096, d 40/80/160
// in SD-1.5, 64 in SD-2) and ::_attn_kernel (the streaming kernel) for the
// bf16 head dims up to 256. attention.cu keeps the d = 512 split-d body and
// the f32 body; the mma.sync body (attention_bf16.cuh) is now launched
// only by the probe K7 (probe_attention.cu). Rounding as the TPU kernel: f32
// scores and softmax (exp2 of scores scaled by scale * log2 e), P rounded to
// bf16 before the PV product, an f32 O accumulator.
//
// What bounds it on the H100: 4 * B*H * Sq * Skv * d flops over only
// 4 * B * S * H*D * 2 bytes, so the tensor cores at large S. The mma.sync body
// ran 1.6-2.0x slower than SDPA; its own ablation (K7, PERF.md section 5)
// showed the tile loads alone taking 62-75% of its time: a block of 64 query
// rows reads all of its head's K and V through cp.async, every thread
// computing addresses. Design:
//   * 128 query rows a block: two consumer warpgroups of 64 rows, plus a
//     producer warpgroup whose one thread issues every load. The wider tile
//     halves the K/V stream through L2 (1.6 GB instead of 3.2 at S4096 d40).
//     setmaxnreg moves registers from the producer (24) to the consumers
//     (240).
//   * TMA: a rank-4 tensor map (D, H, S, B) over each of q, k and v, with
//     any batch and row stride (the UNet's q, k and v are views of one qkv
//     projection). A box is 64 wide in D: d = 40 reads columns 0..63 of its
//     own head with 40..63 zero-filled by TMA (the pad of the 16-wide k-step,
//     and none of the next head); d = 80 and 160 take two and three boxes.
//     Rows past S are zero-filled per batch. Q is loaded once; K and V come
//     in tiles of BKV keys (128 at d <= 128, 64 above) through a ring of 2-4
//     stages (as many as shared memory holds), K and V each on its own full
//     barrier, so Q K^T starts before V lands.
//   * S = Q K^T: wgmma m64nBKVk16 from shared memory, both K-major, over
//     ceil(d / 16) k-steps. The online softmax runs in registers (the
//     accumulator's rows are spread over the 4 threads of a quad); a ragged
//     last tile masks its keys past S_kv to -inf (TMA's zeros would be
//     scores of 0).
//   * O += P V: P, converted to bf16 in registers, is the register A operand
//     of wgmma m64nDVk16 (DV = d rounded up to 8: d40 -> n40); V is read from
//     shared memory as it lies, an MN-major B operand.
//   * Overlap inside a warpgroup: the softmax of tile j runs while the PV
//     product of tile j - 1 is in flight, then Q K^T of tile j + 1 and P V of
//     tile j are issued together (P double-buffered in registers, since the
//     tensor cores read it asynchronously). The two consumer warpgroups run
//     independently, so one's exp2 can also overlap the other's wgmma; the
//     exp2 is ex2.approx.ftz (MUFU).
// Measured on the H100 (tree_ab, PERF.md section 6): ping-pong turns of the
// two warpgroups' wgmma on named barriers lost 13-21%, 64-key tiles lost
// 16-19% at d40 and d80, and row max and sums as trees (in place of the
// chains below) gained nothing at d160; none is kept. Masking keys only in
// the ragged last tile (not by a per-element predicate in every tile) gained
// 7% at d40. The kernel runs 1.1-1.2x slower than SDPA at the UNet's shapes.

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;       // query rows a block
constexpr int THREADS = 384;  // warpgroup 0: producer; 1, 2: consumers
constexpr int BOX = 64;       // head-dim columns a TMA box (one 128-byte row)

template <int DV>
struct Cfg {
  static constexpr int NB = (DV + BOX - 1) / BOX;  // boxes across the head dim
  static constexpr int BKV = NB <= 2 ? 128 : 64;    // keys a K/V tile
  // K/V ring depth: as deep as 227 KB of shared memory allows, up to 4
  static constexpr int STAGES = NB == 1 ? 4 : NB == 4 ? 2 : 3;
  static constexpr int QK_STEPS = (DV + 15) / 16;   // k-steps of the score product
  static constexpr int Q_BOX = BQ * 128;            // bytes of one Q box
  static constexpr int KV_BOX = BKV * 128;          // bytes of one K or V box
  static constexpr int SMEM =
      1024 + NB * Q_BOX + 2 * STAGES * NB * KV_BOX + (1 + 3 * STAGES) * 8;
  static_assert(SMEM <= 232448, "shared memory of one block");
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

template <int DV>
__global__ void __launch_bounds__(THREADS, 1)
attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int H,
                      int Sq, int Skv, int D, float scale_log2) {
  typedef Cfg<DV> C;
  constexpr int BKV = C::BKV, STAGES = C::STAGES;
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

  float acc[DV / 2];  // O: rows 16 warp + g (+ 8), columns 8 i + 2 t4 (+ 1)
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float sc[BKV / 2];  // scores of one tile, same layout with keys for columns
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of this thread's two rows
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the running sums
  // P of two consecutive tiles: one is written while the PV product of the
  // other may still read it
  uint32_t pa0[BKV / 16][4], pa1[BKV / 16][4];

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
  // the next scores awaited while that P V runs.
  auto step = [&](int j, uint32_t(&p_cur)[BKV / 16][4], uint32_t(&p_prev)[BKV / 16][4]) {
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
    // O += P V: V MN-major, 64-column groups BKV * 128 bytes apart, 16 keys
    // (two 8-row atoms) a k-step
    cpd::mbar_wait(&v_full[j % STAGES], (j / STAGES) & 1);
    const unsigned char* tV = sV + (j % STAGES) * C::NB * C::KV_BOX;
    cpd::fence_regs(acc);
    fence_pregs(p_cur);
    cpd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      cpd::Wgmma<DV>::rs(acc, p_cur[kk], cpd::desc_sw128(tV + kk * 16 * 128, C::KV_BOX, 1024),
                         1);
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

  // out = O / l, rows past Sq and columns past D not stored
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + cw * 64 + warp * 16 + (lane >> 2);
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
}

// rank-4 map (D, H, S, B) over one operand, box {64, 1, rows, 1}
int encode_operand(CUtensorMap* map, const void* base, int B, int H, int S, int D,
                   long long bstride, long long rstride, int rows) {
  return cpd::encode_bf16_map<4>(
      map, base, {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B},
      {(uint64_t)D * 2, (uint64_t)rstride * 2, (uint64_t)bstride * 2},
      {(uint32_t)BOX, 1u, (uint32_t)rows, 1u});
}

template <int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Skv,
           int D, long long qbs, long long qrs, long long kbs, long long krs, long long vbs,
           long long vrs, float scale_log2, cudaStream_t stream) {
  typedef Cfg<DV> C;
  CUtensorMap tq, tk, tv;
  int err = encode_operand(&tq, q, B, H, Sq, D, qbs, qrs, BQ);
  if (!err) err = encode_operand(&tk, k, B, H, Skv, D, kbs, krs, C::BKV);
  if (!err) err = encode_operand(&tv, v, B, H, Skv, D, vbs, vrs, C::BKV);
  if (err) return err;
  auto kernel = attention_sm90_kernel<DV>;
  static bool attr_set = false;  // one card a process
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, static_cast<bf16*>(o), H, Sq, Skv, D,
                                             scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Sq, H*D], k and v [B, Skv, H*D] bf16 with unit column stride, batch
// and row strides in elements (multiples of 8, 16-byte aligned bases); o a
// fresh contiguous [B, Sq, H*D]. D % 8 == 0 and D <= 256.
extern "C" int cpd_attention_sm90_bf16(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int Sq, int Skv, int D, long long qbs,
                                       long long qrs, long long kbs, long long krs,
                                       long long vbs, long long vrs, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 || D > 256 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * 1.4426950408889634f;
#define CPD_SM90_CASE(DVV)                                                                   \
  case DVV:                                                                                  \
    return launch<DVV>(q, k, v, o, B, H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs, sl2, s);
  switch (D) {
    CPD_SM90_CASE(8)
    CPD_SM90_CASE(16)
    CPD_SM90_CASE(24)
    CPD_SM90_CASE(32)
    CPD_SM90_CASE(40)
    CPD_SM90_CASE(48)
    CPD_SM90_CASE(56)
    CPD_SM90_CASE(64)
    CPD_SM90_CASE(72)
    CPD_SM90_CASE(80)
    CPD_SM90_CASE(88)
    CPD_SM90_CASE(96)
    CPD_SM90_CASE(120)
    CPD_SM90_CASE(128)
    CPD_SM90_CASE(152)
    CPD_SM90_CASE(160)
    CPD_SM90_CASE(248)
    CPD_SM90_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CPD_SM90_CASE
}
