// K5 on Hopper, f32: exact-f32 softmax attention, out = softmax(scale *
// Q K^T) V, over operands whose SEQUENCE axis is the contiguous one, on the
// TF32 tensor cores with three products per product ("3xTF32").
//
// Replaces the TPU kernels complex_prompt_diffusion_tpu/ops/attention.py::
// _onepass_kernel_hdbs and ::_onepass_kernel_kcanon for f32 (an f32 UNet
// under attn_route="cm" or the kcanon route). The body it replaced
// (attention_cm.cu: CUDA-core FMAs, 64 x 64 tiles) stays built as
// ops.attention.attention_dmajor_prior. Rounding as the plain twin: f32
// scores, an exp2 softmax on scores scaled by scale * log2 e, P V on f32 P,
// one division by the row sum.
//
// What bounds it on the H100: 4 B H Sq Skv d flops. Exact f32 rules out one
// TF32 product (about 1e-3 relative); the FMA units give 67 TFLOP/s, and
// the replaced body ran 1.5-2.3x slower than SDPA. Here, as in K1's 3xTF32
// body (attention_f32_sm90.cu), each operand x is split into hi = tf32(x)
// and lo = tf32(x - hi), and a product a b is a_lo b_hi + a_hi b_lo + a_hi
// b_hi with f32 accumulation: three TF32 products, at 495 / 3 TFLOP/s.
//
// TF32 wgmma takes K-major operands only, so the d-major tiles cannot be
// read as they lie (the bf16 body, attention_cm_sm90.cu, reads them so).
// Fused design, for head dims up to 160:
//   * a producer warpgroup whose one thread lands f32 tiles by TMA (rank-4
//     maps with the sequence innermost, as the bf16 body's, no swizzle):
//     Q once, then K and V tiles of BKV keys into a landing buffer, the next
//     tile's while the consumers compute on this one;
//   * one or two consumer warpgroups (64 query rows each) that split what
//     landed into TF32 hi and lo tiles in shared memory, in the K-major
//     128-byte-swizzled layout wgmma reads: the d-major Q [d][q] transposed
//     to [q][d] (once), a d-major K [d][keys] transposed to [keys][d] (hdbs)
//     or a canonical K [keys][d] split as it lies (kcanon), a d-major V
//     [d][keys] split as it lies (it is a K-major B of P V);
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
//   * the accumulator holds [q][d] and the output is d-major: it is staged
//     transposed in Q's space (dead by then) and written with 16-byte stores
//     along S.
// Shared memory sets the tiles (CfgF; ops/attention.py: k5_config): Q's
// hi and lo for 128 rows, one split K and V tile, one landed K and V tile.
// d <= 80: 128 queries, 64-key tiles; d <= 128: 128 queries, 32 keys; d <=
// 160: 64 queries, 32 keys. Above 160 no such block fits 227 KB, and the head
// dim takes the unfused 3xTF32 kernels of attention_f32_sm90.cu: a split of
// K5's strided layouts into their K-major hi and lo buffers (three kernels
// here), then their scores, softmax and output kernels, the output written
// d-major.

#include "attention_f32x3.cuh"
#include "sm90.cuh"

namespace {

constexpr int SMEM_MAX = 232448;
constexpr int KB = 32;  // f32 elements of a 128-byte row: a K-major box's width
constexpr int FUSED_MAX_D = 160;

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

struct OStrides {
  long long b, h, d;
};

template <int DV, bool KCANON>
__global__ void __launch_bounds__(CfgF<DV>::THREADS, 1)
attention_cm_f32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                             OStrides os, int H, int Sq, int Skv, int D, float scale_log2) {
  typedef CfgF<DV> C;
  constexpr int BQ = C::BQ, BKV = C::BKV, NC = C::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;              // hi [NKB][BQ][32], then lo
  unsigned char* sK = sQ + C::Q_BYTES;   // hi [NKB][BKV][32], then lo
  unsigned char* sV = sK + C::K_BYTES;   // hi [NVB][DV][32 keys], then lo
  float* rawK = reinterpret_cast<float*>(sV + C::V_BYTES);  // [DV][BKV], or [BKV][DV] (kcanon)
  float* rawV = rawK + BKV * DV;                            // [DV][BKV]
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
      // Q [DV][BQ] lands in the split tiles' space, free until the first split
      cpd::mbar_expect_tx(q_full, BQ * DV * 4);
      cpd::tma_load_4d(sK, &tq, q_full, q0, 0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        if (j > 0) cpd::mbar_wait(land_empty, (j - 1) & 1);
        cpd::mbar_expect_tx(land_full, 2 * C::RAW);
        if constexpr (KCANON)
          cpd::tma_load_4d(rawK, &tk, land_full, 0, j * BKV, h, b);
        else
          cpd::tma_load_4d(rawK, &tk, land_full, j * BKV, 0, h, b);
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

  // Q: [DV][BQ] as it landed -> K-major [BQ][DV] hi and lo
  cpd::mbar_wait(q_full, 0);
  {
    const float* rq = reinterpret_cast<const float*>(sK);
    for (int idx = ct; idx < BQ * (DV / 4); idx += NC) {
      const int r = idx % BQ, c4 = idx / BQ;
      const float4 x = make_float4(rq[(4 * c4) * BQ + r], rq[(4 * c4 + 1) * BQ + r],
                                   rq[(4 * c4 + 2) * BQ + r], rq[(4 * c4 + 3) * BQ + r]);
      store_split(sQ, C::Q_PART, C::NKB * C::Q_PART, r, c4, x);
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
  uint32_t ph[BKV / 8][4], pl[BKV / 8][4];

  for (int j = 0; j < ntiles; ++j) {
    cpd::mbar_wait(land_full, j & 1);
    if (j > 0) cpd::named_barrier(1, NC);  // every warpgroup is done with tile j - 1's split tiles
    if constexpr (KCANON) {  // [BKV][DV] -> hi and lo as they lie
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
    // V [DV][BKV] -> hi and lo as they lie, each 8-key group as keys 0 2 4 6 1 3 5 7
    for (int idx = ct; idx < DV * (BKV / 8); idx += NC) {
      const int r = idx / (BKV / 8), g8 = idx % (BKV / 8);
      const float4 a = *reinterpret_cast<const float4*>(rawV + r * BKV + 8 * g8);
      const float4 c = *reinterpret_cast<const float4*>(rawV + r * BKV + 8 * g8 + 4);
      store_split(sV, C::V_PART, C::NVB * C::V_PART, r, 2 * g8, make_float4(a.x, a.z, c.x, c.z));
      store_split(sV, C::V_PART, C::NVB * C::V_PART, r, 2 * g8 + 1,
                  make_float4(a.y, a.w, c.y, c.w));
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

  // out = O / l, transposed through Q's space: [DV][BQ] f32, row d's 16-byte
  // chunk c at c ^ (d % 8)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
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
      *reinterpret_cast<float4*>(ob + d * os.d + 4 * c) =
          *reinterpret_cast<const float4*>(st + d * BQ + ((c ^ (d & 7)) << 2));
  }
}

// rank-4 f32 map (inner, rows, H, B): inner unit stride, the others at the
// given element strides; box {box_inner, box_rows, 1, 1}, no swizzle
int encode(CUtensorMap* map, const void* base, int inner, int rows, int H, int B,
           long long rstride, long long hstride, long long bstride, int box_inner, int box_rows) {
  return cpd::encode_map<4>(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base,
                            {(uint64_t)inner, (uint64_t)rows, (uint64_t)H, (uint64_t)B},
                            {(uint64_t)rstride * 4, (uint64_t)hstride * 4, (uint64_t)bstride * 4},
                            {(uint32_t)box_inner, (uint32_t)box_rows, 1u, 1u},
                            CU_TENSOR_MAP_SWIZZLE_NONE);
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, Sq, Skv, D;
  long long q_sb, q_sh, q_sd, k_sb, k_sh, k_sx, v_sb, v_sh, v_sd, o_sb, o_sh, o_sd;
  float scale;
};

template <int DV, bool KCANON>
int launch(const Args& a, cudaStream_t stream) {
  typedef CfgF<DV> C;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, a.q, a.Sq, a.D, a.H, a.B, a.q_sd, a.q_sh, a.q_sb, C::BQ, DV);
  if (!err)
    err = KCANON ? encode(&tk, a.k, a.D, a.Skv, a.H, a.B, a.k_sx, a.k_sh, a.k_sb, DV, C::BKV)
                 : encode(&tk, a.k, a.Skv, a.D, a.H, a.B, a.k_sx, a.k_sh, a.k_sb, C::BKV, DV);
  if (!err) err = encode(&tv, a.v, a.Skv, a.D, a.H, a.B, a.v_sd, a.v_sh, a.v_sb, C::BKV, DV);
  if (err) return err;
  auto kernel = attention_cm_f32_sm90_kernel<DV, KCANON>;
  static bool attr_set = false;  // one card a process
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((a.Sq + C::BQ - 1) / C::BQ, a.B * a.H);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, static_cast<float*>(a.o),
                                                OStrides{a.o_sb, a.o_sh, a.o_sd}, a.H, a.Sq,
                                                a.Skv, a.D, a.scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// the fused width for head dim D (ops/attention.py: _K5_F32_DV), 0 above
// FUSED_MAX_D
int width_of(int D) {
  static const int widths[] = {16, 32, 40, 48, 64, 80, 96, 128, 160};
  if (D <= 0 || D % 4 || D > FUSED_MAX_D) return 0;
  for (int w : widths)
    if (w >= D) return w;
  return 0;
}

template <bool KCANON>
int dispatch(const Args& a, cudaStream_t s) {
  switch (width_of(a.D)) {
    case 16: return launch<16, KCANON>(a, s);
    case 32: return launch<32, KCANON>(a, s);
    case 40: return launch<40, KCANON>(a, s);
    case 48: return launch<48, KCANON>(a, s);
    case 64: return launch<64, KCANON>(a, s);
    case 80: return launch<80, KCANON>(a, s);
    case 96: return launch<96, KCANON>(a, s);
    case 128: return launch<128, KCANON>(a, s);
    case 160: return launch<160, KCANON>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

void config_of(int DV, int* out) {
#define CPD_CMF_CFG(W)                                                                \
  case W:                                                                            \
    out[0] = CfgF<W>::BQ, out[1] = CfgF<W>::BKV, out[2] = 1, out[3] = CfgF<W>::SMEM; \
    break;
  switch (DV) {
    CPD_CMF_CFG(16)
    CPD_CMF_CFG(32)
    CPD_CMF_CFG(40)
    CPD_CMF_CFG(48)
    CPD_CMF_CFG(64)
    CPD_CMF_CFG(80)
    CPD_CMF_CFG(96)
    CPD_CMF_CFG(128)
    CPD_CMF_CFG(160)
  }
#undef CPD_CMF_CFG
}

// ---- the unfused route (FUSED_MAX_D < d <= 256) ----

// hi and lo of a strided operand, rows r and columns c of each (b, h) as the
// contiguous [B*H, R, Cp] (columns from C on zero): element (r, c) at
// b sb + h sh + r sr + c sc, with sr == 1 (r_unit) or sc == 1; 32 x 32
// tiles through shared memory, read along the unit stride
__global__ void attention_cm_split_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                          float* __restrict__ lo, int H, int R, int C, int Cp,
                                          long long sb, long long sh, long long sr, long long sc,
                                          int r_unit) {
  __shared__ float tile[32][33];
  const int z = blockIdx.z;
  const int b = z / H, h = z - (z / H) * H;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* base = x + b * sb + h * sh;
  for (int i = ty; i < 32; i += 8) {
    const int rr = r_unit ? tx : i, cc = r_unit ? i : tx;
    const int r = r0 + rr, c = c0 + cc;
    tile[rr][cc] = (r < R && c < C) ? base[r * sr + c * sc] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    if (r < R && c < Cp) {
      uint32_t a, l;
      split(tile[i][tx], a, l);
      const long long idx = ((long long)z * R + r) * Cp + c;
      hi[idx] = __uint_as_float(a);
      lo[idx] = __uint_as_float(l);
    }
  }
}

}  // namespace

// q, v [B, H, D, S] and o [B, H, D, Sq] f32 views with unit stride along S;
// k the same, or with k_canonical a [B, H, Skv, D] view with unit stride
// along D. Strides in elements as cpd_attention_cm_sm90_bf16's, multiples of
// 4 with 16-byte aligned bases. D % 4 == 0, D <= 256; Sq % 4 == 0 and
// Skv % 4 == 0. D <= 160 launches the fused kernel (*launched = 1); above,
// ws (ws_floats floats: cpd::f32x3_workspace's) takes the
// split operands, S and P of `rows` query rows a pass, and *launched is
// 3 + 3 a pass.
extern "C" int cpd_attention_cm_f32_sm90(const void* q, const void* k, const void* v, void* o,
                                         void* ws, long long ws_floats, int B, int H, int Sq,
                                         int Skv, int D, long long q_sb, long long q_sh,
                                         long long q_sd, long long k_sb, long long k_sh,
                                         long long k_sx, long long v_sb, long long v_sh,
                                         long long v_sd, long long o_sb, long long o_sh,
                                         long long o_sd, int k_canonical, float scale, int rows,
                                         int* launched, void* stream) {
  *launched = 0;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 4 || D > 256 || Sq % 4 ||
      Skv % 4 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= FUSED_MAX_D) {
    const Args a{q, k, v, o, B, H, Sq, Skv, D, q_sb, q_sh, q_sd, k_sb, k_sh, k_sx,
                 v_sb, v_sh, v_sd, o_sb, o_sh, o_sd, scale};
    const int err = k_canonical ? dispatch<true>(a, s) : dispatch<false>(a, s);
    if (!err) *launched = 1;
    return err;
  }
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  rows = rows < Sq ? rows : Sq;
  const cpd::F32x3Ws w = cpd::f32x3_workspace(ws, B, H, Sq, Skv, D, rows);
  if (ws_floats < w.floats) return (int)cudaErrorInvalidValue;
  const long long Z = (long long)B * H, Sp = (Skv + 3) / 4 * 4;
  const dim3 tb(32, 8);
  auto grid = [&](long long r, long long c) {
    return dim3((unsigned)((c + 31) / 32), (unsigned)((r + 31) / 32), (unsigned)Z);
  };
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  // Q (queries x d, queries unit), K (keys x d: d-major, keys unit; or
  // canonical, d unit), V (d x keys, keys unit, padded to Sp)
  attention_cm_split_kernel<<<grid(Sq, D), tb, 0, s>>>(qf, w.qh, w.ql, H, Sq, D, D, q_sb,
                                                        q_sh, 1, q_sd, 1);
  if (k_canonical)
    attention_cm_split_kernel<<<grid(Skv, D), tb, 0, s>>>(kf, w.kh, w.kl, H, Skv, D, D, k_sb,
                                                           k_sh, k_sx, 1, 0);
  else
    attention_cm_split_kernel<<<grid(Skv, D), tb, 0, s>>>(kf, w.kh, w.kl, H, Skv, D, D, k_sb,
                                                           k_sh, 1, k_sx, 1);
  attention_cm_split_kernel<<<grid(D, Sp), tb, 0, s>>>(vf, w.vh, w.vl, H, D, Skv, (int)Sp,
                                                        v_sb, v_sh, v_sd, 1, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *launched += 3;
  int passes = 0;
  const int err = cpd::f32x3_passes(w, o, B, H, Sq, Skv, D, scale, rows, 1, o_sb, o_sh, o_sd,
                                    &passes, s);
  *launched += passes;
  return err;
}

// out[0..4]: query rows a block, keys a tile, stages, shared-memory bytes,
// and 1 for the fused kernel (0: the unfused kernels, no block config)
extern "C" int cpd_attention_cm_f32_sm90_config(int D, int k_canonical, int* out) {
  (void)k_canonical;  // the canonical K tile takes the d-major one's space
  if (D <= 0 || D % 4 || D > 256) return (int)cudaErrorInvalidValue;
  const int dv = width_of(D);
  out[0] = out[1] = out[2] = out[3] = out[4] = 0;
  if (dv) {
    config_of(dv, out);
    out[4] = 1;
  }
  return 0;
}
