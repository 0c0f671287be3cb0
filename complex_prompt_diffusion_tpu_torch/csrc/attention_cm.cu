// K5: non-causal softmax attention, out = softmax(scale * Q K^T) V, over
// operands whose SEQUENCE axis is the contiguous one.
//
// Replaces the TPU kernels complex_prompt_diffusion_tpu/ops/attention.py::
// _onepass_kernel_hdbs (the fused channel-major self-attention block: Q, K,
// V and the output are [H, D, B*S] slices of the [3C, B, S] qkv projection)
// and ::_onepass_kernel_kcanon (Q, V and the output d-major [BH, D, S], K
// canonical [BH, S, D]). What those kernels exist for is that the operands
// arrive with S contiguous and no relayout is made on either side of the
// kernel, so this is a kernel of its own and not K1 behind two copies.
//
// Operands: Q, V and the output are "d-major": element (b, h, dd, s) lies
// at base + b * sb + h * sh + dd * sd + s. That one form covers the
// [H, D, B, S] slices of the cm block (sb = S, sh = D * B * S, sd = B * S)
// and a contiguous [B, H, D, S]. K is d-major too, or, in canonical mode,
// element (b, h, s, dd) at base + b * sb + h * sh + s * sx + dd, read in
// place from a [B, S, H*D] projection. Sequence lengths and all strides are
// multiples of 16 bytes (the wrapper checks), so every global access is a
// 16-byte one along s (or along dd for a canonical K).
//
// What bounds it on the H100: the same work as K1, 4 * B * H * Sq * Skv * D
// flops over 2 * B * H * (Sq + Skv) * D elements, compute bound at the UNet
// shapes (S = 4096 / 1024 / 256, d = 40 / 80 / 160). The TPU kernels kept a
// whole K/V row in VMEM and took the row sums from a ones-row appended to V;
// a Hopper SM's 227 KB of shared memory cannot hold an S = 4096 row, so this
// is an online-softmax loop over 64-key KV tiles like K1, and the row sums
// live in registers.
//
// Design, bf16: 4 warps x 16 query rows, K/V tiles double-buffered with
// cp.async, both products on the tensor cores (mma.sync m16n8k16, f32
// accumulate), P rounded to bf16 before the PV product as in the TPU
// kernels. With S contiguous the shared-memory tiles are [d][s], the
// transposes of K1's:
//   * the Q tile [d][64 queries] is the A operand [m][k] transposed, and a
//     d-major K tile [d][64 keys] is the B operand [n][k] transposed: both
//     come out of ldmatrix.trans; a canonical K tile [64 keys][d] is read as
//     in K1;
//   * the V tile [d][64 keys] already is [n][k] for the PV product: plain
//     ldmatrix, the reverse of K1;
//   * the accumulator holds [query][d] but the output row is [d][Sq]: it is
//     staged through shared memory (the Q tile's space) so that the global
//     stores are 16-byte and coalesced along s;
//   * d = 40 is padded to 48 by zero-filled ROWS of the tiles in shared
//     memory, never in device memory; keys beyond Skv are zero-filled and
//     their scores masked, so any Skv % 8 == 0 is taken (the JAX wrapper
//     pads to 128 and masks).
// A block works on one (batch, head) pair, so a query block never straddles
// a batch and its K/V row is its own batch's.
//
// f32: CUDA-core FMAs (no TF32), K1's f32 tiling (64 x 64 tiles, 4 x 4
// scores and 4 x 16 outputs a thread, d <= 256). It keeps Q^T and K^T in
// shared memory, which is how d-major operands arrive, so Q and a d-major K
// are copied straight in with float4 loads along s; V is transposed while it
// is staged, and the output is written as float4s along s.
// Not yet: wgmma, TMA, warp specialisation.

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

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

template <int DP, bool KCANON>
__global__ void __launch_bounds__(kThreads)
attention_cm_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Sq,
                         int Skv, int D, Strides qs, Strides ks, Strides vs, Strides os,
                         float scale_log2) {
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
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int dd = i * 8 + 2 * t4;
    sO[dd * kLdS + qr] = __float2bfloat16(acc[i][0] * inv0);
    sO[(dd + 1) * kLdS + qr] = __float2bfloat16(acc[i][1] * inv0);
    sO[dd * kLdS + qr + 8] = __float2bfloat16(acc[i][2] * inv1);
    sO[(dd + 1) * kLdS + qr + 8] = __float2bfloat16(acc[i][3] * inv1);
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

template <int DP, bool KCANON>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                int Skv, int D, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                cudaStream_t stream) {
  const int ktile = KCANON ? kB * (DP + 8) : DP * kLdS;
  const int smem = (3 * DP * kLdS + 2 * ktile) * (int)sizeof(bf16);  // Q + 2 x (K, V)
  auto kernel = attention_cm_bf16_kernel<DP, KCANON>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kB - 1) / kB, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, Sq, Skv, D, qs, ks, vs, os, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---- f32: CUDA-core FMAs ----

constexpr int kFB = 64;           // query rows and keys per tile
constexpr int kFThreads = 256;    // 16 x 16 threads, 4 x 4 scores each
constexpr int kFMaxD = 256;
constexpr int kFDChunk = 32;      // head-dim slice of K staged per step
constexpr int kFVChunk = 128;     // head-dim slice of V staged per step
constexpr int kFCol = kFMaxD / 64;  // 64-column slices of O per thread
constexpr int kFLdP = kFB + 4;      // padded rows of the transposed P tile
constexpr int kFLdV = kFVChunk + 4;

// Shared memory (floats): Q^T [D][kFB], K^T chunk [kFDChunk][kFB],
// P^T [kFB][kFLdP], V chunk [kFB][kFLdV].
__host__ __device__ constexpr int f32_smem_floats(int D) {
  return D * kFB + kFDChunk * kFB + kFB * kFLdP + kFB * kFLdV;
}

template <bool KCANON>
__global__ void __launch_bounds__(kFThreads)
attention_cm_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o, int H, int Sq,
                        int Skv, int D, Strides qs, Strides ks, Strides vs, Strides os,
                        float scale_log2) {
  extern __shared__ __align__(16) float fsm[];
  float* sQt = fsm;                     // [D][kFB]: the Q tile as it lies in memory
  float* sKt = sQt + D * kFB;           // [kFDChunk][kFB]: K chunk, d-major
  float* sPt = sKt + kFDChunk * kFB;    // [kFB keys][kFLdP]: P transposed
  float* sV = sPt + kFB * kFLdP;        // [kFB keys][kFLdV]: V chunk, key-major

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kFB;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx*4.. of S, and of each 64-wide O slice
  const int ty = tid >> 4;  // rows ty*4..ty*4+3
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  constexpr int kQuads = kFB / 4;  // float4s along s in a tile row

  for (int idx = tid; idx < D * kQuads; idx += kFThreads) {
    const int dd = idx / kQuads;
    const int r4 = (idx - dd * kQuads) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r4 < Sq) val = *reinterpret_cast<const float4*>(qb + (long long)dd * qs.x + q0 + r4);
    *reinterpret_cast<float4*>(sQt + dd * kFB + r4) = val;
  }

  float acc[4][kFCol][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int kk = 0; kk < kFCol; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][kk][j] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int kv0 = 0; kv0 < Skv; kv0 += kFB) {
    // S = Q K^T for this thread's 4 x 4 block, K staged kFDChunk dims at a time
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kFDChunk) {
      __syncthreads();  // previous readers of sKt are done (and sQt is complete)
      if constexpr (KCANON) {
        // transpose while staging: consecutive threads take consecutive keys
        for (int idx = tid; idx < kFB * (kFDChunk / 4); idx += kFThreads) {
          const int r = idx % kFB;
          const int c = (idx / kFB) * 4;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (kv0 + r < Skv && d0 + c < D)
            val = *reinterpret_cast<const float4*>(kb + (long long)(kv0 + r) * ks.x + d0 + c);
          sKt[(c + 0) * kFB + r] = val.x;
          sKt[(c + 1) * kFB + r] = val.y;
          sKt[(c + 2) * kFB + r] = val.z;
          sKt[(c + 3) * kFB + r] = val.w;
        }
      } else {
        for (int idx = tid; idx < kFDChunk * kQuads; idx += kFThreads) {
          const int dd = idx / kQuads;
          const int r4 = (idx - dd * kQuads) * 4;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (d0 + dd < D && kv0 + r4 < Skv)
            val = *reinterpret_cast<const float4*>(kb + (long long)(d0 + dd) * ks.x + kv0 + r4);
          *reinterpret_cast<float4*>(sKt + dd * kFB + r4) = val;
        }
      }
      __syncthreads();
      const int dn = min(kFDChunk, D - d0);
      for (int dd = 0; dd < dn; ++dd) {
        const float4 qa = *reinterpret_cast<const float4*>(sQt + (d0 + dd) * kFB + ty * 4);
        const float4 ka = *reinterpret_cast<const float4*>(sKt + dd * kFB + tx * 4);
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
        const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
      }
    }

    // online softmax; the 16 threads of a row group are lanes xor 1..8
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = kv0 + tx * 4 + j < Skv ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      alpha[i] = exp2f(m[i] - mx);
      m[i] = mx;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - mx);
        ps += s[i][j];
      }
      l[i] = l[i] * alpha[i] + ps;
#pragma unroll
      for (int kk = 0; kk < kFCol; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][kk][j] *= alpha[i];
    }
    // P^T to shared memory: one float4 holds 4 query rows of one key
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sPt + (tx * 4 + j) * kFLdP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    // O += P V, V staged kFVChunk dims at a time and transposed to [key][d]
    // on the way (consecutive threads take consecutive head dims)
#pragma unroll
    for (int vc = 0; vc < kFMaxD; vc += kFVChunk) {
      if (vc < D) {
        __syncthreads();  // sPt written; previous readers of sV are done
        for (int idx = tid; idx < kFVChunk * kQuads; idx += kFThreads) {
          const int dd = idx % kFVChunk;
          const int r4 = (idx / kFVChunk) * 4;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (vc + dd < D && kv0 + r4 < Skv)
            val = *reinterpret_cast<const float4*>(vb + (long long)(vc + dd) * vs.x + kv0 + r4);
          sV[(r4 + 0) * kFLdV + dd] = val.x;
          sV[(r4 + 1) * kFLdV + dd] = val.y;
          sV[(r4 + 2) * kFLdV + dd] = val.z;
          sV[(r4 + 3) * kFLdV + dd] = val.w;
        }
        __syncthreads();
        for (int key = 0; key < kFB; ++key) {
          const float4 pa = *reinterpret_cast<const float4*>(sPt + key * kFLdP + ty * 4);
          const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
          for (int k2 = 0; k2 < kFVChunk / 64; ++k2) {
            const float4 va = *reinterpret_cast<const float4*>(sV + key * kFLdV + k2 * 64 + tx * 4);
            const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][vc / 64 + k2][j] += pv[i] * vv[j];
          }
        }
      }
    }
  }

  // out = O / l, l summed over the row group; one float4 = 4 queries of one
  // head dim (Sq % 4 == 0: the four rows are valid together)
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    inv[i] = 1.f / li;
  }
  if (q0 + ty * 4 >= Sq) return;
  float* ob = o + b * os.b + h * os.h + q0 + ty * 4;
#pragma unroll
  for (int kk = 0; kk < kFCol; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dd = kk * 64 + tx * 4 + j;
      if (dd < D)
        *reinterpret_cast<float4*>(ob + (long long)dd * os.x) =
            make_float4(acc[0][kk][j] * inv[0], acc[1][kk][j] * inv[1], acc[2][kk][j] * inv[2],
                        acc[3][kk][j] * inv[3]);
    }
  }
}

template <bool KCANON>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
               int Skv, int D, Strides qs, Strides ks, Strides vs, Strides os, float scale,
               cudaStream_t stream) {
  const int smem = (int)sizeof(float) * f32_smem_floats(D);
  auto kernel = attention_cm_f32_kernel<KCANON>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kFB - 1) / kFB, B * H);
  kernel<<<grid, kFThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Sq, Skv, D, qs, ks, vs, os, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements: (batch, head, head dim) of q, v and o, and of a
// d-major k; (batch, head, key row) of a canonical k.
extern "C" int cpd_attention_cm_bf16(const void* q, const void* k, const void* v, void* o,
                                     int B, int H, int Sq, int Skv, int D, long long q_sb,
                                     long long q_sh, long long q_sd, long long k_sb,
                                     long long k_sh, long long k_sx, long long v_sb,
                                     long long v_sh, long long v_sd, long long o_sb,
                                     long long o_sh, long long o_sd, int k_canonical,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || Sq % 8 != 0 || Skv % 8 != 0 || B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_sd}, ks{k_sb, k_sh, k_sx}, vs{v_sb, v_sh, v_sd},
      os{o_sb, o_sh, o_sd};
  const int dp = (D + 15) / 16 * 16;
#define CPD_ATTN_CM_CASE(DPV)                                                                \
  case DPV:                                                                                  \
    return k_canonical                                                                       \
               ? launch_bf16<DPV, true>(q, k, v, o, B, H, Sq, Skv, D, qs, ks, vs, os, scale, s) \
               : launch_bf16<DPV, false>(q, k, v, o, B, H, Sq, Skv, D, qs, ks, vs, os, scale, s);
  switch (dp) {
    CPD_ATTN_CM_CASE(16)
    CPD_ATTN_CM_CASE(32)
    CPD_ATTN_CM_CASE(48)
    CPD_ATTN_CM_CASE(64)
    CPD_ATTN_CM_CASE(80)
    CPD_ATTN_CM_CASE(96)
    CPD_ATTN_CM_CASE(128)
    CPD_ATTN_CM_CASE(160)
    CPD_ATTN_CM_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CPD_ATTN_CM_CASE
}

extern "C" int cpd_attention_cm_f32(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int Sq, int Skv, int D, long long q_sb,
                                    long long q_sh, long long q_sd, long long k_sb,
                                    long long k_sh, long long k_sx, long long v_sb,
                                    long long v_sh, long long v_sd, long long o_sb,
                                    long long o_sh, long long o_sd, int k_canonical,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > kFMaxD || D % 4 != 0 || Sq % 4 != 0 || Skv % 4 != 0 || B <= 0 || H <= 0 || Sq <= 0 ||
      Skv <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_sd}, ks{k_sb, k_sh, k_sx}, vs{v_sb, v_sh, v_sd},
      os{o_sb, o_sh, o_sd};
  return k_canonical
             ? launch_f32<true>(q, k, v, o, B, H, Sq, Skv, D, qs, ks, vs, os, scale, s)
             : launch_f32<false>(q, k, v, o, B, H, Sq, Skv, D, qs, ks, vs, os, scale, s);
}
