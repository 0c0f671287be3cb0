// K1 on Hopper, bf16 with 256 < d <= 512: softmax attention,
// out = softmax(scale * Q K^T) V, for the VAE mid-block of the bf16 decode
// and encode (one head, d = 512, S = 4096 at 512^2, batch 1 or 4).
//
// Replaces the TPU kernel complex_prompt_diffusion_tpu/ops/attention.py::
// _attn_kernel (the streaming kernel) for bf16 with d > 256. attention.cu's
// mma.sync body for these head dims (attention_bf16_wide_kernel) stays built
// as the body this one replaced, timed beside it. Rounding as the TPU
// kernel: S in f32, P = exp2(S - max) rounded to bf16 before P V, P V
// accumulated in f32, one division by the f32 row sum at the end.
//
// What bounds it on the H100: 4 B H Sq Skv d flops (3.4e10 at B1 S4096
// d512: 0.035 ms on the bf16 tensor cores). The mma.sync body split the
// head dim over 8 warps of a 64-row query tile (214.5 KB of shared memory,
// one block an SM): 64 blocks at B1 on 132 SMs, and its score step fed two
// MMAs per ldmatrix fragment (bound by shared memory). It ran 1.45x SDPA at
// B1. A fused flash body on wgmma needs a 64 x 512 f32 O tile (128 KB of
// registers) and 64 KB K and V tiles a stage, which leaves no room for a
// ring. So this body is three kernels (the form of attention_f32_sm90.cu,
// with one bf16 product in place of three TF32 ones and no split kernels):
//   1. scores: S = scale log2(e) Q K^T, f32 into a workspace [B*H, rows,
//      Skv'] (Skv' = Skv rounded up to 8); Q and K K-major as they lie
//      (rank-4 TMA maps (D, H, S, B) over the [B, S, H*D] operands);
//   2. softmax_rows: row max, exp2, f32 row sum; P in bf16 into the
//      workspace, 1 / sum;
//   3. out: O = (P V) / sum; V read in place as the MN-major B operand of
//      wgmma (its 64-column boxes), so no transpose.
// Both GEMMs: 128 x 128 output tiles, two consumer warpgroups of wgmma
// m64n128k16, a producer thread issuing TMA loads (128-byte swizzle, zero
// fill past the operands: ragged rows, keys and head dims need no masks)
// into a 3-stage ring of 32 KB; 96 KB and 288 threads a block (the producer
// is one warp, so the registers of two blocks fit an SM), two blocks an SM,
// so one block's epilogue runs under the other's products. 1024 score tiles and
// 128 output tiles at B1 S4096: the grid fills the card at batch 1, which
// the split-d body's 64 blocks did not. The workspace holds S and P for
// `rows` query rows at a time (the host's choice, all of them at the
// decode's shapes), so it does not grow with S^2 past its cap.

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TM = 128;        // output rows a tile (two warpgroups of 64)
constexpr int TN = 128;        // output columns a tile
constexpr int TK = 64;         // reduction elements a k-step (one 128-byte row)
constexpr int STAGES = 3;
constexpr int THREADS = 288;   // warpgroups 0, 1: consumers; warp 8: the producer
constexpr int A_BYTES = TM * TK * 2;
constexpr int B_BYTES = TN * TK * 2;
constexpr int B_BOX = 64 * TK * 2;  // EPI_OUT: one {64 d, 64 keys} box of V
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
static_assert(2 * SMEM <= 232448, "two blocks an SM");
// two blocks an SM: at most 65536 / (2 * 288) = 113 registers a thread

constexpr int EPI_SCORES = 0;  // s[z][m][n] = scale * acc (f32)
constexpr int EPI_OUT = 1;     // o[b, row0 + m, h D + n] = acc * inv_l[z][m] (bf16)

struct GemmArgs {
  int M, N, ksteps;    // output rows and columns of a z, k-steps of 64
  int H;               // heads: z = b H + h
  int row0;            // the pass's first query row
  float scale;         // EPI_SCORES: scale log2 e
  float* s;            // EPI_SCORES: [z][M][lds] f32
  long long lds;
  const float* inv_l;  // EPI_OUT: [z][M]
  bf16* o;             // EPI_OUT: [B, Sq, H * D]
  int Sq, D;
};

// EPI_SCORES: C[z] = Q[z] K[z]^T, A = Q (rank-4 map), B = K (rank-4 map),
// both K-major. EPI_OUT: C[z] = P[z] V[z], A = P (rank-3 map over the
// workspace), B = V (rank-4 map, MN-major: two {64, 64} boxes a k-step).
template <int EPI>
__global__ void __launch_bounds__(THREADS, 2)
wide_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 GemmArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM, z = blockIdx.z;
  const int b = z / a.H, h = z - (z / a.H) * a.H;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 256) {
    for (int s = 0; s < STAGES; ++s) {
      cpd::mbar_init(&full[s], 1);
      cpd::mbar_init(&empty[s], 256);
    }
    cpd::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    if (threadIdx.x == 256) {
      cpd::tma_prefetch_desc(&ta);
      cpd::tma_prefetch_desc(&tb);
      for (int i = 0; i < a.ksteps; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) cpd::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * STAGE;
        cpd::mbar_expect_tx(&full[s], STAGE);
        if constexpr (EPI == EPI_SCORES) {
          cpd::tma_load_4d(st, &ta, &full[s], i * TK, h, a.row0 + m0, b);
          cpd::tma_load_4d(st + A_BYTES, &tb, &full[s], i * TK, h, n0, b);
        } else {
          cpd::tma_load_3d(st, &ta, &full[s], i * TK, m0, z);
          cpd::tma_load_4d(st + A_BYTES, &tb, &full[s], n0, h, i * TK, b);
          cpd::tma_load_4d(st + A_BYTES + B_BOX, &tb, &full[s], n0 + 64, h, i * TK, b);
        }
      }
    }
    return;
  }

  const int cw = wg;  // this warpgroup's rows: 64 cw .. 64 cw + 63 of the tile
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < a.ksteps; ++i) {
    const int s = i % STAGES;
    cpd::mbar_wait(&full[s], (i / STAGES) & 1);
    const unsigned char* st = ring + s * STAGE;
    cpd::fence_regs(acc);
    cpd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint64_t da = cpd::desc_sw128(st + cw * 64 * 128 + kk * 32, 16, 1024);
      if constexpr (EPI == EPI_SCORES)
        cpd::Wgmma<TN>::ss(acc, da, cpd::desc_sw128(st + A_BYTES + kk * 32, 16, 1024),
                           i > 0 || kk > 0);
      else
        cpd::Wgmma<TN>::ss_bmn(acc, da,
                               cpd::desc_sw128(st + A_BYTES + kk * 16 * 128, B_BOX, 1024),
                               i > 0 || kk > 0);
    }
    cpd::wgmma_commit();
    cpd::wgmma_wait<1>();  // k-step i - 1's group has retired: free its stage
    cpd::fence_regs(acc);
    if (i > 0) cpd::mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  cpd::wgmma_wait<0>();
  cpd::fence_regs(acc);

  // epilogue: thread rows 16 warp + g (+ 8) of this warpgroup's 64,
  // columns 8 j + 2 t4 (+ 1)
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + cw * 64 + warp * 16 + g + half * 8;
    if (m >= a.M) continue;
    if constexpr (EPI == EPI_SCORES) {
      float* row = a.s + ((long long)z * a.M + m) * a.lds;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * t4;
        const float v0 = acc[4 * j + 2 * half] * a.scale;
        const float v1 = acc[4 * j + 2 * half + 1] * a.scale;
        if (col + 1 < a.N) {
          *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
        } else if (col < a.N) {
          row[col] = v0;
        }
      }
    } else {
      const float il = a.inv_l[(long long)z * a.M + m];
      bf16* row = a.o + ((long long)b * a.Sq + a.row0 + m) * ((long long)a.H * a.D) +
                  (long long)h * a.D;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * t4;
        if (col < a.D)  // D % 8 == 0
          *reinterpret_cast<uint32_t*>(row + col) =
              cpd::pack_bf16(acc[4 * j + 2 * half] * il, acc[4 * j + 2 * half + 1] * il);
      }
    }
  }
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = cpd::warp_max(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? scratch[lane] : -INFINITY;
    t = cpd::warp_max(t);
    if (lane == 0) scratch[32] = t;
  }
  __syncthreads();
  const float out = scratch[32];
  __syncthreads();
  return out;
}

// one block a row of S (N scores, already scaled by scale log2 e): P =
// bf16(exp2(S - max)) into p (same row stride), inv_l = 1 / sum of the f32
// exp2 values. Pairs of columns: ld is even.
__global__ void __launch_bounds__(256)
wide_softmax_rows_kernel(const float* __restrict__ s, bf16* __restrict__ p,
                         float* __restrict__ inv_l, int N, long long ld) {
  __shared__ float scratch[33];
  const float* r = s + blockIdx.x * ld;
  bf16* pr = p + blockIdx.x * ld;
  const int pairs = N / 2;
  float mx = -INFINITY;
  for (int c = threadIdx.x; c < pairs; c += blockDim.x) {
    const float2 v = reinterpret_cast<const float2*>(r)[c];
    mx = fmaxf(mx, fmaxf(v.x, v.y));
  }
  if ((N & 1) && threadIdx.x == 0) mx = fmaxf(mx, r[N - 1]);
  mx = block_max(mx, scratch);
  float sum = 0.f;
  for (int c = threadIdx.x; c < pairs; c += blockDim.x) {
    const float2 v = reinterpret_cast<const float2*>(r)[c];
    const float p0 = exp2f(v.x - mx), p1 = exp2f(v.y - mx);
    sum += p0 + p1;
    reinterpret_cast<uint32_t*>(pr)[c] = cpd::pack_bf16(p0, p1);
  }
  if ((N & 1) && threadIdx.x == 0) {
    const float p0 = exp2f(r[N - 1] - mx);
    sum += p0;
    pr[N - 1] = __float2bfloat16(p0);
  }
  sum = cpd::block_sum(sum, scratch);
  if (threadIdx.x == 0) inv_l[blockIdx.x] = 1.f / sum;
}

// rank-4 map (D, H, S, B) over one [B, S, H*D] operand, box {64, 1, rows, 1}
int encode_operand(CUtensorMap* map, const void* base, int B, int H, int S, int D,
                   long long bstride, long long rstride, int rows) {
  return cpd::encode_bf16_map<4>(
      map, base, {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B},
      {(uint64_t)D * 2, (uint64_t)rstride * 2, (uint64_t)bstride * 2},
      {(uint32_t)TK, 1u, (uint32_t)rows, 1u});
}

template <int EPI>
int launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const GemmArgs& a, int Z,
                cudaStream_t stream) {
  auto kernel = wide_gemm_kernel<EPI>;
  static bool attr_set = false;  // one card a process
  if (!attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((a.N + TN - 1) / TN, (a.M + TM - 1) / TM, Z);
  kernel<<<grid, THREADS, SMEM, stream>>>(ta, tb, a);
  return (int)cudaGetLastError();
}

long long round256(long long n) { return (n + 255) / 256 * 256; }

// bytes of workspace with `rows` query rows a pass (ops/attention.py:
// _bf16_wide_workspace computes the same): S f32, P bf16, 1 / sum f32
long long workspace_bytes(int B, int H, int Skv, int rows) {
  const long long Z = (long long)B * H, ld = (Skv + 7) / 8 * 8;
  return round256(Z * rows * ld * 4) + round256(Z * rows * ld * 2) + round256(Z * rows * 4);
}

}  // namespace

// q [B, Sq, H*D], k and v [B, Skv, H*D] bf16 with unit column stride, batch
// and row strides in elements (multiples of 8, 16-byte aligned bases); o a
// fresh contiguous [B, Sq, H*D]; ws: workspace_bytes() bytes (ws_bytes of
// them), 256-byte aligned. D % 8 == 0, 256 < D <= 512 (any D % 8 == 0 up to
// 512 computes). Query rows go through the scores, softmax and output
// kernels `rows` at a time. Sets *launched to the kernels it launched, three
// a pass.
extern "C" int cpd_attention_bf16_wide_sm90(const void* q, const void* k, const void* v, void* o,
                                            void* ws, long long ws_bytes, int B, int H, int Sq,
                                            int Skv, int D, long long qbs, long long qrs,
                                            long long kbs, long long krs, long long vbs,
                                            long long vrs, float scale, int rows, int* launched,
                                            void* stream) {
  *launched = 0;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 || D > 512 || rows <= 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  rows = rows < Sq ? rows : Sq;
  if (ws_bytes < workspace_bytes(B, H, Skv, rows)) return (int)cudaErrorInvalidValue;
  const int Z = B * H;
  const long long ld = (Skv + 7) / 8 * 8;
  unsigned char* w = static_cast<unsigned char*>(ws);
  float* sc = reinterpret_cast<float*>(w);
  bf16* pb = reinterpret_cast<bf16*>(w + round256((long long)Z * rows * ld * 4));
  float* il = reinterpret_cast<float*>(w + round256((long long)Z * rows * ld * 4) +
                                       round256((long long)Z * rows * ld * 2));
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  CUtensorMap tq, tk, tv;
  int err = encode_operand(&tq, q, B, H, Sq, D, qbs, qrs, TM);
  if (!err) err = encode_operand(&tk, k, B, H, Skv, D, kbs, krs, TN);
  if (!err) err = encode_operand(&tv, v, B, H, Skv, D, vbs, vrs, TK);
  if (err) return err;
  for (int row0 = 0; row0 < Sq; row0 += rows) {
    const int R = min(rows, Sq - row0);
    // 1. scores of rows row0 .. row0 + R - 1 (the Q map's rows past them are
    // loaded and not stored)
    GemmArgs g1{R, Skv, (D + TK - 1) / TK, H, row0, scale * 1.4426950408889634f, sc, ld,
                nullptr, nullptr, Sq, D};
    err = launch_gemm<EPI_SCORES>(tq, tk, g1, Z, st);
    if (err) return err;
    ++*launched;
    // 2. softmax
    wide_softmax_rows_kernel<<<Z * R, 256, 0, st>>>(sc, pb, il, Skv, ld);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launched;
    // 3. out, through a map over P's Skv columns (zero fill past them)
    CUtensorMap tp;
    err = cpd::encode_bf16_map<3>(&tp, pb, {(uint64_t)Skv, (uint64_t)R, (uint64_t)Z},
                                  {(uint64_t)ld * 2, (uint64_t)ld * 2 * R},
                                  {(uint32_t)TK, (uint32_t)TM, 1u});
    if (err) return err;
    GemmArgs g2{R, D, (Skv + TK - 1) / TK, H, row0, 1.f, nullptr, 0, il,
                static_cast<bf16*>(o), Sq, D};
    err = launch_gemm<EPI_OUT>(tp, tv, g2, Z, st);
    if (err) return err;
    ++*launched;
  }
  return 0;
}
