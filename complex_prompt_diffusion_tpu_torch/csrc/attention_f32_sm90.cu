// K1 on Hopper, f32 with 256 < d <= 512: exact-f32 softmax attention,
// out = softmax(scale * Q K^T) V, for the VAE mid-block of the exact decode
// (one head, d = 512, S = 4096 at 512^2), on the TF32 tensor cores with
// three products per product ("3xTF32").
//
// Replaces the TPU kernel complex_prompt_diffusion_tpu/ops/attention.py::
// _attn_kernel (the streaming kernel) for f32 with d > 256. attention.cu's
// FMA body (attention_f32.cuh) keeps f32 with d <= 256 and is the probe K7's
// f32 scores loop.
//
// What bounds it on the H100: 4 B H Sq Skv d flops, 1.374e11 at B4 S4096
// d512. Exact f32 rules out one TF32 product (about 1e-3 relative). On the
// FMA units (67 TFLOP/s) that is 2.05 ms; the FMA body ran 7.37 ms, capped
// by shared memory (a 4 x 4 register tile does 2 FMAs per float loaded, and
// an SM's shared memory delivers 32 floats a clock against 128 FMAs). Here
// each f32 operand x is split into a TF32 high part hi = tf32(x) and a low
// part lo = tf32(x - hi), and a product a b is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 accumulation (the lo lo term,
// 2^-22 relative, is dropped): three TF32 products, 0.83 ms of tensor work
// at 495 TFLOP/s, with the error of an f32 product.
//
// Why not fused: at d = 512 a 64-row f32 O tile is 128 KB, and the hi and
// lo parts of one 64-key K tile and one V tile another 256 KB, more than a
// block's 227 KB of shared memory; TF32 wgmma also takes both operands
// K-major only, so V has to be transposed. So the body is four kernels:
//   1. split: Q and K to hi and lo [B*H, S, D], V to hi and lo of its
//      transpose [B*H, D, Skv] (through a shared-memory tile);
//   2. scores: S = scale log2(e) Q K^T by tf32x3_gemm_kernel, f32 into a
//      workspace [B*H, rows, Skv];
//   3. softmax_rows_kernel: row max, exp2, row sum in f32; P split into hi
//      (in place of S) and lo, and 1 / sum;
//   4. out: O = (P V) / sum by tf32x3_gemm_kernel.
// The GEMM: 128 x 128 output tiles, two consumer warpgroups of wgmma
// m64n128k8 (tf32), a producer thread issuing 3-D TMA loads (128-byte
// swizzle, zero fill past the matrix: ragged rows, keys and head dims need
// no masks) of the four 16 KB operand parts of a 32-deep k-step into a ring
// of 3 stages. Each k-step's products land in a fresh accumulator that f32
// adds fold into the running sum (two such accumulators in turns, so one
// k-step's products run while the last one's are added): accumulated in
// the tensor cores across the whole K = 4096 of the output product, the
// first form missed the f32 tolerance (4.6e-5 against 1e-5 at S4095 d384,
// on the H100). The workspace holds S and P for `rows` query rows at a time
// (the host's choice, all of them at the decode's shapes), so the memory
// does not grow with S^2 past its cap. Rounding as the plain twin: f32
// scores and softmax, f32 P V, one division by the row sum. Steps 2-4
// (cpd::f32x3_passes) also run K5's f32 head dims above 160
// (attention_cm_f32_sm90.cu), with the output written d-major.

#include "attention_f32x3.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int TM = 128;       // output rows a tile (two warpgroups of 64)
constexpr int TN = 128;       // output columns a tile
constexpr int TK = 32;        // f32 reduction elements a k-step (one 128-byte row)
constexpr int TSTAGES = 3;
constexpr int TTHREADS = 384;  // warpgroup 0: producer; 1, 2: consumers
constexpr int PART = TM * TK * 4;  // bytes of one operand part (A or B, hi or lo)
constexpr int TSTAGE = 4 * PART;
constexpr int TSMEM = 1024 + TSTAGES * TSTAGE + 2 * TSTAGES * 8;
static_assert(TSMEM <= 232448, "shared memory of one block");

constexpr int EPI_SCORES = 0;  // c[z][m][n] = scale * acc
constexpr int EPI_OUT = 1;     // o[b, row0 + m, h D + n] = acc * inv_l[z][m]

// the 3xTF32 split (tf32x3.cuh), as floats: the split operands go to global
// memory and the TMA loads them back as f32 tiles
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  uint32_t h, l;
  cpd::tf32x3::split(x, h, l);
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

// rows of a [B, S, H*D] operand (any batch and row stride, 16-byte aligned)
// -> hi and lo, contiguous [B*H, S, D]
__global__ void split_rows_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                  float* __restrict__ lo, int H, int S, int D, long long bs,
                                  long long rs, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 4;
    const int d = (int)(e % D);
    const long long rest = e / D;
    const int s = (int)(rest % S);
    const int z = (int)(rest / S);
    const int b = z / H, h = z - (z / H) * H;
    const float4 v = *reinterpret_cast<const float4*>(x + b * bs + s * rs + (long long)h * D + d);
    float4 a, c;
    split(v.x, a.x, c.x);
    split(v.y, a.y, c.y);
    split(v.z, a.z, c.z);
    split(v.w, a.w, c.w);
    *reinterpret_cast<float4*>(hi + e) = a;
    *reinterpret_cast<float4*>(lo + e) = c;
  }
}

// v [B, S, H*D] -> hi and lo of its transpose, [B*H, D, Sp] (Sp >= S, the
// columns from S on are zero); 32 x 32 tiles through shared memory
__global__ void split_transpose_kernel(const float* __restrict__ v, float* __restrict__ hi,
                                       float* __restrict__ lo, int H, int S, int D, int Sp,
                                       long long bs, long long rs) {
  __shared__ float t[32][33];
  const int z = blockIdx.z;
  const int b = z / H, h = z - (z / H) * H;
  const int s0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) {
    const int s = s0 + r, d = d0 + tx;
    t[r][tx] = (s < S && d < D) ? v[b * bs + s * rs + (long long)h * D + d] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int d = d0 + r, s = s0 + tx;
    if (d < D && s < Sp) {
      float a, c;
      split(t[tx][r], a, c);
      const long long idx = ((long long)z * D + d) * Sp + s;
      hi[idx] = a;
      lo[idx] = c;
    }
  }
}

struct GemmArgs {
  int M, N, ksteps;   // output rows and columns of a z, k-steps of 32
  float scale;        // EPI_SCORES
  float* c;           // EPI_SCORES: [z][M][ldc]; EPI_OUT: o [B, Sq, H*D]
  long long ldc;
  const float* inv_l;  // EPI_OUT: [z][M]
  int H, Sq, row0, D;  // EPI_OUT
  // EPI_OUT with dmajor: o d-major (K5's layouts), element (b, h, d, q) at
  // b osb + h osh + d osd + q
  int dmajor;
  long long osb, osh, osd;
};

// C[z] = A[z] B[z]^T with A [M, K] and B [N, K] (K contiguous) given as TF32
// hi and lo parts: a k-step adds A_lo B_hi + A_hi B_lo + A_hi B_hi
template <int EPI>
__global__ void __launch_bounds__(TTHREADS, 1)
tf32x3_gemm_kernel(const __grid_constant__ CUtensorMap tah, const __grid_constant__ CUtensorMap tal,
                   const __grid_constant__ CUtensorMap tbh, const __grid_constant__ CUtensorMap tbl,
                   GemmArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: [A hi][A lo][B hi][B lo], 128 rows x 32 floats each, swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + TSTAGES * TSTAGE);
  uint64_t* empty = full + TSTAGES;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM, z = blockIdx.z;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TSTAGES; ++s) {
      cpd::mbar_init(&full[s], 1);
      cpd::mbar_init(&empty[s], 256);
    }
    cpd::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    cpd::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < a.ksteps; ++i) {
        const int s = i % TSTAGES;
        if (i >= TSTAGES) cpd::mbar_wait(&empty[s], ((i / TSTAGES) & 1) ^ 1);
        unsigned char* st = ring + s * TSTAGE;
        cpd::mbar_expect_tx(&full[s], TSTAGE);
        cpd::tma_load_3d(st, &tah, &full[s], i * TK, m0, z);
        cpd::tma_load_3d(st + PART, &tal, &full[s], i * TK, m0, z);
        cpd::tma_load_3d(st + 2 * PART, &tbh, &full[s], i * TK, n0, z);
        cpd::tma_load_3d(st + 3 * PART, &tbl, &full[s], i * TK, n0, z);
      }
    }
    return;
  }

  cpd::reg_alloc<240>();
  const int cw = wg - 1;  // this warpgroup's rows: 64 cw .. 64 cw + 63 of the tile
  // Each k-step's three products go into a fresh accumulator (t0 or t1, in
  // turns), which is added to acc with f32 adds once its group retires: the
  // tensor cores' accumulation then never carries the running sum of a long
  // reduction (K = Skv = 4096 in the output product), only 32 terms.
  float acc[TN / 2], t0[TN / 2], t1[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = t0[i] = t1[i] = 0.f;
  auto issue = [&](int i, float(&t)[TN / 2]) {
    const int s = i % TSTAGES;
    cpd::mbar_wait(&full[s], (i / TSTAGES) & 1);
    const unsigned char* st = ring + s * TSTAGE;
    cpd::fence_regs(t);
    cpd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 8; ++kk) {
      const int off = cw * 64 * 128 + kk * 32;
      const uint64_t ah = cpd::desc_sw128(st + off, 16, 1024);
      const uint64_t al = cpd::desc_sw128(st + PART + off, 16, 1024);
      const uint64_t bh = cpd::desc_sw128(st + 2 * PART + kk * 32, 16, 1024);
      const uint64_t bl = cpd::desc_sw128(st + 3 * PART + kk * 32, 16, 1024);
      cpd::WgmmaTf32<TN>::ss(t, al, bh, kk > 0);
      cpd::WgmmaTf32<TN>::ss(t, ah, bl, 1);
      cpd::WgmmaTf32<TN>::ss(t, ah, bh, 1);
    }
    cpd::wgmma_commit();
  };
  // after the wait that retired k-step i's group: add it, free its stage
  auto retire = [&](int i, float(&t)[TN / 2]) {
    cpd::fence_regs(t);
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) acc[e] += t[e];
    cpd::mbar_arrive(&empty[i % TSTAGES]);
  };
  issue(0, t0);
  for (int i = 0; i < a.ksteps; i += 2) {
    if (i + 1 < a.ksteps) {
      issue(i + 1, t1);
      cpd::wgmma_wait<1>();
    } else {
      cpd::wgmma_wait<0>();
    }
    retire(i, t0);
    if (i + 1 < a.ksteps) {
      if (i + 2 < a.ksteps) {
        issue(i + 2, t0);
        cpd::wgmma_wait<1>();
      } else {
        cpd::wgmma_wait<0>();
      }
      retire(i + 1, t1);
    }
  }

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
      float* row = a.c + ((long long)z * a.M + m) * a.ldc;
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
    } else if (a.dmajor) {
      const float il = a.inv_l[(long long)z * a.M + m];
      const int b = z / a.H, h = z - (z / a.H) * a.H;
      float* col0 = a.c + b * a.osb + h * a.osh + a.row0 + m;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * t4;
        if (col < a.N) {  // N = D is even
          col0[col * a.osd] = acc[4 * j + 2 * half] * il;
          col0[(col + 1) * a.osd] = acc[4 * j + 2 * half + 1] * il;
        }
      }
    } else {
      const float il = a.inv_l[(long long)z * a.M + m];
      const int b = z / a.H, h = z - (z / a.H) * a.H;
      float* row = a.c + (((long long)b * a.Sq + a.row0 + m) * a.H + h) * a.D;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * t4;
        if (col < a.N)  // N = D is even
          *reinterpret_cast<float2*>(row + col) =
              make_float2(acc[4 * j + 2 * half] * il, acc[4 * j + 2 * half + 1] * il);
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
// exp2(S - max) split into hi (over S) and lo, inv_l = 1 / sum P
__global__ void __launch_bounds__(256)
softmax_rows_kernel(float* __restrict__ s, float* __restrict__ plo, float* __restrict__ inv_l,
                    int N, long long ld) {
  __shared__ float scratch[33];
  float* r = s + blockIdx.x * ld;
  float* rl = plo + blockIdx.x * ld;
  float mx = -INFINITY;
  for (int c = threadIdx.x; c < N; c += blockDim.x) mx = fmaxf(mx, r[c]);
  mx = block_max(mx, scratch);
  float sum = 0.f;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    const float p = exp2f(r[c] - mx);
    sum += p;
    float hi, lo;
    split(p, hi, lo);
    r[c] = hi;
    rl[c] = lo;
  }
  sum = cpd::block_sum(sum, scratch);
  if (threadIdx.x == 0) inv_l[blockIdx.x] = 1.f / sum;
}

// rank-3 f32 map (inner, rows, Z) with row stride ld floats, box {32, 128, 1}
int encode3(CUtensorMap* map, const float* base, int inner, int rows, int Z, long long ld) {
  return cpd::encode_f32_map<3>(map, base, {(uint64_t)inner, (uint64_t)rows, (uint64_t)Z},
                                {(uint64_t)ld * 4, (uint64_t)ld * 4 * rows},
                                {(uint32_t)TK, (uint32_t)TM, 1u});
}

template <int EPI>
int launch_gemm(const CUtensorMap& ah, const CUtensorMap& al, const CUtensorMap& bh,
                const CUtensorMap& bl, const GemmArgs& a, int Z, cudaStream_t stream) {
  auto kernel = tf32x3_gemm_kernel<EPI>;
  static bool attr_set = false;  // one card a process
  if (!attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TSMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((a.N + TN - 1) / TN, (a.M + TM - 1) / TM, Z);
  kernel<<<grid, TTHREADS, TSMEM, stream>>>(ah, al, bh, bl, a);
  return (int)cudaGetLastError();
}

long long round32(long long n) { return (n + 31) / 32 * 32; }

}  // namespace

namespace cpd {

// The workspace's parts with `rows` query rows a pass, from ws on, and its
// floats (ops/attention.py: _f32_sm90_workspace computes the same): hi and
// lo of Q and K [B*H, S, D] and of V's transpose [B*H, D, Sp]; S (then P
// hi), P lo [B*H, rows, Sp]; 1 / sum [B*H, rows]. Each part 32-float aligned.
F32x3Ws f32x3_workspace(void* ws, int B, int H, int Sq, int Skv, int D, int rows) {
  const long long Z = (long long)B * H, Sp = (Skv + 3) / 4 * 4;
  const long long sizes[9] = {Z * Sq * D, Z * Sq * D, Z * Skv * D, Z * Skv * D, Z * D * Sp,
                              Z * D * Sp, Z * rows * Sp, Z * rows * Sp, Z * rows};
  float* parts[9];
  long long off = 0;
  for (int i = 0; i < 9; ++i) {
    parts[i] = static_cast<float*>(ws) + off;
    off += round32(sizes[i]);
  }
  return {parts[0], parts[1], parts[2], parts[3], parts[4], parts[5], parts[6], parts[7],
          parts[8], off};
}

// Steps 2-4 over the split operands in w into its S, P and 1 / sum, `rows`
// query rows a pass; the output [B, Sq, H*D], or d-major when dmajor (K5's
// unfused route, attention_cm_f32_sm90.cu). Adds the kernels it launched to
// *launched.
int f32x3_passes(const F32x3Ws& w, void* o, int B, int H, int Sq, int Skv, int D, float scale,
                 int rows, int dmajor, long long osb, long long osh, long long osd,
                 int* launched, cudaStream_t st) {
  const int Z = B * H, Sp = (Skv + 3) / 4 * 4;
  const float *qh = w.qh, *ql = w.ql, *kh = w.kh, *kl = w.kl, *vh = w.vh, *vl = w.vl;
  float *sc = w.sc, *pl = w.pl, *il = w.il;
  CUtensorMap tkh, tkl, tph, tpl, tvh, tvl;
  int err = encode3(&tkh, kh, D, Skv, Z, D);
  if (!err) err = encode3(&tkl, kl, D, Skv, Z, D);
  if (!err) err = encode3(&tvh, vh, Skv, D, Z, Sp);
  if (!err) err = encode3(&tvl, vl, Skv, D, Z, Sp);
  if (err) return err;
  for (int row0 = 0; row0 < Sq; row0 += rows) {
    const int R = min(rows, Sq - row0);
    // 2. scores of rows row0 .. row0 + R - 1, through Q maps over the
    // chunk's rows (zero fill past them)
    CUtensorMap tqch, tqcl;
    err = cpd::encode_f32_map<3>(&tqch, qh + (long long)row0 * D,
                                 {(uint64_t)D, (uint64_t)R, (uint64_t)Z},
                                 {(uint64_t)D * 4, (uint64_t)Sq * D * 4},
                                 {(uint32_t)TK, (uint32_t)TM, 1u});
    if (!err)
      err = cpd::encode_f32_map<3>(&tqcl, ql + (long long)row0 * D,
                                   {(uint64_t)D, (uint64_t)R, (uint64_t)Z},
                                   {(uint64_t)D * 4, (uint64_t)Sq * D * 4},
                                   {(uint32_t)TK, (uint32_t)TM, 1u});
    if (!err) err = encode3(&tph, sc, Skv, R, Z, Sp);
    if (!err) err = encode3(&tpl, pl, Skv, R, Z, Sp);
    if (err) return err;
    GemmArgs g1{R, Skv, (D + TK - 1) / TK, scale * 1.4426950408889634f, sc, Sp,
                nullptr, H, Sq, row0, D, 0, 0, 0, 0};
    err = launch_gemm<EPI_SCORES>(tqch, tqcl, tkh, tkl, g1, Z, st);
    if (err) return err;
    ++*launched;
    // 3. softmax
    softmax_rows_kernel<<<Z * R, 256, 0, st>>>(sc, pl, il, Skv, Sp);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launched;
    // 4. out
    GemmArgs g2{R,     D,  (Skv + TK - 1) / TK, 1.f, static_cast<float*>(o), 0, il, H, Sq,
                row0,  D,  dmajor, osb, osh, osd};
    err = launch_gemm<EPI_OUT>(tph, tpl, tvh, tvl, g2, Z, st);
    if (err) return err;
    ++*launched;
  }
  return 0;
}

}  // namespace cpd

// q [B, Sq, H*D], k and v [B, Skv, H*D] f32 with unit column stride, batch
// and row strides in elements (multiples of 4, 16-byte aligned bases); o a
// fresh contiguous [B, Sq, H*D]; ws: f32x3_workspace()'s floats (ws_floats
// of them), 16-byte aligned. D % 4 == 0, D <= 512.
// Query rows go through the scores, softmax and output kernels `rows` at a
// time. Sets *launched to the number of kernels it launched: the three
// split kernels, then three a pass.
extern "C" int cpd_attention_f32_sm90(const void* q, const void* k, const void* v, void* o,
                                      void* ws, long long ws_floats, int B, int H, int Sq,
                                      int Skv, int D, long long qbs, long long qrs,
                                      long long kbs, long long krs, long long vbs,
                                      long long vrs, float scale, int rows, int* launched,
                                      void* stream) {
  *launched = 0;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 4 || D > 512 || rows <= 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  rows = rows < Sq ? rows : Sq;
  const cpd::F32x3Ws w = cpd::f32x3_workspace(ws, B, H, Sq, Skv, D, rows);
  if (ws_floats < w.floats) return (int)cudaErrorInvalidValue;
  const int Z = B * H, Sp = (Skv + 3) / 4 * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // 1. the split
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const long long nq4 = (long long)Z * Sq * D / 4, nk4 = (long long)Z * Skv * D / 4;
  split_rows_kernel<<<(int)min((nq4 + 255) / 256, 132LL * 16), 256, 0, st>>>(
      qf, w.qh, w.ql, H, Sq, D, qbs, qrs, nq4);
  split_rows_kernel<<<(int)min((nk4 + 255) / 256, 132LL * 16), 256, 0, st>>>(
      kf, w.kh, w.kl, H, Skv, D, kbs, krs, nk4);
  split_transpose_kernel<<<dim3((Sp + 31) / 32, (D + 31) / 32, Z), dim3(32, 8), 0, st>>>(
      static_cast<const float*>(v), w.vh, w.vl, H, Skv, D, Sp, vbs, vrs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *launched += 3;

  int passes = 0;
  const int err = cpd::f32x3_passes(w, o, B, H, Sq, Skv, D, scale, rows, 0, 0, 0, 0, &passes,
                                    st);
  *launched += passes;
  return err;
}
