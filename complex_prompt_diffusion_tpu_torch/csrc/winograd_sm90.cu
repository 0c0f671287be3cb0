// K6 on Hopper: bf16 3x3 stride-1 'same' convolution + bias via Winograd
// F(2x2,3x3), NHWC, for C % 8 == 0 and any Co.
//
// Replaces the TPU kernel complex_prompt_diffusion_tpu/ops/probes/
// winograd.py::_wino_kernel (an opt-in probe that no layer dispatches, here
// as there) for the bf16 shapes ops/probes/winograd.py routes here (every
// ResBlock conv of the SD-1.5 UNet and of a UNet at CompVis LDM-VQ-4's
// widths, 224 .. 896 channels); the first body (winograd.cu) keeps the bf16
// widths with C % 8 != 0. Same
// arithmetic: V = B^T d B of each 4x4 input patch in f32, rounded once to
// bf16; the 16 products M_ij = V_ij [tiles, C] x U_ij [C, Co] (U = G g G^T,
// [16, C, Co], made by the wrapper) with f32 accumulation; Y = A^T M A plus
// the bias in f32, rounded once. The transformed tiles never reach device
// memory.
//
// What bounds it on the H100: 32 * tiles * C * Co flops (B2 32^2 1280->1280:
// 26.8 GFLOP, 27 us at 989 TFLOP/s), 2.25x fewer than the direct conv, but
// with CUDA-core work the direct conv lacks: the input transform (adds) and
// the output transform. The first body (mma.sync, 32 tiles x 64 channels a
// block, sixteen 8-byte global loads per tile and channel quad, the
// transform repeated for every 64-channel slab) ran 4.0-5.6x cuDNN. Design:
//   * A block owns 64 tiles (a tw x th rectangle of one image: 16 x 4, 8 x 8
//     or 4 x 16 tiles, from the plan) by 128 output channels, and walks its
//     split of C in chunks of 64 channels: ceil(C / 64) of them, the last
//     partly past C where C % 64 != 0. TMA fills the patch's and U's
//     channels >= C with zeros (per dimension), so that chunk adds nothing
//     past C; U's rows past Co are zeros too, and the epilogue and the
//     reduce store n < Co only.
//   * Input patch: one 4-D TMA box {64 channels, 2 tw + 2, 2 th + 2, 1} over
//     x at (c0, 2 tj0 - 1, 2 ti0 - 1, b) a chunk. TMA zero-fills what lies
//     outside the plane, which is the 'same' padding; neighbouring tiles
//     share the patch columns and rows they overlap in.
//   * Four transform warps turn the landed patch into the 16 V_ij tiles
//     (each a K-major [64 tiles][64 channels] wgmma operand in the 128-byte
//     swizzle, written as 4-byte channel pairs: a warp writes one tile's
//     row, conflict-free), in two halves: positions i = 0, 1 (patch rows
//     0-2) and i = 2, 3 (rows 1-3), each with its own full and empty
//     barrier, so a half of the next chunk is written while the consumers
//     multiply the other half of this one. A warp walks runs of 8 tiles
//     along a rectangle row (4 where the row has 4), so each tile loads
//     and combines only the two patch columns it does not share with its
//     left neighbour.
//   * U streams through a 3-stage ring of {64, 64} TMA boxes a consumer
//     warpgroup (one position, 64 channels, its 64 output channels), read
//     MN-major as it lies; the warpgroup's first thread refills a stage as
//     soon as the warpgroup's product has read it, and the transform's first
//     thread loads the next patch once the transform has read this one, so
//     all four warps of warpgroup 0 transform.
//   * Two consumer warpgroups, 64 output channels each, share each V tile.
//     Keeping all 16 M_ij would take 512 accumulators a thread. Instead each
//     position's product over the chunk lands in one fresh accumulator
//     (m64n64k16 wgmma, 4 k-steps), which is folded into four running f32
//     sums y_ab (+-1 coefficients, 36 adds an element over the 16
//     positions) once it retires: the TPU kernel's own fold. 160 accumulator
//     registers a thread (216 after setmaxnreg; the transform warps keep 72);
//     while one warpgroup folds, the other multiplies.
//   * Epilogue: the sums (+ bias, one rounding) go out from registers as
//     bf16 pairs. Where the tiles cannot fill 132 SMs, C is split by the
//     plan (ops/probes/winograd.py: wino3x3_plan): each split writes its
//     partial Y in f32 to a workspace (A^T M A is linear) and
//     wino3x3_sm90_reduce_kernel sums the splits in split order, adds the
//     bias and rounds once: the same bits on every run.
// Measured on the H100 (PERF.md section 6), a chunk of a block with one
// split: 7.9 us against 2.2 us of tensor-core work. What set the pace, in
// turn: the transform (three warps, every tile loading all four of its
// patch columns, a fourth warp polling as the TMA issuer: 11.3 us a chunk;
// copies without the U loads took the same time, without the transform
// 0.70x), then, with runs of tiles and a fourth transform warp, the
// consumers (a copy without the transform 6.5 us). Tried and dropped, each
// slower at the phase-9 shapes: 32-channel chunks in the 64-byte swizzle
// with two patch slots and a 14-stage U ring (7.4 us a 32-channel chunk); a
// second fresh accumulator so that each fold runs under the next
// position's wgmma (108 bytes of spills, 6% slower).

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BT = 64;      // tiles a block: the wgmma M
constexpr int BN = 128;     // output channels a block, 64 a consumer warpgroup
constexpr int KC = 64;      // channels a chunk: one 128-byte row
constexpr int USTAGES = 3;  // U ring
constexpr int THREADS = 384;  // warpgroup 0: the transform; 1, 2: consumers
constexpr int XF_THREADS = 128;
constexpr int V_TILE = BT * KC * 2;                // one position's V: 8 KB
constexpr int U_BOX = KC * 64 * 2;                 // [64 c][64 co]: 8 KB
constexpr int U_STAGE = 2 * U_BOX;                 // one position, 128 co
constexpr int PATCH_MAX = (2 * 16 + 2) * (2 * 4 + 2) * KC * 2;  // 16 x 4 or 4 x 16 tiles
constexpr int OFF_U = 16 * V_TILE;
constexpr int OFF_PATCH = OFF_U + USTAGES * U_STAGE;
constexpr int OFF_BAR = OFF_PATCH + PATCH_MAX;
constexpr int NBAR = 2 * USTAGES + 4 + 1;
constexpr int SMEM = 1024 + OFF_BAR + NBAR * 8;
static_assert(SMEM <= 232448, "a block may use 227 KB of shared memory");
static_assert((2 * 8 + 2) * (2 * 8 + 2) * KC * 2 <= PATCH_MAX, "the 8 x 8 rectangle's patch");

struct WPlan {
  int B, H, W, C, Co;
  int TH, TW;              // tiles of a plane: H / 2, W / 2
  int tw, th;              // the tile rectangle of a block (tw * th == 64)
  int rects_w, rects_h;    // rectangles along a plane
  int kchunks;             // ceil(C / 64)
  int chunks_per_split;
};

// A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]: row a, column i
__host__ __device__ constexpr int at(int a, int i) {
  return a == 0 ? (i < 3 ? 1 : 0) : (i == 0 ? 0 : (i == 1 ? 1 : -1));
}

// B^T applied to a 4-vector: (a0 - a2, a1 + a2, a2 - a1, a1 - a3)
__device__ __forceinline__ void butterfly(float& a0, float& a1, float& a2, float& a3) {
  const float b0 = a0 - a2, b1 = a1 + a2, b2 = a2 - a1, b3 = a1 - a3;
  a0 = b0;
  a1 = b1;
  a2 = b2;
  a3 = b3;
}

// Half H of a chunk's V for a run of LEN tiles along one rectangle row (row
// li, columns lj0 .. lj0 + LEN - 1, block tiles t0 ..) and one channel pair
// `cp`: rows i = 2H, 2H + 1 of B^T d B, which need patch rows 2 li + H ..
// + 2, rounded to bf16 pairs and written at the tile's row, channel pair
// `cp`, of the 8 position tiles 8H .. 8H + 7 (K-major, 128-byte swizzle).
// Neighbouring tiles share two patch columns: each tile loads and combines
// only its two new columns, and the run is unrolled so that the next
// tile's loads are in flight while this one's are transformed.
template <int H, int LEN>
__device__ __forceinline__ void transform_run(const unsigned char* patch, int pw, int li, int lj0,
                                              int t0, int cp, unsigned char* v) {
  const unsigned char* base = patch + ((2 * li + H) * pw + 2 * lj0) * (KC * 2) + cp * 4;
  // B^T d of one patch column: rows 2H, 2H + 1, low and high channel
  auto column = [&](int col, float (&cl)[2], float (&ch)[2]) {
    float lo[3], hi[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(base + (r * pw + col) * (KC * 2));
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
      lo[r] = f.x;
      hi[r] = f.y;
    }
    if constexpr (H == 0) {  // d0 - d2, d1 + d2
      cl[0] = lo[0] - lo[2];
      cl[1] = lo[1] + lo[2];
      ch[0] = hi[0] - hi[2];
      ch[1] = hi[1] + hi[2];
    } else {  // d2 - d1, d1 - d3 (rows 1 .. 3 loaded)
      cl[0] = lo[1] - lo[0];
      cl[1] = lo[0] - lo[2];
      ch[0] = hi[1] - hi[0];
      ch[1] = hi[0] - hi[2];
    }
  };
  float cl[4][2], ch[4][2];  // the tile's four columns
  column(0, cl[0], ch[0]);
  column(1, cl[1], ch[1]);
#pragma unroll
  for (int s = 0; s < LEN; ++s) {
    column(2 * s + 2, cl[2], ch[2]);
    column(2 * s + 3, cl[3], ch[3]);
    const int tile = t0 + s;
    const int at_row = tile * 128 + (((cp >> 2) ^ (tile & 7)) << 4) + (cp & 3) * 4;
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      float a0 = cl[0][ii], a1 = cl[1][ii], a2 = cl[2][ii], a3 = cl[3][ii];
      float b0 = ch[0][ii], b1 = ch[1][ii], b2 = ch[2][ii], b3 = ch[3][ii];
      butterfly(a0, a1, a2, a3);
      butterfly(b0, b1, b2, b3);
      const int p = (2 * H + ii) * 4;
      unsigned char* row = v + p * V_TILE + at_row;
      *reinterpret_cast<uint32_t*>(row) = cpd::pack_bf16(a0, b0);
      *reinterpret_cast<uint32_t*>(row + V_TILE) = cpd::pack_bf16(a1, b1);
      *reinterpret_cast<uint32_t*>(row + 2 * V_TILE) = cpd::pack_bf16(a2, b2);
      *reinterpret_cast<uint32_t*>(row + 3 * V_TILE) = cpd::pack_bf16(a3, b3);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      cl[0][q] = cl[2][q];
      cl[1][q] = cl[3][q];
      ch[0][q] = ch[2][q];
      ch[1][q] = ch[3][q];
    }
  }
}

// Half H of a chunk's V for the whole block: runs of min(8, tw) tiles, run g
// to warp g % 4
template <int H>
__device__ __forceinline__ void transform_half(const unsigned char* patch, int pw, int tw, int lg,
                                               int warp, int cp, unsigned char* v) {
  if (tw == 4) {
    for (int g = warp; g < BT / 4; g += 4)
      transform_run<H, 4>(patch, pw, (4 * g) >> lg, (4 * g) & (tw - 1), 4 * g, cp, v);
  } else {
    for (int g = warp; g < BT / 8; g += 4)
      transform_run<H, 8>(patch, pw, (8 * g) >> lg, (8 * g) & (tw - 1), 8 * g, cp, v);
  }
}

// y_ab += A^T[a][i] A^T[b][j] m for position p = 4 i + j (a constant once the
// position loop is unrolled)
__device__ __forceinline__ void fold(float (&y)[4][32], const float (&m)[32], int p) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int coef = at(a, p / 4) * at(b, p % 4);
      if (coef > 0) {
#pragma unroll
        for (int r = 0; r < 32; ++r) y[a * 2 + b][r] += m[r];
      } else if (coef < 0) {
#pragma unroll
        for (int r = 0; r < 32; ++r) y[a * 2 + b][r] -= m[r];
      }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
wino3x3_sm90_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tu,
                    const float* __restrict__ bias, bf16* __restrict__ y,
                    float* __restrict__ ws, WPlan p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sV = smem;                  // [16][64 tiles][64 ch], swizzled
  unsigned char* sU = smem + OFF_U;          // [USTAGES][2 boxes][64 c][64 co], swizzled
  unsigned char* patch = smem + OFF_PATCH;   // [2 th + 2][2 tw + 2][64 ch]
  uint64_t* ufull = reinterpret_cast<uint64_t*>(smem + OFF_BAR);  // [2][USTAGES]: a ring a
                                                                   // consumer warpgroup
  uint64_t* vfull = ufull + 2 * USTAGES;  // [2]: the halves of V
  uint64_t* vempty = vfull + 2;
  uint64_t* pfull = vempty + 2;

  const int n0 = blockIdx.x * BN;
  int r = blockIdx.y;  // (image, rectangle row, rectangle column)
  const int rw = r % p.rects_w;
  r /= p.rects_w;
  const int rh = r % p.rects_h;
  const int b = r / p.rects_h;
  const int ti0 = rh * p.th, tj0 = rw * p.tw;
  const int split = blockIdx.z;
  const int kb = split * p.chunks_per_split;
  const int nk = min(p.kchunks, kb + p.chunks_per_split) - kb;  // chunks of this split
  const int pw = 2 * p.tw + 2, ph = 2 * p.th + 2;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * USTAGES; ++s) cpd::mbar_init(&ufull[s], 1);
    for (int h = 0; h < 2; ++h) {
      cpd::mbar_init(&vfull[h], XF_THREADS);
      cpd::mbar_init(&vempty[h], 256);
    }
    cpd::mbar_init(pfull, 1);
    cpd::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // the transform warpgroup: lane = channel pair, runs of tiles along a
    // row; thread 0 loads chunk k's patch once all 128 threads have read
    // chunk k - 1's (named barrier 1)
    cpd::reg_dealloc<72>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    const int lg = p.tw == 16 ? 4 : p.tw == 8 ? 3 : 2;  // tile t: rectangle row t >> lg
    const uint32_t patch_bytes = pw * ph * KC * 2;
    auto load_patch = [&](int k) {
      cpd::mbar_expect_tx(pfull, patch_bytes);
      cpd::tma_load_4d(patch, &tx, pfull, (kb + k) * KC, 2 * tj0 - 1, 2 * ti0 - 1, b);
    };
    if (threadIdx.x == 0) {
      cpd::tma_prefetch_desc(&tx);
      load_patch(0);
    }
    for (int k = 0; k < nk; ++k) {
      cpd::mbar_wait(pfull, k & 1);
      if (k > 0) cpd::mbar_wait(&vempty[0], (k - 1) & 1);
      transform_half<0>(patch, pw, p.tw, lg, warp, lane, sV);
      cpd::fence_async_shared();  // V, to wgmma's (async) proxy
      cpd::mbar_arrive(&vfull[0]);
      if (k > 0) cpd::mbar_wait(&vempty[1], (k - 1) & 1);
      transform_half<1>(patch, pw, p.tw, lg, warp, lane, sV);
      cpd::fence_async_shared();
      cpd::mbar_arrive(&vfull[1]);
      cpd::named_barrier(1, XF_THREADS);  // this chunk's patch is read
      if (threadIdx.x == 0 && k + 1 < nk) {
        cpd::fence_async_shared();  // the reads, before the async proxy writes again
        load_patch(k + 1);
      }
    }
    return;
  }

  cpd::reg_alloc<216>();
  const int cw = wg - 1;  // output channels n0 + 64 cw .. + 63
  // this warpgroup's U ring: load i (chunk i / 16, position i % 16) of its
  // 64-column box into stage i % USTAGES, completing phase i / USTAGES of
  // its barrier; thread 0 issues it once the warpgroup has read load i -
  // USTAGES from that stage (named barrier 2 + cw)
  uint64_t* my_full = ufull + cw * USTAGES;
  const int total_u = nk * 16;
  // a box wholly past Co (Co <= n0 + 64: the second warpgroup of the last
  // block) loads the block's first columns instead: its products land in
  // columns the epilogue does not store, and no TMA box lies wholly
  // outside the tensor
  const int u_col = n0 + 64 * cw < p.Co ? n0 + 64 * cw : n0;
  auto load_u = [&](int i) {
    const int s = i % USTAGES;
    cpd::mbar_expect_tx(&my_full[s], U_BOX);
    cpd::tma_load_3d(sU + s * U_STAGE + cw * U_BOX, &tu, &my_full[s], u_col,
                     (kb + i / 16) * KC, i % 16);
  };
  const bool issuer = (threadIdx.x & 127) == 0;
  if (issuer) {
    cpd::tma_prefetch_desc(&tu);
    for (int i = 0; i < USTAGES && i < total_u; ++i) load_u(i);
  }
  float acc[4][32];       // y_00, y_01, y_10, y_11
  float m[32];            // one position's product over the chunk
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
  int u_it = 0;
  for (int k = 0; k < nk; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cpd::mbar_wait(&vfull[h], k & 1);
#pragma unroll
      for (int pp = 0; pp < 8; ++pp) {
        const int pos = 8 * h + pp;
        const int s = u_it % USTAGES;
        cpd::mbar_wait(&my_full[s], (u_it / USTAGES) & 1);
        const unsigned char* a = sV + pos * V_TILE;
        const unsigned char* bt = sU + s * U_STAGE + cw * U_BOX;
        cpd::fence_regs(m);
        cpd::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk)
          cpd::Wgmma<64>::ss_bmn(m, cpd::desc_sw128(a + kk * 32, 16, 1024),
                                 cpd::desc_sw128(bt + kk * 16 * 128, U_BOX, 1024), kk > 0);
        cpd::wgmma_commit();
        cpd::wgmma_wait<0>();
        cpd::fence_regs(m);
        if (u_it + USTAGES < total_u) {
          cpd::named_barrier(2 + cw, 128);  // the warpgroup's product has read the stage
          if (issuer) load_u(u_it + USTAGES);
        }
        ++u_it;
        fold(acc, m, pos);
      }
      cpd::mbar_arrive(&vempty[h]);
    }
  }

  // epilogue: thread rows (tiles) 16 warp + g (+ 8), columns 8 j + 2 t4 (+ 1)
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const long long M = (long long)p.B * p.H * p.W;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = warp * 16 + g + half * 8;
    const int ti = ti0 + t / p.tw, tj = tj0 + t % p.tw;
    if (ti >= p.TH || tj >= p.TW) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + cw * 64 + j * 8 + 2 * t4;
      if (col >= p.Co) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long pix = ((long long)b * p.H + 2 * ti + (q >> 1)) * p.W + 2 * tj + (q & 1);
        const float v0 = acc[q][4 * j + 2 * half], v1 = acc[q][4 * j + 2 * half + 1];
        if ((p.Co & 1) == 0) {  // col + 1 < Co, and the pair is 4-byte aligned
          if (gridDim.z == 1)
            *reinterpret_cast<uint32_t*>(y + pix * p.Co + col) =
                cpd::pack_bf16(v0 + bias[col], v1 + bias[col + 1]);
          else
            *reinterpret_cast<float2*>(ws + ((long long)split * M + pix) * p.Co + col) =
                make_float2(v0, v1);
        } else {  // an odd Co: element by element, the column past Co dropped
          for (int e = 0; e < 2 && col + e < p.Co; ++e) {
            const float v = e ? v1 : v0;
            if (gridDim.z == 1)
              y[pix * p.Co + col + e] = cpd::from_f32<bf16>(v + bias[col + e]);
            else
              ws[((long long)split * M + pix) * p.Co + col + e] = v;
          }
        }
      }
    }
  }
}

// y[i] = bf16(sum over splits s = 0, 1, .. of ws[s][i], in that order, + bias)
__global__ void wino3x3_sm90_reduce_kernel(const float* __restrict__ ws,
                                           const float* __restrict__ bias, bf16* __restrict__ y,
                                           long long n4, int Co, int splits) {
  const long long stride = n4 * 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 acc = reinterpret_cast<const float4*>(ws)[i];
    for (int s = 1; s < splits; ++s) {
      const float4 v = reinterpret_cast<const float4*>(ws + s * stride)[i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    const int c = (int)((i * 4) % Co);
    uint2 out;
    out.x = cpd::pack_bf16(acc.x + bias[c], acc.y + bias[c + 1]);
    out.y = cpd::pack_bf16(acc.z + bias[c + 2], acc.w + bias[c + 3]);
    reinterpret_cast<uint2*>(y)[i] = out;
  }
}

// The same for Co % 4 != 0, element by element
__global__ void wino3x3_sm90_reduce1_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                                bf16* __restrict__ y, long long n, int Co, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = ws[i];
    for (int s = 1; s < splits; ++s) acc += ws[s * n + i];
    y[i] = cpd::from_f32<bf16>(acc + bias[(int)(i % Co)]);
  }
}

}  // namespace

// x: [B, H, W, C] bf16; u: [16, C, Co] bf16 (U = G g G^T, position i*4+j
// major) with row stride Cu >= Co (the wrapper pads an odd width to Cu %
// 8 == 0); bias: [Co] f32; y: [B, H, W, Co] bf16; ws: splits x B*H*W x Co
// f32 when splits > 1 (else unused). x, y, ws contiguous; x, u 16-byte
// aligned. C % 8 == 0 (the maps' 16-byte strides), any Co, H and W even and
// >= 8. The plan (ops/probes/winograd.py: wino3x3_plan): a block's rectangle
// is tw x (64 / tw) tiles, tw in {4, 8, 16}; C's ceil(C / 64) 64-channel
// chunks are cut into `splits` runs of chunks_per_split, every run
// non-empty. Sets *launched to the kernels launched (1, or 2 with the
// reduction).
extern "C" int cpd_wino3x3_sm90_bf16(const void* x, const void* u, const void* bias, void* y,
                                     void* ws, int B, int H, int W, int C, int Co, int Cu,
                                     int tw, int splits, int chunks_per_split, int* launched,
                                     void* stream) {
  *launched = 0;
  const int kchunks = (C + KC - 1) / KC;
  if (B <= 0 || H < 8 || W < 8 || H % 2 || W % 2 || C <= 0 || C % 8 || Co <= 0 || Cu < Co ||
      Cu % 8 ||
      (tw != 4 && tw != 8 && tw != 16) || splits < 1 || chunks_per_split < 1 ||
      (long long)splits * chunks_per_split < kchunks ||
      (long long)(splits - 1) * chunks_per_split >= kchunks ||
      (long long)B * H * W * Co >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  const int th = BT / tw;
  WPlan p{B, H, W, C, Co, H / 2, W / 2, tw, th, 0, 0, kchunks, chunks_per_split};
  p.rects_w = (p.TW + tw - 1) / tw;
  p.rects_h = (p.TH + th - 1) / th;
  if ((long long)B * p.rects_h * p.rects_w > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tu;
  int err = cpd::encode_map<4>(
      &tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B},
      {(uint64_t)C * 2, (uint64_t)W * C * 2, (uint64_t)H * W * C * 2},
      {(uint32_t)KC, (uint32_t)(2 * tw + 2), (uint32_t)(2 * th + 2), 1u},
      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  err = cpd::encode_bf16_map<3>(&tu, u, {(uint64_t)Co, (uint64_t)C, 16},
                                {(uint64_t)Cu * 2, (uint64_t)C * Cu * 2}, {64u, (uint32_t)KC, 1u});
  if (err) return err;
  static bool attr_set = false;  // one card a process
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(wino3x3_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((Co + BN - 1) / BN, B * p.rects_h * p.rects_w, splits);
  wino3x3_sm90_kernel<<<grid, THREADS, SMEM, st>>>(tx, tu, static_cast<const float*>(bias),
                                                   static_cast<bf16*>(y),
                                                   static_cast<float*>(ws), p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *launched = 1;
  if (splits == 1) return 0;
  const long long n = (long long)B * H * W * Co;
  if (Co % 4 == 0) {
    const long long n4 = n / 4;
    const int blocks = (int)min((n4 + 255) / 256, 132LL * 8);
    wino3x3_sm90_reduce_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
        static_cast<const float*>(bias), static_cast<bf16*>(y), n4, Co, splits);
  } else {
    const int blocks = (int)min((n + 255) / 256, 132LL * 8);
    wino3x3_sm90_reduce1_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
        static_cast<const float*>(bias), static_cast<bf16*>(y), n, Co, splits);
  }
  e = cudaGetLastError();
  if (e == cudaSuccess) *launched = 2;
  return (int)e;
}
