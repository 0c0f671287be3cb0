// K6 on Hopper in f32: the 3x3 stride-1 'same' convolution + bias via
// Winograd F(2x2,3x3), NHWC, for C % 32 == 0 and Co % 64 == 0, its products
// as three TF32 products each on wgmma (tf32x3.cuh).
//
// Replaces the TPU kernel complex_prompt_diffusion_tpu/ops/probes/
// winograd.py::_wino_kernel (an opt-in probe that no layer dispatches, here
// as there) in f32 for the shapes ops/probes/winograd.py routes here
// (k6_body): every ResBlock conv of the UNet; winograd.cu (the first body:
// exact FMAs on the CUDA cores, single-buffered) keeps the other f32 widths
// and is the body this one replaced. Same arithmetic as the first body, all
// in f32: V = B^T d B of each 4x4 input patch; the 16 products M_ij = V_ij
// [tiles, C] x U_ij [C, Co] (U = G g G^T, [16, C, Co] f32, made by the
// wrapper) with f32 accumulation; Y = A^T M A plus the bias. The
// transformed tiles never reach device memory.
//
// What bounds it on the H100: 32 * tiles * C * Co flops, 2.25x fewer than
// the direct conv (B1 32^2 512->512: 2.15 GFLOP), at 495 / 3 TFLOP/s as
// three TF32 products a product: 0.013 ms; the first body, on the FMA units
// (67 TFLOP/s: 0.032 ms), ran 0.205 ms there. Design (K6's bf16 Hopper body,
// winograd_sm90.cu, with the 3xTF32 pieces of K4's f32 body):
//   * A block owns 64 tiles (a tw x th rectangle of one image: 16 x 4, 8 x 8
//     or 4 x 16, from the plan) by 128 output channels, and walks its split
//     of C in chunks of 32 channels (one 128-byte row of f32).
//   * Input patch: one 4-D TMA box {32 channels, 2 tw + 2, 2 th + 2, 1} over
//     x a chunk; TMA's zero fill outside the plane is the 'same' padding.
//   * V in f32 is 8 KB a position, 128 KB a chunk, and twice that split
//     into TF32 hi and lo: more than fits beside U. So the four transform
//     warps write it two positions at a time (a half of row i of B^T d B:
//     positions 4 i + 2 h, + 1, from two patch rows), already split into
//     K-major hi and lo tiles in the 128-byte swizzle, into a ring of two
//     slots with a full and an empty barrier each, and run a slot ahead of
//     the consumers. V is split once for both consumer warpgroups, and the
//     products read A from shared memory, so the consumers hold no A
//     fragments (wgmma's register-A form, as K2's and K4's f32 bodies, split
//     A twice and left no registers for the 128 sums: ptxas spilled 2 KB,
//     PERF.md section 6). A lane is one channel: a warp reads a patch pixel's
//     128 bytes and writes a tile's row of each tile, conflict-free, along
//     runs of 8 tiles (4 where the rectangle's row has 4), each tile
//     combining only the two patch columns it does not share with its left
//     neighbour.
//   * U streams through a 3-stage ring of {64 co, 32 c} TMA boxes a consumer
//     warpgroup (one position, its 64 output channels), MN-major as it
//     lies; TF32 wgmma takes K-major operands only, so the warpgroup splits
//     each landed box into K-major hi and lo tiles while it transposes it
//     (tf32x3::split_mnmajor's walk), into one of two split buffers, once its
//     products of the position before have retired and been folded (the
//     other warpgroup's products run meanwhile): a split under the
//     warpgroup's own products kept its registers live beside the 32 of the
//     fresh accumulator, and ptxas spilled.
//   * The three products of each 8-deep step (tf32x3::mma_kstep_ss,
//     m64n64k8 .tf32, A and B from shared memory) go into one fresh
//     accumulator a position and chunk (32 reduction terms, within tf32x3's
//     fold rule of kFold k-steps), folded into four f32 sums y_ab with +-1
//     coefficients once it retires (the TPU kernel's own fold), fenced so
//     that the compiler cannot sink it past the next position's products.
//     128 sum and 32 fresh registers a thread (224 after setmaxnreg; the
//     transform warps keep 56: the block's pool is its 168 registers a
//     thread at launch, and an increase past it never returns). ptxas still
//     spills 128 bytes in the consumers' loop.
//   * Epilogue: the sums + bias in f32, out from registers. Where the tiles
//     cannot fill 132 SMs, C is split by the plan (wino3x3_plan(...,
//     float32)): each split writes its partial Y to a workspace (A^T M A is
//     linear) and wino3x3_f32_sm90_reduce_kernel sums the splits in split
//     order and adds the bias: the same bits on every run.

#include "tf32x3.cuh"

namespace {

namespace tx = cpd::tf32x3;

constexpr int BT = 64;          // tiles a block: the wgmma M
constexpr int BN = 128;         // output channels a block, 64 a consumer warpgroup
constexpr int KC = tx::KB;      // channels a chunk: one 128-byte row of f32
constexpr int USTAGES = 3;      // a consumer warpgroup's U ring
constexpr int THREADS = 384;    // warpgroup 0: the transform; 1, 2: consumers
constexpr int XF_THREADS = 128;
constexpr int V_TILE = BT * KC * 4;            // one position's V hi (or lo): 8 KB
constexpr int V_SLOT = 4 * V_TILE;             // two positions, hi and lo: a slot of the V ring
constexpr int U_BOX = KC * 64 * 4;             // [32 c][64 co] f32: 8 KB
constexpr int SPLIT = 2 * 64 * 128;            // hi and lo [64 co][32 c]: 16 KB
constexpr int PATCH_MAX = (2 * 16 + 2) * (2 * 4 + 2) * KC * 4;  // 16 x 4 or 4 x 16 tiles
constexpr int OFF_U = 2 * V_SLOT;
constexpr int OFF_SPLIT = OFF_U + 2 * USTAGES * U_BOX;
constexpr int OFF_PATCH = OFF_SPLIT + 2 * 2 * SPLIT;
constexpr int OFF_BAR = OFF_PATCH + PATCH_MAX;
constexpr int NBAR = 2 * USTAGES + 2 + 2 + 1;
constexpr int SMEM = 1024 + OFF_BAR + NBAR * 8;
static_assert(SMEM <= 232448, "a block may use 227 KB of shared memory");
static_assert(OFF_SPLIT % 1024 == 0, "wgmma's swizzled B tiles start 1024-byte aligned");
static_assert((2 * 8 + 2) * (2 * 8 + 2) * KC * 4 <= PATCH_MAX, "the 8 x 8 rectangle's patch");

struct WPlan {
  int B, H, W, C, Co;
  int TH, TW;              // tiles of a plane: H / 2, W / 2
  int tw, th;              // the tile rectangle of a block (tw * th == 64)
  int rects_w, rects_h;    // rectangles along a plane
  int kchunks;             // C / 32
  int chunks_per_split;
};

// A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]: row a, column i
__host__ __device__ constexpr int at(int a, int i) {
  return a == 0 ? (i < 3 ? 1 : 0) : (i == 0 ? 0 : (i == 1 ? 1 : -1));
}

// Half H of row I of a chunk's V (positions 4 I + 2 H, + 1) for a run of
// LEN tiles along one rectangle row (row li, columns lj0 .., block tiles t0
// ..) and channel `lane`: row I of B^T d (two patch rows) for each patch
// column, then B^T along the columns, split into TF32 hi and lo, written at
// the tile's row of `v`'s four tiles (position 4 I + 2 H hi, lo, then the
// next position's; K-major [64 tiles][32 ch], 16-byte chunk c at c ^ (tile %
// 8), the layout wgmma reads in the 128-byte swizzle).
template <int I, int H, int LEN>
__device__ __forceinline__ void transform_run(const float* patch, int pw, int li, int lj0, int t0,
                                              int lane, unsigned char* v) {
  const float* base = patch + ((2 * li) * pw + 2 * lj0) * KC + lane;
  const int row = pw * KC;
  // row I of B^T d at patch column col: d0 - d2, d1 + d2, d2 - d1, d1 - d3
  auto column = [&](int col) -> float {
    const float* p = base + col * KC;
    if constexpr (I == 0) return p[0] - p[2 * row];
    else if constexpr (I == 1) return p[row] + p[2 * row];
    else if constexpr (I == 2) return p[2 * row] - p[row];
    else return p[row] - p[3 * row];
  };
  auto put = [](unsigned char* dst, float x) {
    uint32_t hi, lo;
    tx::split(x, hi, lo);
    *reinterpret_cast<uint32_t*>(dst) = hi;
    *reinterpret_cast<uint32_t*>(dst + V_TILE) = lo;
  };
  float c0 = column(0), c1 = column(1);
  const int chunk = lane >> 2, word = (lane & 3) * 4;
#pragma unroll
  for (int s = 0; s < LEN; ++s) {
    const float c2 = column(2 * s + 2), c3 = column(2 * s + 3);
    const int tile = t0 + s;
    unsigned char* dst = v + tile * 128 + ((chunk ^ (tile & 7)) << 4) + word;
    if constexpr (H == 0) {  // B^T along the columns: c0 - c2, c1 + c2 | c2 - c1, c1 - c3
      put(dst, c0 - c2);
      put(dst + 2 * V_TILE, c1 + c2);
    } else {
      put(dst, c2 - c1);
      put(dst + 2 * V_TILE, c1 - c3);
    }
    c0 = c2;
    c1 = c3;
  }
}

// Half H of row I of a chunk's V for the whole block: runs of min(8, tw)
// tiles, run g to warp g % 4
template <int I, int H>
__device__ __forceinline__ void transform_half(const float* patch, int pw, int tw, int lg,
                                               int warp, int lane, unsigned char* v) {
  if (tw == 4) {
    for (int g = warp; g < BT / 4; g += 4)
      transform_run<I, H, 4>(patch, pw, (4 * g) >> lg, (4 * g) & (tw - 1), 4 * g, lane, v);
  } else {
    for (int g = warp; g < BT / 8; g += 4)
      transform_run<I, H, 8>(patch, pw, (8 * g) >> lg, (8 * g) & (tw - 1), 8 * g, lane, v);
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
wino3x3_f32_sm90_kernel(const __grid_constant__ CUtensorMap tmx,
                        const __grid_constant__ CUtensorMap tmu, const float* __restrict__ bias,
                        float* __restrict__ y, float* __restrict__ ws, WPlan p) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned by an offset from the shared array, so that the
  // compiler keeps every access below a 32-bit shared one (through a
  // uintptr_t it made them generic 64-bit loads and stores)
  unsigned char* smem = smem_raw + ((1024u - (cpd::smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* sV = smem;                       // [2 slots][2 positions][hi, lo][64][32]
  unsigned char* sU = smem + OFF_U;               // [2 wg][USTAGES][32 c][64 co]
  unsigned char* sS = smem + OFF_SPLIT;           // [2 wg][2 buffers][hi, lo][64 co][32 c]
  float* patch = reinterpret_cast<float*>(smem + OFF_PATCH);  // [2 th + 2][2 tw + 2][32 ch]
  uint64_t* ufull = reinterpret_cast<uint64_t*>(smem + OFF_BAR);  // [2][USTAGES]
  uint64_t* vfull = ufull + 2 * USTAGES;  // [2]: the V slots
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
    // the transform warpgroup: lane = channel, runs of tiles along a row;
    // thread 0 loads chunk k's patch once all 128 threads have read chunk
    // k - 1's (named barrier 1)
    cpd::reg_dealloc<56>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    const int lg = p.tw == 16 ? 4 : p.tw == 8 ? 3 : 2;  // tile t: rectangle row t >> lg
    const uint32_t patch_bytes = pw * ph * KC * 4;
    auto load_patch = [&](int k) {
      cpd::mbar_expect_tx(pfull, patch_bytes);
      cpd::tma_load_4d(patch, &tmx, pfull, (kb + k) * KC, 2 * tj0 - 1, 2 * ti0 - 1, b);
    };
    if (threadIdx.x == 0) {
      cpd::tma_prefetch_desc(&tmx);
      load_patch(0);
    }
    // half row hr = 8 k + 2 i + h of V goes to slot h, its use hr / 2 of
    // that slot (4 k + i)
    auto open_slot = [&](int use, int h) -> unsigned char* {
      if (use > 0) cpd::mbar_wait(&vempty[h], (use - 1) & 1);
      return sV + h * V_SLOT;
    };
    auto publish = [&](int h) {
      cpd::fence_async_shared();  // V, to wgmma's (async) proxy
      cpd::mbar_arrive(&vfull[h]);
    };
    for (int k = 0; k < nk; ++k) {
      cpd::mbar_wait(pfull, k & 1);
      transform_half<0, 0>(patch, pw, p.tw, lg, warp, lane, open_slot(4 * k, 0));
      publish(0);
      transform_half<0, 1>(patch, pw, p.tw, lg, warp, lane, open_slot(4 * k, 1));
      publish(1);
      transform_half<1, 0>(patch, pw, p.tw, lg, warp, lane, open_slot(4 * k + 1, 0));
      publish(0);
      transform_half<1, 1>(patch, pw, p.tw, lg, warp, lane, open_slot(4 * k + 1, 1));
      publish(1);
      transform_half<2, 0>(patch, pw, p.tw, lg, warp, lane, open_slot(4 * k + 2, 0));
      publish(0);
      transform_half<2, 1>(patch, pw, p.tw, lg, warp, lane, open_slot(4 * k + 2, 1));
      publish(1);
      transform_half<3, 0>(patch, pw, p.tw, lg, warp, lane, open_slot(4 * k + 3, 0));
      publish(0);
      transform_half<3, 1>(patch, pw, p.tw, lg, warp, lane, open_slot(4 * k + 3, 1));
      publish(1);
      cpd::named_barrier(1, XF_THREADS);  // this chunk's patch is read
      if (threadIdx.x == 0 && k + 1 < nk) {
        cpd::fence_async_shared();  // the reads, before the async proxy writes again
        load_patch(k + 1);
      }
    }
    return;
  }

  cpd::reg_alloc<224>();
  const int cw = wg - 1;              // output channels n0 + 64 cw .. + 63
  const int ct = threadIdx.x & 127;   // thread of this warpgroup
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  unsigned char* my_u = sU + cw * USTAGES * U_BOX;
  unsigned char* my_s = sS + cw * 2 * SPLIT;
  uint64_t* my_full = ufull + cw * USTAGES;
  // this warpgroup's U ring: load i (chunk i / 16, position i % 16) of its
  // 64-column box into stage i % USTAGES, completing phase i / USTAGES of
  // its barrier; thread 0 issues it once the warpgroup has split load i -
  // USTAGES out of that stage (named barrier 2 + cw)
  const int total_u = nk * 16;
  auto load_u = [&](int i) {
    const int s = i % USTAGES;
    cpd::mbar_expect_tx(&my_full[s], U_BOX);
    cpd::tma_load_3d(my_u + s * U_BOX, &tmu, &my_full[s], n0 + 64 * cw, (kb + i / 16) * KC,
                     i % 16);
  };
  if (ct == 0) {
    cpd::tma_prefetch_desc(&tmu);
    for (int i = 0; i < USTAGES && i < total_u; ++i) load_u(i);
  }
  // load i, landed, -> its K-major hi and lo tiles in split buffer i % 2:
  // tf32x3::split_mnmajor's walk (column n of k rows 4 c .. 4 c + 3 a
  // thread), two steps at a time, so that its temporaries stay few beside
  // the 128 sums
  auto split_u = [&](int i) {
    const int s = i % USTAGES;
    cpd::mbar_wait(&my_full[s], (i / USTAGES) & 1);
    const float* raw = reinterpret_cast<const float*>(my_u + s * U_BOX);
    unsigned char* hi = my_s + (i & 1) * SPLIT;
#pragma unroll 2
    for (int e = ct; e < 64 * 8; e += 128) {
      const int n = e % 64, c = e / 64;
      const float* x = raw + 4 * c * 64 + n;
      tx::store_split(hi, 64 * 128, SPLIT / 2, n, c, make_float4(x[0], x[64], x[128], x[192]));
    }
    cpd::fence_async_shared();  // the split tiles, to wgmma's (async) proxy
    cpd::named_barrier(2 + cw, 128);
    if (ct == 0 && i + USTAGES < total_u) load_u(i + USTAGES);
  };

  float acc[4][32];  // y_00, y_01, y_10, y_11
  float m[32];       // one position's product over the chunk
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
  split_u(0);
  for (int k = 0; k < nk; ++k) {
#pragma unroll
    for (int pos = 0; pos < 16; ++pos) {
      const int i = 16 * k + pos;
      const int slot = (pos >> 1) & 1, use = 4 * k + pos / 4;  // the V half row's slot
      if (pos % 2 == 0) cpd::mbar_wait(&vfull[slot], use & 1);
      // an offset opaque here: each position's descriptors depend on the
      // position alone, and hoisted out of the chunk loop the 16 positions'
      // 192 of them were spilled with part of the sums
      uint32_t here = 0;
      asm volatile("" : "+r"(here));
      const unsigned char* a = sV + here + slot * V_SLOT + (pos % 2) * 2 * V_TILE;
      const unsigned char* bt = my_s + here + (i & 1) * SPLIT;
      cpd::fence_regs(m);
      cpd::wgmma_fence();
      tx::mma_kstep_ss<64>(m, a, a + V_TILE, bt, bt + SPLIT / 2, true);
      cpd::wgmma_commit();
      cpd::wgmma_wait<0>();
      cpd::fence_regs(m);
      if (pos % 2 == 1) cpd::mbar_arrive(&vempty[slot]);  // the slot's products have retired
      fold(acc, m, pos);
      // the fold done before the next position's products are issued: left
      // free, the compiler moved it past them and spilled part of the sums
#pragma unroll
      for (int q = 0; q < 4; ++q) cpd::fence_regs(acc[q]);
      // split buffer (i + 1) % 2 was last read by position i - 1's products,
      // which every warp retired before the barrier of split_u(i)
      if (i + 1 < total_u) split_u(i + 1);
    }
  }

  // epilogue: thread rows (tiles) 16 warp + g (+ 8), columns 8 j + 2 t4 (+ 1)
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
        if (gridDim.z == 1)
          *reinterpret_cast<float2*>(y + pix * p.Co + col) =
              make_float2(v0 + bias[col], v1 + bias[col + 1]);
        else
          *reinterpret_cast<float2*>(ws + ((long long)split * M + pix) * p.Co + col) =
              make_float2(v0, v1);
      }
    }
  }
}

// y[i] = sum over splits s = 0, 1, .. of ws[s][i], in that order, + bias
__global__ void wino3x3_f32_sm90_reduce_kernel(const float* __restrict__ ws,
                                               const float* __restrict__ bias,
                                               float* __restrict__ y, long long n4, int Co,
                                               int splits) {
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
    reinterpret_cast<float4*>(y)[i] =
        make_float4(acc.x + bias[c], acc.y + bias[c + 1], acc.z + bias[c + 2], acc.w + bias[c + 3]);
  }
}

}  // namespace

// x: [B, H, W, C] f32; u: [16, C, Co] f32 (U = G g G^T, position i*4+j
// major); bias: [Co] f32; y: [B, H, W, Co] f32; ws: splits x B*H*W x Co f32
// when splits > 1 (else unused). All contiguous, 16-byte aligned. C % 32 ==
// 0, Co % 64 == 0, H and W even and >= 8. The plan (ops/probes/winograd.py:
// wino3x3_plan(..., float32)): a block's rectangle is tw x (64 / tw) tiles,
// tw in {4, 8, 16}; C's 32-channel chunks are cut into `splits` runs of
// chunks_per_split, every run non-empty. Sets *launched to the kernels
// launched (1, or 2 with the reduction).
extern "C" int cpd_wino3x3_f32_sm90(const void* x, const void* u, const void* bias, void* y,
                                    void* ws, int B, int H, int W, int C, int Co, int tw,
                                    int splits, int chunks_per_split, int* launched,
                                    void* stream) {
  *launched = 0;
  const int kchunks = C / KC;
  if (B <= 0 || H < 8 || W < 8 || H % 2 || W % 2 || C <= 0 || C % KC || Co <= 0 || Co % 64 ||
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
  CUtensorMap tmx, tmu;
  int err = cpd::encode_map<4>(
      &tmx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x,
      {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B},
      {(uint64_t)C * 4, (uint64_t)W * C * 4, (uint64_t)H * W * C * 4},
      {(uint32_t)KC, (uint32_t)(2 * tw + 2), (uint32_t)(2 * th + 2), 1u},
      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  err = cpd::encode_map<3>(&tmu, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, u,
                           {(uint64_t)Co, (uint64_t)C, 16},
                           {(uint64_t)Co * 4, (uint64_t)C * Co * 4}, {64u, (uint32_t)KC, 1u},
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  static bool attr_set = false;  // one card a process
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(wino3x3_f32_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((Co + BN - 1) / BN, B * p.rects_h * p.rects_w, splits);
  wino3x3_f32_sm90_kernel<<<grid, THREADS, SMEM, st>>>(tmx, tmu, static_cast<const float*>(bias),
                                                       static_cast<float*>(y),
                                                       static_cast<float*>(ws), p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *launched = 1;
  if (splits == 1) return 0;
  const long long n4 = (long long)B * H * W * Co / 4;
  const int blocks = (int)min((n4 + 255) / 256, 132LL * 8);
  wino3x3_f32_sm90_reduce_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                                         static_cast<const float*>(bias),
                                                         static_cast<float*>(y), n4, Co, splits);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launched = 2;
  return (int)e;
}
