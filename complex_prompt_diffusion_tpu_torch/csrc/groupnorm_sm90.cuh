// The body of K3 on Hopper (csrc/groupnorm_sm90.cu, whose notes give the
// design): the slab form (gn_slab_kernel) and the split form
// (gn_stats_kernel, gn_apply_kernel), and the host launch of either.
// groupnorm_sm90.cu launches them as K3; the probe K8 (probe_groupnorm.cu)
// launches them in the modes of the TPU ablation scripts, the GnProbeMode
// below, with the statistics' channel sums on the tensor cores (MMA), and
// with each split-form tile streaming its share of several runs of the
// sample in turn (RUNS, K8's forced chunks). The mode, MMA and RUNS are
// template parameters with K3's as the defaults, so the kernels K3 launches
// are the code it ran before them, and K8's full mode at K3's plan is K3's
// own instantiation: the same bits.
#pragma once

#include "sm90.cuh"

namespace {

// What a kernel writes (K3: kModeFull). Every mode keeps the TMA and bulk-
// copy loads of its form, so that a mode ablates K3's kernel as it is.
enum GnProbeMode : int {
  kModeFull = 0,     // silu?((x - mean) * rstd * gamma + beta)
  kModeCopy = 1,     // x through f32 and back, no statistics: one read, one write
  kModeStats = 2,    // the statistics, then x + rstd * gamma * 0 (the statistics stay live)
  kModeNorm = 3,     // kModeFull without SiLU (the C entries launch kModeFull, silu = 0)
  kModeBf16Sig = 4,  // the normalized value rounded to bf16, SiLU in bf16x2 arithmetic
};

constexpr int kVec = 8;                       // channels a thread holds
constexpr int kConsumers = 512;               // threads that compute
constexpr int kThreads = 32 + kConsumers;     // + warp 0, the producer
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kMaxGroups = 256;
constexpr int kMaxBoxes = 32;                 // slab form: one mbarrier a TMA box
constexpr int kStages = 4;                    // split form: the ring
constexpr int kStageBytes = 32768;
constexpr int kFewGroups = 4;  // blocks of at most this many groups fold by shuffles
constexpr int kSmemMax = 232448;
// shared memory ahead of the slab (slab form) or the ring (split form): the
// mbarriers at 0, then these regions
constexpr int kPartOff = kMaxBoxes * 8;                 // float2 [G]: this block's partials
constexpr int kStatOff = kPartOff + kMaxGroups * 8;     // float2 [G]: (mean, rstd)
constexpr int kCntOff = kStatOff + kMaxGroups * 8;      // float [R]: pixels a thread row saw,
                                                        // then [S]: a row slice's pixels
constexpr int kSlices = kThreads / kVec;                // row slices of the fold, at most
constexpr int kAOff = kCntOff + (kConsumers + kSlices) * 4;  // float [R][C]: the threads' a
constexpr int kBOff = kAOff + kConsumers * kVec * 4;    // float [R][C]: the threads' b
constexpr int kHeader = (kBOff + kConsumers * kVec * 4 + 127) / 128 * 128;  // the slab or ring
constexpr int kTileMax = kSmemMax - kHeader;            // bytes of a slab
static_assert(kHeader % 128 == 0, "TMA boxes land 128-byte aligned");

// bytes of shared memory a slab form's TMA box of box_px pixels x kc
// channels takes: its boxes start 128-byte aligned
__host__ __device__ __forceinline__ int box_bytes(int box_px, int kc, int esize) {
  return (box_px * kc * esize + 127) / 128 * 128;
}

__host__ __device__ __forceinline__ int rows_of(int C) { return kConsumers / (C / kVec); }

__host__ __device__ __forceinline__ int split_at(int n, int parts, int i) {
  return (int)((long long)n * i / parts);
}

// K8's forced chunks (RUNS): the split form's tile t of `tiles` a sample,
// the sample's HW pixels cut into `runs` runs (split_at) and the tile taking
// its share of each run in turn: the first pixel and the count of its share
// of run k
__host__ __device__ __forceinline__ int2 run_share(int HW, int runs, int tiles, int t, int k) {
  const int r0 = split_at(HW, runs, k), L = split_at(HW, runs, k + 1) - r0;
  const int a = split_at(L, tiles, t);
  return make_int2(r0 + a, split_at(L, tiles, t + 1) - a);
}

// the pixels of tile t: K3's contiguous tile (RUNS false), or its shares
// of all runs, HW % runs runs of HW / runs + 1 pixels and the others of
// HW / runs
template <bool RUNS>
__host__ __device__ __forceinline__ int tile_pixels(int HW, int runs, int tiles, int t) {
  if constexpr (!RUNS) return split_at(HW, tiles, t + 1) - split_at(HW, tiles, t);
  const int L = HW / runs, r = HW % runs;
  return (runs - r) * (split_at(L, tiles, t + 1) - split_at(L, tiles, t)) +
         r * (split_at(L + 1, tiles, t + 1) - split_at(L + 1, tiles, t));
}

// pixels a chunk of the split form's ring: a multiple of R, about 32 KB
__host__ __device__ __forceinline__ int ring_chunk(int C, int esize) {
  const int R = rows_of(C);
  const int q = kStageBytes / (C * esize) / R * R;
  return q < R ? R : q;
}

struct Geo {
  int R;     // pixel rows the consumers cover at once
  int r, j;  // this thread's row and 8-channel column
  bool on;   // a consumer with a (row, column)
};

__device__ __forceinline__ Geo geometry(int C) {
  const int cv = C / kVec;
  const int t = (int)threadIdx.x - 32;
  Geo g;
  g.R = kConsumers / cv;
  g.r = t >= 0 ? t / cv : -1;
  g.j = t - g.r * cv;
  g.on = t >= 0 && g.r < g.R;
  return g;
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[kVec]) {
  if constexpr (sizeof(T) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[kVec]) {
  if constexpr (sizeof(T) == 2) {
    uint4 u;
    u.x = cpd::pack_bf16(v[0], v[1]);
    u.y = cpd::pack_bf16(v[2], v[3]);
    u.z = cpd::pack_bf16(v[4], v[5]);
    u.w = cpd::pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// A thread's statistics of its 8 channels: bf16 (sum, sum of squares); f32
// (mean, centered sum of squares) of the n pixels it has seen
struct Acc {
  float a[kVec], b[kVec], n;
};

// add the q pixels of a chunk (its first pixel at `buf`, in shared memory)
template <typename T>
__device__ __forceinline__ void accumulate(Acc& s, const T* buf, int q, int C, const Geo& g) {
  if (!g.on) return;
  const T* col = buf + kVec * g.j;
  if constexpr (sizeof(T) == 2) {
    for (int p = g.r; p < q; p += g.R) {
      float v[kVec];
      load8(col + p * C, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        s.a[e] += v[e];
        s.b[e] = fmaf(v[e], v[e], s.b[e]);
      }
    }
  } else {
    // the chunk's mean, then its centered sum of squares, merged (Chan)
    float m[kVec], m2[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) m[e] = m2[e] = 0.f;
    int k = 0;
    for (int p = g.r; p < q; p += g.R, ++k) {
      float v[kVec];
      load8(col + p * C, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) m[e] += v[e];
    }
    if (k == 0) return;
    const float ik = 1.f / (float)k;
#pragma unroll
    for (int e = 0; e < kVec; ++e) m[e] *= ik;
    for (int p = g.r; p < q; p += g.R) {
      float v[kVec];
      load8(col + p * C, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = v[e] - m[e];
        m2[e] = fmaf(d, d, m2[e]);
      }
    }
    const float n = s.n + (float)k;
    const float w = (float)k / n, wab = s.n * w;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float d = m[e] - s.a[e];
      s.a[e] += d * w;
      s.b[e] += m2[e] + d * d * wab;
    }
    s.n = n;
  }
}

// The statistics' channel sums on the tensor cores (K8's MMA form, the TPU
// script's ones-vector products): for channels 8o .. 8o + 7 (octet o) of q
// bf16 pixel rows at `buf` (rows `width` channels apart), each 16-row step a
// mma.sync m16n8k16 with an all-ones A and B = those rows' 8 channels, loaded
// transposed by ldmatrix, so D's columns are the channel sums (its 16 rows
// equal). s1 takes the values as they are (x * 1 is exact), s2 takes x^2
// rounded once to bf16 (__hmul2), as the TPU script's bf16 products do.
// Lane (g, t4) ends with c1[0], c1[1] = s1 of channels 8o + 2 t4, + 1 (and
// c2 the same for s2); rows past q load a valid row and are zeroed. Every
// lane of the warp calls it (mma.sync).
__device__ __forceinline__ void octet_sums_mma(const __nv_bfloat16* buf, int q, int width, int o,
                                               float (&c1)[4], float (&c2)[4]) {
  const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
  const int lane = threadIdx.x & 31, t4 = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) c1[e] = c2[e] = 0.f;
  for (int p0 = 0; p0 < q; p0 += 16) {
    uint32_t b[2];
    // lanes 0-7 address rows p0 .. p0 + 7 (matrix 0: k 0-7), lanes 8-15 the next 8
    cpd::ldmatrix_x2_trans(b, buf + (long long)min(p0 + (lane & 15), q - 1) * width + 8 * o);
    if (p0 + 16 > q) {  // this lane's pixels: p0 + 2 t4 (+ 1) in b[0], p0 + 8 + 2 t4 (+ 1) in b[1]
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int p = p0 + 8 * m + 2 * t4;
        if (p >= q) b[m] = 0u;
        else if (p + 1 >= q) b[m] &= 0xFFFFu;
      }
    }
    __nv_bfloat162 s0 = *reinterpret_cast<const __nv_bfloat162*>(&b[0]);
    __nv_bfloat162 s1 = *reinterpret_cast<const __nv_bfloat162*>(&b[1]);
    s0 = __hmul2(s0, s0);
    s1 = __hmul2(s1, s1);
    cpd::mma_16816(c1, ones, b[0], b[1]);
    cpd::mma_16816(c2, ones, *reinterpret_cast<const uint32_t*>(&s0),
                   *reinterpret_cast<const uint32_t*>(&s1));
  }
}

// a partial of one group: count, then bf16 (sum, sum of squares) or f32
// (mean, centered sum of squares)
struct Part {
  float n, a, b;
};

template <bool F32>
__device__ __forceinline__ void merge(Part& s, const Part& o) {
  if constexpr (!F32) {
    s.n += o.n;
    s.a += o.a;
    s.b += o.b;
  } else {
    if (o.n == 0.f) return;
    const float n = s.n + o.n, d = o.a - s.a, w = o.n / n;
    s.a += d * w;
    s.b += o.b + d * d * s.n * w;
    s.n = n;
  }
}

// (mean, rstd) of a group's merged partial (n: its element count)
template <bool F32>
__device__ __forceinline__ float2 finish(const Part& p, float eps) {
  float mean, var;
  if constexpr (!F32) {
    mean = p.a / p.n;
    var = fmaxf(p.b / p.n - mean * mean, 0.f);
  } else {
    mean = p.a;
    var = p.b / p.n;
  }
  return make_float2(mean, rsqrtf(var + eps));
}

// R rows of partials in shared memory (row r: A[r][C], B[r][C], cnt[r]
// pixels) -> one partial per group, out[g] = (a, b), in a fixed order:
// first S = 544 / C slices of each channel's rows (thread (s, c) merges rows
// s, s + S, ... into row s), then each group's S x C/G (slice, channel)
// partials (one warp a group, lanes, then a shuffle tree). Every thread of
// the block calls it, after the rows are written and a __syncthreads (two
// more inside).
template <bool F32>
__device__ void fold_rows(unsigned char* smem, int C, int G, int R, float2* out) {
  float* cnt = reinterpret_cast<float*>(smem + kCntOff);
  float* scnt = cnt + kConsumers;
  float* A = reinterpret_cast<float*>(smem + kAOff);
  float* B = reinterpret_cast<float*>(smem + kBOff);
  const int S = min(max(kThreads / C, 1), R);
  for (int w = threadIdx.x; w < S * C; w += kThreads) {
    const int sl = w / C, c = w - sl * C;
    Part p{0.f, 0.f, 0.f};
    for (int r = sl; r < R; r += S) merge<F32>(p, Part{cnt[r], A[r * C + c], B[r * C + c]});
    A[sl * C + c] = p.a;
    B[sl * C + c] = p.b;
    if (c == 0) scnt[sl] = p.n;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = C / G, entries = S * cg;
  for (int g = warp; g < G; g += kThreads / 32) {
    Part p{0.f, 0.f, 0.f};
    for (int e = lane; e < entries; e += 32) {
      const int sl = e / cg, c = g * cg + (e - sl * cg);
      merge<F32>(p, Part{scnt[sl], A[sl * C + c], B[sl * C + c]});
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const Part q{__shfl_xor_sync(0xffffffffu, p.n, o), __shfl_xor_sync(0xffffffffu, p.a, o),
                   __shfl_xor_sync(0xffffffffu, p.b, o)};
      merge<F32>(p, q);
    }
    if (lane == 0) out[g] = make_float2(p.a, p.b);
  }
  __syncthreads();
}

// The block's per-thread statistics (of its P pixels) -> one partial per
// group: each thread's row (its 8 channels) into shared memory, then
// fold_rows over the thread rows that saw a pixel. Every thread of the block
// calls it (three __syncthreads).
template <bool F32>
__device__ void fold(const Acc& s, unsigned char* smem, int C, int G, int P, const Geo& geo,
                     float2* out) {
  float* cnt = reinterpret_cast<float*>(smem + kCntOff);
  float* A = reinterpret_cast<float*>(smem + kAOff);
  float* B = reinterpret_cast<float*>(smem + kBOff);
  if (geo.on) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      A[geo.r * C + kVec * geo.j + e] = s.a[e];
      B[geo.r * C + kVec * geo.j + e] = s.b[e];
    }
    if (geo.j == 0) cnt[geo.r] = s.n;
  }
  __syncthreads();
  fold_rows<F32>(smem, C, G, min(geo.R, P), out);
}

// the group (of the block's) of each of this thread's 8 channels, with one
// division
__device__ __forceinline__ void channel_groups(int cg, const Geo& g, int (&ge)[kVec]) {
  const int c0 = kVec * (g.on ? g.j : 0);
  int grp = c0 / cg, next = (grp + 1) * cg - c0;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    if (e == next) {
      ++grp;
      next += cg;
    }
    ge[e] = grp;
  }
}

// the sum over a warp of a thread's partial, by a shuffle tree (bf16 sums
// need no count)
template <bool F32>
__device__ __forceinline__ void warp_merge(Part& p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Part q{0.f, __shfl_xor_sync(0xffffffffu, p.a, o), __shfl_xor_sync(0xffffffffu, p.b, o)};
    if constexpr (F32) q.n = __shfl_xor_sync(0xffffffffu, p.n, o);
    merge<F32>(p, q);
  }
}

// The statistics of a block of at most kFewGroups whole groups (the slab
// form's; `count` elements a group): each thread merges its 8 channels into
// one partial per group, then shuffle trees over each warp and over the
// warps' partials, and warp g writes group g's (mean, rstd) to stat[g]. Two
// __syncthreads and no pass over [R][C] in shared memory (on the H100
// fold's pass took 2.4 of a 5 us slab block at 8^2 x 1280).
template <bool F32>
__device__ void fold_few(const Acc& s, unsigned char* smem, const int (&ge)[kVec], int G,
                         float count, float eps, const Geo& geo, float2* stat) {
  Part* wp = reinterpret_cast<Part*>(smem + kAOff);  // [kFewGroups][kThreads / 32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = kThreads / 32;
#pragma unroll
  for (int g = 0; g < kFewGroups; ++g) {
    if (g >= G) break;
    Part p{0.f, 0.f, 0.f};
    if (geo.on) {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (ge[e] == g) merge<F32>(p, Part{s.n, s.a[e], s.b[e]});
    }
    warp_merge<F32>(p);
    if (lane == 0) wp[g * kWarps + warp] = p;
  }
  __syncthreads();
  if (warp < G) {
    Part p = lane < kWarps ? wp[warp * kWarps + lane] : Part{0.f, 0.f, 0.f};
    warp_merge<F32>(p);
    if (lane == 0) stat[warp] = finish<F32>(Part{count, p.a, p.b}, eps);
  }
  __syncthreads();
}

// this thread's 8 channels of gamma and beta (from c0 on), read ahead of
// the statistics
template <typename T>
__device__ __forceinline__ void load_affine(const T* gamma, const T* beta, int c0, const Geo& g,
                                            float (&ga)[kVec], float (&be)[kVec]) {
  if (!g.on) return;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    ga[e] = cpd::to_f32(gamma[c0 + kVec * g.j + e]);
    be[e] = cpd::to_f32(beta[c0 + kVec * g.j + e]);
  }
}

// this thread's 8 channels: y = (x - mu) * sc + sh, sc = rstd * gamma
// (stat: the (mean, rstd) of the block's groups, cg channels each)
// (bf16: sh becomes sh - mu sc, for one FMA an element)
template <typename T>
__device__ __forceinline__ void channel_consts(const float2* stat, const int (&ge)[kVec],
                                               const Geo& g, const float (&ga)[kVec],
                                               float (&mu)[kVec], float (&sc)[kVec],
                                               float (&sh)[kVec]) {
  if (!g.on) return;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float2 st = stat[ge[e]];
    mu[e] = st.x;
    sc[e] = st.y * ga[e];
    if constexpr (sizeof(T) == 2) sh[e] = fmaf(-mu[e], sc[e], sh[e]);
  }
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// SiLU in bf16 arithmetic on a pair (K8's bf16sig mode, the TPU script's
// bf16 sigmoid): y rounded to bf16, the sigmoid as 0.5 tanh(y / 2) + 0.5 by
// tanh.approx.bf16x2 (one MUFU op a pair; its f32 form is 1 an element, the
// exp and the division of 1 / (1 + exp(-y)) 2) and a bf16x2 FMA, then y
// times it; every result rounded to bf16 as bf16 arithmetic rounds it.
// Returns the pair packed, lo in the low half.
__device__ __forceinline__ uint32_t silu_bf16x2(float lo, float hi) {
  const uint32_t half = 0x3F003F00u;  // (0.5, 0.5)
  uint32_t y, h, t, s, o;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(y) : "f"(hi), "f"(lo));
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(h) : "r"(y), "r"(half));
  asm("tanh.approx.bf16x2 %0, %1;" : "=r"(t) : "r"(h));
  asm("fma.rn.bf16x2 %0, %1, %2, %2;" : "=r"(s) : "r"(t), "r"(half));
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(o) : "r"(y), "r"(s));
  return o;
}

// normalize the q pixels of a chunk in shared memory (rows of C) into `dst`
// (rows ldd apart; bf16: sh holds sh - mu sc, see channel_consts), or write
// what MODE writes instead
template <typename T, int MODE>
__device__ __forceinline__ void normalize(const T* buf, T* dst, int q, int C, int ldd,
                                          const Geo& g, const float (&mu)[kVec],
                                          const float (&sc)[kVec], const float (&sh)[kVec],
                                          int silu) {
  if (!g.on) return;
  const T* col = buf + kVec * g.j;
  T* out = dst + kVec * g.j;
  for (int p = g.r; p < q; p += g.R) {
    float v[kVec];
    load8(col + p * C, v);
    if constexpr (MODE == kModeBf16Sig) {
      static_assert(sizeof(T) == 2, "the bf16sig mode takes bf16");
      uint32_t w[kVec / 2];
#pragma unroll
      for (int e = 0; e < kVec; e += 2)
        w[e / 2] = silu_bf16x2(fmaf(v[e], sc[e], sh[e]), fmaf(v[e + 1], sc[e + 1], sh[e + 1]));
      *reinterpret_cast<uint4*>(out + (long long)p * ldd) = make_uint4(w[0], w[1], w[2], w[3]);
      continue;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if constexpr (MODE == kModeCopy) {
        // v[e] as it is
      } else if constexpr (MODE == kModeStats) {
        v[e] += sc[e] * 0.f;  // x itself for finite statistics, which stay computed
      } else if constexpr (sizeof(T) == 2) {
        // x sc + (sh - mu sc); SiLU as h + h tanh(h), h = y / 2: one MUFU op
        // (tanh.approx, 2^-11 relative, under bf16's 2^-8)
        float y = fmaf(v[e], sc[e], sh[e]);
        if (silu) {
          const float h = 0.5f * y;
          y = fmaf(h, tanh_approx(h), h);
        }
        v[e] = y;
      } else {
        float y = (v[e] - mu[e]) * sc[e] + sh[e];
        if (silu) y = __fdividef(y, 1.f + __expf(-y));  // ex2 and rcp on the MUFU
        v[e] = y;
      }
    }
    store8(out + (long long)p * ldd, v);
  }
}

// f(i, first pixel, pixels) for the chunks of q pixels of tile t, i
// counting them in the order the ring takes them: K3's contiguous tile
// (RUNS false, `runs` unread), or run by run (run_share)
template <bool RUNS, typename F>
__device__ __forceinline__ void for_chunks(int HW, int runs, int tiles, int t, int q, F&& f) {
  if constexpr (!RUNS) {
    const int p0 = split_at(HW, tiles, t), P = split_at(HW, tiles, t + 1) - p0;
    const int nch = (P + q - 1) / q;
    for (int i = 0; i < nch; ++i) f(i, p0 + i * q, min(q, P - i * q));
  } else {
    int i = 0;
    for (int k = 0; k < runs; ++k) {
      const int2 sh = run_share(HW, runs, tiles, t, k);
      for (int o = 0; o < sh.y; o += q, ++i) f(i, sh.x + o, min(q, sh.y - o));
    }
  }
}

// Warp 0 of the split form's kernels: lane 0 streams tile t's chunks of
// sample `src` (its pixel 0) through the ring
template <bool RUNS, typename T>
__device__ __forceinline__ void produce(const T* src, T* ring, int HW, int runs, int tiles, int t,
                                        int q, int C, uint64_t* full, uint64_t* empty) {
  if ((threadIdx.x & 31) == 0) {
    for_chunks<RUNS>(HW, runs, tiles, t, q, [&](int i, int p, int np) {
      const int s = i % kStages;
      if (i >= kStages) cpd::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      const uint32_t bytes = (uint32_t)(np * C * (int)sizeof(T));
      cpd::mbar_expect_tx(&full[s], bytes);
      cpd::bulk_load(ring + (long long)s * q * C, src + (long long)p * C, bytes, &full[s]);
    });
  }
  __syncwarp();
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      cpd::mbar_init(&full[s], 1);
      cpd::mbar_init(&empty[s], kConsumerWarps);
    }
    cpd::fence_barrier_init();
  }
  __syncthreads();
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc.a[e] = acc.b[e] = 0.f;
  acc.n = 0.f;
}

// Slab form: block (blockIdx.x, blockIdx.y) holds groups k blockIdx.x ..
// k blockIdx.x + k - 1 (kc = k cg channels) of sample blockIdx.y, all HW
// pixels, loaded by 3-D TMA boxes {kc, box_px, 1} of x viewed as
// (C, HW, N), normalized from shared memory into y. MMA: the statistics'
// channel sums by octet_sums_mma, one (octet, box) item a consumer warp at a
// time, each item's sums a row of fold_rows (a box's pixels); copy: no
// statistics.
template <typename T, int MODE = kModeFull, bool MMA = false>
__global__ void __launch_bounds__(kThreads, 1)
gn_slab_kernel(const __grid_constant__ CUtensorMap tx, const T* __restrict__ gamma,
               const T* __restrict__ beta, T* __restrict__ y, int HW, int C, int kc, int cg,
               int box_px, float eps, int silu) {
  constexpr bool F32 = sizeof(T) == 4;
  static_assert(!MMA || !F32, "the tensor-core statistics take bf16");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float2* part = reinterpret_cast<float2*>(smem + kPartOff);
  float2* stat = reinterpret_cast<float2*>(smem + kStatOff);
  const int n = blockIdx.y, c0 = blockIdx.x * kc, k = kc / cg;
  const int nbox = (HW + box_px - 1) / box_px;
  const int stride = box_bytes(box_px, kc, (int)sizeof(T));
  auto box_at = [&](int b) { return reinterpret_cast<T*>(smem + kHeader + b * stride); };
  if (threadIdx.x == 0) {  // the loads go out before the block's first barrier
    for (int b = 0; b < nbox; ++b) cpd::mbar_init(&bars[b], 1);
    cpd::fence_barrier_init();
    for (int b = 0; b < nbox; ++b) {
      cpd::mbar_expect_tx(&bars[b], (uint32_t)(box_px * kc * (int)sizeof(T)));
      cpd::tma_load_3d(box_at(b), &tx, &bars[b], c0, b * box_px, n);
    }
  }
  __syncthreads();  // the barriers are initialised for the threads that wait on them
  const Geo geo = geometry(kc);
  float ga[kVec], be[kVec];
  load_affine(gamma, beta, c0, geo, ga, be);
  int ge[kVec];
  channel_groups(cg, geo, ge);
  float mu[kVec], sc[kVec];
  if constexpr (MODE != kModeCopy) {
    const float count = (float)HW * (float)cg;
    if constexpr (MMA) {
      float* cnt = reinterpret_cast<float*>(smem + kCntOff);
      float* A = reinterpret_cast<float*>(smem + kAOff);
      float* B = reinterpret_cast<float*>(smem + kBOff);
      const int warp = (int)(threadIdx.x >> 5) - 1, lane = threadIdx.x & 31;
      const int octets = kc / kVec;
      if (warp >= 0) {
        for (int it = warp; it < octets * nbox; it += kConsumerWarps) {
          const int o = it % octets, b = it / octets, q = min(box_px, HW - b * box_px);
          cpd::mbar_wait(&bars[b], 0);
          float c1[4], c2[4];
          octet_sums_mma(reinterpret_cast<const __nv_bfloat16*>(box_at(b)), q, kc, o, c1, c2);
          if (lane < 4) {
            A[b * kc + 8 * o + 2 * lane] = c1[0];
            A[b * kc + 8 * o + 2 * lane + 1] = c1[1];
            B[b * kc + 8 * o + 2 * lane] = c2[0];
            B[b * kc + 8 * o + 2 * lane + 1] = c2[1];
          }
          if (lane == 0 && o == 0) cnt[b] = (float)q;
        }
      }
      __syncthreads();
      fold_rows<F32>(smem, kc, k, nbox, part);
      if ((int)threadIdx.x < k) {
        const float2 v = part[threadIdx.x];
        stat[threadIdx.x] = finish<F32>(Part{count, v.x, v.y}, eps);
      }
      __syncthreads();
    } else {
      Acc acc;
      zero(acc);
      if (threadIdx.x >= 32) {
        for (int b = 0; b < nbox; ++b) {
          cpd::mbar_wait(&bars[b], 0);
          accumulate(acc, box_at(b), min(box_px, HW - b * box_px), kc, geo);
        }
      }
      if (k <= kFewGroups) {
        fold_few<F32>(acc, smem, ge, k, count, eps, geo, stat);
      } else {
        fold<F32>(acc, smem, kc, k, HW, geo, part);
        if ((int)threadIdx.x < k) {
          const float2 v = part[threadIdx.x];
          stat[threadIdx.x] = finish<F32>(Part{count, v.x, v.y}, eps);
        }
        __syncthreads();
      }
    }
    channel_consts<T>(stat, ge, geo, ga, mu, sc, be);
  }
  for (int b = 0; b < nbox; ++b) {
    // a thread that has not waited on the box (copy, MMA) waits here; a
    // finished phase returns at once
    if constexpr (MODE == kModeCopy || MMA)
      if (geo.on) cpd::mbar_wait(&bars[b], 0);
    normalize<T, MODE>(box_at(b), y + ((long long)n * HW + b * box_px) * C + c0,
                       min(box_px, HW - b * box_px), kc, C, geo, mu, sc, be, silu);
  }
}

// Split form, kernel 1: the partials of tile blockIdx.x of sample blockIdx.y
// (RUNS: its share of each of the sample's `runs` runs).
// MMA: consumer warp w takes the channel octets w, w + 16, .. of every chunk
// (octet_sums_mma), adding each chunk's sums into one row of fold_rows in
// shared memory (an octet's channels are one warp's, so no two threads add
// into one sum)
template <typename T, bool MMA = false, bool RUNS = false>
__global__ void __launch_bounds__(kThreads, 1)
gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ parts, int HW, int C, int G,
                int runs) {
  constexpr bool F32 = sizeof(T) == 4;
  static_assert(!MMA || !F32, "the tensor-core statistics take bf16");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  T* ring = reinterpret_cast<T*>(smem + kHeader);
  const int tiles = (int)gridDim.x, t = blockIdx.x, n = blockIdx.y;
  const int P = tile_pixels<RUNS>(HW, runs, tiles, t), q = ring_chunk(C, (int)sizeof(T));
  float2* out = parts + ((long long)n * tiles + t) * G;
  init_ring(full, empty);
  const Geo geo = geometry(C);
  Acc acc;
  zero(acc);
  if (threadIdx.x < 32) {
    produce<RUNS>(x + (long long)n * HW * C, ring, HW, runs, tiles, t, q, C, full, empty);
  } else {
    const int warp = (int)(threadIdx.x >> 5) - 1, lane = threadIdx.x & 31;
    float* A = reinterpret_cast<float*>(smem + kAOff);
    float* B = reinterpret_cast<float*>(smem + kBOff);
    for_chunks<RUNS>(HW, runs, tiles, t, q, [&](int i, int, int np) {
      const int s = i % kStages;
      cpd::mbar_wait(&full[s], (i / kStages) & 1);
      const T* chunk = ring + (long long)s * q * C;
      if constexpr (MMA) {
        for (int o = warp; o < C / kVec; o += kConsumerWarps) {
          float c1[4], c2[4];
          octet_sums_mma(reinterpret_cast<const __nv_bfloat16*>(chunk), np, C, o, c1, c2);
          if (lane < 4) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = 8 * o + 2 * lane + h;
              A[c] = (i > 0 ? A[c] : 0.f) + c1[h];
              B[c] = (i > 0 ? B[c] : 0.f) + c2[h];
            }
          }
        }
      } else {
        accumulate(acc, chunk, np, C, geo);
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) cpd::mbar_arrive(&empty[s]);
    });
  }
  if constexpr (MMA) {
    if (threadIdx.x == 0) reinterpret_cast<float*>(smem + kCntOff)[0] = (float)P;
    __syncthreads();
    fold_rows<F32>(smem, C, G, 1, out);
  } else {
    fold<F32>(acc, smem, C, G, P, geo, out);
  }
}

// Split form, kernel 2: merge sample blockIdx.y's partials (stat_tiles of
// them a group, in tile order), normalize tile blockIdx.x (RUNS: its share of
// each of the `runs` runs; copy: no partials, the tile through f32 and back)
template <typename T, int MODE = kModeFull, bool RUNS = false>
__global__ void __launch_bounds__(kThreads, 1)
gn_apply_kernel(const T* __restrict__ x, const float2* __restrict__ parts,
                const T* __restrict__ gamma, const T* __restrict__ beta, T* __restrict__ y,
                int HW, int C, int G, int stat_tiles, int runs, float eps, int silu) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int kBatch = 8;  // partials a thread loads before it merges them
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  float2* stat = reinterpret_cast<float2*>(smem + kStatOff);
  T* ring = reinterpret_cast<T*>(smem + kHeader);
  const int tiles = (int)gridDim.x, t = blockIdx.x, n = blockIdx.y;
  const int q = ring_chunk(C, (int)sizeof(T));
  const long long base = (long long)n * HW * C;
  init_ring(full, empty);
  if (threadIdx.x < 32) {
    produce<RUNS>(x + base, ring, HW, runs, tiles, t, q, C, full, empty);
    return;
  }
  const Geo geo = geometry(C);
  float ga[kVec], be[kVec];
  float mu[kVec], sc[kVec];
  if constexpr (MODE != kModeCopy) {
    load_affine(gamma, beta, 0, geo, ga, be);
    // the consumers merge the partials: slice sl of the tiles for group g,
    // then the slices in order
    const int c = (int)threadIdx.x - 32;
    float* sn = reinterpret_cast<float*>(smem + kAOff);
    float* sa = sn + kConsumers;
    float* sb = sa + kConsumers;
    const int nsl = kConsumers / G;
    const float cg = (float)(C / G);
    if (c < nsl * G) {
      const int g = c % G, sl = c / G;
      const float2* pp = parts + (long long)n * stat_tiles * G + g;
      Part s{0.f, 0.f, 0.f};
      for (int i0 = sl; i0 < stat_tiles; i0 += kBatch * nsl) {
        float2 v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int i = i0 + b * nsl;
          if (i < stat_tiles) v[b] = pp[(long long)i * G];
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int i = i0 + b * nsl;
          if (i < stat_tiles)
            merge<F32>(s, Part{(float)tile_pixels<RUNS>(HW, runs, stat_tiles, i) * cg,
                               v[b].x, v[b].y});
        }
      }
      sn[c] = s.n;
      sa[c] = s.a;
      sb[c] = s.b;
    }
    cpd::named_barrier(1, kConsumers);
    if (c < G) {
      Part s{0.f, 0.f, 0.f};
      for (int sl = 0; sl < nsl; ++sl)
        merge<F32>(s, Part{sn[sl * G + c], sa[sl * G + c], sb[sl * G + c]});
      stat[c] = finish<F32>(s, eps);
    }
    cpd::named_barrier(1, kConsumers);
    int ge[kVec];
    channel_groups(C / G, geo, ge);
    channel_consts<T>(stat, ge, geo, ga, mu, sc, be);
  }
  for_chunks<RUNS>(HW, runs, tiles, t, q, [&](int i, int p, int np) {
    const int s = i % kStages;
    cpd::mbar_wait(&full[s], (i / kStages) & 1);
    normalize<T, MODE>(ring + (long long)s * q * C, y + base + (long long)p * C, np, C, C, geo,
                       mu, sc, be, silu);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) cpd::mbar_arrive(&empty[s]);
  });
}

template <typename K>
int set_attrs(K kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
}

// The checks every entry shares: x, y [N, HW, C] 16-byte aligned; C % 8 ==
// 0, C <= 4096, C % G == 0, G <= 256; form 0 (split, `parts` given, `runs`
// >= 1 runs a sample and `tiles` >= 1 tiles with tiles x runs <= HW, so
// that every tile has a pixel of every run) or 1 (slab, `tiles` groups a
// block dividing G)
inline bool gn_args_ok(const void* x, const void* y, const void* parts, int N, int HW, int C,
                       int G, int form, int tiles, int runs = 1) {
  if (N <= 0 || N > 65535 || HW <= 0 || G <= 0 || G > kMaxGroups || C % G || C % kVec ||
      C / kVec > kConsumers || (long long)HW * C >= (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return false;
  if (form == 1) return tiles >= 1 && G % tiles == 0;
  return form == 0 && tiles >= 1 && runs >= 1 && (long long)tiles * runs <= HW &&
         parts != nullptr;
}

// The kernels of one call in `form` (0 split over `tiles` tiles a sample,
// each its share of `runs` runs if RUNS, else contiguous and runs 1; 1 slab
// of `tiles` groups a block), MODE and MMA; *launched counts them (the copy
// mode's split form launches no statistics kernel).
template <typename T, int MODE = kModeFull, bool MMA = false, bool RUNS = false>
int launch(const void* x, const void* gamma, const void* beta, void* y, void* parts, int N,
           int HW, int C, int G, float eps, int silu, int form, int tiles, int runs,
           int* launched, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const T* bp = static_cast<const T*>(beta);
  T* yp = static_cast<T*>(y);
  const int es = (int)sizeof(T);
  static bool attrs = false;  // one card a process
  if (!RUNS && runs != 1) return (int)cudaErrorInvalidValue;
  if (!attrs) {
    int err = set_attrs(gn_slab_kernel<T, MODE, MMA>);
    if (!err) err = set_attrs(gn_stats_kernel<T, MMA, RUNS>);
    if (!err) err = set_attrs(gn_apply_kernel<T, MODE, RUNS>);
    if (err) return err;
    attrs = true;
  }
  if (form == 1) {  // the slab form, `tiles` groups a block
    const int kc = tiles * (C / G), box_px = HW < 256 ? HW : 256;
    const int nbox = (HW + box_px - 1) / box_px;
    const long long bytes = (long long)nbox * box_bytes(box_px, kc, es);
    if (kc % kVec || kc > 256 || nbox > kMaxBoxes || bytes > kTileMax)
      return (int)cudaErrorInvalidValue;
    CUtensorMap tx;
    const CUtensorMapDataType dt =
        es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const uint64_t dims[3] = {(uint64_t)C, (uint64_t)HW, (uint64_t)N};
    const uint64_t strides[2] = {(uint64_t)C * es, (uint64_t)HW * C * es};
    const uint32_t box[3] = {(uint32_t)kc, (uint32_t)box_px, 1u};
    const int err = cpd::encode_map<3>(&tx, dt, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
    gn_slab_kernel<T, MODE, MMA><<<dim3(G / tiles, N), kThreads, kHeader + (int)bytes, st>>>(
        tx, gp, bp, yp, HW, C, kc, C / G, box_px, eps, silu);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launched;
    return 0;
  }
  const int smem = kHeader + kStages * ring_chunk(C, es) * C * es;
  float2* pp = static_cast<float2*>(parts);
  if constexpr (MODE != kModeCopy) {
    gn_stats_kernel<T, MMA, RUNS><<<dim3(tiles, N), kThreads, smem, st>>>(xp, pp, HW, C, G,
                                                                          runs);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launched;
  }
  gn_apply_kernel<T, MODE, RUNS><<<dim3(tiles, N), kThreads, smem, st>>>(
      xp, pp, gp, bp, yp, HW, C, G, tiles, runs, eps, silu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++*launched;
  return 0;
}

}  // namespace
