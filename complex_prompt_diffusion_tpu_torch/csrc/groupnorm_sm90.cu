// K3 on Hopper: GroupNorm (+ optional SiLU) over NHWC activations, f32
// statistics, for every GroupNorm of the port's paths: the bf16 UNet sites
// (61 a UNet call), the bf16 VAE planes and the f32 VAE-decode planes.
//
// Replaces the TPU kernels complex_prompt_diffusion_tpu/ops/groupnorm.py::
// _gn_kernel (one sample resident in VMEM: one read, one write),
// ::_gn_stats_kernel (one-pass statistics of large <= 16-bit planes),
// ::_gn_stats2_kernel (two-pass centered f32 statistics) and
// ::_gn_apply_kernel (normalize + affine + SiLU). groupnorm.cu (the body
// this file replaced, kept as the timed "prior" body and as the probe K8's
// kernels) walked one (sample, group) slice per block at a stride of C,
// with accesses as narrow as 4 bytes where C/G = 10, 30 or 4, read the
// activation 2 (bf16) or 3 (f32) times, and had N x 32 blocks, 32 at batch 1.
//
// Statistics follow the JAX package's rule by dtype, in f32: bf16 one pass,
// var = max(E[x^2] - mean^2, 0); f32 centered: each thread keeps, for each
// of its channels, the mean and centered sum of squares of the values it
// has seen, taking each chunk's in two passes over shared memory and
// merging them by Chan's formula (M2 = M2_a + M2_b + d^2 n_a n_b / n); the
// block's and the tiles' partials merge the same way, so no E[x^2] - mean^2
// ever cancels.
//
// What bounds it on the H100: bytes. One read and one write of the plane
// (bf16 8x64x64x320: 21 MB each way, 0.0125 ms at 3.35 TB/s). Design:
//   * A block's 512 compute threads each hold 8 consecutive channels (one
//     16-byte bf16 access, two f32) of the rows it has in shared memory:
//     thread (r, j) takes channels 8j..8j+7 of pixels r, r + R, r + 2R, ...
//     (R = 512 / (row width / 8)), so a warp reads consecutive 16-byte words
//     and each thread keeps its channels for the whole range, with its sums
//     in registers. At the end the per-thread sums go through shared memory
//     and fold into one partial a group (the TPU kernel's one-hot c2g
//     product, here an index) in a fixed order: the same bits on every run.
//   * Slab form (one launch), the TPU kernel's own block: a block holds k
//     whole groups (k C/G channels, a multiple of 8) of one sample, all its
//     pixels, loaded by 3-D TMA boxes of up to 256 pixels (rows of k C/G x
//     2 or 4 bytes at a stride of C), takes their statistics with no other
//     block and normalizes from shared memory: one read, one write. For the
//     planes whose slab fits (32^2 at C/G <= 40, every 16^2 and 8^2 plane,
//     64^2 x 512 bf16).
//   * Split form (two launches), for the rest: a statistics kernel streams
//     its range of whole pixel rows (P pixels x C channels, one contiguous
//     span) through a 4-stage ring of 32 KB bulk copies (cp.async.bulk; one
//     producer warp, full and empty mbarriers) and writes per-(sample,
//     tile, group) partials; an apply kernel merges its sample's partials
//     in tile order and normalizes its range, streamed through the same
//     ring. 2 reads and 1 write, with SMs / N tiles a sample, so a batch-1
//     plane fills the card.
//   * A third form, a sample resident in a thread-block cluster of up to 16
//     blocks exchanging partials through distributed shared memory, lost to
//     one of these two at every shape of the render on the H100 and was
//     removed (PERF.md section 6).
//   * The host's plan (ops/groupnorm.py: group_norm_plan) picks the form
//     and its blocks; the entry reports the kernels it launched.
// Measured on the H100 (PERF.md section 6): the SiLU as expf and an
// IEEE division (~45 instructions an element) held the normalize at 82K
// elements a block to ~14 us; on the MUFU (bf16: tanh.approx, one op; f32:
// ex2 and rcp) 8x64x64x320 went 0.0310 -> 0.0225 ms. The slab writes y
// from registers: TMA stores of its boxes were 5-25% slower. A slab block
// of an 8^2 plane is a chain of latencies (%globaltimer stamps: ~1 us to
// its TMA data, then the fold and the normalize): thread 0 issues the loads
// before the block's first barrier, and a block of at most 4 groups folds
// by shuffle trees (fold_few) with each channel's group found by one
// division, which took 8x8x8x1280 from 0.0070 to 0.0048 ms.

#include "sm90.cuh"

namespace {

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

// The block's per-thread statistics (of its P pixels) -> one partial per
// group, out[g] = (a, b), in a fixed order: first S = 544 / C slices of each
// channel's thread rows that saw a pixel (thread (s, c) merges rows s,
// s + S, ... into row s), then each group's S x C/G (slice, channel)
// partials (one warp a group, lanes, then a shuffle tree). Every thread of
// the block calls it (three __syncthreads).
template <bool F32>
__device__ void fold(const Acc& s, unsigned char* smem, int C, int G, int P, const Geo& geo,
                     float2* out) {
  float* cnt = reinterpret_cast<float*>(smem + kCntOff);
  float* scnt = cnt + kConsumers;
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
  const int R = min(geo.R, P);  // the thread rows that saw a pixel
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

// normalize the q pixels of a chunk in shared memory (rows of C) into `dst`
// (rows ldd apart; bf16: sh holds sh - mu sc, see channel_consts)
template <typename T>
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
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if constexpr (sizeof(T) == 2) {
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

// Warp 0 of the split form's kernels: lane 0 streams the range's chunks
// through the ring
template <typename T>
__device__ __forceinline__ void produce(const T* src, T* ring, int P, int q, int C,
                                        uint64_t* full, uint64_t* empty) {
  if ((threadIdx.x & 31) == 0) {
    const int nch = (P + q - 1) / q;
    for (int i = 0; i < nch; ++i) {
      const int s = i % kStages;
      if (i >= kStages) cpd::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      const uint32_t bytes = (uint32_t)(min(q, P - i * q) * C * (int)sizeof(T));
      cpd::mbar_expect_tx(&full[s], bytes);
      cpd::bulk_load(ring + (long long)s * q * C, src + (long long)i * q * C, bytes, &full[s]);
    }
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
// (C, HW, N), normalized from shared memory into y
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gn_slab_kernel(const __grid_constant__ CUtensorMap tx, const T* __restrict__ gamma,
               const T* __restrict__ beta, T* __restrict__ y, int HW, int C, int kc, int cg,
               int box_px, float eps, int silu) {
  constexpr bool F32 = sizeof(T) == 4;
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
  Acc acc;
  zero(acc);
  if (threadIdx.x >= 32) {
    for (int b = 0; b < nbox; ++b) {
      cpd::mbar_wait(&bars[b], 0);
      accumulate(acc, box_at(b), min(box_px, HW - b * box_px), kc, geo);
    }
  }
  const float count = (float)HW * (float)cg;
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
  float mu[kVec], sc[kVec];
  channel_consts<T>(stat, ge, geo, ga, mu, sc, be);
  for (int b = 0; b < nbox; ++b)
    normalize(box_at(b), y + ((long long)n * HW + b * box_px) * C + c0,
              min(box_px, HW - b * box_px), kc, C, geo, mu, sc, be, silu);
}

// Split form, kernel 1: the partials of tile blockIdx.x of sample blockIdx.y
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ parts, int HW, int C, int G) {
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  T* ring = reinterpret_cast<T*>(smem + kHeader);
  const int tiles = (int)gridDim.x, t = blockIdx.x, n = blockIdx.y;
  const int p0 = split_at(HW, tiles, t), P = split_at(HW, tiles, t + 1) - p0;
  const int q = ring_chunk(C, (int)sizeof(T)), nch = (P + q - 1) / q;
  init_ring(full, empty);
  const Geo geo = geometry(C);
  Acc acc;
  zero(acc);
  if (threadIdx.x < 32) {
    produce(x + ((long long)n * HW + p0) * C, ring, P, q, C, full, empty);
  } else {
    for (int i = 0; i < nch; ++i) {
      const int s = i % kStages;
      cpd::mbar_wait(&full[s], (i / kStages) & 1);
      accumulate(acc, ring + (long long)s * q * C, min(q, P - i * q), C, geo);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) cpd::mbar_arrive(&empty[s]);
    }
  }
  fold<F32>(acc, smem, C, G, P, geo, parts + ((long long)n * tiles + t) * G);
}

// Split form, kernel 2: merge sample blockIdx.y's partials (stat_tiles of
// them a group, in tile order), normalize tile blockIdx.x
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gn_apply_kernel(const T* __restrict__ x, const float2* __restrict__ parts,
                const T* __restrict__ gamma, const T* __restrict__ beta, T* __restrict__ y,
                int HW, int C, int G, int stat_tiles, float eps, int silu) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int kBatch = 8;  // partials a thread loads before it merges them
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  float2* stat = reinterpret_cast<float2*>(smem + kStatOff);
  T* ring = reinterpret_cast<T*>(smem + kHeader);
  const int tiles = (int)gridDim.x, t = blockIdx.x, n = blockIdx.y;
  const int p0 = split_at(HW, tiles, t), P = split_at(HW, tiles, t + 1) - p0;
  const int q = ring_chunk(C, (int)sizeof(T)), nch = (P + q - 1) / q;
  const long long base = ((long long)n * HW + p0) * C;
  init_ring(full, empty);
  if (threadIdx.x < 32) {
    produce(x + base, ring, P, q, C, full, empty);
    return;
  }
  const Geo geo = geometry(C);
  float ga[kVec], be[kVec];
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
          merge<F32>(s, Part{(float)(split_at(HW, stat_tiles, i + 1) -
                                     split_at(HW, stat_tiles, i)) * cg,
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
  float mu[kVec], sc[kVec];
  channel_consts<T>(stat, ge, geo, ga, mu, sc, be);
  for (int i = 0; i < nch; ++i) {
    const int s = i % kStages;
    cpd::mbar_wait(&full[s], (i / kStages) & 1);
    normalize(ring + (long long)s * q * C, y + base + (long long)i * q * C, min(q, P - i * q), C,
              C, geo, mu, sc, be, silu);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) cpd::mbar_arrive(&empty[s]);
  }
}

template <typename K>
int set_attrs(K kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, void* parts, int N,
           int HW, int C, int G, float eps, int silu, int form, int tiles, int* launched,
           cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const T* bp = static_cast<const T*>(beta);
  T* yp = static_cast<T*>(y);
  const int es = (int)sizeof(T);
  static bool attrs = false;  // one card a process
  if (!attrs) {
    int err = set_attrs(gn_slab_kernel<T>);
    if (!err) err = set_attrs(gn_stats_kernel<T>);
    if (!err) err = set_attrs(gn_apply_kernel<T>);
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
    gn_slab_kernel<T><<<dim3(G / tiles, N), kThreads, kHeader + (int)bytes, st>>>(
        tx, gp, bp, yp, HW, C, kc, C / G, box_px, eps, silu);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launched;
    return 0;
  }
  const int smem = kHeader + kStages * ring_chunk(C, es) * C * es;
  float2* pp = static_cast<float2*>(parts);
  gn_stats_kernel<T><<<dim3(tiles, N), kThreads, smem, st>>>(xp, pp, HW, C, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++*launched;
  gn_apply_kernel<T><<<dim3(tiles, N), kThreads, smem, st>>>(xp, pp, gp, bp, yp, HW, C, G, tiles,
                                                             eps, silu);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++*launched;
  return 0;
}

}  // namespace

// x, y: [N, HW, C] contiguous, 16-byte aligned; gamma, beta: [C] of x's
// dtype (f32 if is_f32, else bf16). C % 8 == 0, C <= 4096, C % G == 0,
// G <= 256. form 0: the split form over `tiles` (1 .. HW) tiles a sample,
// with `parts` N * tiles * G float2 of scratch; form 1: the slab form,
// `tiles` groups a block (dividing G; their channels a multiple of 8 and at
// most 256, their HW pixels at most kTileMax bytes in at most 32 boxes of
// 256 pixels). Sets *launched to the kernels it launched (1 or 2).
extern "C" int cpd_group_norm_sm90(const void* x, const void* gamma, const void* beta, void* y,
                                   void* parts, int is_f32, int N, int HW, int C, int G,
                                   float eps, int silu, int form, int tiles, int* launched,
                                   void* stream) {
  *launched = 0;
  if (N <= 0 || N > 65535 || HW <= 0 || G <= 0 || G > kMaxGroups || C % G || C % kVec ||
      C / kVec > kConsumers || (long long)HW * C >= (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return (int)cudaErrorInvalidValue;
  if (form == 1) {
    if (tiles < 1 || G % tiles) return (int)cudaErrorInvalidValue;
  } else if (form != 0 || tiles < 1 || tiles > HW || parts == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return launch<float>(x, gamma, beta, y, parts, N, HW, C, G, eps, silu, form, tiles, launched,
                         st);
  return launch<__nv_bfloat16>(x, gamma, beta, y, parts, N, HW, C, G, eps, silu, form, tiles,
                               launched, st);
}

// *bytes: the most bytes of a sample one block of the slab form holds
// (ops/groupnorm.py keeps the same number, _TILE_BYTES)
extern "C" int cpd_group_norm_sm90_tile_max(int* bytes) {
  *bytes = kTileMax;
  return 0;
}
