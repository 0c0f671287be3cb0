// The body of K3 (csrc/groupnorm.cu): NHWC GroupNorm (+ SiLU), the slice
// addressing, the statistics, the fused kernel and the split kernels (the
// design notes are at the top of groupnorm.cu). groupnorm.cu launches them
// as K3's replaced body; K8's replaced body (csrc/probe_groupnorm_prior.cu)
// launches the fused bf16 kernel in the modes of the TPU ablation script
// and with tensor-core statistics, and the split kernels with a forced
// split count. The fused
// kernel's mode and statistics engine are template parameters with K3's as
// the defaults, so the kernels K3 launches are the code it always ran.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

// What the fused kernel writes (K3: kGnFull). Every mode keeps K3's access
// pattern: the modes with statistics read the slice twice, as K3 does.
enum GnMode : int {
  kGnFull = 0,     // silu?((x - mean) * rstd * gamma + beta)
  kGnCopy = 1,     // x through f32 and back, no statistics: one read, one write
  kGnStats = 2,    // the statistics, then x + rstd * 0 (the statistics stay live)
  kGnNorm = 3,     // (x - mean) * rstd * gamma + beta, no SiLU
  kGnBf16Sig = 4,  // the normalized value rounded to bf16, SiLU in bf16 arithmetic
};

// VEC consecutive elements, loaded and stored as one access
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The packs [i0, i1) of one (sample, group) slice: pack i is pixel i / nv,
// channels (i % nv) * VEC ..
template <typename T, int VEC>
struct Slice {
  const T* xs;  // x at (n, pixel 0, group's first channel)
  unsigned i0, i1, nv;
  int C;

  __device__ __forceinline__ long long offset(unsigned i) const {
    const unsigned p = i / nv;
    return (long long)p * C + (long long)(i - p * nv) * VEC;
  }
};

template <typename T, int VEC>
__device__ __forceinline__ Slice<T, VEC> make_slice(const T* x, int n, int g, int HW, int C,
                                                    int G, int p0, int p1) {
  const int cg = C / G;
  const unsigned nv = cg / VEC;
  return Slice<T, VEC>{x + (long long)n * HW * C + (long long)g * cg, p0 * nv, p1 * nv, nv, C};
}

// This thread's (sum of x - c, sum of (x - c)^2) over the slice
template <typename T, int VEC>
__device__ __forceinline__ float2 sums(const Slice<T, VEC>& sl, float c) {
  typedef Pack<T, VEC> P;
  float s = 0.f, s2 = 0.f;
  for (unsigned i0 = sl.i0 + threadIdx.x; i0 < sl.i1; i0 += kThreads * kUnroll) {
    P pk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = i0 + u * kThreads;
      if (i < sl.i1) pk[u] = *reinterpret_cast<const P*>(sl.xs + sl.offset(i));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * kThreads < sl.i1)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float d = cpd::to_f32(pk[u].v[e]) - c;
          s += d;
          s2 += d * d;
        }
  }
  return make_float2(s, s2);
}

// The same sums for bf16 on the tensor cores: the packs each thread loads
// (the same packs as sums(), at the same addresses) become B operands of
// m16n8k16 products with an all-ones A, so the column sums land in the f32
// accumulators. s1 takes the elements as they are (x * 1 is exact); s2 takes
// x^2 rounded once to bf16 (__hmul2), a relative error <= 2^-9 per element.
// Which element sits in which (k, n) slot does not matter: only the total
// over the warp is read, 8 times over (rows g of the 8 row groups), hence the
// 1/8. The loop bound is tested per warp, since mma.sync needs all 32 lanes;
// lanes past the slice's end load zeros.
template <int VEC>
__device__ __forceinline__ float2 sums_mma(const Slice<__nv_bfloat16, VEC>& sl) {
  typedef Pack<__nv_bfloat16, VEC> P;
  constexpr int kElems = kUnroll * VEC;  // bf16 values a thread loads per step
  static_assert(kElems % 4 == 0, "each product takes 4 values a thread");
  const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
  float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
  const unsigned lane = threadIdx.x & 31u;
  for (unsigned i0 = sl.i0 + (threadIdx.x & ~31u); i0 < sl.i1; i0 += kThreads * kUnroll) {
    __nv_bfloat16 e[kElems];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = i0 + lane + u * kThreads;
      P pk;
      if (i < sl.i1) {
        pk = *reinterpret_cast<const P*>(sl.xs + sl.offset(i));
      } else {
#pragma unroll
        for (int t = 0; t < VEC; ++t) pk.v[t] = __ushort_as_bfloat16((unsigned short)0);
      }
#pragma unroll
      for (int t = 0; t < VEC; ++t) e[u * VEC + t] = pk.v[t];
    }
#pragma unroll
    for (int m = 0; m < kElems / 4; ++m) {
      __nv_bfloat162 x0 = __halves2bfloat162(e[4 * m], e[4 * m + 1]);
      __nv_bfloat162 x1 = __halves2bfloat162(e[4 * m + 2], e[4 * m + 3]);
      __nv_bfloat162 q0 = __hmul2(x0, x0);
      __nv_bfloat162 q1 = __hmul2(x1, x1);
      cpd::mma_16816(c1, ones, *reinterpret_cast<uint32_t*>(&x0),
                     *reinterpret_cast<uint32_t*>(&x1));
      cpd::mma_16816(c2, ones, *reinterpret_cast<uint32_t*>(&q0),
                     *reinterpret_cast<uint32_t*>(&q1));
    }
  }
  return make_float2((c1[0] + c1[1]) * 0.125f, (c2[0] + c2[1]) * 0.125f);
}

// y = f(x) over the slice, f by MODE (K3: silu?((x - mean) * rstd * gamma + beta))
template <int MODE = kGnFull, typename T, int VEC>
__device__ __forceinline__ void apply(const Slice<T, VEC>& sl, T* ys, const T* gamma,
                                      const T* beta, int c0, float mean, float rstd, int silu) {
  typedef Pack<T, VEC> P;
  for (unsigned i0 = sl.i0 + threadIdx.x; i0 < sl.i1; i0 += kThreads * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = i0 + u * kThreads;
      if (i < sl.i1) {
        const long long off = sl.offset(i);
        const int c = c0 + (int)(i % sl.nv) * VEC;
        const P in = *reinterpret_cast<const P*>(sl.xs + off);
        P out;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if constexpr (MODE == kGnCopy) {
            out.v[e] = cpd::from_f32<T>(cpd::to_f32(in.v[e]));
          } else if constexpr (MODE == kGnStats) {
            out.v[e] = cpd::from_f32<T>(cpd::to_f32(in.v[e]) + rstd * 0.f);
          } else {
            float v = (cpd::to_f32(in.v[e]) - mean) * rstd;
            v = v * cpd::to_f32(gamma[c + e]) + cpd::to_f32(beta[c + e]);
            if constexpr (MODE == kGnBf16Sig) {
              const __nv_bfloat16 yb = __float2bfloat16(v);
              const __nv_bfloat16 one = __float2bfloat16(1.f);
              const __nv_bfloat16 sig = __hdiv(one, __hadd(one, hexp(__hneg(yb))));
              out.v[e] = cpd::from_f32<T>(__bfloat162float(__hmul(yb, sig)));
            } else {
              if constexpr (MODE == kGnFull)
                if (silu) v = v / (1.f + expf(-v));
              out.v[e] = cpd::from_f32<T>(v);
            }
          }
        }
        *reinterpret_cast<P*>(ys + off) = out;
      }
    }
  }
}

// The statistics of the pixels [p0, p1) of (n, g) on every thread: bf16
// (sum, sum of squares); f32 (mean, centered sum of squares) of the range.
template <bool MMA = false, typename T, int VEC>
__device__ __forceinline__ float2 range_stats(const Slice<T, VEC>& sl, float count,
                                              float* scratch) {
  if constexpr (MMA) {
    const float2 a = sums_mma(sl);
    const float s = cpd::block_sum(a.x, scratch);
    return make_float2(s, cpd::block_sum(a.y, scratch));
  } else {
    const float2 a = sums(sl, 0.f);
    const float s = cpd::block_sum(a.x, scratch);
    if constexpr (sizeof(T) <= 2) {
      return make_float2(s, cpd::block_sum(a.y, scratch));
    } else {
      const float mean = s / count;
      return make_float2(mean, cpd::block_sum(sums(sl, mean).y, scratch));
    }
  }
}

// (mean, rstd) from one statistics pair over `count` elements
template <typename T>
__device__ __forceinline__ float2 finish(float2 st, float count, float eps) {
  float mean, var;
  if constexpr (sizeof(T) <= 2) {
    mean = st.x / count;
    var = fmaxf(st.y / count - mean * mean, 0.f);
  } else {
    mean = st.x;
    var = st.y / count;
  }
  return make_float2(mean, rsqrtf(var + eps));
}

// S = 1: one block per (sample, group) does both. MMA: the statistics on
// the tensor cores (bf16 only).
template <typename T, int VEC, int MODE = kGnFull, bool MMA = false>
__global__ void __launch_bounds__(kThreads)
group_norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y, int HW, int C, int G,
                  float eps, int silu) {
  __shared__ float scratch[33];
  const int g = blockIdx.x, n = blockIdx.y, cg = C / G;
  const Slice<T, VEC> sl = make_slice<T, VEC>(x, n, g, HW, C, G, 0, HW);
  const float count = (float)HW * (float)cg;
  float2 mr = make_float2(0.f, 0.f);
  if constexpr (MODE != kGnCopy) mr = finish<T>(range_stats<MMA>(sl, count, scratch), count, eps);
  apply<MODE>(sl, y + (sl.xs - x), gamma, beta, g * cg, mr.x, mr.y, silu);
}

__device__ __forceinline__ int split_begin(int HW, int S, int s) {
  return (int)((long long)HW * s / S);
}

// S > 1, kernel 1: partial statistics of split blockIdx.z
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
group_norm_stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int HW, int C,
                        int G, int S) {
  __shared__ float scratch[33];
  const int g = blockIdx.x, n = blockIdx.y, sp = blockIdx.z;
  const int p0 = split_begin(HW, S, sp), p1 = split_begin(HW, S, sp + 1);
  const Slice<T, VEC> sl = make_slice<T, VEC>(x, n, g, HW, C, G, p0, p1);
  const float2 st = range_stats(sl, (float)(p1 - p0) * (float)(C / G), scratch);
  if (threadIdx.x == 0) part[((long long)n * G + g) * S + sp] = st;
}

// S > 1, kernel 2: merge the S partials, normalize split blockIdx.z
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
group_norm_apply_kernel(const T* __restrict__ x, const float2* __restrict__ part,
                        const T* __restrict__ gamma, const T* __restrict__ beta,
                        T* __restrict__ y, int HW, int C, int G, int S, float eps, int silu) {
  const int g = blockIdx.x, n = blockIdx.y, sp = blockIdx.z, cg = C / G;
  const float2* pp = part + ((long long)n * G + g) * S;
  const float count = (float)HW * (float)cg;
  float2 st = make_float2(0.f, 0.f);
  if constexpr (sizeof(T) <= 2) {
    for (int i = 0; i < S; ++i) {
      st.x += pp[i].x;
      st.y += pp[i].y;
    }
  } else {  // Chan: mean = sum n_i mean_i / n, M2 = sum M2_i + n_i (mean_i - mean)^2
    for (int i = 0; i < S; ++i)
      st.x += pp[i].x * (float)(split_begin(HW, S, i + 1) - split_begin(HW, S, i)) * cg;
    st.x /= count;
    for (int i = 0; i < S; ++i) {
      const float ni = (float)(split_begin(HW, S, i + 1) - split_begin(HW, S, i)) * cg;
      const float d = pp[i].x - st.x;
      st.y += pp[i].y + ni * d * d;
    }
  }
  const float2 mr = finish<T>(st, count, eps);
  const int p0 = split_begin(HW, S, sp), p1 = split_begin(HW, S, sp + 1);
  const Slice<T, VEC> sl = make_slice<T, VEC>(x, n, g, HW, C, G, p0, p1);
  apply(sl, y + (sl.xs - x), gamma, beta, g * cg, mr.x, mr.y, silu);
}

template <typename T, int VEC>
void launch_split(const T* x, const T* gamma, const T* beta, T* y, float2* part, int N, int HW,
                  int C, int G, int S, float eps, int silu, cudaStream_t s) {
  group_norm_stats_kernel<T, VEC><<<dim3(G, N, S), kThreads, 0, s>>>(x, part, HW, C, G, S);
  group_norm_apply_kernel<T, VEC><<<dim3(G, N, S), kThreads, 0, s>>>(x, part, gamma, beta, y, HW,
                                                                      C, G, S, eps, silu);
}

// The widest aligned access that divides C/G and still leaves two per
// pixel: with one (f32, C/G = 4) each warp load touches 32 pixels 512
// bytes apart, and the H100 ran that plane 2.2x slower than with two.
template <typename T>
int pick_vec(const void* x, const void* y, int cg) {
  constexpr int kMaxVec = 16 / (int)sizeof(T);  // 16-byte accesses at most
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  int vec = kMaxVec;
  while (vec > 1 && (cg % vec != 0 || cg / vec < 2 || addr % (vec * sizeof(T)) != 0)) vec /= 2;
  return vec;
}

// The shape checks every launch shares
inline bool gn_shape_ok(int HW, int C, int G, int S, const void* part) {
  if (G <= 0 || C % G != 0 || S < 1 || S > HW || (S > 1 && part == nullptr)) return false;
  return (long long)HW * (C / G) < (1LL << 31);
}

}  // namespace
