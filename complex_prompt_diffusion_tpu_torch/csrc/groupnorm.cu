// K3: GroupNorm (+ optional SiLU) over NHWC activations.
//
// Replaces the TPU kernels complex_prompt_diffusion_tpu/ops/groupnorm.py::
// _gn_kernel (one-pass-per-sample GroupNorm for planes <= 16 MB),
// ::_gn_stats_kernel (streaming one-pass statistics for larger <= 16-bit
// planes), ::_gn_stats2_kernel (streaming two-pass f32 statistics) and
// ::_gn_apply_kernel (normalize + affine + SiLU per HW chunk). The port
// launches it for every GroupNorm: the bf16 UNet sites (which the JAX
// package leaves to its XLA matmul-stats form, _gn_xla_mm), the bf16 VAE
// encode/decode planes and the f32 VAE-decode planes, up to 512x512x256
// f32 = 256 MB per sample.
//
// Statistics follow the JAX package's rule by dtype, in f32 accumulators:
//   * bf16: one pass computes sum(x) and sum(x^2) together, then
//     var = max(E[x^2] - mean^2, 0) (every <= 16-bit GroupNorm of the JAX
//     package: _gn_xla_mm, _gn_stats_kernel, _gn_kernel with one_pass);
//   * f32: the centered sum of squares, never E[x^2] (the exact contract of
//     _gn_stats2_kernel: no cancellation).
// A last pass normalizes, applies gamma/beta and SiLU.
//
// What bounds it on the H100: it is pure memory traffic — 2 reads and 1
// write of the activation in bf16, 3 reads and 1 write in f32 (the TPU
// kernel, with the sample resident in VMEM, read it once). A group's C/G
// channels are contiguous within a pixel, so each thread moves VEC of them
// per access (VEC = the largest of 8 bf16 / 4 f32, 4, 2, 1 that divides C/G
// with at least two accesses per pixel: up to 16-byte loads), and loads are
// unrolled 4-deep so each thread keeps several requests in flight. A warp
// still reads runs of C/G channels at a stride of C, so reads are only
// partly coalesced. Keeping the slice in shared memory (one read instead
// of three) was measured and gained nothing.
//
// Two schedules, both with 512-thread blocks; the wrapper picks the number
// of HW splits S per (sample, group):
//   * S = 1, one fused kernel: one block per (sample, group) computes the
//     statistics and applies them (the UNet planes at UNet batch 8, whose
//     256+ blocks fill the card);
//   * S > 1, two kernels: the VAE planes have N x 32 blocks only (32 at
//     batch 1 on 132 SMs), so block (g, n, s) takes 1/S of the slice's
//     pixels. group_norm_stats_kernel writes per-split partials — (sum,
//     sum of squares) in bf16; (mean, centered sum of squares) of the
//     split in f32, merged with Chan's formula M2 = sum M2_i + n_i (mean_i -
//     mean)^2, so the f32 variance is still centered — and
//     group_norm_apply_kernel merges the S partials and normalizes its part.
//
// The kernels live in groupnorm.cuh, which the probe kernel K8
// (probe_groupnorm.cu) also instantiates; this file launches K3.

#include "groupnorm.cuh"

namespace {

template <typename T, int VEC>
void launch_vec(const T* x, const T* gamma, const T* beta, T* y, float2* part, int N, int HW,
                int C, int G, int S, float eps, int silu, cudaStream_t s) {
  if (S == 1) {
    group_norm_kernel<T, VEC><<<dim3(G, N), kThreads, 0, s>>>(x, gamma, beta, y, HW, C, G, eps,
                                                                silu);
  } else {
    launch_split<T, VEC>(x, gamma, beta, y, part, N, HW, C, G, S, eps, silu, s);
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, void* part, int N,
           int HW, int C, int G, int S, float eps, int silu, void* stream) {
  if (!gn_shape_ok(HW, C, G, S, part)) return (int)cudaErrorInvalidValue;
  constexpr int kMaxVec = 16 / (int)sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const T* bp = static_cast<const T*>(beta);
  T* yp = static_cast<T*>(y);
  float2* pp = static_cast<float2*>(part);
  switch (pick_vec<T>(x, y, C / G)) {
    case kMaxVec:
      launch_vec<T, kMaxVec>(xp, gp, bp, yp, pp, N, HW, C, G, S, eps, silu, s);
      break;
    case 2:
      launch_vec<T, 2>(xp, gp, bp, yp, pp, N, HW, C, G, S, eps, silu, s);
      break;
    case 1:
      launch_vec<T, 1>(xp, gp, bp, yp, pp, N, HW, C, G, S, eps, silu, s);
      break;
    default:  // 4 elements of a type whose widest pack is 8 (bf16)
      launch_vec<T, 4>(xp, gp, bp, yp, pp, N, HW, C, G, S, eps, silu, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [N, HW, C] contiguous; gamma, beta: [C] of the same dtype as x.
// S: HW splits per (sample, group); S > 1 needs `part`, N * G * S float2
// of scratch.
extern "C" int cpd_group_norm_f32(const void* x, const void* gamma, const void* beta, void* y,
                                  void* part, int N, int HW, int C, int G, int S, float eps,
                                  int silu, void* stream) {
  return launch<float>(x, gamma, beta, y, part, N, HW, C, G, S, eps, silu, stream);
}

extern "C" int cpd_group_norm_bf16(const void* x, const void* gamma, const void* beta, void* y,
                                   void* part, int N, int HW, int C, int G, int S, float eps,
                                   int silu, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, y, part, N, HW, C, G, S, eps, silu, stream);
}
