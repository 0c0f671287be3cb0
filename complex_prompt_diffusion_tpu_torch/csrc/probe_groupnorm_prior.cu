// K8's replaced body: the GroupNorm probe as first ported, on K3's first
// kernels (groupnorm.cuh, the body K3's Hopper forms replaced) in the forms
// the TPU GroupNorm was tuned with. bf16 NHWC, as the TPU scripts. K8 now
// runs K3's Hopper forms (probe_groupnorm.cu); this body stays callable
// (ops/probes/groupnorm.py: group_norm_probe_prior) and is timed beside it.
//
// Replaces the TPU probe kernels:
//   * scripts/perf_gn6.py:73 make (_kernel :27): modes copy, stats, norm,
//     full and bf16sig of K3's fused bf16 kernel (GnMode in groupnorm.cuh),
//     with K3's access pattern unchanged;
//   * scripts/perf_gn5.py:111 make, kind "mxu" (_kernel_mxu :56): the
//     channel sums as products with a ones operand, here mma.sync m16n8k16
//     (sums_mma in groupnorm.cuh: s1 of the bf16 values as they are, s2 of
//     x^2 rounded once to bf16). Kinds "merged" and "nohi" are K3's fused
//     kernel: the channel -> group map is an index on this card, not a
//     matmul, so DEFAULT against HIGHEST precision changes no work here;
//   * scripts/perf_gn4.py:43,63 chunked (the package's _gn_stats_kernel and
//     _gn_apply_kernel over HW chunks): K3's split schedule, its statistics
//     and apply kernels, with the split count forced (hw / chunk);
//     perf_gn4.py:96 flat_onepass is K3's fused kernel (splits = 1).
//
// What bounds it: bytes. One read and one write of the plane at least; K3's
// modes with statistics read it twice, the copy once.

#include "groupnorm.cuh"

namespace {

typedef __nv_bfloat16 bf16;

template <int VEC>
int probe_vec(const bf16* x, const bf16* gamma, const bf16* beta, bf16* y, float2* part, int N,
              int HW, int C, int G, int S, float eps, int mode, int mma, cudaStream_t s) {
  const dim3 grid(G, N);
  if (S > 0) {
    if (mode != kGnFull || mma) return (int)cudaErrorInvalidValue;
    launch_split<bf16, VEC>(x, gamma, beta, y, part, N, HW, C, G, S, eps, 1, s);
    return 0;
  }
  if (mma) {
    if (mode != kGnFull) return (int)cudaErrorInvalidValue;
    group_norm_kernel<bf16, VEC, kGnFull, true><<<grid, kThreads, 0, s>>>(x, gamma, beta, y, HW, C,
                                                                           G, eps, 1);
    return 0;
  }
  switch (mode) {
    case kGnFull:
      group_norm_kernel<bf16, VEC, kGnFull><<<grid, kThreads, 0, s>>>(x, gamma, beta, y, HW, C, G,
                                                                      eps, 1);
      return 0;
    case kGnCopy:
      group_norm_kernel<bf16, VEC, kGnCopy><<<grid, kThreads, 0, s>>>(x, gamma, beta, y, HW, C, G,
                                                                      eps, 1);
      return 0;
    case kGnStats:
      group_norm_kernel<bf16, VEC, kGnStats><<<grid, kThreads, 0, s>>>(x, gamma, beta, y, HW, C,
                                                                       G, eps, 1);
      return 0;
    case kGnNorm:
      group_norm_kernel<bf16, VEC, kGnNorm><<<grid, kThreads, 0, s>>>(x, gamma, beta, y, HW, C, G,
                                                                      eps, 1);
      return 0;
    case kGnBf16Sig:
      group_norm_kernel<bf16, VEC, kGnBf16Sig><<<grid, kThreads, 0, s>>>(x, gamma, beta, y, HW, C,
                                                                         G, eps, 1);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [N, HW, C] bf16 contiguous; gamma, beta: [C] bf16. splits = 0: the
// fused kernel in `mode` (GnMode), with tensor-core statistics if `mma`
// (mode full only); splits = S >= 1: K3's statistics and apply kernels over
// S HW splits (mode full), with `part` N * G * S float2 of scratch. SiLU is
// on in every mode that applies an activation (full; bf16sig's own).
extern "C" int cpd_probe_group_norm_prior_bf16(const void* x, const void* gamma, const void* beta,
                                               void* y, void* part, int N, int HW, int C,
                                               int G, int splits, float eps, int mode, int mma,
                                               void* stream) {
  if (splits < 0 || !gn_shape_ok(HW, C, G, splits > 0 ? splits : 1, splits > 0 ? part : nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* gp = static_cast<const bf16*>(gamma);
  const bf16* bp = static_cast<const bf16*>(beta);
  bf16* yp = static_cast<bf16*>(y);
  float2* pp = static_cast<float2*>(part);
  int err;
  switch (pick_vec<bf16>(x, y, C / G)) {
    case 8:
      err = probe_vec<8>(xp, gp, bp, yp, pp, N, HW, C, G, splits, eps, mode, mma, s);
      break;
    case 4:
      err = probe_vec<4>(xp, gp, bp, yp, pp, N, HW, C, G, splits, eps, mode, mma, s);
      break;
    case 2:
      err = probe_vec<2>(xp, gp, bp, yp, pp, N, HW, C, G, splits, eps, mode, mma, s);
      break;
    default:
      err = probe_vec<1>(xp, gp, bp, yp, pp, N, HW, C, G, splits, eps, mode, mma, s);
  }
  return err != 0 ? err : (int)cudaGetLastError();
}
