// K8: the GroupNorm probe. K3's Hopper kernels (groupnorm_sm90.cuh) in the
// forms the TPU GroupNorm was tuned with, to find where their time goes on
// the H100. bf16 NHWC, as the TPU scripts.
//
// Replaces the TPU probe kernels:
//   * scripts/perf_gn6.py:73 make (_kernel :27): modes copy, stats, norm,
//     full and bf16sig, each an epilogue and statistics variant of K3's slab
//     and apply loops (GnProbeMode in groupnorm_sm90.cuh), with their TMA and
//     bulk-copy loads unchanged;
//   * scripts/perf_gn5.py:111 make, kind "mxu" (_kernel_mxu :56): the
//     channel sums as products with a ones operand, here mma.sync m16n8k16 on
//     the slab's boxes or on the statistics kernel's ring chunks
//     (octet_sums_mma: s1 of the bf16 values as they are, s2 of x^2 rounded
//     once to bf16). Kinds "merged" and "nohi" are K3: the channel -> group
//     map is an index on this card, not a matmul, so DEFAULT against HIGHEST
//     precision changes no work here;
//   * scripts/perf_gn4.py:43,63 chunked (the package's _gn_stats_kernel and
//     _gn_apply_kernel over a grid (sample, chunk) whose chunks one core
//     streams in turn): K3's split form with the sample cut into `runs`
//     chunks (hw / chunk), each of K3's tiles streaming its share of every
//     chunk in turn, so that the grid stays K3's one full wave;
//     perf_gn4.py:96 flat_onepass is K3.
//
// The form and its blocks come from the host: K3's plan (ops/groupnorm.py:
// group_norm_plan), or the split form over K3's split tiles (at most hw /
// runs of them) and the forced runs. The full mode at K3's plan launches
// K3's own instantiations, so it writes K3's bits.
//
// What bounds it: bytes. One read and one write of the plane at least (bf16
// 8x64x64x320: 0.0125 ms at 3.35 TB/s); the split form reads it twice, and
// its copy mode once (no statistics kernel). The body this replaced
// (probe_groupnorm_prior.cu: one block a (sample, group) slice, accesses as
// narrow as 4 bytes, the plane read 2-3 times) ran 0.083-0.091 ms there.

#include "groupnorm_sm90.cuh"

// x, y: [N, HW, C] bf16 contiguous, 16-byte aligned; gamma, beta: [C] bf16.
// C % 8 == 0, C <= 4096, C % G == 0, G <= 256. mode: GnProbeMode; mma (mode
// full only): the tensor-core statistics. form and tiles as
// cpd_group_norm_sm90's (0: split over `tiles` tiles a sample with `parts`
// N * tiles * G float2 of scratch; 1: slab of `tiles` groups a block);
// runs: the split form's runs a sample (1 at K3's plan and its kernels;
// more, forced chunks, mode full only; tiles x runs <= HW).
// Sets *launched to the kernels it launched (1 or 2).
extern "C" int cpd_probe_group_norm_sm90(const void* x, const void* gamma, const void* beta,
                                         void* y, void* parts, int N, int HW, int C, int G,
                                         float eps, int mode, int mma, int form, int tiles,
                                         int runs, int* launched, void* stream) {
  typedef __nv_bfloat16 bf16;
  *launched = 0;
  if (!gn_args_ok(x, y, parts, N, HW, C, G, form, tiles, runs) || (mma && mode != kModeFull) ||
      (runs != 1 && (form != 0 || mode != kModeFull || mma)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (runs != 1)  // forced chunks: the split form's RUNS kernels, GroupNorm + SiLU
    return launch<bf16, kModeFull, false, true>(x, gamma, beta, y, parts, N, HW, C, G, eps, 1,
                                                form, tiles, runs, launched, st);
  if (mma)
    return launch<bf16, kModeFull, true>(x, gamma, beta, y, parts, N, HW, C, G, eps, 1, form,
                                         tiles, runs, launched, st);
  switch (mode) {
    case kModeFull:
    case kModeNorm:
      return launch<bf16, kModeFull>(x, gamma, beta, y, parts, N, HW, C, G, eps,
                                     mode == kModeFull, form, tiles, runs, launched, st);
    case kModeCopy:
      return launch<bf16, kModeCopy>(x, gamma, beta, y, parts, N, HW, C, G, eps, 0, form, tiles,
                                     runs, launched, st);
    case kModeStats:
      return launch<bf16, kModeStats>(x, gamma, beta, y, parts, N, HW, C, G, eps, 0, form, tiles,
                                      runs, launched, st);
    case kModeBf16Sig:
      return launch<bf16, kModeBf16Sig>(x, gamma, beta, y, parts, N, HW, C, G, eps, 0, form,
                                        tiles, runs, launched, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
