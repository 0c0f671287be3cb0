// K3 on Hopper: GroupNorm (+ optional SiLU) over NHWC activations, f32
// statistics, for every GroupNorm of the port's paths: the bf16 UNet sites
// (61 a UNet call), the bf16 VAE planes and the f32 VAE-decode planes.
//
// Replaces the TPU kernels complex_prompt_diffusion_tpu/ops/groupnorm.py::
// _gn_kernel (one sample resident in VMEM: one read, one write),
// ::_gn_stats_kernel (one-pass statistics of large <= 16-bit planes),
// ::_gn_stats2_kernel (two-pass centered f32 statistics) and
// ::_gn_apply_kernel (normalize + affine + SiLU). groupnorm.cu (the body
// this file replaced, kept as the timed "prior" body and as the body the
// probe K8 replaced) walked one (sample, group) slice per block at a stride of C,
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
//   * Two-source form (two launches), for the UNet's up-path ResBlocks,
//     whose GroupNorm+SiLU takes the hidden state and its skip as one
//     virtual row [a | b] (the JAX package's group_norm_silu_cat): the
//     split form with each ring stage filled by two bulk copies, P x Ca of
//     a and P x Cb of b, the statistics one pass in f32 for both dtypes (as
//     that function's), the output written as two tensors, so the concat
//     never reaches device memory. Groups may straddle the boundary: a
//     thread's 8 channels lie in one source (Ca % 8 == 0) and the fold sees
//     the virtual channel index.
//   * Two-source slab form (one launch), where the virtual row's groups of
//     a sample fit a block by the slab form's rule (cat_box_bytes: the one
//     block straddling the boundary takes each box as a box of a and a box
//     of b in two regions): the three 8^2 and three 16^2 pairs of the
//     UNet's up path and 32^2 (640 | 640) at UNet batch 2 and 4. The
//     split two-source form, always two launches and the plane read twice,
//     took 1.5-1.8x torch.cat + the one-input slab on the 8^2 and 16^2
//     pairs on the H100: it is what the plan runs where no slab fits, and
//     the replaced body that phase 1 times beside the slab. The slab form took
//     those pairs to 0.0047-0.0084 ms at UNet batch 2, under torch.cat + K3
//     at each; a block that straddles the boundary runs 1.2-1.4x one that
//     does not (PERF.md section 6).
//   * A third form, a sample resident in a thread-block cluster of up to 16
//     blocks exchanging partials through distributed shared memory, lost to
//     one of these two at every shape of the render on the H100 and was
//     removed (PERF.md section 6).
//   * The host's plan (ops/groupnorm.py: group_norm_plan) picks the form
//     and its blocks; the entry reports the kernels it launched.
//   * The kernels and their launch live in groupnorm_sm90.cuh, with the
//     mode and the tensor-core statistics of the probe K8 as template
//     parameters (probe_groupnorm.cu); this file launches K3's own
//     instantiations.
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

#include "groupnorm_sm90.cuh"

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
  if (!gn_args_ok(x, y, parts, N, HW, C, G, form, tiles)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return launch<float>(x, gamma, beta, y, parts, N, HW, C, G, eps, silu, form, tiles, 1,
                         launched, st);
  return launch<__nv_bfloat16>(x, gamma, beta, y, parts, N, HW, C, G, eps, silu, form, tiles, 1,
                               launched, st);
}

// *bytes: the most bytes of a sample one block of the slab form holds
// (ops/groupnorm.py keeps the same number, _TILE_BYTES)
extern "C" int cpd_group_norm_sm90_tile_max(int* bytes) {
  *bytes = kTileMax;
  return 0;
}

// The two-source form: a [N, HW, Ca] and b [N, HW, Cb] (contiguous, 16-byte
// aligned, of one dtype: f32 if is_f32, else bf16) normalized as the rows
// [a | b] into ya (like a) and yb (like b); gamma, beta: [Ca + Cb] of that
// dtype. Ca, Cb > 0 and % 8 == 0, Ca + Cb <= 4096, (Ca + Cb) % G == 0, G <=
// 256. form 0: the split form over `tiles` (1 .. HW) tiles a sample with
// `parts` N * tiles * G float2 of scratch (two launches); form 1: the slab
// form, `tiles` groups a block (launch_cat_slab's rule; one launch, `parts`
// unread). Sets *launched to the kernels it launched.
extern "C" int cpd_group_norm_cat_sm90(const void* a, const void* b, const void* gamma,
                                       const void* beta, void* ya, void* yb, void* parts,
                                       int is_f32, int N, int HW, int Ca, int Cb, int G,
                                       float eps, int silu, int form, int tiles, int* launched,
                                       void* stream) {
  *launched = 0;
  const int C = Ca + Cb;
  if (Ca <= 0 || Cb <= 0 || Ca % kVec || Cb % kVec || !gn_args_ok(a, ya, parts, N, HW, C, G,
                                                                  form, tiles) ||
      (reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(yb)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 1)
    return is_f32 ? launch_cat_slab<float>(a, b, gamma, beta, ya, yb, N, HW, Ca, Cb, G, eps,
                                           silu, tiles, launched, st)
                  : launch_cat_slab<__nv_bfloat16>(a, b, gamma, beta, ya, yb, N, HW, Ca, Cb, G,
                                                   eps, silu, tiles, launched, st);
  if (is_f32)
    return launch_cat<float>(a, b, gamma, beta, ya, yb, parts, N, HW, Ca, Cb, G, eps, silu,
                             tiles, launched, st);
  return launch_cat<__nv_bfloat16>(a, b, gamma, beta, ya, yb, parts, N, HW, Ca, Cb, G, eps,
                                   silu, tiles, launched, st);
}

// *bytes: the most bytes a two-source slab box of box_px pixels takes at
// kc channels a block with the boundary at Ca (cat_box_bytes; ops/
// groupnorm.py keeps the same rule), for the card test that holds the two
// rules together
extern "C" int cpd_group_norm_cat_box_bytes(int box_px, int Ca, int kc, int esize, int* bytes) {
  if (box_px <= 0 || kc <= 0 || Ca <= 0 || (esize != 2 && esize != 4))
    return (int)cudaErrorInvalidValue;
  *bytes = cat_box_bytes(box_px, Ca, kc, esize);
  return 0;
}
