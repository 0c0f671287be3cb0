// K5 on Hopper, bf16: non-causal softmax attention, out = softmax(scale *
// Q K^T) V, over operands whose SEQUENCE axis is the contiguous one, with
// TMA loads and wgmma in a warp-specialised block.
//
// Replaces the TPU kernels complex_prompt_diffusion_tpu/ops/attention.py::
// _onepass_kernel_hdbs (the channel-major self-attention block: Q, K, V and
// the output are the [H, D, B, S] slices of one [3C, B, S] qkv projection)
// and ::_onepass_kernel_kcanon (Q, V and the output d-major, K canonical
// [B, H, Skv, D]) for bf16. The body it replaced (attention_cm.cu with
// attention_cm_bf16.cuh: mma.sync, cp.async, 64 query rows a block) stays
// built as ops.attention.attention_dmajor_prior and as the probe K7's
// replaced K5 loop. Rounding as the TPU kernels: f32 scores and an exp2 softmax on
// scores scaled by scale * log2 e, P rounded to bf16 before P V, an f32 O
// divided once by the row sum.
//
// What bounds it on the H100: 4 B H Sq Skv d flops over 2 B H (Sq + Skv) d
// elements, so the tensor cores at the UNet's shapes (S 4096 / 1024 / 256,
// d 40 / 80 / 160). The body it replaced ran 1.5-2.0x slower than SDPA; the
// probe K7 found 62-75% of that loop's time in its tile loads. Design, K1's
// (attention_sm90.cu) for the other operand order:
//   * 128 query rows of one (batch, head) a block: two consumer warpgroups
//     of 64 rows, a producer warpgroup whose one thread issues every TMA
//     load; setmaxnreg moves registers from the producer (24) to the
//     consumers (240). A query tile never straddles a batch.
//   * TMA: rank-4 maps (S, D, H, B) with the sequence innermost (unit
//     stride) and D, H and B at the view's own strides. That one form takes
//     the [H, D, B, S] slices of a projection, a contiguous [B, H, D, S] and
//     the output; a canonical K has the map (D, S, H, B). Boxes are 64
//     sequence elements (128 bytes) wide in the 128-byte swizzle. A box runs
//     ceil(d / 16) * 16 rows down D: at d = 40 rows 40..47 are zero-filled by
//     TMA (the pad of the 16-deep k-step), never the next head's, since D is
//     a dimension of its own. Keys past Skv and queries past Sq are
//     zero-filled; keys are masked to -inf only in the ragged last tile.
//   * S = Q K^T by wgmma m64nBKVk16 over ceil(d / 16) k-steps, both operands
//     read as they lie: the d-major Q tile [d][q] is an MN-major A, a d-major
//     K tile [d][keys] an MN-major B (hdbs), a canonical K tile [keys][d] a
//     K-major B (kcanon). Q is loaded once; K and V come in tiles of BKV keys
//     (128 at d <= 128, 64 above) through a ring of stages, K and V each on
//     its own full barrier, so Q K^T starts before V lands.
//   * O += P V by wgmma m64nDVk16 with P (bf16, in registers) as the A
//     operand and the d-major V tile [d][keys] a K-major B read as it lies;
//     DV is d rounded up to a width this file instantiates (d40 -> n40,
//     d80 -> n80, d160 -> n160).
//   * K1's overlap: the softmax of tile j runs while P V of tile j - 1 is in
//     flight, then Q K^T of tile j + 1 and P V of tile j are issued together.
//   * The accumulator holds [q][d] and the output is d-major: each consumer
//     warpgroup stages its 64 x DV tile transposed in its own Q box (dead by
//     then) in the 128-byte swizzle, then writes it with 16-byte stores along
//     S (TMA stores of the output's map measured the same on the H100).
// The kernel sits in attention_cm_sm90.cuh with the mode as a template
// parameter: this file launches the attention, the probe K7 its scores mode.

#include "attention_cm_sm90.cuh"

namespace {

using namespace k5sm90;

// the instantiated width for head dim D, 0 for a head dim the body does not
// take: D % 8 == 0 with ceil(D / 16) * 16 one of K1's padded widths
// (ops/attention.py: _ATTN_BF16_DP, _K5_BF16_DV)
int width_of(int D) {
  static const int pads[] = {16, 32, 48, 64, 80, 96, 128, 160, 256};
  static const int widths[] = {16, 32, 40, 48, 64, 80, 96, 128, 160, 256};
  if (D <= 0 || D % 8) return 0;
  bool ok = false;
  for (int p : pads) ok |= p == (D + 15) / 16 * 16;
  if (!ok) return 0;
  for (int w : widths)
    if (w >= D) return w;
  return 0;
}

template <bool KCANON>
int dispatch(const Args& a, cudaStream_t s) {
  switch (width_of(a.D)) {
    case 16: return launch<16, KCANON, kFull>(a, s);
    case 32: return launch<32, KCANON, kFull>(a, s);
    case 40: return launch<40, KCANON, kFull>(a, s);
    case 48: return launch<48, KCANON, kFull>(a, s);
    case 64: return launch<64, KCANON, kFull>(a, s);
    case 80: return launch<80, KCANON, kFull>(a, s);
    case 96: return launch<96, KCANON, kFull>(a, s);
    case 128: return launch<128, KCANON, kFull>(a, s);
    case 160: return launch<160, KCANON, kFull>(a, s);
    case 256: return launch<256, KCANON, kFull>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool KCANON>
void config_of(int DV, int* out) {
#define CPD_CM_CFG(W)                                                                 \
  case W:                                                                            \
    out[0] = BQ, out[1] = Cfg<W, KCANON>::BKV, out[2] = Cfg<W, KCANON>::STAGES,       \
    out[3] = Cfg<W, KCANON>::SMEM;                                                    \
    break;
  switch (DV) {
    CPD_CM_CFG(16)
    CPD_CM_CFG(32)
    CPD_CM_CFG(40)
    CPD_CM_CFG(48)
    CPD_CM_CFG(64)
    CPD_CM_CFG(80)
    CPD_CM_CFG(96)
    CPD_CM_CFG(128)
    CPD_CM_CFG(160)
    CPD_CM_CFG(256)
  }
#undef CPD_CM_CFG
}

}  // namespace

// q, v [B, H, D, S] and o [B, H, D, Sq] bf16 views with unit stride along S;
// k the same, or with k_canonical a [B, H, Skv, D] view with unit stride
// along D. Strides are in elements: (batch, head, head dim) of q, v and o and
// of a d-major k; (batch, head, key row) of a canonical k; all multiples of 8
// with 16-byte aligned bases (TMA's rule). D % 8 == 0 with a width
// width_of() has; Sq % 8 == 0 and Skv % 8 == 0.
extern "C" int cpd_attention_cm_sm90_bf16(const void* q, const void* k, const void* v, void* o,
                                          int B, int H, int Sq, int Skv, int D, long long q_sb,
                                          long long q_sh, long long q_sd, long long k_sb,
                                          long long k_sh, long long k_sx, long long v_sb,
                                          long long v_sh, long long v_sd, long long o_sb,
                                          long long o_sh, long long o_sd, int k_canonical,
                                          float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || Sq % 8 || Skv % 8 || !width_of(D) ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, H, Sq, Skv, D, q_sb, q_sh, q_sd, k_sb, k_sh, k_sx, v_sb, v_sh,
               v_sd, o_sb, o_sh, o_sd, scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return k_canonical ? dispatch<true>(a, s) : dispatch<false>(a, s);
}

// out[0..4]: query rows a block, keys a tile, K/V stages, shared-memory
// bytes, and 1 (a fused body) of the bf16 body for head dim D
extern "C" int cpd_attention_cm_sm90_bf16_config(int D, int k_canonical, int* out) {
  const int dv = width_of(D);
  if (!dv) return (int)cudaErrorInvalidValue;
  if (k_canonical)
    config_of<true>(dv, out);
  else
    config_of<false>(dv, out);
  out[4] = 1;
  return 0;
}
