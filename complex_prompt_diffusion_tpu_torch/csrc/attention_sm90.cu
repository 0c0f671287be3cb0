// K1 on Hopper, bf16 with head dim d <= 256: non-causal softmax attention,
// out = softmax(scale * Q K^T) V, over the [B, S, H*D] layout, with TMA
// loads and wgmma in a warp-specialised block.
//
// Replaces the TPU kernels complex_prompt_diffusion_tpu/ops/attention.py::
// _onepass_kernel (UNet self-attention: bf16, S_kv 256..4096, d 40/80/160
// in SD-1.5, 64 in SD-2) and ::_attn_kernel (the streaming kernel) for the
// bf16 head dims up to 256. attention.cu keeps the d = 512 split-d body
// (attention_bf16_wide_mma) and the f32 FMA body (attention_f32_fma), both
// replaced; the mma.sync body (attention_bf16.cuh) is launched only as the
// probe K7's replaced loop (probe_attention_prior.cu). Rounding as the TPU kernel: f32
// scores and softmax (exp2 of scores scaled by scale * log2 e), P rounded to
// bf16 before the PV product, an f32 O accumulator.
//
// What bounds it on the H100: 4 * B*H * Sq * Skv * d flops over only
// 4 * B * S * H*D * 2 bytes, so the tensor cores at large S. The mma.sync body
// ran 1.6-2.0x slower than SDPA; its own ablation (K7, PERF.md section 5)
// showed the tile loads alone taking 62-75% of its time: a block of 64 query
// rows reads all of its head's K and V through cp.async, every thread
// computing addresses. Design:
//   * 128 query rows a block: two consumer warpgroups of 64 rows, plus a
//     producer warpgroup whose one thread issues every load. The wider tile
//     halves the K/V stream through L2 (1.6 GB instead of 3.2 at S4096 d40).
//     setmaxnreg moves registers from the producer (24) to the consumers
//     (240).
//   * TMA: a rank-4 tensor map (D, H, S, B) over each of q, k and v, with
//     any batch and row stride (the UNet's q, k and v are views of one qkv
//     projection). A box is 64 wide in D: d = 40 reads columns 0..63 of its
//     own head with 40..63 zero-filled by TMA (the pad of the 16-wide k-step,
//     and none of the next head); d = 80 and 160 take two and three boxes.
//     Rows past S are zero-filled per batch. Q is loaded once; K and V come
//     in tiles of BKV keys (128 at d <= 128, 64 above) through a ring of 2-4
//     stages (as many as shared memory holds), K and V each on its own full
//     barrier, so Q K^T starts before V lands.
//   * S = Q K^T: wgmma m64nBKVk16 from shared memory, both K-major, over
//     ceil(d / 16) k-steps. The online softmax runs in registers (the
//     accumulator's rows are spread over the 4 threads of a quad); a ragged
//     last tile masks its keys past S_kv to -inf (TMA's zeros would be
//     scores of 0).
//   * O += P V: P, converted to bf16 in registers, is the register A operand
//     of wgmma m64nDVk16 (DV = d rounded up to 8: d40 -> n40); V is read from
//     shared memory as it lies, an MN-major B operand.
//   * Overlap inside a warpgroup: the softmax of tile j runs while the PV
//     product of tile j - 1 is in flight, then Q K^T of tile j + 1 and P V of
//     tile j are issued together (P double-buffered in registers, since the
//     tensor cores read it asynchronously). The two consumer warpgroups run
//     independently, so one's exp2 can also overlap the other's wgmma; the
//     exp2 is ex2.approx.ftz (MUFU).
// The loop is a mode template (attention_sm90.cuh): this file launches its
// attention at K1's choices (row sums, exp2, the key tiles above), and the
// probe K7 (probe_attention*.cu) the same loop with pieces removed.
// Measured on the H100 80GB HBM3 at 700 W (tree_ab, PERF.md section 6):
// ping-pong turns of the two warpgroups' wgmma on named barriers lost
// 13-21%, 64-key tiles lost 16-19% at d40 and d80, and row max and sums as
// trees (in place of the chains below) gained nothing at d160; none is
// kept. Masking keys only in the ragged last tile (not by a per-element
// predicate in every tile) gained 7% at d40. The kernel runs 1.1-1.2x slower
// than SDPA at the UNet's shapes.

#include "attention_sm90.cuh"

namespace {

template <int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Skv,
           int D, long long qbs, long long qrs, long long kbs, long long krs, long long vbs,
           long long vrs, float scale_log2, cudaStream_t stream) {
  return k1sm90::launch<DV, k1sm90::k1_bkv<DV>(), kFull, kSumRows, true, false>(
      q, k, v, o, B, H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs, scale_log2, stream);
}

}  // namespace

// q [B, Sq, H*D], k and v [B, Skv, H*D] bf16 with unit column stride, batch
// and row strides in elements (multiples of 8, 16-byte aligned bases); o a
// fresh contiguous [B, Sq, H*D]. D % 8 == 0 and D <= 256.
extern "C" int cpd_attention_sm90_bf16(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int Sq, int Skv, int D, long long qbs,
                                       long long qrs, long long kbs, long long krs,
                                       long long vbs, long long vrs, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 || D > 256 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * 1.4426950408889634f;
#define CPD_SM90_CASE(DVV)                                                                   \
  case DVV:                                                                                  \
    return launch<DVV>(q, k, v, o, B, H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs, sl2, s);
  switch (D) {
    CPD_SM90_CASE(8)
    CPD_SM90_CASE(16)
    CPD_SM90_CASE(24)
    CPD_SM90_CASE(32)
    CPD_SM90_CASE(40)
    CPD_SM90_CASE(48)
    CPD_SM90_CASE(56)
    CPD_SM90_CASE(64)
    CPD_SM90_CASE(72)
    CPD_SM90_CASE(80)
    CPD_SM90_CASE(88)
    CPD_SM90_CASE(96)
    CPD_SM90_CASE(120)
    CPD_SM90_CASE(128)
    CPD_SM90_CASE(152)
    CPD_SM90_CASE(160)
    CPD_SM90_CASE(248)
    CPD_SM90_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CPD_SM90_CASE
}
