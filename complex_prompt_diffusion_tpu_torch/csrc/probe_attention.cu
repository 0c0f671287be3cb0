// K7: the attention probe. K1's and K5's Hopper loops (attention_sm90.cuh,
// attention_cm_sm90.cuh) and the fused 3xTF32 body (attention_f32_fused.cuh)
// with pieces of the work removed or one design choice changed, to find
// where the time of the loops the renders run goes on the H100.
//
// Replaces the TPU probe kernels of scripts/perf_attn8.py .. perf_attn12.py
// (each a pl.pallas_call the TPU kernels were tuned with):
//   * perf_attn8.py:88 flash_t (online softmax on [BH, D, S], a (bq, bk)
//     sweep): the key-tile width of K1's loop, K1's own (128 keys at
//     d <= 128, 64 at d = 160) or 64 keys where K1 takes 128;
//   * perf_attn9.py:81 onepass V1/V2/V3 (denominator from a sum pass or a
//     ones row in V; exp or exp2): `denom` and `use_exp2` on K1's loop. A
//     whole KV row resident in shared memory cannot exist here (K + V at
//     S = 4096, d = 48 is 786 KB against 227 KB), so the loop stays online;
//   * perf_attn10.py:84 run_mode A-G: modes kScores (A), kMax (B), kExp (C),
//     kFull (D), kPv (E) and kRowsum (G) of K1's bf16 loop, and kScores of
//     K1's fused f32 body (F: scores on f32 operands, three TF32 products);
//   * perf_attn11.py:92 h2 (all S-major, a ones column in V, the output
//     unnormalized f32 with l in column d): the ones column and the
//     unnormalized output on K1's layout, d padded to D + 8 (not to the TPU
//     MXU's 128);
//   * perf_attn12.py:51/105 (the QK-only forms of v3 and h1): kScores of K5's
//     loop, d-major or canonical K.
// One mode more than the scripts: kLoads streams the tiles and computes
// nothing, the floor under every other mode.
// (perf_attn11.py:56 h1 and the full v3/h1 forms are K5 itself.)
//
// What bounds it: the attention's own bound (compute, 4 B H Sq Skv D flops
// over 2 B H (Sq + Skv) D elements at the UNet shapes); the score-only
// modes do half the products. Every mode streams Q, K and V through K1's
// producer ring as the attention does and keeps its work alive with sink()
// (attention_modes.cuh), so its time is what its steps cost in K1's loop.
//
// The ones column: TMA zero-fills a V tile's columns d .. 64 * ceil(d / 64)
// - 1, and each consumer warpgroup writes 1.0 into column d of every landed
// V tile, fenced to the async proxy before the wgmma that reads it; the PV
// width grows by 8 (n48 at d = 40, n88 at 80, n168 at 160).
//
// The replaced loops (K1's and K5's mma.sync loops, K1's f32 FMA loop) stay
// built in probe_attention_prior.cu.

#include "attention_cm_sm90.cuh"
#include "attention_f32_fused.cuh"
#include "probe_attention_sm90.cuh"

// K1's layout: q [B, Sq, H*D], k and v [B, Skv, H*D] (row strides qrs, krs,
// vrs, batch strides qbs, kbs, vbs, multiples of 8; unit column stride;
// 16-byte aligned bases). The output is a fresh [B, Sq, H*D] bf16, or with
// `unnormalized` a [B, H, Sq, D + 8] f32. mode: enum Mode; denom: 0 row
// sums, 1 ones column; kv_tile: K1's tile (128 keys at d <= 128, 64 at
// d = 160), or 64 for the full mode at K1's other choices. Head dims 40, 80
// and 160 (the UNet's); any other combination returns
// cudaErrorInvalidValue (probe_attention_sm90.cuh lists the combinations).
extern "C" int cpd_probe_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                        int B, int H, int Sq, int Skv, int D, long long qbs,
                                        long long qrs, long long kbs, long long krs,
                                        long long vbs, long long vrs, float scale, int mode,
                                        int denom, int use_exp2, int unnormalized, int kv_tile,
                                        void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const cpd_probe::Args a{q,   k,   v,   o,   B,     H,    Sq,       Skv,  D,
                          qbs, qrs, kbs, krs, vbs,   vrs,  scale,    mode, denom,
                          use_exp2, unnormalized, kv_tile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return cpd_probe::sm90_w40(a, s);
    case 80: return cpd_probe::sm90_w80(a, s);
    case 160: return cpd_probe::sm90_w160(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

namespace {

template <int DV>
int probe_f32_scores(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                     int Skv, long long qbs, long long qrs, long long kbs, long long krs,
                     long long vbs, long long vrs, float scale, cudaStream_t s) {
  CUtensorMap maps[3];
  const int err =
      f32x3::encode_rows<DV>(maps, q, k, v, B, H, Sq, Skv, DV, qbs, qrs, kbs, krs, vbs, vrs);
  if (err) return err;
  const long long ors = (long long)H * DV;
  return f32x3::launch_kernel<DV, f32x3::kRows, kScores>(
      maps, static_cast<float*>(o), f32x3::OStrides{(long long)Sq * ors, DV, ors}, B, H, Sq,
      Skv, DV, scale * 1.4426950408889634f, s);
}

}  // namespace

// The fused f32 body's scores mode, on cpd_attention_f32_fused_sm90's
// operands (row and batch strides multiples of 4); the output a fresh
// [B, Sq, H*D] f32. Head dims 40, 80 and 160; mode kScores only.
extern "C" int cpd_probe_attention_f32(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int Sq, int Skv, int D, long long qbs,
                                       long long qrs, long long kbs, long long krs,
                                       long long vbs, long long vrs, float scale, int mode,
                                       void* stream) {
  if (mode != kScores || B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return probe_f32_scores<40>(q, k, v, o, B, H, Sq, Skv, qbs, qrs, kbs, krs, vbs, vrs, scale,
                                  s);
    case 80:
      return probe_f32_scores<80>(q, k, v, o, B, H, Sq, Skv, qbs, qrs, kbs, krs, vbs, vrs, scale,
                                  s);
    case 160:
      return probe_f32_scores<160>(q, k, v, o, B, H, Sq, Skv, qbs, qrs, kbs, krs, vbs, vrs,
                                   scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K5's bf16 Hopper loop, the scores mode only (the operands and strides of
// cpd_attention_cm_sm90_bf16; Sq % 8 == 0, Skv % 8 == 0); head dims 40, 80
// and 160.
extern "C" int cpd_probe_attention_cm_bf16(const void* q, const void* k, const void* v, void* o,
                                           int B, int H, int Sq, int Skv, int D, long long q_sb,
                                           long long q_sh, long long q_sd, long long k_sb,
                                           long long k_sh, long long k_sx, long long v_sb,
                                           long long v_sh, long long v_sd, long long o_sb,
                                           long long o_sh, long long o_sd, int k_canonical,
                                           float scale, int mode, void* stream) {
  if (mode != kScores || Sq % 8 != 0 || Skv % 8 != 0 || B <= 0 || H <= 0 || Sq <= 0 ||
      Skv <= 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const k5sm90::Args a{q,    k,    v,    o,    B,    H,    Sq,   Skv,  D,
                       q_sb, q_sh, q_sd, k_sb, k_sh, k_sx, v_sb, v_sh, v_sd,
                       o_sb, o_sh, o_sd, scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CPD_PROBE_CM_CASE(W)                                            \
  case W:                                                               \
    return k_canonical ? k5sm90::launch<W, true, kScores>(a, s)         \
                       : k5sm90::launch<W, false, kScores>(a, s);
  switch (D) {
    CPD_PROBE_CM_CASE(40)
    CPD_PROBE_CM_CASE(80)
    CPD_PROBE_CM_CASE(160)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CPD_PROBE_CM_CASE
}
