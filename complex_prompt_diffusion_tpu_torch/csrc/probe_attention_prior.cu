// K7's replaced loops: the attention probe as it ran before it moved onto
// the Hopper loops (probe_attention.cu). K1's and K5's mma.sync loops and
// K1's f32 FMA loop (attention_bf16.cuh, attention_cm_bf16.cuh,
// attention_f32.cuh) with pieces of the work removed or one design choice
// changed, kept built as ops.probes.attention.attention_probe_prior and
// attention_dmajor_scores_prior so that tools/probe_attention.py times them
// beside each probe row; no wrapper falls back to them.
//
// The modes and flags, against the TPU probe scripts (scripts/perf_attn8.py
// .. perf_attn12.py):
//   * perf_attn8.py:88 flash_t: the KV-tile width of K1's loop, 64 keys or
//     128 keys;
//   * perf_attn9.py:81 onepass V1/V2/V3: `denom` and `use_exp2`;
//   * perf_attn10.py:84 run_mode A-G: modes kScores (A), kMax (B), kExp (C),
//     kFull (D), kPv (E) and kRowsum (G) of K1's bf16 loop, and kScores of
//     K1's f32 loop (F);
//   * perf_attn11.py:92 h2: the ones column and the unnormalized output,
//     d padded to D + 8;
//   * perf_attn12.py:51/105 (the QK-only forms of v3 and h1): kScores of K5's
//     loop, d-major or canonical K;
//   * kLoads streams the tiles and computes nothing.
//
// A ones column is free only where d leaves a pad column: at d = 40 the PV
// product already spans DP = 48, and column 40 carries the ones; at d = 80
// or 160 (DP = d) it adds one 8-wide n-tile of PV products, 11 / 10 and
// 21 / 20 of them.

#include "attention_bf16.cuh"
#include "attention_cm_bf16.cuh"
#include "attention_f32.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
int probe_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
               int Skv, int D, long long qbs, long long qrs, long long kbs, long long krs,
               long long vbs, long long vrs, float scale, int mode, int denom, int use_exp2,
               int unnormalized, int kv_tile, cudaStream_t s) {
  // the PV width with a ones column at D = DV1 - 8 (d = 40, 80, 160)
  constexpr int DV1 = DP == 48 ? 48 : DP + 8;
  const float sl2 = scale * kLog2e;
#define CPD_PROBE_ARGS q, k, v, o, B, H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs
  if (mode != kFull) {
    if (denom != kSumRows || !use_exp2 || unnormalized || kv_tile != 64)
      return (int)cudaErrorInvalidValue;
    switch (mode) {
      case kScores:
        return launch_bf16_body<DP, DP, 64, kScores, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
      case kMax:
        return launch_bf16_body<DP, DP, 64, kMax, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
      case kExp:
        return launch_bf16_body<DP, DP, 64, kExp, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
      case kPv:
        return launch_bf16_body<DP, DP, 64, kPv, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
      case kRowsum:
        return launch_bf16_body<DP, DP, 64, kRowsum, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
      case kLoads:
        return launch_bf16_body<DP, DP, 64, kLoads, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (kv_tile == 128) {
    if (denom != kSumRows || !use_exp2 || unnormalized) return (int)cudaErrorInvalidValue;
    return launch_bf16_body<DP, DP, 128, kFull, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
  }
  if (kv_tile != 64) return (int)cudaErrorInvalidValue;
  if (denom == kOnesColumn) {
    if (D + 8 != DV1) return (int)cudaErrorInvalidValue;
    if (unnormalized)
      return use_exp2 ? launch_bf16_body<DP, DV1, 64, kFull, kOnesColumn, true, true>(
                            CPD_PROBE_ARGS, sl2, s)
                      : (int)cudaErrorInvalidValue;
    return use_exp2 ? launch_bf16_body<DP, DV1, 64, kFull, kOnesColumn, true, false>(
                          CPD_PROBE_ARGS, sl2, s)
                    : launch_bf16_body<DP, DV1, 64, kFull, kOnesColumn, false, false>(
                          CPD_PROBE_ARGS, scale, s);
  }
  if (denom != kSumRows || unnormalized) return (int)cudaErrorInvalidValue;
  return use_exp2
             ? launch_bf16_body<DP, DP, 64, kFull, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s)
             : launch_bf16_body<DP, DP, 64, kFull, kSumRows, false, false>(CPD_PROBE_ARGS, scale,
                                                                            s);
#undef CPD_PROBE_ARGS
}

}  // namespace

// K1's layout: q [B, Sq, H*D], k and v [B, Skv, H*D] (row strides qrs, krs,
// vrs, batch strides qbs, kbs, vbs, unit column stride). The output is a
// fresh [B, Sq, H*D] bf16, or with `unnormalized` a [B, H, Sq, D + 8] f32.
// mode: Mode of attention_bf16.cuh; denom: 0 row sums, 1 ones column;
// kv_tile: 64 or 128 keys. Head dims padded to 48, 80 or 160 (d = 40 ..
// 160 of the UNet); any other combination returns cudaErrorInvalidValue.
extern "C" int cpd_probe_attention_prior_bf16(const void* q, const void* k, const void* v, void* o,
                                        int B, int H, int Sq, int Skv, int D, long long qbs,
                                        long long qrs, long long kbs, long long krs,
                                        long long vbs, long long vrs, float scale, int mode,
                                        int denom, int use_exp2, int unnormalized, int kv_tile,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return (int)cudaErrorInvalidValue;
  switch ((D + 15) / 16 * 16) {
    case 48:
      return probe_bf16<48>(q, k, v, o, B, H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs, scale,
                            mode, denom, use_exp2, unnormalized, kv_tile, s);
    case 80:
      return probe_bf16<80>(q, k, v, o, B, H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs, scale,
                            mode, denom, use_exp2, unnormalized, kv_tile, s);
    case 160:
      return probe_bf16<160>(q, k, v, o, B, H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs, scale,
                             mode, denom, use_exp2, unnormalized, kv_tile, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K1's f32 loop, the scores mode only (the layout of cpd_attention_f32)
extern "C" int cpd_probe_attention_prior_f32(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int Sq, int Skv, int D, long long qbs,
                                       long long qrs, long long kbs, long long krs,
                                       long long vbs, long long vrs, float scale, int mode,
                                       void* stream) {
  if (mode != kScores || B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_f32_body<kScores>(q, k, v, o, B, H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs,
                                  scale * kLog2e, static_cast<cudaStream_t>(stream));
}

// K5's bf16 loop, the scores mode only (the operands and strides of
// cpd_attention_cm_bf16)
extern "C" int cpd_probe_attention_prior_cm_bf16(const void* q, const void* k, const void* v, void* o,
                                           int B, int H, int Sq, int Skv, int D, long long q_sb,
                                           long long q_sh, long long q_sd, long long k_sb,
                                           long long k_sh, long long k_sx, long long v_sb,
                                           long long v_sh, long long v_sd, long long o_sb,
                                           long long o_sh, long long o_sd, int k_canonical,
                                           float scale, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode != kScores || D % 8 != 0 || Sq % 8 != 0 || Skv % 8 != 0 || B <= 0 || H <= 0 ||
      Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  const cm::Strides qs{q_sb, q_sh, q_sd}, ks{k_sb, k_sh, k_sx}, vs{v_sb, v_sh, v_sd},
      os{o_sb, o_sh, o_sd};
#define CPD_PROBE_CM_CASE(DPV)                                                                 \
  case DPV:                                                                                    \
    return k_canonical                                                                         \
               ? cm::launch_bf16<DPV, true, kScores>(q, k, v, o, B, H, Sq, Skv, D, qs, ks, vs, \
                                                     os, scale, s)                             \
               : cm::launch_bf16<DPV, false, kScores>(q, k, v, o, B, H, Sq, Skv, D, qs, ks,    \
                                                      vs, os, scale, s);
  switch ((D + 15) / 16 * 16) {
    CPD_PROBE_CM_CASE(48)
    CPD_PROBE_CM_CASE(80)
    CPD_PROBE_CM_CASE(160)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CPD_PROBE_CM_CASE
}
