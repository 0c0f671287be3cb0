// K7's instantiations of K1's Hopper loop (attention_sm90.cuh), one head
// dim a translation unit (probe_attention_w40.cu, _w80.cu, _w160.cu, built
// in parallel), reached from cpd_probe_attention_bf16 (probe_attention.cu).
//
// For head dim DV (the UNet's d = 40, 80, 160):
//   * every ablated mode (scores, max, exp, pv, rowsum, loads) at K1's own
//     choices: row sums, exp2, K1's key tile (128 keys at d <= 128, 64 at
//     d = 160);
//   * the full attention at K1's choices (K1's own instantiation), and with
//     64-key tiles where K1 takes 128 (perf_attn8's tile sweep; 128-key tiles
//     at d = 160 do not fit: Q's three boxes and two stages of 128-key K and
//     V tiles need 246,840 bytes of a block's 232,448);
//   * the full attention at K1's key tile with one flag changed: exp in
//     place of exp2 (perf_attn9 V1), the ones column with exp2 or exp (V3,
//     V2), the ones column with the unnormalized f32 output (perf_attn11 h2).
// Any other combination returns cudaErrorInvalidValue.
#pragma once

#include "attention_sm90.cuh"

namespace cpd_probe {

// cpd_probe_attention_bf16's arguments
struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, Sq, Skv, D;
  long long qbs, qrs, kbs, krs, vbs, vrs;
  float scale;
  int mode, denom, use_exp2, unnormalized, kv_tile;
};

int sm90_w40(const Args& a, cudaStream_t s);
int sm90_w80(const Args& a, cudaStream_t s);
int sm90_w160(const Args& a, cudaStream_t s);

}  // namespace cpd_probe

namespace {

template <int DV>
int probe_sm90(const cpd_probe::Args& a, cudaStream_t s) {
  using k1sm90::launch;
  constexpr int K1B = k1sm90::k1_bkv<DV>();
  const float sl2 = a.scale * 1.4426950408889634f;
  const bool k1_choices = a.denom == kSumRows && a.use_exp2 && !a.unnormalized;
  if (a.D != DV) return (int)cudaErrorInvalidValue;
#define CPD_PROBE_ARGS a.q, a.k, a.v, a.o, a.B, a.H, a.Sq, a.Skv, a.D, a.qbs, a.qrs, a.kbs, \
                       a.krs, a.vbs, a.vrs
  if (a.mode != kFull) {
    if (!k1_choices || a.kv_tile != K1B) return (int)cudaErrorInvalidValue;
    switch (a.mode) {
      case kScores:
        return launch<DV, K1B, kScores, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
      case kMax:
        return launch<DV, K1B, kMax, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
      case kExp:
        return launch<DV, K1B, kExp, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
      case kPv:
        return launch<DV, K1B, kPv, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
      case kRowsum:
        return launch<DV, K1B, kRowsum, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
      case kLoads:
        return launch<DV, K1B, kLoads, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (a.kv_tile != K1B) {  // the other tile width, at K1's other choices
    if constexpr (K1B == 128) {
      if (k1_choices && a.kv_tile == 64)
        return launch<DV, 64, kFull, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (k1_choices) return launch<DV, K1B, kFull, kSumRows, true, false>(CPD_PROBE_ARGS, sl2, s);
  if (a.denom == kOnesColumn) {
    if (a.unnormalized)
      return a.use_exp2
                 ? launch<DV, K1B, kFull, kOnesColumn, true, true>(CPD_PROBE_ARGS, sl2, s)
                 : (int)cudaErrorInvalidValue;
    return a.use_exp2
               ? launch<DV, K1B, kFull, kOnesColumn, true, false>(CPD_PROBE_ARGS, sl2, s)
               : launch<DV, K1B, kFull, kOnesColumn, false, false>(CPD_PROBE_ARGS, a.scale, s);
  }
  if (a.denom != kSumRows || a.unnormalized) return (int)cudaErrorInvalidValue;
  return launch<DV, K1B, kFull, kSumRows, false, false>(CPD_PROBE_ARGS, a.scale, s);  // exp
#undef CPD_PROBE_ARGS
}

}  // namespace
