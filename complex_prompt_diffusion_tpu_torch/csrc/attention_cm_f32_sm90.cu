// K5 on Hopper, f32: exact-f32 softmax attention, out = softmax(scale *
// Q K^T) V, over operands whose SEQUENCE axis is the contiguous one, on the
// TF32 tensor cores with three products per product ("3xTF32").
//
// Replaces the TPU kernels complex_prompt_diffusion_tpu/ops/attention.py::
// _onepass_kernel_hdbs and ::_onepass_kernel_kcanon for f32 (an f32 UNet
// under attn_route="cm" or the kcanon route). The body it replaced
// (attention_cm.cu: CUDA-core FMAs, 64 x 64 tiles) stays built as
// ops.attention.attention_dmajor_prior. Rounding as the plain twin: f32
// scores, an exp2 softmax on scores scaled by scale * log2 e, P V on f32 P,
// one division by the row sum.
//
// What bounds it on the H100: 4 B H Sq Skv d flops. Exact f32 rules out one
// TF32 product (about 1e-3 relative); the FMA units give 67 TFLOP/s, and
// the replaced body ran 1.5-2.3x slower than SDPA. Here, as in K1's 3xTF32
// body (attention_f32_sm90.cu), each operand x is split into hi = tf32(x)
// and lo = tf32(x - hi), and a product a b is a_lo b_hi + a_hi b_lo + a_hi
// b_hi with f32 accumulation: three TF32 products, at 495 / 3 TFLOP/s.
//
// TF32 wgmma takes K-major operands only, so the d-major tiles cannot be
// read as they lie (the bf16 body, attention_cm_sm90.cu, reads them so).
// Head dims up to 160 run the fused body of attention_f32_fused.cuh (whose
// header sets out the design; K1's f32 rows share it) in its kDmajorK
// (hdbs) and kCanonK (kcanon) layouts: Q and a d-major K transposed to
// K-major hi and lo tiles, a canonical K and the d-major V split as they
// lie, the [q][d] accumulator staged transposed and written along S. Above
// 160 no fused block fits 227 KB, and the head dim takes the unfused
// 3xTF32 kernels of attention_f32_sm90.cu: a split of K5's strided layouts
// into their K-major hi and lo buffers (three kernels here), then their
// scores, softmax and output kernels, the output written d-major.

#include "attention_f32_fused.cuh"
#include "attention_f32x3.cuh"

namespace {

using f32x3::CfgF;
using f32x3::FUSED_MAX_D;
using f32x3::width_of;

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, Sq, Skv, D;
  long long q_sb, q_sh, q_sd, k_sb, k_sh, k_sx, v_sb, v_sh, v_sd, o_sb, o_sh, o_sd;
  float scale;
};

template <int DV, bool KCANON>
int launch(const Args& a, cudaStream_t stream) {
  typedef CfgF<DV> C;
  CUtensorMap maps[3];
  int err = f32x3::encode(&maps[0], a.q, a.Sq, a.D, a.H, a.B, a.q_sd, a.q_sh, a.q_sb, C::BQ, DV);
  if (!err)
    err = KCANON ? f32x3::encode(&maps[1], a.k, a.D, a.Skv, a.H, a.B, a.k_sx, a.k_sh, a.k_sb,
                                 DV, C::BKV)
                 : f32x3::encode(&maps[1], a.k, a.Skv, a.D, a.H, a.B, a.k_sx, a.k_sh, a.k_sb,
                                 C::BKV, DV);
  if (!err)
    err = f32x3::encode(&maps[2], a.v, a.Skv, a.D, a.H, a.B, a.v_sd, a.v_sh, a.v_sb, C::BKV, DV);
  if (err) return err;
  return f32x3::launch_kernel<DV, KCANON ? f32x3::kCanonK : f32x3::kDmajorK, kFull>(
      maps, static_cast<float*>(a.o), f32x3::OStrides{a.o_sb, a.o_sh, a.o_sd}, a.B, a.H, a.Sq,
      a.Skv, a.D, a.scale * 1.4426950408889634f, stream);
}

template <bool KCANON>
int dispatch(const Args& a, cudaStream_t s) {
  switch (width_of(a.D)) {
    case 16: return launch<16, KCANON>(a, s);
    case 32: return launch<32, KCANON>(a, s);
    case 40: return launch<40, KCANON>(a, s);
    case 48: return launch<48, KCANON>(a, s);
    case 64: return launch<64, KCANON>(a, s);
    case 80: return launch<80, KCANON>(a, s);
    case 96: return launch<96, KCANON>(a, s);
    case 128: return launch<128, KCANON>(a, s);
    case 160: return launch<160, KCANON>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- the unfused route (FUSED_MAX_D < d <= 256) ----

// hi and lo of a strided operand, rows r and columns c of each (b, h) as the
// contiguous [B*H, R, Cp] (columns from C on zero): element (r, c) at
// b sb + h sh + r sr + c sc, with sr == 1 (r_unit) or sc == 1; 32 x 32
// tiles through shared memory, read along the unit stride
__global__ void attention_cm_split_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                          float* __restrict__ lo, int H, int R, int C, int Cp,
                                          long long sb, long long sh, long long sr, long long sc,
                                          int r_unit) {
  __shared__ float tile[32][33];
  const int z = blockIdx.z;
  const int b = z / H, h = z - (z / H) * H;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* base = x + b * sb + h * sh;
  for (int i = ty; i < 32; i += 8) {
    const int rr = r_unit ? tx : i, cc = r_unit ? i : tx;
    const int r = r0 + rr, c = c0 + cc;
    tile[rr][cc] = (r < R && c < C) ? base[r * sr + c * sc] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    if (r < R && c < Cp) {
      uint32_t a, l;
      f32x3::split(tile[i][tx], a, l);
      const long long idx = ((long long)z * R + r) * Cp + c;
      hi[idx] = __uint_as_float(a);
      lo[idx] = __uint_as_float(l);
    }
  }
}

}  // namespace

// q, v [B, H, D, S] and o [B, H, D, Sq] f32 views with unit stride along S;
// k the same, or with k_canonical a [B, H, Skv, D] view with unit stride
// along D. Strides in elements as cpd_attention_cm_sm90_bf16's, multiples of
// 4 with 16-byte aligned bases. D % 4 == 0, D <= 256; Sq % 4 == 0 and
// Skv % 4 == 0. D <= 160 launches the fused kernel (*launched = 1); above,
// ws (ws_floats floats: cpd::f32x3_workspace's) takes the
// split operands, S and P of `rows` query rows a pass, and *launched is
// 3 + 3 a pass.
extern "C" int cpd_attention_cm_f32_sm90(const void* q, const void* k, const void* v, void* o,
                                         void* ws, long long ws_floats, int B, int H, int Sq,
                                         int Skv, int D, long long q_sb, long long q_sh,
                                         long long q_sd, long long k_sb, long long k_sh,
                                         long long k_sx, long long v_sb, long long v_sh,
                                         long long v_sd, long long o_sb, long long o_sh,
                                         long long o_sd, int k_canonical, float scale, int rows,
                                         int* launched, void* stream) {
  *launched = 0;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 4 || D > 256 || Sq % 4 ||
      Skv % 4 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= FUSED_MAX_D) {
    const Args a{q, k, v, o, B, H, Sq, Skv, D, q_sb, q_sh, q_sd, k_sb, k_sh, k_sx,
                 v_sb, v_sh, v_sd, o_sb, o_sh, o_sd, scale};
    const int err = k_canonical ? dispatch<true>(a, s) : dispatch<false>(a, s);
    if (!err) *launched = 1;
    return err;
  }
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  rows = rows < Sq ? rows : Sq;
  const cpd::F32x3Ws w = cpd::f32x3_workspace(ws, B, H, Sq, Skv, D, rows);
  if (ws_floats < w.floats) return (int)cudaErrorInvalidValue;
  const long long Z = (long long)B * H, Sp = (Skv + 3) / 4 * 4;
  const dim3 tb(32, 8);
  auto grid = [&](long long r, long long c) {
    return dim3((unsigned)((c + 31) / 32), (unsigned)((r + 31) / 32), (unsigned)Z);
  };
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  // Q (queries x d, queries unit), K (keys x d: d-major, keys unit; or
  // canonical, d unit), V (d x keys, keys unit, padded to Sp)
  attention_cm_split_kernel<<<grid(Sq, D), tb, 0, s>>>(qf, w.qh, w.ql, H, Sq, D, D, q_sb,
                                                        q_sh, 1, q_sd, 1);
  if (k_canonical)
    attention_cm_split_kernel<<<grid(Skv, D), tb, 0, s>>>(kf, w.kh, w.kl, H, Skv, D, D, k_sb,
                                                           k_sh, k_sx, 1, 0);
  else
    attention_cm_split_kernel<<<grid(Skv, D), tb, 0, s>>>(kf, w.kh, w.kl, H, Skv, D, D, k_sb,
                                                           k_sh, 1, k_sx, 1);
  attention_cm_split_kernel<<<grid(D, Sp), tb, 0, s>>>(vf, w.vh, w.vl, H, D, Skv, (int)Sp,
                                                        v_sb, v_sh, v_sd, 1, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *launched += 3;
  int passes = 0;
  const int err = cpd::f32x3_passes(w, o, B, H, Sq, Skv, D, scale, rows, 1, o_sb, o_sh, o_sd,
                                    &passes, s);
  *launched += passes;
  return err;
}

// out[0..4]: query rows a block, keys a tile, stages, shared-memory bytes,
// and 1 for the fused kernel (0: the unfused kernels, no block config)
extern "C" int cpd_attention_cm_f32_sm90_config(int D, int k_canonical, int* out) {
  (void)k_canonical;  // the canonical K tile takes the d-major one's space
  if (D <= 0 || D % 4 || D > 256) return (int)cudaErrorInvalidValue;
  const int dv = width_of(D);
  out[0] = out[1] = out[2] = out[3] = out[4] = 0;
  if (dv) {
    f32x3::config_of(dv, out);
    out[4] = 1;
  }
  return 0;
}
