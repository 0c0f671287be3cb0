// K1 on Hopper, f32 with head dim d <= 160: exact-f32 softmax attention,
// out = softmax(scale * Q K^T) V, over the [B, S, H*D] layout, on the TF32
// tensor cores with three products per product ("3xTF32"), in one fused
// kernel.
//
// Replaces the TPU kernels complex_prompt_diffusion_tpu/ops/attention.py::
// _attn_kernel and ::_onepass_kernel for f32 with d <= 160 (an f32 UNet's
// self-attention: d = 40 / 80 / 160 at S = 4096 / 1024 / 256). The body it
// replaced, attention.cu's FMA body (attention_f32.cuh: exact f32 on
// CUDA-core FFMAs, Q^T and K and V chunks staged by plain loads), stays
// built as ops.attention.attention_f32_fma. Rounding as the plain twin: f32
// scores, an exp2 softmax on scores scaled by scale * log2 e, P V on f32 P,
// one division by the row sum.
//
// What bounds it on the H100: 4 B H Sq Skv d flops over 4 B (Sq + Skv) H*D
// floats, so the arithmetic at the UNet's shapes. The FMA body ran at 24% of
// the FMA units' 67 TFLOP/s, slower than its plain twin (cuBLAS in full
// f32; H100 80GB HBM3 at 700 W, PERF.md section 6), held back by that roof
// and by its shared-memory transposes. Here the products run as three TF32
// products (165 TFLOP/s of f32 work) in the fused body that K5's f32 head
// dims run (attention_f32_fused.cuh, whose
// header sets out the design), in its kRows layout: rank-4 TMA maps
// (D, S, H, B) over q, k and v at any batch and row stride; Q and K split
// into K-major hi and lo tiles as they lie; V transposed to [d][keys] while
// it is split (TF32 wgmma takes K-major operands only); the [q][d]
// accumulator written from registers with 16-byte stores. Tiles as K5's
// (CfgF): d <= 80: 128 queries, 64-key tiles; d <= 128: 128 queries, 32
// keys; d <= 160: 64 queries, 32 keys. Above 160 no fused block fits 227 KB:
// those head dims take the unfused kernels of attention_f32_sm90.cu
// (ops/attention.py: k1_body).

#include "attention_f32_fused.cuh"

namespace {

template <int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Skv,
           int D, long long qbs, long long qrs, long long kbs, long long krs, long long vbs,
           long long vrs, float scale, cudaStream_t stream) {
  CUtensorMap maps[3];
  const int err =
      f32x3::encode_rows<DV>(maps, q, k, v, B, H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs);
  if (err) return err;
  const long long ors = (long long)H * D;
  return f32x3::launch_kernel<DV, f32x3::kRows, kFull>(
      maps, static_cast<float*>(o), f32x3::OStrides{(long long)Sq * ors, D, ors}, B, H, Sq, Skv,
      D, scale * 1.4426950408889634f, stream);
}

}  // namespace

// q [B, Sq, H*D], k and v [B, Skv, H*D] f32 with unit column stride, batch
// and row strides in elements (multiples of 4, 16-byte aligned bases); o a
// fresh contiguous [B, Sq, H*D]. D % 4 == 0 and D <= 160; any Sq and Skv.
extern "C" int cpd_attention_f32_fused_sm90(const void* q, const void* k, const void* v,
                                            void* o, int B, int H, int Sq, int Skv, int D,
                                            long long qbs, long long qrs, long long kbs,
                                            long long krs, long long vbs, long long vrs,
                                            float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CPD_F32X3_CASE(W) \
  case W:                 \
    return launch<W>(q, k, v, o, B, H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs, scale, s);
  switch (f32x3::width_of(D)) {
    CPD_F32X3_CASE(16)
    CPD_F32X3_CASE(32)
    CPD_F32X3_CASE(40)
    CPD_F32X3_CASE(48)
    CPD_F32X3_CASE(64)
    CPD_F32X3_CASE(80)
    CPD_F32X3_CASE(96)
    CPD_F32X3_CASE(128)
    CPD_F32X3_CASE(160)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CPD_F32X3_CASE
}

// out[0..3]: query rows a block, keys a tile, 1 (one split and one landed
// tile), shared-memory bytes of the fused block for head dim D
extern "C" int cpd_attention_f32_fused_sm90_config(int D, int* out) {
  const int dv = f32x3::width_of(D);
  if (!dv) return (int)cudaErrorInvalidValue;
  f32x3::config_of(dv, out);
  return 0;
}
