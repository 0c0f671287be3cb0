// The f32 body of K1 (csrc/attention.cu): exact-f32 attention on CUDA-core
// FMAs (no TF32), tiled like an SGEMM. 256 threads, 64 query rows x 64 keys
// per tile; each thread computes a 4x4 block of S from float4 reads of Q^T
// and K^T (16 FMAs per two shared-memory loads) and keeps 4 rows x 32
// columns of O in registers (d <= 512). Q^T stays in shared memory for the
// block's life; K and V are staged in head-dim slices.
//
// MODE kFull is K1's attention (attention.cu); MODE kScores (the probe
// kernel K7, csrc/probe_attention.cu) keeps only S = Q K^T on f32 operands
// (the K staging and the FMAs), hands every score tile to sink(), and writes
// sc * S[:, key 0] on every column. Mode and sink() as in attention_bf16.cuh.
#pragma once

#include "attention_bf16.cuh"

namespace {

constexpr int kFB = 64;           // f32 kernel: query rows and keys per tile
constexpr int kFThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kFMaxD = 512;
constexpr int kFDChunk = 32;      // head-dim slice of K staged per step
constexpr int kFVChunk = 128;     // head-dim slice of V staged per step
constexpr int kFCol = kFMaxD / 64;  // 64-column slices of O per thread
constexpr int kFLdP = kFB + 4;      // padded rows of the transposed P tile
constexpr int kFLdV = kFVChunk + 4;

// Shared memory (floats): Q^T [D][kFB], K^T chunk [kFDChunk][kFB],
// P^T [kFB][kFLdP], V chunk [kFB][kFLdV].
__host__ __device__ constexpr int f32_smem_floats(int D) {
  return D * kFB + kFDChunk * kFB + kFB * kFLdP + kFB * kFLdV;
}

template <int MODE>
__global__ void __launch_bounds__(kFThreads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H, int Sq,
                     int Skv, int D, long long qbs, long long qrs, long long kbs,
                     long long krs, long long vbs, long long vrs, float scale_log2,
                     float* sink_ptr) {
  static_assert(MODE == kFull || MODE == kScores, "the f32 body has the full and scores modes");
  extern __shared__ __align__(16) float fsm[];
  float* sQt = fsm;                     // [D][kFB]: Q transposed
  float* sKt = sQt + D * kFB;           // [kFDChunk][kFB]: K chunk transposed
  float* sPt = sKt + kFDChunk * kFB;    // [kFB keys][kFLdP]: P transposed
  float* sV = sPt + kFB * kFLdP;        // [kFB keys][kFLdV]: V chunk

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kFB;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx*4.. of S, and of each 64-wide O slice
  const int ty = tid >> 4;  // rows ty*4..ty*4+3
  const float* qb = q + b * qbs + (long long)h * D;
  const float* kb = k + b * kbs + (long long)h * D;
  const float* vb = v + b * vbs + (long long)h * D;
  const int d4 = D / 4;

  // Q tile, transposed so that one float4 holds 4 query rows of one dim
  // (consecutive threads take consecutive rows: conflict-free stores)
  for (int idx = tid; idx < kFB * d4; idx += kFThreads) {
    const int r = idx % kFB;
    const int c = (idx / kFB) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) val = *reinterpret_cast<const float4*>(qb + (long long)(q0 + r) * qrs + c);
    sQt[(c + 0) * kFB + r] = val.x;
    sQt[(c + 1) * kFB + r] = val.y;
    sQt[(c + 2) * kFB + r] = val.z;
    sQt[(c + 3) * kFB + r] = val.w;
  }

  float acc[4][kFCol][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int kk = 0; kk < kFCol; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][kk][j] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float key0[4] = {0.f, 0.f, 0.f, 0.f};  // sc * S[row, key 0] (the scores mode)

  for (int kv0 = 0; kv0 < Skv; kv0 += kFB) {
    // S = Q K^T for this thread's 4 x 4 block, K staged kFDChunk dims at a time
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kFDChunk) {
      __syncthreads();  // previous readers of sKt are done (and sQt is complete)
      for (int idx = tid; idx < kFB * (kFDChunk / 4); idx += kFThreads) {
        const int r = idx % kFB;
        const int c = (idx / kFB) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kv0 + r < Skv && d0 + c < D)
          val = *reinterpret_cast<const float4*>(kb + (long long)(kv0 + r) * krs + d0 + c);
        sKt[(c + 0) * kFB + r] = val.x;
        sKt[(c + 1) * kFB + r] = val.y;
        sKt[(c + 2) * kFB + r] = val.z;
        sKt[(c + 3) * kFB + r] = val.w;
      }
      __syncthreads();
      const int dn = min(kFDChunk, D - d0);
      for (int dd = 0; dd < dn; ++dd) {
        const float4 qa = *reinterpret_cast<const float4*>(sQt + (d0 + dd) * kFB + ty * 4);
        const float4 ka = *reinterpret_cast<const float4*>(sKt + dd * kFB + tx * 4);
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
        const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
      }
    }

    if constexpr (MODE == kScores) {
      if (kv0 == 0) {  // key 0: column 0 of the tile, held by tx == 0
#pragma unroll
        for (int i = 0; i < 4; ++i) key0[i] = s[i][0] * scale_log2;
      }
      sink(s, sink_ptr);
      continue;
    }

    // online softmax; the 16 threads of a row group are lanes xor 1..8
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = kv0 + tx * 4 + j < Skv ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      alpha[i] = exp2f(m[i] - mx);
      m[i] = mx;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - mx);
        ps += s[i][j];
      }
      l[i] = l[i] * alpha[i] + ps;
#pragma unroll
      for (int kk = 0; kk < kFCol; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][kk][j] *= alpha[i];
    }
    // P^T to shared memory: one float4 holds 4 query rows of one key
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sPt + (tx * 4 + j) * kFLdP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    // O += P V, V staged kFVChunk dims at a time
#pragma unroll
    for (int vc = 0; vc < kFMaxD; vc += kFVChunk) {
      if (vc < D) {
        __syncthreads();  // sPt written; previous readers of sV are done
        for (int idx = tid; idx < kFB * (kFVChunk / 4); idx += kFThreads) {
          const int r = idx / (kFVChunk / 4);
          const int c = (idx - r * (kFVChunk / 4)) * 4;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (kv0 + r < Skv && vc + c < D)
            val = *reinterpret_cast<const float4*>(vb + (long long)(kv0 + r) * vrs + vc + c);
          *reinterpret_cast<float4*>(sV + r * kFLdV + c) = val;
        }
        __syncthreads();
        for (int key = 0; key < kFB; ++key) {
          const float4 pa = *reinterpret_cast<const float4*>(sPt + key * kFLdP + ty * 4);
          const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
          for (int k2 = 0; k2 < kFVChunk / 64; ++k2) {
            const float4 va = *reinterpret_cast<const float4*>(sV + key * kFLdV + k2 * 64 + tx * 4);
            const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][vc / 64 + k2][j] += pv[i] * vv[j];
          }
        }
      }
    }
  }

  if constexpr (MODE == kScores) {
    // sc * S[row, key 0] from the row group's tx == 0 lane, on every column
    const int lane0 = (tid & 31) & ~15;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float w = __shfl_sync(0xffffffffu, key0[i], lane0);
      const int row = q0 + ty * 4 + i;
      if (row >= Sq) continue;
      float* orow = o + (long long)b * Sq * H * D + (long long)row * H * D + (long long)h * D;
      for (int col = tx * 4; col < D; col += 64)
        *reinterpret_cast<float4*>(orow + col) = make_float4(w, w, w, w);
    }
    return;
  }

  // out = O / l, l summed over the row group
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float inv = 1.f / li;
    float* orow = o + (long long)b * Sq * H * D + (long long)row * H * D + (long long)h * D;
#pragma unroll
    for (int kk = 0; kk < kFCol; ++kk) {
      const int col = kk * 64 + tx * 4;
      if (col < D)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][kk][0] * inv, acc[i][kk][1] * inv, acc[i][kk][2] * inv,
                        acc[i][kk][3] * inv);
    }
  }
}

template <int MODE>
int launch_f32_body(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                    int Skv, int D, long long qbs, long long qrs, long long kbs, long long krs,
                    long long vbs, long long vrs, float scale_log2, cudaStream_t stream) {
  if (D > kFMaxD || D % 4 != 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * f32_smem_floats(D);
  auto kernel = attention_f32_kernel<MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kFB - 1) / kFB, B * H);
  kernel<<<grid, kFThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Sq, Skv, D, qbs, qrs, kbs, krs, vbs, vrs, scale_log2, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace
