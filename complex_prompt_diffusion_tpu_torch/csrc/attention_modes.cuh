// The modes of the attention loops that the probe K7 (probe_attention*.cu)
// instantiates with pieces of the work removed, and sink(), which keeps an
// ablated mode's work alive. Shared by K1's Hopper loop (attention_sm90.cuh),
// K5's (attention_cm_sm90.cuh), the fused 3xTF32 body
// (attention_f32_fused.cuh) and the mma.sync / FMA loops they replaced
// (attention_bf16.cuh, attention_f32.cuh, attention_cm_bf16.cuh).
//
// nvcc deletes an MMA or an exp whose result is never used, and an empty
// asm statement emits no PTX instruction that would use it, so an ablated
// mode hands what it computed to sink(): a store behind a branch on a
// pointer the compiler cannot see through (null at every launch).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode : int {
  kFull = 0,    // out = softmax(scale * Q K^T) V
  kScores = 1,  // S = Q K^T only; out = sc * S[:, key 0] on every column
  kMax = 2,     // + the running row max; out = m, the final max of sc * S
  kExp = 3,     // + P = exp(sc * S - m) rounded to bf16; out = P[:, key 0] for the final m
  kPv = 4,      // P V only, with P[q, key] = Q[q, 0]; out = Q[:, 0] * sum_keys V
  kRowsum = 5,  // scores, max, exp and the row sum l; out = l
  kLoads = 6,   // the Q, K and V tiles only, no arithmetic; out = Q[:, 0] on every column
};

enum Denom : int { kSumRows = 0, kOnesColumn = 1 };

// Hand values an ablated mode computed but does not output to a store the
// compiler must keep (p is null at every launch; the asm makes it opaque at
// each call, so the test cannot be hoisted out of the KV loop).
template <typename T, int N>
__device__ __forceinline__ void sink(const T (&a)[N][4], float* p) {
  asm volatile("" : "+l"(p));
  if (p != nullptr) {
    T* d = reinterpret_cast<T*>(p) + (long long)threadIdx.x * N * 4;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i * 4 + e] = a[i][e];
  }
}

template <typename T, int N>
__device__ __forceinline__ void sink(const T (&a)[N], float* p) {
  asm volatile("" : "+l"(p));
  if (p != nullptr) {
    T* d = reinterpret_cast<T*>(p) + (long long)threadIdx.x * N;
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = a[i];
  }
}

}  // namespace
