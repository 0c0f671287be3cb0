// K1's 3xTF32 passes (attention_f32_sm90.cu), shared with K5's f32 head
// dims above its fused range (attention_cm_f32_sm90.cu): the workspace
// layout and the scores, softmax and output kernels over split operands.
#pragma once

#include <cuda_runtime.h>

namespace cpd {

// the parts of a workspace (f32x3_workspace) and its size in floats
struct F32x3Ws {
  float *qh, *ql, *kh, *kl, *vh, *vl, *sc, *pl, *il;
  long long floats;
};

F32x3Ws f32x3_workspace(void* ws, int B, int H, int Sq, int Skv, int D, int rows);

int f32x3_passes(const F32x3Ws& w, void* o, int B, int H, int Sq, int Skv, int D, float scale,
                 int rows, int dmajor, long long osb, long long osh, long long osd,
                 int* launched, cudaStream_t st);

}  // namespace cpd
