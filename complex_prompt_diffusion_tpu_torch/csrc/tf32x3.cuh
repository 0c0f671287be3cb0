// Exact-f32 products on the TF32 tensor cores ("3xTF32"), the pieces every
// 3xTF32 body shares: the split of an f32 operand into TF32 hi and lo parts,
// the K-major 128-byte-swizzled hi and lo tiles that wgmma reads, the
// "landed f32 tile -> hi and lo tiles" routines of the GEMM bodies (K2's f32
// GEGLU FF, geglu_ff_f32_sm90.cu; K4's f32 conv, conv3x3_f32_sm90.cu), their
// A fragments split in registers, the three products of a k-step (A from
// registers, or from shared memory: K6's f32 Winograd body,
// winograd_f32_sm90.cu, which also takes the split_mnmajor), and the fold
// rule. K1's and K5's fused attention body (attention_f32_fused.cuh)
// takes the split and the swizzled store from here, K1's unfused body
// (attention_f32_sm90.cu) the split.
//
// The arithmetic: x = hi + lo with hi = tf32(x) (round to nearest) and
// lo = tf32(x - hi); a product a b is a_lo b_hi + a_hi b_lo + a_hi b_hi,
// accumulated in f32 (the lo lo term, 2^-22 relative, is dropped): three
// TF32 products at 495 / 3 TFLOP/s on an H100, with the error of an f32
// product.
//
// The fold rule: the tensor cores' f32 accumulation does not round like an
// f32 add, and carried across a long reduction its error grows past the f32
// tolerance (K1's first 3xTF32 form: 4.6e-5 against 1e-5 at K = 4096). So a
// GEMM body keeps a fresh wgmma accumulator for each run of kFold k-steps
// (32 reduction elements each) and adds it into an f32 register sum with
// f32 adds when the run ends (fold_into). tools/fold_rule.py builds the
// package with other run lengths and measures them at the longest
// reductions of a UNet; see kFold for its readings.
// The GEMM bodies' pipeline (consume_unit): a producer thread lands raw f32
// tiles by TMA into a ring of stages, A K-major in the 128-byte swizzle
// ([rows][32 floats], 128-byte rows), B K-major the same way or MN-major
// ([32 k][N], no swizzle); two consumer warpgroups (64 rows of A each) then,
// per k-step:
//   1. split B's landed tile into hi and lo K-major swizzled tiles
//      (split_kmajor, or split_mnmajor, which transposes) in one of three
//      split buffers, their 256 threads sharing the work, and meet at a
//      named barrier;
//   2. load their A fragments from the landed tile and split them in
//      registers (load_a), for wgmma's register-A form, so A's hi and lo
//      tiles are never written: half the split traffic of shared memory;
//   3. issue the three products of each of the four 8-deep steps
//      (mma_kstep, wgmma m64nNk8 .tf32, A from registers, B K-major),
//      release the raw stage, and wait for all but this group (or, at the
//      end of a fold run, for all, then fold).
// Three split buffers: a thread that writes buffer it % 3 has passed the
// barrier of k-step it - 1, which every thread reaches only after its wait
// retired k-step it - 3, the last reader of that buffer. The A fragments of
// a k-step stay in registers until its group retires (wgmma reads them
// asynchronously), so consecutive k-steps use two sets in turns.
#pragma once

#include "sm90.cuh"

namespace cpd {
namespace tf32x3 {

constexpr int KB = 32;  // f32 elements of a 128-byte row: a K-major box's width

// k-steps a fresh wgmma accumulator takes before it is folded into the f32
// sum. tools/fold_rule.py reads, on an H100 80GB HBM3 at 700 W, the max
// relative error against the TF32-off twin, one unit over the whole K, for
// runs of 1, 2, 4 and 8 k-steps and one run of all of them: K4's 16^2
// 2560->1280 conv (K = 23040) 1.6, 1.4, 1.5, 2.3e-6 and 1.7e-4, in 1.246,
// 1.183, 1.140, 1.149 and 1.132 ms; K2 at M512 C1280 (its GEMM2 reduces over
// K = 5120) 1.5, 1.9, 3.0, 5.9e-6 and 5.2e-5. A run of 4 holds 1e-5 with 3x
// to spare at both and costs 1% over the longest run; 8 leaves K2 1.7x.
constexpr int kFold = 4;

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// hi and lo of 4 consecutive K-major elements (row r, columns 4 c4 ..) into
// 32-column boxes of `part` bytes, 128-byte rows, chunk c at c ^ (r % 8); the
// lo tile starts `lo_off` bytes after the hi tile
__device__ __forceinline__ void store_split(unsigned char* base, int part, int lo_off, int r,
                                            int c4, float4 x) {
  const int off = (c4 >> 3) * part + r * 128 + (((c4 & 7) ^ (r & 7)) << 4);
  uint4 hi, lo;
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(base + off) = hi;
  *reinterpret_cast<uint4*>(base + lo_off + off) = lo;
}

template <int N>
__device__ __forceinline__ void fence_pregs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// A landed K-major tile of ROWS rows (TMA, 128-byte swizzle: [ROWS][32]
// floats, 16-byte chunk c of row r at c ^ (r % 8)) -> its hi and lo tiles in
// the same layout: element by element, thread t of NT takes chunks t, t +
// NT, ..
template <int ROWS, int NT>
__device__ __forceinline__ void split_kmajor(const unsigned char* raw, unsigned char* hi,
                                             unsigned char* lo, int t) {
#pragma unroll
  for (int i = t; i < ROWS * 8; i += NT) {
    const float4 x = reinterpret_cast<const float4*>(raw)[i];
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    reinterpret_cast<uint4*>(hi)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// A landed MN-major tile (TMA, no swizzle: boxes of BOXN columns, each
// [32 k][BOXN], the boxes one after another) of ROWS columns -> the hi and
// lo K-major tiles of its transpose, [ROWS][32] in the 128-byte swizzle.
// Consecutive threads take consecutive columns n: their reads of a k row
// and their 16-byte writes (row n, chunk c ^ (n % 8)) hit distinct banks.
template <int ROWS, int BOXN, int NT>
__device__ __forceinline__ void split_mnmajor(const float* raw, unsigned char* hi,
                                              unsigned char* lo, int t) {
#pragma unroll
  for (int i = t; i < ROWS * 8; i += NT) {
    const int n = i % ROWS, c = i / ROWS;
    const float* x = raw + (n / BOXN) * (KB * BOXN) + 4 * c * BOXN + n % BOXN;
    store_split(hi, ROWS * 128, static_cast<int>(lo - hi), n, c,
                make_float4(x[0], x[BOXN], x[2 * BOXN], x[3 * BOXN]));
  }
}

// The m64k8 A fragment of 8-deep step kk (columns 8 kk ..) from a landed
// K-major tile (`slab`: the warpgroup's 64 rows), split into TF32 hi and lo:
// a thread holds rows r0 = 16 warp + g and r0 + 8, columns t and t + 4 of the
// step, in wgmma's order (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
// Element (r, k) lies at r 128 + ((k / 4) ^ (r % 8)) 16 + (k % 4) 4 and r0 %
// 8 == g, so the 32 lanes of a load hit 32 banks.
__device__ __forceinline__ void load_a(const unsigned char* slab, int r0, int g, int t, int kk,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const unsigned char* p = slab + r0 * 128 + t * 4;
  const int c0 = ((2 * kk) ^ g) << 4, c1 = ((2 * kk + 1) ^ g) << 4;
  split(*reinterpret_cast<const float*>(p + c0), ah[0], al[0]);
  split(*reinterpret_cast<const float*>(p + 8 * 128 + c0), ah[1], al[1]);
  split(*reinterpret_cast<const float*>(p + c1), ah[2], al[2]);
  split(*reinterpret_cast<const float*>(p + 8 * 128 + c1), ah[3], al[3]);
}

// the A fragments of one k-step (32 columns): hi and lo of its 4 steps
struct AFrag {
  uint32_t h[4][4], l[4][4];
};

__device__ __forceinline__ void fence_frag(AFrag& f) {
  fence_pregs(f.h);
  fence_pregs(f.l);
}

// the three products of one k-step into d (d = them when `fresh`, else d +
// them): A from the fragments, B from its hi and lo K-major tiles of N rows
template <int N>
__device__ __forceinline__ void mma_kstep(float (&d)[N / 2], const AFrag& f,
                                          const unsigned char* bhi, const unsigned char* blo,
                                          bool fresh) {
#pragma unroll
  for (int kk = 0; kk < KB / 8; ++kk) {
    const uint64_t bh = desc_sw128(bhi + kk * 32, 16, 1024);
    const uint64_t bl = desc_sw128(blo + kk * 32, 16, 1024);
    WgmmaTf32<N>::rs(d, f.l[kk], bh, kk > 0 || !fresh);
    WgmmaTf32<N>::rs(d, f.h[kk], bl, 1);
    WgmmaTf32<N>::rs(d, f.h[kk], bh, 1);
  }
}

// the three products of one k-step into d (d = them when `fresh`) with A's
// hi and lo K-major tiles (64 rows) in shared memory too: for a body whose A
// is split once for several consumer warpgroups (K6's f32 body)
template <int N>
__device__ __forceinline__ void mma_kstep_ss(float (&d)[N / 2], const unsigned char* ahi,
                                             const unsigned char* alo, const unsigned char* bhi,
                                             const unsigned char* blo, bool fresh) {
#pragma unroll
  for (int kk = 0; kk < KB / 8; ++kk) {
    const uint64_t ah = desc_sw128(ahi + kk * 32, 16, 1024);
    const uint64_t al = desc_sw128(alo + kk * 32, 16, 1024);
    const uint64_t bh = desc_sw128(bhi + kk * 32, 16, 1024);
    const uint64_t bl = desc_sw128(blo + kk * 32, 16, 1024);
    WgmmaTf32<N>::ss(d, al, bh, kk > 0 || !fresh);
    WgmmaTf32<N>::ss(d, ah, bl, 1);
    WgmmaTf32<N>::ss(d, ah, bh, 1);
  }
}

template <int R>
__device__ __forceinline__ void fold_into(float (&acc)[R], float (&t)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += t[i];
}

// The consumers' side of one work unit: its `nsteps` k-steps, ring slots
// from `it` on (advanced), into acc (zeroed here). The ring: STAGES stages
// of STAGE bytes, A's landed tile (BM = 128 rows) first, then B's at A_BYTES;
// `sbuf` holds the three split buffers of B, each BN rows of hi then lo;
// split_b(raw B, hi, lo, consumer thread) splits a landed B tile. Runs of
// kFold k-steps accumulate in t and are added into acc when they end.
template <int BN, int STAGES, int STAGE, int A_BYTES, typename SplitB>
__device__ __forceinline__ void consume_unit(unsigned char* ring, unsigned char* sbuf,
                                             uint64_t* full, uint64_t* empty, int nsteps,
                                             int& it, float (&acc)[BN / 2],
                                             float (&t)[BN / 2], AFrag& f0, AFrag& f1, int cw,
                                             int ct, SplitB split_b) {
  constexpr int HALF = BN * 128;  // a split buffer's hi (or lo) tile
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  // k-step i of the unit with fragments f (the other set: fo)
  auto step = [&](int i, AFrag& f, AFrag& fo) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    unsigned char* st = ring + s * STAGE;
    unsigned char* hi = sbuf + (it % 3) * 2 * HALF;
    split_b(st + A_BYTES, hi, hi + HALF, ct);
    fence_async_shared();
    named_barrier(1, 256);
    const unsigned char* slab = st + cw * 64 * 128;
#pragma unroll
    for (int kk = 0; kk < KB / 8; ++kk) load_a(slab, r0, g, t4, kk, f.h[kk], f.l[kk]);
    fence_regs(t);
    wgmma_fence();
    mma_kstep<BN>(t, f, hi, hi + HALF, i % kFold == 0);
    wgmma_commit();
    mbar_arrive(&empty[s]);  // A read into registers, B split: the stage is free
    ++it;
    if (i % kFold == kFold - 1 || i == nsteps - 1) {
      wgmma_wait<0>();
      fence_regs(t);
      fence_frag(f);
      fence_frag(fo);
      fold_into(acc, t);
    } else {
      wgmma_wait<1>();  // k-step i - 1 has retired, its fragments are free
      fence_frag(fo);
    }
  };
  for (int i = 0; i < nsteps; i += 2) {
    step(i, f0, f1);
    if (i + 1 < nsteps) step(i + 1, f1, f0);
  }
}

}  // namespace tf32x3
}  // namespace cpd
