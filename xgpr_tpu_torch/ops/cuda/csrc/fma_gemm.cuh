// The CUDA-core products of the fp32 FMA bodies ("highest", the
// "reference" preset's fp32-exact products: K2's kernel in
// feature_map_fma.cu, K3 and K4's FmaTile in conv_sync.cuh), and the
// scalar helpers the epilogues share (fma_t, max_t).
//
// The register tile: a thread holds 8 GEMM rows by 8 columns
// (frequencies), acc[8r + c], and its operands lie channel-major ("K-major"
// tiles of one channel a row) in shared memory, so that one channel's 8 A
// and 8 B values are four 16-byte loads for its 64 FMAs: A's rows as two
// runs of 4 (at a and a + a1), B's columns as two runs of 4 (at b and
// b + b1).  Each accumulator is one fmaf chain over the channels in order,
// so an output is the same fp32 sum whatever the tile's staging; a
// 16-byte load of A is the same address across a quarter warp (a
// broadcast) and B's loads are 128 contiguous bytes a quarter warp in both
// kernels' layouts, so they are free of bank conflicts.  The wgmma
// fragment as a thread tile (2 rows x 32 frequencies: 34 shared loads per
// 256 FMAs) ran K3 at 31% and K2 at 11% of their bound on the card.
#pragma once

#include <cuda_runtime.h>

namespace xgpr {

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ float max_t(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double max_t(double a, double b) {
  return fmax(a, b);
}

// One channel's 64 FMAs: acc[8r + c] = fmaf(a_r, b_c, acc[8r + c]) for
// A's rows a[0..3], a[a1 .. a1 + 3] and B's columns b[0..3],
// b[b1 .. b1 + 3] (shared memory, 16-byte aligned).
__device__ __forceinline__ void fma_channel(const float* a, int a1,
                                            const float* b, int b1,
                                            float acc[64]) {
  const float4 a0 = *reinterpret_cast<const float4*>(a);
  const float4 a4 = *reinterpret_cast<const float4*>(a + a1);
  const float4 b0 = *reinterpret_cast<const float4*>(b);
  const float4 b4 = *reinterpret_cast<const float4*>(b + b1);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a4.x, a4.y, a4.z, a4.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc[8 * r + c] = fmaf(av[r], bv[c], acc[8 * r + c]);
}

// KS channels of a step in order, channel k's A values at a + k * ap and
// B values at b + k * bp.  Unrolled by 8 channels, not KS: a whole 32-
// channel step's 2,048 FMAs in straight-line code ran K3 10% slower on the
// card (PERF.md §6).
template <int KS>
__device__ __forceinline__ void fma_step(const float* a, int ap, int a1,
                                         const float* b, int bp, int b1,
                                         float acc[64]) {
#pragma unroll 8
  for (int k = 0; k < KS; ++k) fma_channel(a + k * ap, a1, b + k * bp, b1, acc);
}

// The same over the first kn channels of a step (a ragged last step).
__device__ __forceinline__ void fma_step_n(const float* a, int ap, int a1,
                                           const float* b, int bp, int b1,
                                           int kn, float acc[64]) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) fma_channel(a + k * ap, a1, b + k * bp, b1, acc);
}

}  // namespace xgpr
