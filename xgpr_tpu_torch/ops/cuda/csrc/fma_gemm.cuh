// The projection body of K2 at the "highest" feature precision (the
// "reference" preset), beside the wgmma bodies of tf32_gemm.cuh (Format):
// FMT_FMA32, fp32 FMAs on the CUDA cores (fma_products), whose products
// are complete when issued (no wgmma in flight).  K3 and K4 run the same
// arithmetic in conv_sync.cuh.  xgpr_tpu's "highest" is an fp32-exact
// product (HIGHEST: six bf16 passes on the TPU); the 3xTF32 body sums in
// the tensor cores' fp32 accumulation and measured 6.2x (K3) and 5.1x (K4)
// the error of a plain fp32 product against a float64 witness on the H100
// (PERF.md), while an fp32 FMA rounds each step as the plain product
// does.  Float64 operands run elsewhere: K1 and K2 on dense_f64.cuh's
// m16n8k8 DMMA loop, K3 and K4 in conv_sync.cuh.
//
// What bounds it: operations, 5.6 GFLOP at RBF's chunk as fp32 FMAs, 0.084
// ms at the CUDA cores' 67 TFLOP/s (PERF.md §6).
//
// Layout: the stages of the wgmma bodies, filled by the same copies
// (tf32_gemm.cuh: gemm_loop, load_rows), one plane per operand: each row
// K-major in 128-byte lines (32 fp32 values of depth) in the 128-byte
// swizzle.  Thread (warp W, lane (g, t) = (lane / 4, lane % 4)) owns the
// accumulator fragment of the wgmma bodies: tile rows 16W + g + 8h by
// columns 8j + 2t + e, in acc[4j + 2h + e] (h, e < 2, j < 16), so every
// epilogue reads the same registers whatever the body.  Depth runs in a
// fixed order, so the sums are the same from run to run.
#pragma once

#include "common.cuh"

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

// The 16 bytes at p (shared memory) as 4 values.
__device__ __forceinline__ void load16(const unsigned char* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// acc (this thread's fragment) = or += A rows (the tile's 128 rows at a)
// times B rows (its 128 columns at b) over one 128-byte line of depth, in
// fp32 FMAs; overwrite: the group's first step.  For each 16-byte chunk of
// depth (VEC values) a thread loads its two A rows and its 32 B columns,
// one 16-byte load each (the 4 lanes of one g, or the 8 of one t, read the
// same address; the swizzle puts the 8 rows, or 4 columns, of one load on
// distinct banks), and does 64 x VEC FMAs: 34 shared loads per 256 FMAs.
template <class T>
__device__ __forceinline__ void fma_products(const unsigned char* a,
                                             const unsigned char* b,
                                             T acc[64], bool overwrite) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x % 32, t4 = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16 + lane / 4;
  if (overwrite) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = T(0);
  }
#pragma unroll 1
  for (int c = 0; c < 8; ++c) {  // the line's 16-byte chunks
    T a0[VEC], a1[VEC];
    load16(a + sw128(r0, c), a0);
    load16(a + sw128(r0 + 8, c), a1);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        T bv[VEC];
        load16(b + sw128(8 * j + 2 * t4 + e, c), bv);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          acc[4 * j + e] = fma_t(a0[v], bv[v], acc[4 * j + e]);
          acc[4 * j + 2 + e] = fma_t(a1[v], bv[v], acc[4 * j + 2 + e]);
        }
      }
  }
}

}  // namespace xgpr
