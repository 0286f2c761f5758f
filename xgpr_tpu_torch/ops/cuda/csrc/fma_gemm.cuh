// The two projection bodies whose products are complete when issued (no
// wgmma in flight), beside the wgmma bodies of tf32_gemm.cuh (Format):
//
// - FMT_FMA32 (T = float): fp32 FMAs on the CUDA cores (fma_products).
//   K2 runs it at the "highest" feature precision (the "reference"
//   preset; K3 and K4 run the same arithmetic in conv_sync.cuh).  xgpr_tpu's "highest" is an fp32-exact product (HIGHEST: six
//   bf16 passes on the TPU); the 3xTF32 body sums in the tensor cores'
//   fp32 accumulation and measured 6.2x (K3) and 5.1x (K4) the error of a
//   plain fp32 product against a float64 witness on the H100 (PERF.md),
//   while an fp32 FMA rounds each step as the plain product does.
// - FMT_F64 (T = double): float64 products on the tensor cores
//   (dmma_products: mma.sync.m8n8k4.f64, each multiply-add rounded as an
//   FP64 FMA).  Every kernel runs it on float64 operands, whatever the
//   feature precision, as xgpr_tpu's float64 runs ignore the precision
//   knobs.
//
// What bounds them: operations at K2 "highest" and in K1's float64
// projection (PERF.md §6).
//
// Layout: the stages of the wgmma bodies, filled by the same copies
// (tf32_gemm.cuh: gemm_loop, load_rows), one plane
// per operand: each row K-major in 128-byte lines (32 fp32 or 16 float64
// values of depth) in the 128-byte swizzle.  Thread (warp W, lane
// (g, t) = (lane / 4, lane % 4)) owns the accumulator fragment of the
// wgmma bodies: tile rows 16W + g + 8h by columns 8j + 2t + e, in
// acc[4j + 2h + e] (h, e < 2, j < 16), so every epilogue reads the same
// registers whatever the body.  Depth runs in a fixed order, so the sums
// are the same from run to run.
#pragma once

#include "common.cuh"

namespace xgpr {

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float max_t(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double max_t(double a, double b) {
  return fmax(a, b);
}

// The 16 bytes at p (shared memory) as VEC values.
__device__ __forceinline__ void load16(const unsigned char* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load16(const unsigned char* p, double v[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x;
  v[1] = q.y;
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

// One DMMA: the 8 x 8 tile (c0, c1) += a (8 x 4) b (4 x 8) in float64, lane
// (g, t) holding a[g][t], b[t][g] and c[g][2t .. 2t + 1].
__device__ __forceinline__ void dmma(double& c0, double& c1, double a,
                                     double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// fma_products' contract in float64 on the tensor cores: the fragment is
// 2 x 16 DMMA tiles (rows 16W + 8h + g, columns 8j + g' of B), each
// accumulator pair acc[4j + 2h], acc[4j + 2h + 1] one tile's c0, c1.  The
// k of a DMMA is lane t's depth: in pass s < 2 lane t loads the 16-byte
// chunk 2t + s of its rows (depth 4t + 2s and 4t + 2s + 1) and feeds one
// value to each of two DMMAs, so the 16 values of the line are summed in
// the fixed order the passes give.  Chunk 2t + s of rows g and g ^ 1 lie
// in different 16-byte columns of the swizzle, so each quarter-warp's
// loads fall on distinct banks: 36 shared loads per 128 DMMAs a warp.
__device__ __forceinline__ void dmma_products(const unsigned char* a,
                                              const unsigned char* b,
                                              double acc[64], bool overwrite) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16 + g;
  if (overwrite) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0;
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = 2 * t4 + s;
    double a0[2], a1[2];
    load16(a + sw128(r0, c), a0);
    load16(a + sw128(r0 + 8, c), a1);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      double bv[2];
      load16(b + sw128(8 * j + g, c), bv);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        dmma(acc[4 * j], acc[4 * j + 1], a0[v], bv[v]);
        dmma(acc[4 * j + 2], acc[4 * j + 3], a1[v], bv[v]);
      }
    }
  }
}

}  // namespace xgpr
