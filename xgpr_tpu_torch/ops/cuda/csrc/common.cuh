// Shared device code: the tiled fp32 projection x @ proj of the RBF
// feature-map kernel (feature_map.cu) and the fused CG-matvec kernels
// (ztzv.cu), and the guarded (cos, sin) evaluator, which the conv
// window-loop kernels (conv.cu) use too.
//
// Each kernel computes arg = x @ proj for a TM x TN tile of (rows, freqs)
// with plain fp32 FMAs, staging TK-deep slices of x and proj in shared
// memory.  256 threads each own a 4 x 4 micro-tile whose rows and freqs are
// strided by 16, so consecutive lanes touch consecutive columns.  The
// callers pick which thread index walks the rows: the reductions in ztzv.cu
// reduce over lanes with warp shuffles.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace xgpr {

constexpr int TM = 64;   // rows per tile
constexpr int TN = 64;   // frequencies per tile
constexpr int TK = 16;   // contraction depth per shared-memory stage
constexpr int NT = 256;  // threads per block, seen as 16 x 16

// Cody-Waite reduction by whole periods is exact while |x| < 2^13
// (xgpr_tpu/ops/sincos.py:_POLY_ARG_LIMIT); past it the builtin is used.
constexpr float POLY_ARG_LIMIT = 8192.0f;

struct TileSmem {
  float a[TK][TM + 1];  // x slice, transposed; +1 spreads the stores over banks
  float b[TK][TN];      // proj slice
};

// acc[i][j] = sum_d x[(row0 + r_lo + 16 i) * lda + d] * proj[d, f0 + f_lo + 16 j].
// Rows >= n, freqs >= f and depth >= d read as zero, so any shape works
// without padded copies.  lda >= d is the row stride of x.  Ends with a
// __syncthreads().
__device__ __forceinline__ void project_tile_strided(
    const float* __restrict__ x, size_t lda, const float* __restrict__ proj,
    int n, int d, int f, int row0, int f0, int r_lo, int f_lo, TileSmem& sm,
    float acc[4][4]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int d0 = 0; d0 < d; d0 += TK) {
#pragma unroll
    for (int q = 0; q < (TM * TK) / NT; ++q) {
      const int e = tid + q * NT;
      const int r = e / TK, k = e % TK;
      const int gr = row0 + r, gd = d0 + k;
      sm.a[k][r] = (gr < n && gd < d) ? x[(size_t)gr * lda + gd] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < (TK * TN) / NT; ++q) {
      const int e = tid + q * NT;
      const int k = e / TN, c = e % TN;
      const int gd = d0 + k, gf = f0 + c;
      sm.b[k][c] = (gd < d && gf < f) ? proj[(size_t)gd * f + gf] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.a[k][r_lo + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.b[k][f_lo + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The same for a dense (n, d) x.
__device__ __forceinline__ void project_tile(
    const float* __restrict__ x, const float* __restrict__ proj, int n, int d,
    int f, int row0, int f0, int r_lo, int f_lo, TileSmem& sm,
    float acc[4][4]) {
  project_tile_strided(x, (size_t)d, proj, n, d, f, row0, f0, r_lo, f_lo, sm,
                       acc);
}

// (cos x * w, sin x * w).  exact == 0: the "hi" pair of
// xgpr_tpu/ops/sincos.py:_hi_sincos (one reduction by whole periods, deg-13
// sin and deg-14 cos minimax, the same constants), with sincosf for
// |x| > POLY_ARG_LIMIT.  exact != 0: sincosf everywhere.  The library is
// built without --use_fast_math, so sincosf is the accurate routine and not
// __sincosf.
__device__ __forceinline__ void sincos_scaled(float x, float w, int exact,
                                              float* c, float* s) {
  if (exact || fabsf(x) > POLY_ARG_LIMIT) {
    float sv, cv;
    sincosf(x, &sv, &cv);
    *c = cv * w;
    *s = sv * w;
    return;
  }
  const float n = rintf(x * 0.15915494309189535f);  // round half to even
  float r = x - n * 6.28125f;
  r = r - n * 1.9353071795864769e-3f;
  const float z = r * r;
  float sp = 1.3451442737455466e-10f;
  sp = sp * z + -2.4676957366409624e-08f;
  sp = sp * z + 2.752945192696643e-06f;
  sp = sp * z + -0.0001984015543712303f;
  sp = sp * z + 0.00833331048488617f;
  sp = sp * z + -0.166666641831398f;
  sp = sp * z + 1.0f;
  float cp = -9.758583698060708e-12f;
  cp = cp * z + 2.061550263832146e-09f;
  cp = cp * z + -2.753634191776655e-07f;
  cp = cp * z + 2.480065268173348e-05f;
  cp = cp * z + -0.0013888865942135453f;
  cp = cp * z + 0.0416666641831398f;
  cp = cp * z + -0.5f;
  cp = cp * z + 1.0f;
  *c = cp * w;
  *s = sp * (r * w);
}

}  // namespace xgpr
