// Shared device code: the guarded (cos, sin) evaluator of the epilogues of
// every kernel (feature_map.cu, ztzv.cu, conv.cu), and the dispatch of the
// dense kernels' epilogues to its polynomial alone.  The tensor-core GEMM
// body they share is in tf32_gemm.cuh.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace xgpr {

// Cody-Waite reduction by whole periods is exact while |x| < 2^13
// (xgpr_tpu/ops/sincos.py:_POLY_ARG_LIMIT); past it the builtin is used.
constexpr float POLY_ARG_LIMIT = 8192.0f;

// (cos x * w, sin x * w) by the "hi" pair of
// xgpr_tpu/ops/sincos.py:_hi_sincos (one reduction by whole periods, deg-13
// sin and deg-14 cos minimax, the same constants); right for
// |x| <= POLY_ARG_LIMIT.
__device__ __forceinline__ void sincos_poly(float x, float w, float* c,
                                            float* s) {
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

// (cos x * w, sin x * w).  exact == 0: sincos_poly, with sincosf for
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
  sincos_poly(x, w, c, s);
}

// Runs an epilogue body over a warp's 64 accumulator values with the
// sincos evaluator they need: sincos_poly when no argument acc[i] * sigma
// of the warp is past POLY_ARG_LIMIT and the mode is "hi", else
// sincos_scaled.  The two bodies are separate straight-line code: with
// sincosf's slow path inlined beside each of the 64 evaluations, the
// executed instructions of the common case are scattered over a body many
// times larger, and K2's epilogue ran ~4x slower (PERF.md).  Both give the
// values of sincos_scaled.
template <class Body>
__device__ __forceinline__ void with_sincos(const float acc[64], float sigma,
                                            int exact, Body&& body) {
  bool builtin = exact != 0;
#pragma unroll
  for (int i = 0; i < 64; ++i)
    builtin |= fabsf(acc[i] * sigma) > POLY_ARG_LIMIT;
  if (__any_sync(0xffffffffu, builtin)) {
    body([exact](float x, float w, float* c, float* s) {
      sincos_scaled(x, w, exact, c, s);
    });
  } else {
    body([](float x, float w, float* c, float* s) {
      sincos_poly(x, w, c, s);
    });
  }
}

}  // namespace xgpr
