// Shared device code: the guarded (cos, sin) evaluators of the epilogues of
// every kernel (feature_map.cu, ztzv.cu, conv.cu), one per sincos mode, and
// the dispatch of the dense kernels' epilogues to a mode's polynomial
// alone; float64's builtin evaluator; the swizzle of the shared tiles.
// The GEMM bodies they share are in tf32_gemm.cuh (tensor cores) and
// fma_gemm.cuh (CUDA cores).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace xgpr {

// Byte offset of 16-byte chunk c of row r in a tile of 128-byte rows in
// the 128-byte swizzle, the layout wgmma's descriptors read
// (tf32_gemm.cuh) and the CUDA-core body reads the same way
// (fma_gemm.cuh).
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r % 8)) << 4);
}

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

// (cos x * w, sin x * w) by the "fast" pair of
// xgpr_tpu/ops/sincos.py:_fast_sincos: the same reduction by whole periods
// with deg-9 sin / deg-8 cos minimax over [-pi, pi] (max error 4.1e-5),
// the same constants; right for |x| <= POLY_ARG_LIMIT.
__device__ __forceinline__ void sincos_fast(float x, float w, float* c,
                                            float* s) {
  const float n = rintf(x * 0.15915494309189535f);  // round half to even
  float r = x - n * 6.28125f;
  r = r - n * 1.9353071795864769e-3f;
  const float z = r * r;
  float sp = 2.14788592e-06f;
  sp = sp * z + -1.92650222e-04f;
  sp = sp * z + 8.30898665e-03f;
  sp = sp * z + -1.66624389e-01f;
  sp = sp * z + 9.99979391e-01f;
  float cp = 1.87919992e-05f;
  cp = cp * z + -1.33926855e-03f;
  cp = cp * z + 4.14960343e-02f;
  cp = cp * z + -4.99793151e-01f;
  cp = cp * z + 9.99959802e-01f;
  *c = cp * w;
  *s = sp * (r * w);
}

// (cos x * w, sin x * w) by the "poly" pair of
// xgpr_tpu/ops/sincos.py:_poly_sincos: a three-term Cody-Waite reduction by
// quarter periods, the cephes sinf/cosf polynomials on |r| <= pi/4 and the
// quadrant's swap and signs from the low two bits of n, the same
// constants; right for |x| <= POLY_ARG_LIMIT.
__device__ __forceinline__ void sincos_poly_quadrant(float x, float w,
                                                     float* c, float* s) {
  const float n = rintf(x * 0.6366197723675814f);  // round half to even
  float r = x - n * 1.5703125f;
  r = r - n * 4.837512969970703125e-4f;
  r = r - n * 7.54978995489188216e-8f;
  const float z = r * r;
  const float sin_r =
      ((-1.9515295891e-4f * z + 8.3321608736e-3f) * z + -1.6666654611e-1f) *
          z * r +
      r;
  const float cos_r = ((2.443315711809948e-5f * z + -1.388731625493765e-3f) *
                           z +
                       4.166664568298827e-2f) *
                          z * z -
                      0.5f * z + 1.0f;
  const int q = __float2int_rn(n) & 3;  // n is a whole number: exact
  float sv = (q & 1) ? cos_r : sin_r;
  float cv = (q & 1) ? sin_r : cos_r;
  if (q & 2) sv = -sv;
  if ((q + 1) & 2) cv = -cv;
  *c = cv * w;
  *s = sv * w;
}

// The sincos modes of ops/cuda/feature_map.py:kernel_sincos_flag, one
// instantiation of each kernel per mode, chosen on the host at launch.
enum SincosMode : int { MODE_HI = 0, MODE_EXACT = 1, MODE_FAST = 2,
                        MODE_POLY = 3 };

// The mode's polynomial alone (not for MODE_EXACT).
template <int MODE>
__device__ __forceinline__ void sincos_mode_poly(float x, float w, float* c,
                                                 float* s) {
  static_assert(MODE != MODE_EXACT, "the exact mode has no polynomial");
  if constexpr (MODE == MODE_FAST) {
    sincos_fast(x, w, c, s);
  } else if constexpr (MODE == MODE_POLY) {
    sincos_poly_quadrant(x, w, c, s);
  } else {
    sincos_poly(x, w, c, s);
  }
}

// (cos x * w, sin x * w) in a mode: its polynomial, with sincosf for
// |x| > POLY_ARG_LIMIT; MODE_EXACT takes sincosf everywhere.  The library
// is built without --use_fast_math, so sincosf is the accurate routine and
// not __sincosf.
template <int MODE>
__device__ __forceinline__ void sincos_scaled(float x, float w, float* c,
                                              float* s) {
  if (MODE == MODE_EXACT || fabsf(x) > POLY_ARG_LIMIT) {
    float sv, cv;
    sincosf(x, &sv, &cv);
    *c = cv * w;
    *s = sv * w;
    return;
  }
  if constexpr (MODE != MODE_EXACT) sincos_mode_poly<MODE>(x, w, c, s);
}

// (cos x * w, sin x * w) in float64: the builtin sincos whatever the mode,
// as float64 takes it in both packages (ops/sincos.py: kernel_sincos).
template <int MODE>
__device__ __forceinline__ void sincos_scaled(double x, double w, double* c,
                                              double* s) {
  double sv, cv;
  sincos(x, &sv, &cv);
  *c = cv * w;
  *s = sv * w;
}

// Runs an epilogue body over a warp's 64 accumulator values with the
// sincos evaluator they need: the mode's polynomial alone when no argument
// acc[i] * sigma of the warp is past POLY_ARG_LIMIT, else sincos_scaled.
// The two bodies are separate straight-line code: with sincosf's slow path
// inlined beside each of the 64 evaluations, the executed instructions of
// the common case are scattered over a body many times larger, and K2's
// epilogue ran ~4x slower (PERF.md).  Both give the values of
// sincos_scaled<MODE>.  MODE_EXACT has the one body.
template <int MODE, class Body>
__device__ __forceinline__ void with_sincos(const float acc[64], float sigma,
                                            Body&& body) {
  auto scaled = [](float x, float w, float* c, float* s) {
    sincos_scaled<MODE>(x, w, c, s);
  };
  if constexpr (MODE == MODE_EXACT) {
    body(scaled);
  } else {
    bool builtin = false;
#pragma unroll
    for (int i = 0; i < 64; ++i)
      builtin |= fabsf(acc[i] * sigma) > POLY_ARG_LIMIT;
    if (__any_sync(0xffffffffu, builtin)) {
      body(scaled);
    } else {
      body([](float x, float w, float* c, float* s) {
        sincos_mode_poly<MODE>(x, w, c, s);
      });
    }
  }
}

}  // namespace xgpr
