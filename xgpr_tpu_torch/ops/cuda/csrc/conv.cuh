// Conv window loop for Hopper: what K3 (masked cos/sin window sums) and K4
// (ReLU + global max over windows) compute, and the epilogues every body
// shares.  Each body is a kernel of its own: 3xTF32 ("high", the
// "balanced" default) the TMA pipeline of conv_tf32.cuh (conv.cu), bf16
// ("default", the "max" preset) that of conv_ws.cuh (conv_bf16.cu), and
// the synchronous bodies, fp32 FMAs ("highest") and float64 DMMA, the
// kernel of conv_sync.cuh (conv_fma.cu, conv_f64.cu).
//
// Replace the TPU kernels xgpr_tpu/ops/pallas/conv_pallas.py:
//   K3 _conv_parts_kernel   (pallas_call in _conv_parts_impl)
//   K4 _conv_maxpool_kernel (pallas_call in _conv_maxpool_impl)
// For zero-padded sequences x (N, L, D), the dense projection (w*D, F) in
// window-major row order (row t*D + c), chi folded in, nw = L - w + 1
// windows and nk_i = clamp(lengths_i - w + 1, 0, nw):
//
//   g[i, j, :] = x[i, j : j + w, :].flatten() @ proj        (j < nw)
//   K3: c[i, f] = scale_i * sum_{j < nk_i} cos(g[i, j, f] * sigma)
//       s[i, f] = scale_i * sum_{j < nk_i} sin(g[i, j, f] * sigma)
//   K4: out[i, f] = max(0, max_{j < nk_i} g[i, j, f])
//
// scale_i is the optional per-row scale (averaging factor times
// rbf_norm_constant; 1 when the pointer is null).  Masked windows add 0 to
// K3 and are -inf against K4's zero start, the implicit ReLU of
// conv_pallas.py:157-164.
//
// What bounds it on the H100.  At the motif slice (8192 rows, L 16, D 64,
// w 9, F 4096) the valid windows need 173 GFLOP of fp32-grade products
// against 34 MB of x, 9.4 MB of proj and 268 MB of outputs (0.09 ms at
// 3.35 TB/s): bound by operations.  On CUDA cores (67 TFLOP/s) that is
// 2.6 ms; on the tensor cores, three TF32 products per multiply-add at
// 495 TFLOP/s, 1.05 ms; under "default", one bf16 product at 989 TFLOP/s,
// 0.18 ms (the bytes then weigh: 0.09 ms at 3.35 TB/s).
//
// What every body shares:
// - Rows ordered by window count.  The wrapper passes a stable order of
//   the rows by nk; a tile is 64 consecutive rows of that order, so its
//   rows have near-equal nk, and it takes windows in pairs only up to its
//   own largest nk.  At the motif slice that projects 1.12 window slots
//   per valid window instead of 1.79.  Outputs go to each row's own
//   index, so callers see the input order.
// - A thread owns every window of its rows, so K3's sincos sums and K4's
//   max fold into register accumulators after each window pair, and each
//   output is written once, with no atomics: results are the same from run
//   to run.  K3's epilogue is instantiated once per sincos mode of
//   xgpr_tpu's switch ("hi", "exact", "fast", "poly"; common.cuh), chosen
//   on the host at launch; float64 takes the builtin sincos in every mode
//   and sums in float64.  sigma multiplies the fp32 product.
// - Any shape: rows past N, windows past nw, channels past D and
//   frequencies past F are zero-filled by the copies and masked at the
//   store.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "fma_gemm.cuh"
#include "gemm_common.cuh"

namespace xgpr {
namespace conv {

// K3: running cos/sin sums of a thread's H rows x J frequency pairs, in
// one sincos mode (common.cuh; float64 takes the builtin in every mode).
// The TMA pipelines (conv_tf32.cuh, conv_ws.cuh) hold two rows x 8 pairs,
// conv_sync.cuh's fp32 body 4 x 4 and its float64 body 2 x 4.
template <class T, int MODE, int H, int J>
struct PartsEpilogue {
  struct Args {
    const T* row_scale;
    T* c_out;
    T* s_out;
    T sigma;
  };
  Args a;
  T cs[H][J][2], sn[H][J][2];

  __device__ __forceinline__ explicit PartsEpilogue(const Args& args)
      : a(args) {
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) cs[h][j][e] = sn[h][j][e] = T(0);
  }
  __device__ __forceinline__ void fold(int h, int j, int e, T g) {
    T c, s;
    sincos_scaled<MODE>(g * a.sigma, T(1), &c, &s);
    cs[h][j][e] += c;
    sn[h][j][e] += s;
  }
  // The TMA pipelines' fold of one window: needs_builtin(acc)
  // is with_sincos's choice for the warp (an argument past
  // POLY_ARG_LIMIT), fold_row adds row h of acc[4j + 2h + e] (J pairs) to
  // row h's sums by that evaluator: fold's values, 2J independent
  // evaluations in straight-line code.  The sums add rounded values
  // (__fadd_rn): fused into the polynomial's last product they would
  // round once, and differ.
  __device__ __forceinline__ bool needs_builtin(const float* acc) const {
    if constexpr (MODE == MODE_EXACT) {
      return true;
    } else {
      bool builtin = false;
#pragma unroll
      for (int i = 0; i < 4 * J; ++i)
        builtin |= fabsf(acc[i] * a.sigma) > POLY_ARG_LIMIT;
      return __any_sync(0xffffffffu, builtin);
    }
  }
  __device__ __forceinline__ void fold_row(const float* acc, int h,
                                           bool builtin) {
    auto add = [&](auto sincos) {
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float c, s;
          sincos(acc[4 * j + 2 * h + e] * a.sigma, 1.0f, &c, &s);
          cs[h][j][e] = __fadd_rn(cs[h][j][e], c);
          sn[h][j][e] = __fadd_rn(sn[h][j][e], s);
        }
    };
    if (MODE == MODE_EXACT || builtin) {
      add([](float x, float w, float* c, float* s) {
        sincos_scaled<MODE>(x, w, c, s);
      });
    } else if constexpr (MODE != MODE_EXACT) {
      add([](float x, float w, float* c, float* s) {
        sincos_mode_poly<MODE>(x, w, c, s);
      });
    }
  }
  __device__ __forceinline__ T row_factor(int row) const {
    return a.row_scale ? a.row_scale[row] : T(1);
  }
  __device__ __forceinline__ void store(size_t at, T w, int h, int j,
                                        int e) const {
    a.c_out[at] = cs[h][j][e] * w;
    a.s_out[at] = sn[h][j][e] * w;
  }
  // Both values of pair j of row h, at an even `at` (the same values).
  __device__ __forceinline__ void store_pair(size_t at, T w, int h,
                                             int j) const {
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float2*>(a.c_out + at) =
          make_float2(cs[h][j][0] * w, cs[h][j][1] * w);
      *reinterpret_cast<float2*>(a.s_out + at) =
          make_float2(sn[h][j][0] * w, sn[h][j][1] * w);
    } else {
      store(at, w, h, j, 0);
      store(at + 1, w, h, j, 1);
    }
  }
};

// K4: running max against a zero start.
template <class T, int H, int J>
struct MaxpoolEpilogue {
  struct Args {
    T* out;
  };
  Args a;
  T mx[H][J][2];

  __device__ __forceinline__ explicit MaxpoolEpilogue(const Args& args)
      : a(args) {
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) mx[h][j][e] = T(0);
  }
  __device__ __forceinline__ void fold(int h, int j, int e, T g) {
    mx[h][j][e] = max_t(mx[h][j][e], g);
  }
  __device__ __forceinline__ bool needs_builtin(const T*) const {
    return false;
  }
  __device__ __forceinline__ void fold_row(const T* acc, int h, bool) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) fold(h, j, e, acc[4 * j + 2 * h + e]);
  }
  __device__ __forceinline__ T row_factor(int) const { return T(1); }
  __device__ __forceinline__ void store(size_t at, T, int h, int j,
                                        int e) const {
    a.out[at] = mx[h][j][e];
  }
  __device__ __forceinline__ void store_pair(size_t at, T w, int h,
                                             int j) const {
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float2*>(a.out + at) =
          make_float2(mx[h][j][0], mx[h][j][1]);
    } else {
      store(at, w, h, j, 0);
      store(at + 1, w, h, j, 1);
    }
  }
};

}  // namespace conv
}  // namespace xgpr

