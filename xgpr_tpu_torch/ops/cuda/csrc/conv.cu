// K3 and K4 in the 3xTF32 format ("high", the "balanced" default) on the
// TMA pipeline of conv_tf32.cuh, and their C entry points.  The bf16 body
// (conv_ws.cuh, conv_bf16.cu, which also holds the row operands' layout of
// both pipelines) and the synchronous bodies, fp32 FMAs and float64
// (conv_sync.cuh, conv_fma.cu, conv_f64.cu), have their own kernels and
// entry points.
#include "conv_tf32.cuh"

using namespace xgpr;
using namespace xgpr::conv;

// xt: (2, n, l, dp) float32, the TF32 high parts and remainders of x's
// rows in tile order (row r is input row order[r]); nk: (n,) their valid
// windows; top: (ceil(n / 64),) each 64-row tile's largest nk; proj_hi,
// proj_lo: (f, width * dp) float32, projT's TF32 planes, K-major.
// row_scale (may be null) and the outputs are float32, indexed by input
// row.  split is the host's plan (ops/cuda/conv.py: tf32_plan); a plan
// the kernel cannot run, and for K3 an unknown sincos mode, are refused.
extern "C" int xgpr_conv_parts_tf32(const void* xt, const int* order,
                                    const int* nk, const int* top,
                                    const void* proj_hi, const void* proj_lo,
                                    const void* row_scale, void* c_out,
                                    void* s_out, int n, int l, int dp,
                                    int width, int f, double sigma, int mode,
                                    int split, void* stream) {
  const tf32::Args p{order, nk, top, n, l, dp, width, f, split};
  const float* rs = static_cast<const float*>(row_scale);
  float* c = static_cast<float*>(c_out);
  float* s = static_cast<float*>(s_out);
  const float sg = (float)sigma;
  switch (mode) {
    case MODE_HI:
      return tf32::launch<PartsEpilogue<float, MODE_HI, 2, 8>>(
          p, xt, proj_hi, proj_lo, {rs, c, s, sg}, stream);
    case MODE_EXACT:
      return tf32::launch<PartsEpilogue<float, MODE_EXACT, 2, 8>>(
          p, xt, proj_hi, proj_lo, {rs, c, s, sg}, stream);
    case MODE_FAST:
      return tf32::launch<PartsEpilogue<float, MODE_FAST, 2, 8>>(
          p, xt, proj_hi, proj_lo, {rs, c, s, sg}, stream);
    case MODE_POLY:
      return tf32::launch<PartsEpilogue<float, MODE_POLY, 2, 8>>(
          p, xt, proj_hi, proj_lo, {rs, c, s, sg}, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int xgpr_conv_maxpool_tf32(const void* xt, const int* order,
                                      const int* nk, const int* top,
                                      const void* proj_hi,
                                      const void* proj_lo, void* out, int n,
                                      int l, int dp, int width, int f,
                                      int split, void* stream) {
  const tf32::Args p{order, nk, top, n, l, dp, width, f, split};
  return tf32::launch<MaxpoolEpilogue<float, 2, 8>>(
      p, xt, proj_hi, proj_lo, {static_cast<float*>(out)}, stream);
}
