// K3 and K4 in the 3xTF32 format ("high", the default), and the C entry
// points of both kernels for every format; the kernels and their design
// are in conv.cuh.
#include "conv.cuh"

using namespace xgpr;
using namespace xgpr::conv;

// The C entry points.  x_hi/x_lo and proj_hi/proj_lo are the planes of
// the format `body` names (tf32_gemm.cuh: Format): TF32 splits for
// FMT_TF32X3; bf16 values (FMT_BF16), float32 values (FMT_FMA32) or
// float64 values (FMT_F64) with the lo pointers unused.  row_scale,
// the outputs and sigma are float32, or float64 for FMT_F64, whose
// sincos is the builtin in every mode.  Any other body, and for K3 any
// other sincos mode, is refused.
extern "C" int xgpr_conv_parts(const void* x_hi, const void* x_lo,
                               const int* order, const int* nk,
                               const void* proj_hi, const void* proj_lo,
                               const void* row_scale, void* c_out,
                               void* s_out, int n, int l, int dp, int width,
                               int f, double sigma, int mode, int body,
                               void* stream) {
  const ConvArgs p{x_hi, x_lo, order, nk, proj_hi, proj_lo,
                   n,    l,    dp,    width, f};
  if (body == FMT_F64)
    return launch_parts_f64(p, static_cast<const double*>(row_scale),
                            static_cast<double*>(c_out),
                            static_cast<double*>(s_out), sigma, mode, stream);
  const float* rs = static_cast<const float*>(row_scale);
  float* c = static_cast<float*>(c_out);
  float* s = static_cast<float*>(s_out);
  switch (body) {
    case FMT_TF32X3:
      return launch_parts<FMT_TF32X3>(p, rs, c, s, (float)sigma, mode,
                                      stream);
    case FMT_FMA32:
      return launch_parts_fma32(p, rs, c, s, (float)sigma, mode, stream);
    case FMT_BF16:
      return launch_parts_bf16(p, rs, c, s, (float)sigma, mode, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int xgpr_conv_maxpool(const void* x_hi, const void* x_lo,
                                 const int* order, const int* nk,
                                 const void* proj_hi, const void* proj_lo,
                                 void* out, int n, int l, int dp, int width,
                                 int f, int body, void* stream) {
  const ConvArgs p{x_hi, x_lo, order, nk, proj_hi, proj_lo,
                   n,    l,    dp,    width, f};
  switch (body) {
    case FMT_TF32X3:
      return launch_maxpool<FMT_TF32X3>(p, static_cast<float*>(out), stream);
    case FMT_FMA32:
      return launch_maxpool_fma32(p, static_cast<float*>(out), stream);
    case FMT_BF16:
      return launch_maxpool_bf16(p, static_cast<float*>(out), stream);
    case FMT_F64:
      return launch_maxpool_f64(p, static_cast<double*>(out), stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
