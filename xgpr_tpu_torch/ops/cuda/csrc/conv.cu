// K3 and K4 in the 3xTF32 format ("high", the default), and their C entry
// points; the kernels and their design are in conv.cuh.  The bf16 body
// (conv_ws.cuh, conv_bf16.cu) and the synchronous bodies, fp32 FMAs and
// float64 (conv_sync.cuh, conv_fma.cu, conv_f64.cu), have their own
// kernels and entry points.
#include "conv.cuh"

using namespace xgpr;
using namespace xgpr::conv;

// The C entry points.  x_hi/x_lo and proj_hi/proj_lo are the TF32 splits
// of the format `body` names (tf32_gemm.cuh: Format), FMT_TF32X3;
// row_scale, the outputs and sigma are float32.  Any other body (FMT_BF16:
// xgpr_conv_parts_ws; FMT_FMA32, FMT_F64: xgpr_conv_parts_sync), and for
// K3 any other sincos mode, is refused.
extern "C" int xgpr_conv_parts(const void* x_hi, const void* x_lo,
                               const int* order, const int* nk,
                               const void* proj_hi, const void* proj_lo,
                               const void* row_scale, void* c_out,
                               void* s_out, int n, int l, int dp, int width,
                               int f, double sigma, int mode, int body,
                               void* stream) {
  const ConvArgs p{x_hi, x_lo, order, nk, proj_hi, proj_lo,
                   n,    l,    dp,    width, f};
  if (body != FMT_TF32X3) return (int)cudaErrorInvalidValue;
  return launch_parts<FMT_TF32X3>(p, static_cast<const float*>(row_scale),
                                  static_cast<float*>(c_out),
                                  static_cast<float*>(s_out), (float)sigma,
                                  mode, stream);
}

extern "C" int xgpr_conv_maxpool(const void* x_hi, const void* x_lo,
                                 const int* order, const int* nk,
                                 const void* proj_hi, const void* proj_lo,
                                 void* out, int n, int l, int dp, int width,
                                 int f, int body, void* stream) {
  const ConvArgs p{x_hi, x_lo, order, nk, proj_hi, proj_lo,
                   n,    l,    dp,    width, f};
  if (body != FMT_TF32X3) return (int)cudaErrorInvalidValue;
  return launch_maxpool<FMT_TF32X3>(p, static_cast<float*>(out), stream);
}
