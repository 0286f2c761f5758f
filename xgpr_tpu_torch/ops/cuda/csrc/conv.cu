// K3 and K4 in the 3xTF32 format ("high", the default), and the C entry
// points of both kernels for every format; the kernels and their design
// are in conv.cuh.
#include "conv.cuh"

using namespace xgpr;
using namespace xgpr::conv;

// The C entry points.  x_hi/x_lo and proj_hi/proj_lo are the planes of
// the format `precision` names (a Format of tf32_gemm.cuh: TF32 splits,
// or bf16 values with the lo pointers unused; PREC_HIGHEST takes the TF32
// splits and runs FMT_TF32X3); any other precision, and
// for K3 any other sincos mode, is refused.
extern "C" int xgpr_conv_parts(const void* x_hi, const void* x_lo,
                               const int* order, const int* nk,
                               const void* proj_hi, const void* proj_lo,
                               const float* row_scale, float* c_out,
                               float* s_out, int n, int l, int dp, int width,
                               int f, float sigma, int mode, int precision,
                               void* stream) {
  const ConvArgs p{x_hi, x_lo, order, nk, proj_hi, proj_lo,
                   n,    l,    dp,    width, f};
  switch (precision) {
    case PREC_HIGHEST:
    case FMT_TF32X3:
      return launch_parts<FMT_TF32X3>(p, row_scale, c_out, s_out, sigma,
                                      mode, stream);
    case FMT_BF16:
      return launch_parts_bf16(p, row_scale, c_out, s_out, sigma, mode,
                               stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int xgpr_conv_maxpool(const void* x_hi, const void* x_lo,
                                 const int* order, const int* nk,
                                 const void* proj_hi, const void* proj_lo,
                                 float* out, int n, int l, int dp, int width,
                                 int f, int precision, void* stream) {
  const ConvArgs p{x_hi, x_lo, order, nk, proj_hi, proj_lo,
                   n,    l,    dp,    width, f};
  switch (precision) {
    case PREC_HIGHEST:
    case FMT_TF32X3:
      return launch_maxpool<FMT_TF32X3>(p, out, stream);
    case FMT_BF16:
      return launch_maxpool_bf16(p, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
