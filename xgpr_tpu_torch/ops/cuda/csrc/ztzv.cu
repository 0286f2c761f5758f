// K1 in the 3xTF32 format ("high", the default) and K1's C entry point
// for every format; the kernels and their design are in ztzv.cuh.
#include "ztzv.cuh"

using namespace xgpr;
using namespace xgpr::ztzv;

// K1's C entry point.  x_hi/x_lo (n, dp) and proj_hi/proj_lo (f, dp) are
// the planes of x and of proj transposed in the format `precision` names
// (a Format of tf32_gemm.cuh: TF32 splits with dp % 4 == 0, or bf16 values
// with dp % 8 == 0 and the lo pointers unused; PREC_HIGHEST takes the TF32
// splits and runs FMT_TF32X3); zv_part is (zsplit, n, k);
// oc_part/os_part are (osplit, f, k); oc/os are (f, k), fp32.  All
// contiguous, on `stream`.  mode is a SincosMode (common.cuh); any other
// mode or precision is refused.
extern "C" int xgpr_ztzv(const void* x_hi, const void* x_lo, const float* m,
                         const void* proj_hi, const void* proj_lo,
                         float sigma, const float* vc, const float* vs,
                         float* zv_part, float* oc_part, float* os_part,
                         float* oc, float* os, int n, int dp, int f, int k,
                         int zsplit, int osplit, float scale, int intercept,
                         int mode, int precision, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  const ZtzvArgs a{m, vc, vs, sigma, scale, k, intercept};
  switch (precision) {
    case PREC_HIGHEST:
    case FMT_TF32X3:
      return launch<FMT_TF32X3>(p, a, zv_part, oc_part, os_part, oc, os,
                                zsplit, osplit, mode, st);
    case FMT_BF16:
      return launch_bf16(p, a, zv_part, oc_part, os_part, oc, os, zsplit,
                         osplit, mode, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
