// K3 and K4 in the float64 format (float64 operands: float64 DMMA on the
// tensor cores, the builtin sincos); see conv.cuh and fma_gemm.cuh.
#include "conv.cuh"

namespace xgpr {
namespace conv {

int launch_parts_f64(const ConvArgs& p, const double* row_scale,
                     double* c_out, double* s_out, double sigma, int mode,
                     void* stream) {
  return launch_parts<FMT_F64>(p, row_scale, c_out, s_out, sigma, mode,
                                 stream);
}

int launch_maxpool_f64(const ConvArgs& p, double* out, void* stream) {
  return launch_maxpool<FMT_F64>(p, out, stream);
}

}  // namespace conv
}  // namespace xgpr
