// K3 and K4 in the float64 format (float64 operands: DMMA on the tensor
// cores, the builtin sincos); see conv_sync.cuh.  The C entry points are
// in conv_fma.cu.
#include "conv_sync.cuh"

namespace xgpr {
namespace conv {
namespace sync {

int launch_parts_f64(const Args& p, const double* row_scale, double* c_out,
                     double* s_out, double sigma, int mode, void* stream) {
  return launch_parts<DmmaTile>(p, row_scale, c_out, s_out, sigma, mode,
                                stream);
}

int launch_maxpool_f64(const Args& p, double* out, void* stream) {
  return launch_maxpool<DmmaTile>(p, out, stream);
}

}  // namespace sync
}  // namespace conv
}  // namespace xgpr
