// K1 in the float64 format (float64 operands: the projections and the
// contractions on m16n8k8 DMMA, the builtin sincos); see ztzv.cuh and
// dense_f64.cuh.
#include "ztzv.cuh"

namespace xgpr {
namespace ztzv {

int launch_f64(const DenseOperands& p, const ZtzvArgs<double>& a,
               double* zv_part, double* oc_part, double* os_part, double* oc,
               double* os, int zsplit, int osplit, cudaStream_t st) {
  if (f64_nt(a.k) == 1)
    return (int)launch_all_f64<1>(p, a, zv_part, oc_part, os_part, oc, os,
                                  zsplit, osplit, st);
  return (int)launch_all_f64<4>(p, a, zv_part, oc_part, os_part, oc, os,
                                zsplit, osplit, st);
}

}  // namespace ztzv
}  // namespace xgpr
