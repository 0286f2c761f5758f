// K2 in the float64 format (float64 operands: float64 DMMA on the tensor
// cores, the builtin sincos); see feature_map.cuh.
#include "feature_map.cuh"

namespace xgpr {
namespace features {

int launch_f64(const DenseOperands& p, const FeatureArgs<double>& a,
               int rsplit, cudaStream_t stream) {
  return launch<FMT_F64, MODE_EXACT>(p, a, rsplit, stream);
}

}  // namespace features
}  // namespace xgpr
