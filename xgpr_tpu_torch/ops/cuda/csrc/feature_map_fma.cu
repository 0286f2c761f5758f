// K2 in the fp32 CUDA-core format ("highest": fp32 FMAs, the "reference"
// preset's fp32-exact products); see feature_map.cuh and fma_gemm.cuh.
#include "feature_map.cuh"

namespace xgpr {
namespace features {

int launch_fma32(const DenseOperands& p, const FeatureArgs<float>& a,
                 int mode, int rsplit, cudaStream_t stream) {
  switch (mode) {
    case MODE_HI: return launch<FMT_FMA32, MODE_HI>(p, a, rsplit, stream);
    case MODE_EXACT:
      return launch<FMT_FMA32, MODE_EXACT>(p, a, rsplit, stream);
    case MODE_FAST: return launch<FMT_FMA32, MODE_FAST>(p, a, rsplit, stream);
    default: return launch<FMT_FMA32, MODE_POLY>(p, a, rsplit, stream);
  }
}

}  // namespace features
}  // namespace xgpr
