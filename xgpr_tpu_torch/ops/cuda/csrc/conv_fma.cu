// K3 and K4 in the fp32 CUDA-core format ("highest": fp32 FMAs, the
// "reference" preset's fp32-exact products); see conv.cuh and
// fma_gemm.cuh.
#include "conv.cuh"

namespace xgpr {
namespace conv {

int launch_parts_fma32(const ConvArgs& p, const float* row_scale,
                       float* c_out, float* s_out, float sigma, int mode,
                       void* stream) {
  return launch_parts<FMT_FMA32>(p, row_scale, c_out, s_out, sigma, mode,
                                 stream);
}

int launch_maxpool_fma32(const ConvArgs& p, float* out, void* stream) {
  return launch_maxpool<FMT_FMA32>(p, out, stream);
}

}  // namespace conv
}  // namespace xgpr
