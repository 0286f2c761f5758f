// K3 and K4 in the bf16 format ("default": one bf16 pass, the TPU's
// DEFAULT dot); see conv.cuh.
#include "conv.cuh"

namespace xgpr {
namespace conv {

int launch_parts_bf16(const ConvArgs& p, const float* row_scale,
                      float* c_out, float* s_out, float sigma, int mode,
                      void* stream) {
  return launch_parts<FMT_BF16>(p, row_scale, c_out, s_out, sigma, mode,
                             stream);
}

int launch_maxpool_bf16(const ConvArgs& p, float* out, void* stream) {
  return launch_maxpool<FMT_BF16>(p, out, stream);
}

}  // namespace conv
}  // namespace xgpr
