// K1 in the bf16 format ("default": one bf16 pass, the TPU's DEFAULT
// dot); see ztzv.cuh.
#include "ztzv.cuh"

namespace xgpr {
namespace ztzv {

int launch_bf16(const DenseOperands& p, const ZtzvArgs<float>& a,
                float* zv_part, float* oc_part, float* os_part, float* oc,
                float* os, int zsplit, int osplit, int mode, cudaStream_t st) {
  return launch<FMT_BF16>(p, a, zv_part, oc_part, os_part, oc, os, zsplit,
                          osplit, mode, st);
}

}  // namespace ztzv
}  // namespace xgpr
