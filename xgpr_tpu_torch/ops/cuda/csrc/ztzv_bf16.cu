// K1 in the bf16 format ("default": one bf16 pass, the TPU's DEFAULT
// dot) on the warp-specialised TMA pipeline of dense_wgmma.cuh; what the
// kernels compute is in ztzv.cuh.
#include "dense_wgmma.cuh"

namespace xgpr {
namespace ztzv {

int launch_bf16(const DenseOperands& p, const ZtzvArgs<float>& a,
                float* zv_part, float* oc_part, float* os_part, float* oc,
                float* os, int zsplit, int osplit, int mode, cudaStream_t st) {
  return dense::launch_k1<FMT_BF16>(p, a, zv_part, oc_part, os_part, oc, os,
                                    zsplit, osplit, mode, st);
}

}  // namespace ztzv
}  // namespace xgpr
