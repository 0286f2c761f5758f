// K2 in the 3xTF32 format (float32 operands, every preset) and K2's C
// entry point for both formats; the kernel and its design are in
// feature_map.cuh.
#include "feature_map.cuh"

using namespace xgpr;
using namespace xgpr::features;

// K2's C entry point.  x_hi/x_lo (n, dp) and proj_hi/proj_lo (f, dp) are
// the planes of x and of proj transposed in the format `body` names
// (tf32_gemm.cuh: Format): FMT_TF32X3, TF32 splits of float32 values with
// dp % 4 == 0, out float32; FMT_F64, float64 values with dp % 2 == 0 and
// the lo pointers unused, out float64.  out is (n, 2f); rsplit blocks
// share each frequency tile's row tiles; mode is a SincosMode
// (common.cuh), which the float64 body reads as the builtin.  Any other
// mode or body is refused.
extern "C" int xgpr_feature_map(const void* x_hi, const void* x_lo,
                                const void* proj_hi, const void* proj_lo,
                                void* out, int n, int dp, int f, int padded,
                                double scale, int mode, int body, int rsplit,
                                void* stream) {
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode < MODE_HI || mode > MODE_POLY) return (int)cudaErrorInvalidValue;
  if (body == FMT_F64)
    return launch_f64(p, {static_cast<double*>(out), padded, scale}, rsplit,
                      st);
  if (body != FMT_TF32X3) return (int)cudaErrorInvalidValue;
  const FeatureArgs<float> a{static_cast<float*>(out), padded, (float)scale};
  switch (mode) {
    case MODE_HI: return launch<FMT_TF32X3, MODE_HI>(p, a, rsplit, st);
    case MODE_EXACT: return launch<FMT_TF32X3, MODE_EXACT>(p, a, rsplit, st);
    case MODE_FAST: return launch<FMT_TF32X3, MODE_FAST>(p, a, rsplit, st);
    default: return launch<FMT_TF32X3, MODE_POLY>(p, a, rsplit, st);
  }
}
