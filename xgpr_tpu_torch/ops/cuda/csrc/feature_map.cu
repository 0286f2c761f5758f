// K2 in the 3xTF32 format (float32 operands, "high" and "default": the
// warp-specialised TMA pipeline of dense_wgmma.cuh) and K2's C entry point
// for every format; what the kernel computes is in feature_map.cuh.
#include "dense_wgmma.cuh"

using namespace xgpr;
using namespace xgpr::features;

// K2's C entry point.  x_hi/x_lo (n, dp) and proj_hi/proj_lo (f, dp) are
// the planes of x and of proj transposed in the format `body` names
// (gemm_common.cuh: Format): FMT_TF32X3, TF32 splits of float32 values with
// dp % 4 == 0, out float32; FMT_FMA32, x^T (dp, np) in x_hi and proj
// (dp, fp) in proj_hi, float32 (np and fp n and f rounded up to multiples
// of 4), the lo pointers unused, out float32; FMT_F64, float64 values with
// dp % 2 == 0 and the lo pointers unused, out float64.  out is (n, 2f);
// rsplit blocks share each frequency tile's 128-row tiles (in 3xTF32 a
// block's two consumers take their halves); mode is a SincosMode
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
  const FeatureArgs<float> a{static_cast<float*>(out), padded, (float)scale};
  if (body == FMT_FMA32) return launch_fma32(p, a, mode, rsplit, st);
  if (body != FMT_TF32X3) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case MODE_HI: return dense::launch_k2<MODE_HI>(p, a, rsplit, st);
    case MODE_EXACT: return dense::launch_k2<MODE_EXACT>(p, a, rsplit, st);
    case MODE_FAST: return dense::launch_k2<MODE_FAST>(p, a, rsplit, st);
    default: return dense::launch_k2<MODE_POLY>(p, a, rsplit, st);
  }
}
