// K1 in the 3xTF32 format ("high" and "highest", the default) and K1's C
// entry point for every format; the kernels and their design are in
// ztzv.cuh.
#include "ztzv.cuh"

using namespace xgpr;
using namespace xgpr::ztzv;

// K1's C entry point.  x_hi/x_lo (n, dp) and proj_hi/proj_lo (f, dp) are
// the planes of x and of proj transposed in the format `body` names
// (tf32_gemm.cuh: Format): FMT_TF32X3, TF32 splits with dp % 4 == 0;
// FMT_BF16, bf16 values with dp % 8 == 0; FMT_F64, float64 values with
// dp % 2 == 0 (the lo pointers unused by both).  m (n,), vc/vs (f, k),
// zv_part (zsplit, n, k), oc_part/os_part (osplit, f, k) and oc/os (f, k)
// are float32, or float64 for FMT_F64, whose sincos is the builtin in
// every mode.  All contiguous, on `stream`.  mode is a SincosMode
// (common.cuh); any other mode or body is refused.
extern "C" int xgpr_ztzv(const void* x_hi, const void* x_lo, const void* m,
                         const void* proj_hi, const void* proj_lo,
                         double sigma, const void* vc, const void* vs,
                         void* zv_part, void* oc_part, void* os_part,
                         void* oc, void* os, int n, int dp, int f, int k,
                         int zsplit, int osplit, double scale, int intercept,
                         int mode, int body, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  if (body == FMT_F64) {
    if (mode < MODE_HI || mode > MODE_POLY)
      return (int)cudaErrorInvalidValue;
    const ZtzvArgs<double> a{static_cast<const double*>(m),
                             static_cast<const double*>(vc),
                             static_cast<const double*>(vs), sigma, scale, k,
                             intercept};
    return launch_f64(p, a, static_cast<double*>(zv_part),
                      static_cast<double*>(oc_part),
                      static_cast<double*>(os_part), static_cast<double*>(oc),
                      static_cast<double*>(os), zsplit, osplit, st);
  }
  const ZtzvArgs<float> a{static_cast<const float*>(m),
                          static_cast<const float*>(vc),
                          static_cast<const float*>(vs), (float)sigma,
                          (float)scale, k, intercept};
  float* const parts[5] = {static_cast<float*>(zv_part),
                           static_cast<float*>(oc_part),
                           static_cast<float*>(os_part),
                           static_cast<float*>(oc), static_cast<float*>(os)};
  switch (body) {
    case FMT_TF32X3:
      return launch<FMT_TF32X3>(p, a, parts[0], parts[1], parts[2], parts[3],
                                parts[4], zsplit, osplit, mode, st);
    case FMT_BF16:
      return launch_bf16(p, a, parts[0], parts[1], parts[2], parts[3],
                         parts[4], zsplit, osplit, mode, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Right-hand sides one block of K1's pass (a) (pass == 0) or pass (b)
// (pass == 1) carries in format `body` at K right-hand sides (the same in
// both passes): 1 at K 1 in float32 (the one-rhs passes), else 8 NT
// (mma_nt: 8 up to K 8, then 16 in 3xTF32, 32 in bf16), and 8 f64_nt for
// float64 (8 up to K 8, then 32); the wrapper sizes its split of the
// walks by it (ops/cuda/ztzv.py: launch_plan).
extern "C" int xgpr_ztzv_rhs_per_block(int body, int k, int pass) {
  (void)pass;
  if (body == FMT_F64) return 8 * f64_nt(k);
  if (k == 1) return 1;
  return 8 * mma_nt(body, k);
}
