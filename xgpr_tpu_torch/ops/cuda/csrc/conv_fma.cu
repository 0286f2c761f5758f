// K3 and K4 in the fp32 CUDA-core format ("highest": fp32 FMAs, the
// "reference" preset's fp32-exact products), and the C entry points of the
// synchronous kernel in both its formats (the float64 launches are in
// conv_f64.cu); the kernel and its design are in conv_sync.cuh.
#include "conv_sync.cuh"

using namespace xgpr;
using namespace xgpr::conv::sync;

// x, proj and the other operands as conv_sync.cuh's Args lays them out
// for the format `body` names (gemm_common.cuh: Format): FMT_FMA32 (float32
// row_scale, outputs and sigma; fp the row stride of proj) or FMT_F64
// (float64; the builtin sincos in every mode).  Any other body, and for
// K3 any other sincos mode, is refused.
extern "C" int xgpr_conv_parts_sync(const void* x, const int* order,
                                    const int* nk, const void* proj,
                                    const void* row_scale, void* c_out,
                                    void* s_out, int n, int l, int d,
                                    int width, int f, int fp, double sigma,
                                    int mode, int body, void* stream) {
  const Args p{x, order, nk, proj, n, l, d, width, f, fp};
  if (body == FMT_F64)
    return launch_parts_f64(p, static_cast<const double*>(row_scale),
                            static_cast<double*>(c_out),
                            static_cast<double*>(s_out), sigma, mode,
                            stream);
  if (body == FMT_FMA32)
    return launch_parts<FmaTile>(p, static_cast<const float*>(row_scale),
                                 static_cast<float*>(c_out),
                                 static_cast<float*>(s_out), (float)sigma,
                                 mode, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int xgpr_conv_maxpool_sync(const void* x, const int* order,
                                      const int* nk, const void* proj,
                                      void* out, int n, int l, int d,
                                      int width, int f, int fp, int body,
                                      void* stream) {
  const Args p{x, order, nk, proj, n, l, d, width, f, fp};
  if (body == FMT_F64)
    return launch_maxpool_f64(p, static_cast<double*>(out), stream);
  if (body == FMT_FMA32)
    return launch_maxpool<FmaTile>(p, static_cast<float*>(out), stream);
  return (int)cudaErrorInvalidValue;
}
