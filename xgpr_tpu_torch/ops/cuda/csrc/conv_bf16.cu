// K3 and K4 in the bf16 format ("default": one bf16 pass, the TPU's
// DEFAULT dot), on the warp-specialised pipeline of conv_ws.cuh, and
// their C entry points (the other formats' are in conv.cu and
// conv_fma.cu): the row operands' layout of both TMA pipelines (this body's
// and the 3xTF32 body's, conv_tf32.cuh), then each kernel.
#include "conv_layout.cuh"
#include "conv_ws.cuh"

using namespace xgpr;
using namespace xgpr::conv;

// The row operands of the TMA pipelines (conv_layout.cuh) from x (n, l, d)
// float32 and the lengths (n,) int32, for the body `body` (FMT_BF16: xt
// (n, l, dp) bf16; FMT_TF32X3: xt (2, n, l, dp) float32, the TF32 high
// parts then the remainders): order and nk_t (n,) int32, top (ceil(n /
// 64),) int32; scratch holds 2 * (l - width + 2) ints.
extern "C" int xgpr_conv_tile_layout(const void* x, const int* lengths,
                                     int n, int l, int d, int dp, int width,
                                     int body, void* xt, int* order,
                                     int* nk_t, int* top, int* scratch,
                                     void* stream) {
  return layout::tile_layout(static_cast<const float*>(x), lengths, n, l, d,
                             dp, width, body, xt, order, nk_t, top, scratch,
                             stream);
}

// xt: (n, l, dp) bf16, the rows in tile order (row r is input row
// order[r]); nk: (n,) their valid windows; top: (ceil(n / 64),) each
// 64-row tile's largest nk; projT: (f, width * dp) bf16, K-major.
// row_scale (may be null) and the outputs are float32, indexed by input
// row.  resident, stages and split are the host's plan
// (ops/cuda/conv.py: ws_plan); a plan the kernel cannot run, and for K3
// an unknown sincos mode, are refused.
extern "C" int xgpr_conv_parts_ws(const void* xt, const int* order,
                                  const int* nk, const int* top,
                                  const void* projT, const void* row_scale,
                                  void* c_out, void* s_out, int n, int l,
                                  int dp, int width, int f, double sigma,
                                  int mode, int resident, int stages,
                                  int split, void* stream) {
  const ws::Args p{order, nk,    top,      n,      l,    dp,
                   width, f,     resident, stages, split};
  const float* rs = static_cast<const float*>(row_scale);
  float* c = static_cast<float*>(c_out);
  float* s = static_cast<float*>(s_out);
  const float sg = (float)sigma;
  switch (mode) {
    case MODE_HI:
      return ws::launch<PartsEpilogue<float, MODE_HI, 2, 8>>(
          p, xt, projT, {rs, c, s, sg}, stream);
    case MODE_EXACT:
      return ws::launch<PartsEpilogue<float, MODE_EXACT, 2, 8>>(
          p, xt, projT, {rs, c, s, sg}, stream);
    case MODE_FAST:
      return ws::launch<PartsEpilogue<float, MODE_FAST, 2, 8>>(
          p, xt, projT, {rs, c, s, sg}, stream);
    case MODE_POLY:
      return ws::launch<PartsEpilogue<float, MODE_POLY, 2, 8>>(
          p, xt, projT, {rs, c, s, sg}, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int xgpr_conv_maxpool_ws(const void* xt, const int* order,
                                    const int* nk, const int* top,
                                    const void* projT, void* out, int n,
                                    int l, int dp, int width, int f,
                                    int resident, int stages, int split,
                                    void* stream) {
  const ws::Args p{order, nk,    top,      n,      l,    dp,
                   width, f,     resident, stages, split};
  return ws::launch<MaxpoolEpilogue<float, 2, 8>>(
      p, xt, projT, {static_cast<float*>(out)}, stream);
}
