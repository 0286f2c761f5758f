// Dense RBF feature map for Hopper (K2).
//
// Replaces the TPU kernel xgpr_tpu/ops/pallas/sorf_pallas.py:_feature_kernel
// (pallas_call in _rbf_feature_map_impl).  For sigma-scaled rows x (N, D)
// and the dense projection proj (D, F), chi folded in:
//
//   arg = x @ proj
//   out[r, blockstart(f) + f_in_block]          = cos(arg[r, f]) * scale
//   out[r, blockstart(f) + width(f) + f_in_block] = sin(arg[r, f]) * scale
//
// i.e. straight into the block [cos b | sin b] layout of ops/layout.py, for
// any block split, including a ragged last block (the Pallas gate rejects
// that case), and any D (edges are masked; no padded copies).
//
// What bounds it on the H100: at the slice's shape (8192 x 84 rows,
// F = 4096) it reads 2.8 MB, writes 268 MB of features and does 5.6 GFLOP
// of fp32 FMAs plus 33M sincos pairs: the write and the CUDA-core FMAs are
// of the same order (~0.08 ms at 3.35 TB/s against ~0.1 ms at 67 TFLOP/s),
// so neither can be ignored.  The design keeps arg in registers (no (N, F)
// intermediate reaches device memory) and writes each feature once,
// coalesced along the frequency axis.  The projection runs on CUDA cores
// in fp32; tensor-core (3xTF32 / wgmma) projection is later work.
#include "common.cuh"

using namespace xgpr;

__global__ void __launch_bounds__(NT)
    feature_map_kernel(const float* __restrict__ x,
                       const float* __restrict__ proj,
                       float* __restrict__ out, int n, int d, int f,
                       int padded, float scale, int exact) {
  __shared__ TileSmem sm;
  const int row0 = blockIdx.x * TM, f0 = blockIdx.y * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
  project_tile(x, proj, n, d, f, row0, f0, ty, tx, sm, acc);

  const size_t ld = 2 * (size_t)f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int fj = f0 + tx + 16 * j;
    if (fj >= f) continue;
    const int blk = fj / padded;
    const int width = min(padded, f - blk * padded);
    const size_t col = (size_t)fj + (size_t)blk * padded;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      if (r >= n) continue;
      float c, s;
      sincos_scaled(acc[i][j], scale, exact, &c, &s);
      out[r * ld + col] = c;
      out[r * ld + col + width] = s;
    }
  }
}

extern "C" int xgpr_feature_map(const float* x, const float* proj, float* out,
                                int n, int d, int f, int padded, float scale,
                                int exact, void* stream) {
  const dim3 grid((n + TM - 1) / TM, (f + TN - 1) / TN);
  feature_map_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, proj, out, n, d, f, padded, scale, exact);
  return (int)cudaGetLastError();
}
