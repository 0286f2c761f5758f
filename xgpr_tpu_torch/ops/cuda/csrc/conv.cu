// Conv window-loop kernels for Hopper: K3 (masked cos/sin window sums) and
// K4 (ReLU + global max over windows).
//
// Replace the TPU kernels xgpr_tpu/ops/pallas/conv_pallas.py:
//   K3 _conv_parts_kernel   (pallas_call in _conv_parts_impl)
//   K4 _conv_maxpool_kernel (pallas_call in _conv_maxpool_impl)
// For zero-padded sequences x (N, L, D), lengths (N,) int32 and the dense
// projection proj (w*D, F) in window-major row order (row t*D + c), chi
// folded in, with nw = L - w + 1 windows and nk_i = lengths_i - w + 1:
//
//   g[i, j, :] = x[i, j : j + w, :].flatten() @ proj        (j < nw)
//   K3: c[i, f] = scale_i * sum_{j < nk_i} cos(g[i, j, f] * sigma)
//       s[i, f] = scale_i * sum_{j < nk_i} sin(g[i, j, f] * sigma)
//   K4: out[i, f] = max(0, max_{j < nk_i} g[i, j, f])
//
// scale_i is the optional per-row epilogue scale (averaging factor times
// rbf_norm_constant; 1 when the pointer is null).  Masked windows add 0 to
// K3 and are -inf against K4's zero start, the implicit ReLU of
// conv_pallas.py:157-164.
//
// Design.  The TPU kernel builds a w-times larger im2col array and walks the
// window blocks in grid order into resident accumulators.  Here no im2col
// array exists: window j of row i is the contiguous slice
// x[i, j*D : (j+w)*D] of the flattened row, already in proj's t*D + c
// order, so the window projections are a GEMM whose A rows are the
// sequences at row stride L*D, starting j*D in.  One block owns a 64-row by
// 64-frequency tile and loops over the windows itself; each window is the
// shared fp32 tile projection of common.cuh (TK-deep slices of x and proj
// staged in shared memory, a 4 x 4 micro-tile per thread), and its sincos
// (K3) or max (K4) folds into register accumulators.  Every output is
// written once, with no atomics, so results are the same from run to run.
// The window loop stops at the largest nk_i of the block's rows, so padded
// windows past every row's length cost nothing.  A 64-row tile's (L x D)
// slabs (256 KB at L 16, D 64) exceed shared memory, so each window's
// slices are re-read through L1/L2 rather than staged once.
//
// What bounds it on the H100: at the motif slice (8192 rows, L 16, D 64,
// w 9, F 4096) the projection is 309 GFLOP of fp32 FMAs (4.6 ms at the
// 67 TFLOP/s CUDA-core peak) against 34 MB of x, 9.4 MB of proj and 268 MB
// of outputs (0.09 ms at 3.35 TB/s): compute-bound.  K4 at F 1024 is
// 77 GFLOP, compute-bound too.  Tensor-core (3xTF32 / wgmma) projections
// and a shared-memory slab are later work.
#include "common.cuh"

using namespace xgpr;

namespace {

// Window counts of this thread's rows, and the block's largest.
__device__ __forceinline__ int row_windows(const int* __restrict__ lengths,
                                           int n, int row0, int ty,
                                           int width, int nw, int nk[4]) {
  __shared__ int block_max;
  if (threadIdx.x == 0) block_max = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    nk[i] = r < n ? max(0, min(lengths[r] - width + 1, nw)) : 0;
  }
  if (threadIdx.x % 16 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) atomicMax(&block_max, nk[i]);
  }
  __syncthreads();
  return block_max;
}

__global__ void __launch_bounds__(NT)
    conv_parts_kernel(const float* __restrict__ x,
                      const int* __restrict__ lengths,
                      const float* __restrict__ proj,
                      const float* __restrict__ row_scale,
                      float* __restrict__ c_out, float* __restrict__ s_out,
                      int n, int l, int d, int width, int f, float sigma,
                      int exact) {
  __shared__ TileSmem sm;
  const int row0 = blockIdx.x * TM, f0 = blockIdx.y * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nw = l - width + 1, wd = width * d;
  const size_t lda = (size_t)l * d;
  int nk[4];
  const int nwin = row_windows(lengths, n, row0, ty, width, nw, nk);

  float cs[4][4], sn[4][4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cs[i][j] = sn[i][j] = 0.0f;

  for (int win = 0; win < nwin; ++win) {
    project_tile_strided(x + (size_t)win * d, lda, proj, n, wd, f, row0, f0,
                         ty, tx, sm, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (win >= nk[i]) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float cv, sv;
        sincos_scaled(acc[i][j] * sigma, 1.0f, exact, &cv, &sv);
        cs[i][j] += cv;
        sn[i][j] += sv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
    const float w = row_scale ? row_scale[r] : 1.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int fj = f0 + tx + 16 * j;
      if (fj >= f) continue;
      c_out[(size_t)r * f + fj] = cs[i][j] * w;
      s_out[(size_t)r * f + fj] = sn[i][j] * w;
    }
  }
}

__global__ void __launch_bounds__(NT)
    conv_maxpool_kernel(const float* __restrict__ x,
                        const int* __restrict__ lengths,
                        const float* __restrict__ proj,
                        float* __restrict__ out, int n, int l, int d,
                        int width, int f) {
  __shared__ TileSmem sm;
  const int row0 = blockIdx.x * TM, f0 = blockIdx.y * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nw = l - width + 1, wd = width * d;
  const size_t lda = (size_t)l * d;
  int nk[4];
  const int nwin = row_windows(lengths, n, row0, ty, width, nw, nk);

  float mx[4][4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[i][j] = 0.0f;

  for (int win = 0; win < nwin; ++win) {
    project_tile_strided(x + (size_t)win * d, lda, proj, n, wd, f, row0, f0,
                         ty, tx, sm, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (win >= nk[i]) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) mx[i][j] = fmaxf(mx[i][j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int fj = f0 + tx + 16 * j;
      if (fj < f) out[(size_t)r * f + fj] = mx[i][j];
    }
  }
}

}  // namespace

extern "C" int xgpr_conv_parts(const float* x, const int* lengths,
                               const float* proj, const float* row_scale,
                               float* c_out, float* s_out, int n, int l,
                               int d, int width, int f, float sigma,
                               int exact, void* stream) {
  const dim3 grid((n + TM - 1) / TM, (f + TN - 1) / TN);
  conv_parts_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, lengths, proj, row_scale, c_out, s_out, n, l, d, width, f, sigma,
      exact);
  return (int)cudaGetLastError();
}

extern "C" int xgpr_conv_maxpool(const float* x, const int* lengths,
                                 const float* proj, float* out, int n, int l,
                                 int d, int width, int f, void* stream) {
  const dim3 grid((n + TM - 1) / TM, (f + TN - 1) / TN);
  conv_maxpool_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, lengths, proj, out, n, l, d, width, f);
  return (int)cudaGetLastError();
}
