// The row operands of K3 and K4's TMA pipelines (conv_ws.cuh: bf16;
// conv_tf32.cuh: 3xTF32), made on the card (ops/cuda/conv.py:
// tile_layout; its CPU branch is the plain version): nk_i = clamp(L_i - w
// + 1, 0, nw), the rows grouped by nk ascending, x's rows in that order
// with dp channels (zeros past d) as the body's planes, and each 64-row
// tile's largest nk.  Within one count the rows land in the order their
// atomics run: a row's outputs depend on its own windows alone, so any
// such order gives the same bits.  Four launches: count, scan, place, and
// the rows, which also round x to the body's planes in the same pass:
// - bf16: xt (n, l, dp) bf16, rounded to nearest even;
// - 3xTF32: xt (2, n, l, dp) float32, the TF32 high parts (to nearest,
//   ties away from zero: cvt.rna.tf32.f32, operands.py split_tf32) and
//   the remainders, hi + lo == x exactly.
// Included by one translation unit (conv_bf16.cu, with the entry point).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_common.cuh"

namespace xgpr {
namespace conv {
namespace layout {

constexpr int ROWS = 64;  // rows per tile (conv_ws.cuh, conv_tf32.cuh)

__device__ __forceinline__ int window_count(int length, int width, int nw) {
  return min(max(length - width + 1, 0), nw);
}

__global__ void count_kernel(const int* lengths, int n, int width, int nw,
                             int* hist) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) atomicAdd(&hist[window_count(lengths[i], width, nw)], 1);
}

// hist (nw + 1 counts) becomes their exclusive prefix sums.
__global__ void scan_kernel(int* hist, int bins) {
  int acc = 0;
  for (int b = 0; b < bins; ++b) {
    const int v = hist[b];
    hist[b] = acc;
    acc += v;
  }
}

__global__ void place_kernel(const int* lengths, int n, int width, int nw,
                             const int* start, int* cursor, int* order,
                             int* nk_t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = window_count(lengths[i], width, nw);
  const int pos = start[k] + atomicAdd(&cursor[k], 1);
  order[pos] = i;
  nk_t[pos] = k;
}

// v's TF32 high part, as operands.py _round_tf32 computes it.
__device__ __forceinline__ float tf32_hi(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & ~0x1FFFu);
}

// One block per row tile: its rows of x (n, l, d) float32 into xt in the
// body's planes, two channels a thread, and the tile's largest nk.
template <int FMT>
__global__ void rows_kernel(const float* x, const int* order,
                            const int* nk_t, int n, int l, int d, int dp,
                            void* xt, int* top) {
  __shared__ int s_top;
  const int row0 = blockIdx.x * ROWS;
  if (threadIdx.x == 0) s_top = 0;
  __syncthreads();
  if (threadIdx.x < ROWS && row0 + (int)threadIdx.x < n)
    atomicMax(&s_top, nk_t[row0 + threadIdx.x]);
  const int half = dp / 2, per = l * half;
  const size_t plane = (size_t)n * l * half;  // float2 pairs a plane
  for (int r = row0; r < min(row0 + ROWS, n); ++r) {
    const float* src = x + (size_t)order[r] * l * d;
    const size_t at = (size_t)r * per;
    for (int e = threadIdx.x; e < per; e += blockDim.x) {
      const int pos = e / half, ch = 2 * (e - pos * half);
      const float v0 = ch < d ? src[pos * d + ch] : 0.0f;
      const float v1 = ch + 1 < d ? src[pos * d + ch + 1] : 0.0f;
      if constexpr (FMT == FMT_BF16) {
        static_cast<__nv_bfloat162*>(xt)[at + e] =
            __floats2bfloat162_rn(v0, v1);
      } else {
        const float h0 = tf32_hi(v0), h1 = tf32_hi(v1);
        float2* out = static_cast<float2*>(xt);
        out[at + e] = make_float2(h0, h1);
        out[plane + at + e] = make_float2(v0 - h0, v1 - h1);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) top[blockIdx.x] = s_top;
}

// scratch: 2 * (l - width + 2) ints of the card; dp a multiple of 8
// (bf16) or 4 (3xTF32).
inline int tile_layout(const float* x, const int* lengths, int n, int l,
                       int d, int dp, int width, int body, void* xt,
                       int* order, int* nk_t, int* top, int* scratch,
                       void* stream) {
  const int multiple = body == FMT_BF16 ? 8 : 4;
  if (n <= 0 || dp % multiple != 0 || dp < d || l < width ||
      (body != FMT_BF16 && body != FMT_TF32X3))
    return (int)cudaErrorInvalidValue;
  const int nw = l - width + 1;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, 2 * (nw + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + 255) / 256;
  count_kernel<<<blocks, 256, 0, s>>>(lengths, n, width, nw, scratch);
  scan_kernel<<<1, 1, 0, s>>>(scratch, nw + 1);
  place_kernel<<<blocks, 256, 0, s>>>(lengths, n, width, nw, scratch,
                                      scratch + nw + 1, order, nk_t);
  const int tiles = (n + ROWS - 1) / ROWS;
  if (body == FMT_BF16)
    rows_kernel<FMT_BF16><<<tiles, 256, 0, s>>>(x, order, nk_t, n, l, d, dp,
                                                xt, top);
  else
    rows_kernel<FMT_TF32X3><<<tiles, 256, 0, s>>>(x, order, nk_t, n, l, d,
                                                  dp, xt, top);
  return (int)cudaGetLastError();
}

}  // namespace layout
}  // namespace conv
}  // namespace xgpr
