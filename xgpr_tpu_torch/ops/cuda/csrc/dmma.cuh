// The float64 fragment code of the library's DMMA kernels: K3 and K4's
// float64 body (conv_sync.cuh) and K1 and K2's float64 bodies
// (dense_f64.cuh).  One product is mma.sync.m16n8k8.f64, which reaches 64
// TFLOP/s of the card's 67 (tests/torch_port/dmma_rate.cu), twice the
// m8n8k4 shape.
//
// Operands are read from shared memory as 128-byte lines of depth (16
// float64 values a row) in the 128-byte swizzle (common.cuh: sw128).  Lane
// (g, t) = (lane / 4, lane % 4) reads 16 bytes, two values, of its rows a
// load, 16-byte chunk 2t + half of the line, and feeds them as the k = t
// and k = t + 4 of the half's product, so one load serves two depths and
// both operands take their depth in the same order.  A quarter warp's
// loads (rows g and g + 1, chunks of opposite parity after the swizzle)
// fall on distinct banks.
#pragma once

#include "common.cuh"

namespace xgpr {

// One DMMA: the 16 x 8 tile c += a (16 x 8) b (8 x 8) in float64; lane
// (g, t) holds a[g][t], a[g + 8][t], a[g][t + 4], a[g + 8][t + 4],
// b[t][g], b[t + 4][g] and c[g][2t, 2t + 1], c[g + 8][2t, 2t + 1]
// (tests/torch_port/dmma_rate.cu checks the layout on the card).
// Volatile, so that it keeps its place among the ring's barrier
// operations.
__device__ __forceinline__ void dmma16x8x8(double c[4], double a0, double a1,
                                           double a2, double a3, double b0,
                                           double b1) {
  double d0, d1, d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=d"(d0), "=d"(d1), "=d"(d2), "=d"(d3)
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1), "d"(c[0]),
        "d"(c[1]), "d"(c[2]), "d"(c[3]));
  c[0] = d0;
  c[1] = d1;
  c[2] = d2;
  c[3] = d3;
}

// The 16 bytes of chunk c of row r of a line.
__device__ __forceinline__ double2 line_chunk(const unsigned char* line,
                                              int r, int c) {
  return *reinterpret_cast<const double2*>(line + sw128(r, c));
}

// A warp's products over one line: MT x NT tiles of 16 x 8, tile (m, n)
// the rows arow + 16m + [0, 16) of line a by the rows brow + 8n + [0, 8)
// of line b (arow and brow the warp's first rows plus g), summed into
// acc[4 (NT m + n) .. + 3], the two 8-deep halves in order.  The warp must
// be converged (mma.sync.aligned).
template <int MT, int NT>
__device__ __forceinline__ void dmma_line(const unsigned char* a, int arow,
                                          const unsigned char* b, int brow,
                                          double* acc) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = 2 * t + half;
    double2 av[MT][2], bv[NT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) av[m][h] = line_chunk(a, arow + 16 * m + 8 * h, c);
#pragma unroll
    for (int n = 0; n < NT; ++n) bv[n] = line_chunk(b, brow + 8 * n, c);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        dmma16x8x8(&acc[4 * (NT * m + n)], av[m][0].x, av[m][1].x,
                   av[m][0].y, av[m][1].y, bv[n].x, bv[n].y);
  }
}

}  // namespace xgpr
