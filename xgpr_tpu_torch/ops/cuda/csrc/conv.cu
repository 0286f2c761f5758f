// Conv window-loop kernels for Hopper: K3 (masked cos/sin window sums) and
// K4 (ReLU + global max over windows), one implicit-GEMM body on the
// tensor cores at fp32 grade (3xTF32 wgmma), templated on the epilogue.
//
// Replace the TPU kernels xgpr_tpu/ops/pallas/conv_pallas.py:
//   K3 _conv_parts_kernel   (pallas_call in _conv_parts_impl)
//   K4 _conv_maxpool_kernel (pallas_call in _conv_maxpool_impl)
// For zero-padded sequences x (N, L, D), the dense projection (w*D, F) in
// window-major row order (row t*D + c), chi folded in, nw = L - w + 1
// windows and nk_i = clamp(lengths_i - w + 1, 0, nw):
//
//   g[i, j, :] = x[i, j : j + w, :].flatten() @ proj        (j < nw)
//   K3: c[i, f] = scale_i * sum_{j < nk_i} cos(g[i, j, f] * sigma)
//       s[i, f] = scale_i * sum_{j < nk_i} sin(g[i, j, f] * sigma)
//   K4: out[i, f] = max(0, max_{j < nk_i} g[i, j, f])
//
// scale_i is the optional per-row scale (averaging factor times
// rbf_norm_constant; 1 when the pointer is null).  Masked windows add 0 to
// K3 and are -inf against K4's zero start, the implicit ReLU of
// conv_pallas.py:157-164.
//
// What bounds it on the H100.  At the motif slice (8192 rows, L 16, D 64,
// w 9, F 4096) the valid windows need 173 GFLOP of fp32-grade products
// against 34 MB of x, 9.4 MB of proj and 268 MB of outputs (0.09 ms at
// 3.35 TB/s): bound by operations.  On CUDA cores (67 TFLOP/s) that is
// 2.6 ms; on the tensor cores, three TF32 products per multiply-add at
// 495 TFLOP/s, 1.05 ms.
//
// Design (the wrapper in ../conv.py prepares the operands):
// - Implicit GEMM with no im2col array.  GEMM rows are (sequence, window)
//   pairs, the depth is (tap t, channel c), the columns are frequencies.
//   For tap t and channels c0 : c0 + 32 the A slice of a tile is
//   x[rows, j0 + t : j0 + t + WG, c0 : c0 + 32], a box of the input, and
//   the B slice projT[f0 : f0 + 128, t*D + c0 : + 32] serves every
//   (sequence, window) row of the tile: B is read once per depth step per
//   tile, not once per window.  cp.async brings both, as 128-byte rows in
//   the 128-byte swizzle, into a 3-stage ring of shared memory.
// - 3xTF32 on wgmma.m64n128k8, the body of tf32_gemm.cuh (shared with K1
//   and K2): the wrapper splits x and projT into TF32 high parts and
//   remainders, both operands are read from shared memory, and step s's
//   products run while the block waits for step s + 1's copies and issues
//   step s + 2's.  This file gives it the row policy (which box of x a
//   GEMM row reads) and the epilogues.  The register-A form (x split in
//   registers, no extra bytes) leaves too few registers for products in
//   flight; it measured slower (PERF.md).
// - Rows ordered by window count.  The wrapper passes a stable order of
//   the rows by nk; a tile is 64 consecutive rows of that order, so its
//   rows have near-equal nk, and it loops over groups of WG = 2 windows
//   only up to its own largest nk.  At the motif slice that projects
//   1.12 window slots per valid window instead of 1.79.  Outputs go to
//   each row's own index, so callers see the input order.
// - Epilogue on the accumulator fragment.  Both windows of a group sit in
//   the same thread's registers (accumulator rows g and g + 8 of a warp),
//   so K3's sincos sums and K4's max fold into register accumulators at
//   the end of each group, and each output is written once, with no
//   atomics: results are the same from run to run.  K3's epilogue is
//   instantiated once per sincos mode of xgpr_tpu's switch ("hi", "exact",
//   "fast", "poly"; common.cuh), chosen on the host at launch.
// - Any shape: rows past N, windows past nw, channel chunks past D and
//   frequencies past F are zero-filled by the copies and masked at the
//   store.  The wrapper pads D to a multiple of 4 (16-byte copies).
#include <stdint.h>

#include "common.cuh"
#include "tf32_gemm.cuh"

using namespace xgpr;

namespace {

constexpr int WR = 64;      // sequences per tile
constexpr int WG = GM / WR;  // windows per group: GM GEMM rows per tile

struct ConvArgs {
  const float* x_hi;     // (n, l, dp), dp % 4 == 0: TF32 high parts
  const float* x_lo;     // the same, remainders
  const int* order;      // (n,) rows in tile order
  const int* nk;         // (n,) valid windows of each row, in [0, nw]
  const float* proj_hi;  // (f, width * dp), K-major: TF32 high parts
  const float* proj_lo;  // the same, remainders
  int n, l, dp, width, f;
};

// K3: running cos/sin sums of this thread's sequence x 32 frequencies, in
// one sincos mode (common.cuh).
template <int MODE>
struct PartsEpilogue {
  struct Args {
    const float* row_scale;
    float* c_out;
    float* s_out;
    float sigma;
  };
  Args a;
  float cs[16][2], sn[16][2];

  __device__ __forceinline__ explicit PartsEpilogue(const Args& args)
      : a(args) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) cs[j][e] = sn[j][e] = 0.0f;
  }
  __device__ __forceinline__ void fold(int j, int e, float g) {
    float c, s;
    sincos_scaled<MODE>(g * a.sigma, 1.0f, &c, &s);
    cs[j][e] += c;
    sn[j][e] += s;
  }
  __device__ __forceinline__ float row_factor(int row) const {
    return a.row_scale ? a.row_scale[row] : 1.0f;
  }
  __device__ __forceinline__ void store(size_t at, float w, int j,
                                        int e) const {
    a.c_out[at] = cs[j][e] * w;
    a.s_out[at] = sn[j][e] * w;
  }
};

// K4: running max against a zero start.
struct MaxpoolEpilogue {
  struct Args {
    float* out;
  };
  Args a;
  float mx[16][2];

  __device__ __forceinline__ explicit MaxpoolEpilogue(const Args& args)
      : a(args) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) mx[j][e] = 0.0f;
  }
  __device__ __forceinline__ void fold(int j, int e, float g) {
    mx[j][e] = fmaxf(mx[j][e], g);
  }
  __device__ __forceinline__ float row_factor(int) const { return 1.0f; }
  __device__ __forceinline__ void store(size_t at, float, int j,
                                        int e) const {
    a.out[at] = mx[j][e];
  }
};

// One block: 64 sequences (rows order[row0 : row0 + 64]) x 128 frequencies,
// two warpgroups of 32 sequences each.  Warp q of warpgroup w owns the 16
// GEMM rows of sequences s = 32w + 8q + [0, 8), row window * 8 + s % 8, so
// lane (g, t) = (lane / 4, lane % 4) holds sequence 32w + 8q + g for both
// windows of the group (accumulator rows g and g + 8) and frequencies
// 8j + 2t + e.  A's shared rows follow the same order:
// (s / 8) * 16 + window * 8 + s % 8.
template <class Epi>
__global__ void __launch_bounds__(GT, 1)
    conv_window_kernel(ConvArgs p, typename Epi::Args ea) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int s_row[WR], s_nk[WR], s_nkmax;
  unsigned char* smem = ring_base(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int seq = (tid / 32) * 8 + g;  // this thread's sequence in the tile
  const int row0 = blockIdx.x * WR, f0 = blockIdx.y * GN;
  const int nw = p.l - p.width + 1;
  const int kdim = p.width * p.dp;

  if (tid == 0) s_nkmax = 0;
  if (tid < WR) {
    const int r = row0 + tid;
    const int orig = r < p.n ? p.order[r] : 0;
    s_row[tid] = orig;
    s_nk[tid] = r < p.n ? p.nk[orig] : 0;
  }
  __syncthreads();
  if (tid < WR) atomicMax(&s_nkmax, s_nk[tid]);
  __syncthreads();

  // Copy assignment: 16-byte chunk lc of a 32-channel row; sequences lr and
  // lr + 32 (both windows), and frequencies lr + 32q, hi and lo each.
  const int lc = tid % 8, lr = tid / 8;
  size_t xoff[2];
  bool xok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = lr + 32 * h;
    xok[h] = row0 + s < p.n;
    xoff[h] = (size_t)s_row[s] * p.l * p.dp;
  }
  size_t boff[4];
  bool bok[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int fr = f0 + lr + 32 * q;
    bok[q] = fr < p.f;
    boff[q] = (size_t)(bok[q] ? fr : 0) * kdim;
  }

  const int kc = (p.dp + GK - 1) / GK;  // channel chunks per tap
  const int spg = p.width * kc;         // pipeline steps per window group
  const int nsteps = (s_nkmax + WG - 1) / WG * spg;

  // Row policy: GEMM row (s / 8) * 16 + window * 8 + s % 8 of a step is
  // window j0 + window of sequence s at tap `tap`, channels c : c + 32.
  auto load_stage = [&](int step, unsigned char* st) {
    const int gi = step / spg, rem = step - gi * spg;
    const int tap = rem / kc, c = (rem - tap * kc) * GK + 4 * lc;
    const int j0 = gi * WG;
    const bool cok = c < p.dp;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = bok[q] && cok;
      const size_t off = ok ? boff[q] + tap * p.dp + c : 0;
      const int dst = sw128(lr + 32 * q, lc);
      cp_async16(st + dst, p.proj_hi + off, ok);
      cp_async16(st + B_BYTES + dst, p.proj_lo + off, ok);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int win = 0; win < WG; ++win) {
        const int s = lr + 32 * h;
        const bool ok = xok[h] && cok && j0 + win < nw;
        const size_t off =
            ok ? xoff[h] + (size_t)(j0 + win + tap) * p.dp + c : 0;
        const int dst =
            2 * B_BYTES + sw128((s / 8) * 16 + win * 8 + s % 8, lc);
        cp_async16(st + dst, p.x_hi + off, ok);
        cp_async16(st + A_BYTES + dst, p.x_lo + off, ok);
      }
  };

  const int nk_s = s_nk[seq];
  Epi epi(ea);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // A finished window group folds its valid windows into the epilogue.
  tf32_pipeline(smem, nsteps, spg, acc, load_stage, [&](int gi) {
    const int j0 = gi * WG;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (j0 + h < nk_s) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) epi.fold(j, e, acc[4 * j + 2 * h + e]);
      }
  });

  if (row0 + seq < p.n) {
    const int orig = s_row[seq];
    const float w = epi.row_factor(orig);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = f0 + 8 * j + 2 * t4 + e;
        if (col < p.f) epi.store((size_t)orig * p.f + col, w, j, e);
      }
  }
}

template <class Epi>
int launch(const ConvArgs& p, const typename Epi::Args& ea, void* stream) {
  auto kernel = conv_window_kernel<Epi>;
  cudaError_t err = allow_ring_smem(kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.n + WR - 1) / WR, (p.f + GN - 1) / GN);
  kernel<<<grid, GT, SMEM_BYTES, (cudaStream_t)stream>>>(p, ea);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int xgpr_conv_parts(const float* x_hi, const float* x_lo,
                               const int* order, const int* nk,
                               const float* proj_hi, const float* proj_lo,
                               const float* row_scale, float* c_out,
                               float* s_out, int n, int l, int dp, int width,
                               int f, float sigma, int mode, void* stream) {
  const ConvArgs p{x_hi, x_lo, order, nk, proj_hi, proj_lo,
                   n,    l,    dp,    width, f};
  switch (mode) {
    case MODE_HI:
      return launch<PartsEpilogue<MODE_HI>>(
          p, {row_scale, c_out, s_out, sigma}, stream);
    case MODE_EXACT:
      return launch<PartsEpilogue<MODE_EXACT>>(
          p, {row_scale, c_out, s_out, sigma}, stream);
    case MODE_FAST:
      return launch<PartsEpilogue<MODE_FAST>>(
          p, {row_scale, c_out, s_out, sigma}, stream);
    case MODE_POLY:
      return launch<PartsEpilogue<MODE_POLY>>(
          p, {row_scale, c_out, s_out, sigma}, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int xgpr_conv_maxpool(const float* x_hi, const float* x_lo,
                                 const int* order, const int* nk,
                                 const float* proj_hi, const float* proj_lo,
                                 float* out, int n, int l, int dp, int width,
                                 int f, void* stream) {
  const ConvArgs p{x_hi, x_lo, order, nk, proj_hi, proj_lo,
                   n,    l,    dp,    width, f};
  return launch<MaxpoolEpilogue>(p, {out}, stream);
}
