// Conv window-loop kernels for Hopper: K3 (masked cos/sin window sums) and
// K4 (ReLU + global max over windows), one implicit-GEMM body templated on
// the operand format (tf32_gemm.cuh: on the tensor cores 3xTF32 or one
// bf16 pass, float64 DMMA, or fp32 FMAs on the CUDA cores) and on the
// epilogue.
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
// 495 TFLOP/s, 1.05 ms; under "default", one bf16 product at 989 TFLOP/s,
// 0.18 ms (the bytes then weigh: 0.09 ms at 3.35 TB/s).
//
// Design (the wrapper in ../conv.py prepares the operands):
// - Implicit GEMM with no im2col array.  GEMM rows are (sequence, window)
//   pairs, the depth is (tap t, channel c), the columns are frequencies.
//   For tap t and channels c0 : c0 + KS (32 fp32 or 64 bf16 values) the A
//   slice of a tile is x[rows, j0 + t : j0 + t + WG, c0 : c0 + KS], a box
//   of the input, and the B slice projT[f0 : f0 + 128, t*D + c0 : + KS]
//   serves every (sequence, window) row of the tile: B is read once per
//   depth step per tile, not once per window.  cp.async brings both, as
//   128-byte rows in the 128-byte swizzle, into a 3-stage ring of shared
//   memory.
// - The body of tf32_gemm.cuh (shared with K1 and K2): the wrapper makes
//   x and projT the planes of the format (TF32 high parts and remainders
//   for 3xTF32, a bf16 copy for "default"), both operands are
//   read from shared memory, and step s's products run while the block
//   waits for step s + 1's copies and issues step s + 2's.  This file
//   gives it the row policy (which box of x a GEMM row reads) and the
//   epilogues; sigma multiplies the fp32 product in every format.  The
//   register-A form (x split in registers, no extra bytes) leaves too few
//   registers for products in flight; it measured slower (PERF.md).
//   Each format's instantiations are a translation unit of their own
//   (conv.cu, conv_bf16.cu, conv_fma.cu, conv_f64.cu), built in parallel.
// - The synchronous bodies (fma_gemm.cuh) read the same stages, one plane
//   each: FMT_FMA32 is the "highest" feature precision ("reference"),
//   fp32-exact products as xgpr_tpu's HIGHEST, on the CUDA cores; FMT_F64
//   takes float64 operands on DMMA, its epilogue the builtin sincos in
//   every mode and its sums in float64.  At the motif slice both bounds
//   are 2.58 ms (fp32 on the CUDA cores and FP64 on the tensor cores, each
//   67 TFLOP/s).
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
//   store.  The wrapper pads D to a multiple of 4 (8 for bf16: 16-byte
//   copies).
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "tf32_gemm.cuh"

namespace xgpr {
namespace conv {

constexpr int WR = 64;      // sequences per tile
constexpr int WG = GM / WR;  // windows per group: GM GEMM rows per tile

struct ConvArgs {
  const void* x_hi;     // (n, l, dp), 16-byte rows: TF32 high parts, bf16
                        // or the values (the CUDA-core formats)
  const void* x_lo;     // the same, TF32 remainders (unused by the others)
  const int* order;     // (n,) rows in tile order
  const int* nk;        // (n,) valid windows of each row, in [0, nw]
  const void* proj_hi;  // (f, width * dp), K-major: the same planes
  const void* proj_lo;
  int n, l, dp, width, f;
};

// K3: running cos/sin sums of this thread's sequence x 32 frequencies, in
// one sincos mode (common.cuh; float64 takes the builtin in every mode).
template <class T, int MODE>
struct PartsEpilogue {
  struct Args {
    const T* row_scale;
    T* c_out;
    T* s_out;
    T sigma;
  };
  Args a;
  T cs[16][2], sn[16][2];

  __device__ __forceinline__ explicit PartsEpilogue(const Args& args)
      : a(args) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) cs[j][e] = sn[j][e] = T(0);
  }
  __device__ __forceinline__ void fold(int j, int e, T g) {
    T c, s;
    sincos_scaled<MODE>(g * a.sigma, T(1), &c, &s);
    cs[j][e] += c;
    sn[j][e] += s;
  }
  __device__ __forceinline__ T row_factor(int row) const {
    return a.row_scale ? a.row_scale[row] : T(1);
  }
  __device__ __forceinline__ void store(size_t at, T w, int j, int e) const {
    a.c_out[at] = cs[j][e] * w;
    a.s_out[at] = sn[j][e] * w;
  }
};

// K4: running max against a zero start.
template <class T>
struct MaxpoolEpilogue {
  struct Args {
    T* out;
  };
  Args a;
  T mx[16][2];

  __device__ __forceinline__ explicit MaxpoolEpilogue(const Args& args)
      : a(args) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) mx[j][e] = T(0);
  }
  __device__ __forceinline__ void fold(int j, int e, T g) {
    mx[j][e] = max_t(mx[j][e], g);
  }
  __device__ __forceinline__ T row_factor(int) const { return T(1); }
  __device__ __forceinline__ void store(size_t at, T, int j, int e) const {
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
template <int FMT, class Epi>
__global__ void __launch_bounds__(GT, 1)
    conv_window_kernel(ConvArgs p, typename Epi::Args ea) {
  using B = Body<FMT>;
  using T = typename B::T;
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

  // Copy assignment: 16-byte chunk lc of a row's 128-byte depth line;
  // sequences lr and lr + 32 (both windows), and frequencies lr + 32q,
  // each plane.
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

  const int kc = (p.dp + B::KS - 1) / B::KS;  // channel chunks per tap
  const int spg = p.width * kc;         // pipeline steps per window group
  const int nsteps = (s_nkmax + WG - 1) / WG * spg;

  // Row policy: GEMM row (s / 8) * 16 + window * 8 + s % 8 of a step is
  // window j0 + window of sequence s at tap `tap`, channels c : c + KS.
  // Offsets count values; each plane's copy scales them to bytes, and a
  // lo plane lies 16 KB (A_BYTES == B_BYTES) after its hi plane.
  auto copy = [&](unsigned char* dst, const void* hi, const void* lo,
                  size_t off, bool ok) {
    const size_t at = off * B::ELEM;
    cp_async16(dst, static_cast<const char*>(hi) + at, ok);
    if constexpr (B::PLANES == 2)
      cp_async16(dst + A_BYTES, static_cast<const char*>(lo) + at, ok);
  };
  auto load_stage = [&](int step, unsigned char* st) {
    const int gi = step / spg, rem = step - gi * spg;
    const int tap = rem / kc, c = (rem - tap * kc) * B::KS + B::VEC * lc;
    const int j0 = gi * WG;
    const bool cok = c < p.dp;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = bok[q] && cok;
      const size_t off = ok ? boff[q] + tap * p.dp + c : 0;
      copy(st + sw128(lr + 32 * q, lc), p.proj_hi, p.proj_lo, off, ok);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int win = 0; win < WG; ++win) {
        const int s = lr + 32 * h;
        const bool ok = xok[h] && cok && j0 + win < nw;
        const size_t off =
            ok ? xoff[h] + (size_t)(j0 + win + tap) * p.dp + c : 0;
        copy(st + B::PLANES * B_BYTES +
                 sw128((s / 8) * 16 + win * 8 + s % 8, lc),
             p.x_hi, p.x_lo, off, ok);
      }
  };

  const int nk_s = s_nk[seq];
  Epi epi(ea);
  T acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = T(0);

  // A finished window group folds its valid windows into the epilogue.
  gemm_pipeline<FMT>(smem, nsteps, spg, acc, load_stage, [&](int gi) {
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
    const T w = epi.row_factor(orig);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = f0 + 8 * j + 2 * t4 + e;
        if (col < p.f) epi.store((size_t)orig * p.f + col, w, j, e);
      }
  }
}

template <int FMT, class Epi>
int launch(const ConvArgs& p, const typename Epi::Args& ea, void* stream) {
  auto kernel = conv_window_kernel<FMT, Epi>;
  cudaError_t err = allow_ring_smem<FMT>(kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.n + WR - 1) / WR, (p.f + GN - 1) / GN);
  kernel<<<grid, GT, Body<FMT>::SMEM, (cudaStream_t)stream>>>(p, ea);
  return (int)cudaGetLastError();
}

// K3 in format FMT and sincos mode `mode` (an unknown mode is refused; the
// float64 format has the builtin's one instantiation), and K4 in format
// FMT.  Each format's instantiations live in their own translation unit
// (conv.cu, conv_bf16.cu, conv_fma.cu, conv_f64.cu), so that the build
// compiles them in parallel.
template <int FMT, class T = typename Body<FMT>::T>
int launch_parts(const ConvArgs& p, const T* row_scale, T* c_out, T* s_out,
                 T sigma, int mode, void* stream) {
  if (mode < MODE_HI || mode > MODE_POLY) return (int)cudaErrorInvalidValue;
  if constexpr (FMT == FMT_F64) {
    return launch<FMT, PartsEpilogue<T, MODE_EXACT>>(
        p, {row_scale, c_out, s_out, sigma}, stream);
  } else {
    switch (mode) {
      case MODE_HI:
        return launch<FMT, PartsEpilogue<T, MODE_HI>>(
            p, {row_scale, c_out, s_out, sigma}, stream);
      case MODE_EXACT:
        return launch<FMT, PartsEpilogue<T, MODE_EXACT>>(
            p, {row_scale, c_out, s_out, sigma}, stream);
      case MODE_FAST:
        return launch<FMT, PartsEpilogue<T, MODE_FAST>>(
            p, {row_scale, c_out, s_out, sigma}, stream);
      default:
        return launch<FMT, PartsEpilogue<T, MODE_POLY>>(
            p, {row_scale, c_out, s_out, sigma}, stream);
    }
  }
}

template <int FMT, class T = typename Body<FMT>::T>
int launch_maxpool(const ConvArgs& p, T* out, void* stream) {
  return launch<FMT, MaxpoolEpilogue<T>>(p, {out}, stream);
}

// The other formats' launches (conv_bf16.cu, conv_fma.cu, conv_f64.cu).
int launch_parts_bf16(const ConvArgs& p, const float* row_scale,
                      float* c_out, float* s_out, float sigma, int mode,
                      void* stream);
int launch_maxpool_bf16(const ConvArgs& p, float* out, void* stream);
int launch_parts_fma32(const ConvArgs& p, const float* row_scale,
                       float* c_out, float* s_out, float sigma, int mode,
                       void* stream);
int launch_maxpool_fma32(const ConvArgs& p, float* out, void* stream);
int launch_parts_f64(const ConvArgs& p, const double* row_scale,
                     double* c_out, double* s_out, double sigma, int mode,
                     void* stream);
int launch_maxpool_f64(const ConvArgs& p, double* out, void* stream);

}  // namespace conv
}  // namespace xgpr

