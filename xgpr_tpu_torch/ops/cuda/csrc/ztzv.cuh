// Fused CG matvec for one chunk on Hopper (K1): Z^T (Z v) without writing Z,
// its projections on the tensor cores in the body of the feature precision
// (tf32_gemm.cuh: 3xTF32 for "high" and "highest", one bf16 pass for
// "default"), or in float64 DMMA for float64 operands (fma_gemm.cuh).
//
// Replaces the TPU kernel xgpr_tpu/ops/pallas/ztzv_pallas.py:_ztzv_kernel
// (pallas_call in _ztzv_parts_impl).  For raw rows x (R, D), row mask m (R,),
// the dense projection proj (D, F) with chi folded in, lengthscale sigma and
// the CG direction split into cos/sin halves v_c, v_s (F, K):
//
//   arg  = (x @ proj) * sigma
//   c, s = cos(arg), sin(arg) * (m * scale);  with an intercept c[:, 0] = m
//   zv   = c v_c + s v_s                     (R, K)
//   oc   = c^T zv,  os = s^T zv              (F, K)
//
// The TPU kernel keeps a whole (R, F) c/s tile in 12 MB of VMEM between the
// two contractions and accumulates in grid order into resident outputs.  At
// F 4096 even 64 rows of features are 2 MB, more than the shared memory of
// an SM or a cluster holds, and blocks run in no order; so this is three
// launches that recompute the features and each own their outputs (no
// atomics: two calls on the same inputs give the same bits):
//
//   (a) ztzv_zv_kernel:  per row tile and slice of the frequency tiles,
//       project, sincos and contract with v_c/v_s tile by tile into per-row
//       partial sums in registers; the 4 lanes of a row reduce with
//       shuffles -> zv_part (SZ, R, K).
//   (b) ztzv_out_kernel: per frequency tile and slice of the row tiles,
//       recompute the same features and contract with zv (the SZ partials
//       are summed in a fixed order as they are staged) into per-column
//       registers, reduced over lanes (shuffles) and warps (shared memory)
//       -> oc_part, os_part (SO, F, K).
//   (c) sum_splits_kernel: fixed-order sum over the SO partials -> oc, os.
//
// What bounds it on the H100: at RBF's chunk (8192 x 84 rows, F 4096,
// K 1) device memory sees only x, the vectors and the partials (3 MB),
// and the two projections are 11.3 GFLOP, 0.068 ms as three TF32 products
// each at 495 TFLOP/s (0.17 ms as fp32 FMAs on CUDA cores; 0.011 ms as
// one bf16 product at 989 TFLOP/s), plus 2 x 33.5M sincos pairs on the
// CUDA cores.  Recomputing the features
// instead of writing Z trades 268 MB of traffic per chunk for the second
// projection.
//
// Design: both passes are the wgmma body of tf32_gemm.cuh with the dense
// row policy, 128-row x 128-frequency tiles whose stages flow from
// one tile to the next of a block's walk (the role the window-group loop
// plays in conv.cu).  Up to three depth steps (D 96 in TF32, 192 in bf16;
// RBF's 84) the tile the walk does not move stays in shared memory and
// the ring carries only the other operand (dense_pipeline): half the
// copies a step.  The epilogues work
// on the accumulator fragment; the small per-tile operands (v_c/v_s of a
// frequency tile, zv and the mask of a row tile) are staged in shared
// memory with the tile's first copies, in a ring of three slots.  Pass
// (a) carries KC right-hand sides per block (grid z walks K in chunks of
// 8 when K > 1); pass (b) keeps 64 column sums a thread, so it takes one
// right-hand side per block (grid z = K).
// The wrapper picks the slice counts that fill the SMs in the fewest waves.
// Under "default" the bf16 body rounds every product's operands as the
// TPU's DEFAULT dot does in _ztzv_kernel: x and proj go to the tensor
// cores as bf16, and the epilogues round c and s (after scale * mask and
// the intercept column), v_c / v_s as they are staged and the summed zv
// to bf16 before their CUDA-core products (as_operand), whose sums stay
// fp32.  Each kernel is instantiated once per sincos mode (common.cuh)
// and format; each format's instantiations are a translation unit of
// their own (ztzv.cu, ztzv_bf16.cu, ztzv_f64.cu), built in parallel,
// and the host picks the instantiation at launch.
// The float64 format runs every product, sum and sincos (the builtin, in
// every mode) in float64, with 16 values of depth a stage and the same
// walks, but its own passes (ztzv_zv_f64_kernel, ztzv_out_f64_kernel):
// both contractions run as DMMAs on the fragment, and a block carries up
// to 16 right-hand sides in both passes: SLQ's K 26 takes two blocks a
// pass, where one right-hand side a block recomputed the features 26
// times.  What bounds it
// there: the two projections of RBF's chunk, 11.3 GFLOP, 0.17 ms at the
// tensor cores' 67 TFLOP/s of FP64, and at K 26 the contractions' 14 GFLOP
// more.
#pragma once

#include "common.cuh"
#include "tf32_gemm.cuh"

namespace xgpr {
namespace ztzv {

template <class T>
struct ZtzvArgs {
  const T* m;   // (n,) row mask
  const T* vc;  // (f, k)
  const T* vs;  // (f, k)
  T sigma, scale;
  int k, intercept;
};

// Right-hand sides a block of pass (a) carries when K > 1 (the tensor-core
// float32 formats; the float64 passes carry 8 F64_NT).
constexpr int ZV_KC = 8;

// Partial zv over the frequency tiles of this block's walk.
template <int FMT, int MODE, int KC>
__global__ void __launch_bounds__(GT, 1)
    ztzv_zv_kernel(DenseOperands p, ZtzvArgs<typename Body<FMT>::T> a,
                   typename Body<FMT>::T* __restrict__ zv_part) {
  using T = typename Body<FMT>::T;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ T vcs[3][GN * KC], vss[3][GN * KC];
  unsigned char* smem = ring_base(smem_raw);
  const DenseWalk w = dense_walk(true, p.n, p.f);
  const int kc = max(1, (p.dp + Body<FMT>::KS - 1) / Body<FMT>::KS);
  const int tid = threadIdx.x, lane = tid % 32, t4 = lane % 4;
  const int rbase = (tid / 32) * 16 + lane / 4;
  const int k0 = blockIdx.z * KC, kcnt = min(KC, a.k - k0);

  T mrow[2], wrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = w.row0(0) + rbase + 8 * h;
    mrow[h] = r < p.n ? a.m[r] : T(0);
    wrow[h] = mrow[h] * a.scale;
  }
  T part[2][KC];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < KC; ++q) part[h][q] = T(0);

  auto stage_v = [&](int step) {
    if (step % kc == 0) {  // stage the tile's v_c / v_s
      const int i = step / kc, f0 = w.col0(i);
      for (int e = tid; e < GN * KC; e += GT) {
        const int fl = e / KC, q = e % KC, gf = f0 + fl;
        const bool ok = gf < p.f && q < kcnt;
        const size_t at = (size_t)gf * a.k + k0 + q;
        vcs[i % 3][e] = ok ? as_operand<FMT>(a.vc[at]) : T(0);
        vss[i % 3][e] = ok ? as_operand<FMT>(a.vs[at]) : T(0);
      }
    }
  };
  T acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = T(0);

  // Frequency tile i is complete: its contributions to the rows' partial
  // sums.
  dense_pipeline<true, FMT>(smem, p, w, kc, acc, stage_v, [&](int i) {
    const T* vct = vcs[i % 3];
    const T* vst = vss[i % 3];
    const int f0 = w.col0(i);
    with_sincos<MODE>(acc, a.sigma, [&](auto sincos) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int fl = 8 * j + 2 * t4 + e;
          const bool icol = a.intercept && f0 + fl == 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            T c, s;
            sincos(acc[4 * j + 2 * h + e] * a.sigma, wrow[h], &c, &s);
            if (icol) c = mrow[h];
            c = as_operand<FMT>(c);
            s = as_operand<FMT>(s);
#pragma unroll
            for (int q = 0; q < KC; ++q)
              part[h][q] = fma_t(c, vct[fl * KC + q],
                                 fma_t(s, vst[fl * KC + q], part[h][q]));
          }
        }
    });
  });

#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      T v = part[h][q];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      part[h][q] = v;
    }
  if (t4 != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = w.row0(0) + rbase + 8 * h;
    if (r >= p.n) continue;
#pragma unroll
    for (int q = 0; q < KC; ++q)
      if (q < kcnt)
        zv_part[((size_t)blockIdx.y * p.n + r) * a.k + k0 + q] = part[h][q];
  }
}

// Partial oc/os of one frequency tile over the row tiles of this block's
// walk, for right-hand side q = blockIdx.z.
template <int FMT, int MODE>
__global__ void __launch_bounds__(GT, 1)
    ztzv_out_kernel(DenseOperands p, ZtzvArgs<typename Body<FMT>::T> a,
                    const typename Body<FMT>::T* __restrict__ zv_part,
                    int zsplit, typename Body<FMT>::T* __restrict__ oc_part,
                    typename Body<FMT>::T* __restrict__ os_part) {
  using T = typename Body<FMT>::T;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ T zvs[3][GM], ms[3][GM];
  __shared__ T red[2][GT / 32][GN];
  unsigned char* smem = ring_base(smem_raw);
  const DenseWalk w = dense_walk(false, p.n, p.f);
  const int kc = max(1, (p.dp + Body<FMT>::KS - 1) / Body<FMT>::KS);
  const int tid = threadIdx.x, lane = tid % 32, t4 = lane % 4;
  const int warp = tid / 32, rbase = warp * 16 + lane / 4;
  const int q = blockIdx.z, f0 = w.col0(0);

  T oc[32], os[32];  // column 8j + 2 t4 + e at [2j + e]
#pragma unroll
  for (int i = 0; i < 32; ++i) oc[i] = os[i] = T(0);

  T acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = T(0);

  dense_pipeline<true, FMT>(
      smem, p, w, kc, acc,
      [&](int step) {
        if (step % kc == 0 && tid < GM) {  // stage the tile's zv and mask
          const int i = step / kc, r = w.row0(i) + tid;
          T v = T(0), mr = T(0);
          if (r < p.n) {
            for (int s = 0; s < zsplit; ++s)
              v += zv_part[((size_t)s * p.n + r) * a.k + q];
            mr = a.m[r];
          }
          zvs[i % 3][tid] = as_operand<FMT>(v);
          ms[i % 3][tid] = mr;
        }
      },
      [&](int i) {
        with_sincos<MODE>(acc, a.sigma, [&](auto sincos) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rl = rbase + 8 * h;
            const T zr = zvs[i % 3][rl], mr = ms[i % 3][rl];
            const T wr = mr * a.scale;
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                T c, s;
                sincos(acc[4 * j + 2 * h + e] * a.sigma, wr, &c, &s);
                if (a.intercept && f0 + 8 * j + 2 * t4 + e == 0) c = mr;
                c = as_operand<FMT>(c);
                s = as_operand<FMT>(s);
                oc[2 * j + e] = fma_t(c, zr, oc[2 * j + e]);
                os[2 * j + e] = fma_t(s, zr, os[2 * j + e]);
              }
          }
        });
      });

  // Sum over the warp's rows (lanes with the same t4), then over warps.
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      oc[i] += __shfl_xor_sync(0xffffffffu, oc[i], off);
      os[i] += __shfl_xor_sync(0xffffffffu, os[i], off);
    }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[0][warp][8 * j + 2 * t4 + e] = oc[2 * j + e];
        red[1][warp][8 * j + 2 * t4 + e] = os[2 * j + e];
      }
  }
  __syncthreads();
  const int which = tid / GN, fl = tid % GN, col = f0 + fl;
  if (col < p.f) {
    T v = T(0);
#pragma unroll
    for (int u = 0; u < GT / 32; ++u) v += red[which][u][fl];
    T* out = which ? os_part : oc_part;
    out[((size_t)blockIdx.y * p.f + col) * a.k + q] = v;
  }
}

// Internal linkage: each format's translation unit keeps its own copy.
template <class T>
static __global__ void sum_splits_kernel(const T* __restrict__ oc_part,
                                         const T* __restrict__ os_part,
                                         T* __restrict__ oc,
                                         T* __restrict__ os, int nsplit,
                                         size_t len) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  T a = T(0), b = T(0);
  for (int s = 0; s < nsplit; ++s) {
    a += oc_part[(size_t)s * len + i];
    b += os_part[(size_t)s * len + i];
  }
  oc[i] = a;
  os[i] = b;
}

template <int FMT, int MODE, int KC>
cudaError_t launch_zv(const DenseOperands& p,
                      const ZtzvArgs<typename Body<FMT>::T>& a,
                      typename Body<FMT>::T* zv_part, int zsplit,
                      cudaStream_t stream) {
  cudaError_t err = allow_ring_smem<FMT>(ztzv_zv_kernel<FMT, MODE, KC>);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + GM - 1) / GM, zsplit, (a.k + KC - 1) / KC);
  ztzv_zv_kernel<FMT, MODE, KC>
      <<<grid, GT, Body<FMT>::SMEM, stream>>>(p, a, zv_part);
  return cudaGetLastError();
}

// The float64 format's passes (a) and (b).  Both contract on the tensor
// cores straight from the fragment: a DMMA's A operand is lane (g, t)'s
// value of row g and depth t, and the fragment holds row g by column
// 8j + 2t + e, so taking (j, e) as one DMMA's four depths makes the
// thread's own feature its A value.  Pass (a) computes the projection as
// the other formats do (rows x frequencies) and contracts over the
// frequencies with v_c / v_s staged in shared memory; pass (b) computes it
// transposed (frequencies x rows: K1's operands with their roles swapped)
// and contracts over the rows with zv staged in shared memory.  A block
// carries 8 NT right-hand sides (NT DMMA tiles of 8), and its sums stay
// in the DMMAs' accumulators; no shuffles, no spills.  The staged rows of
// v_c / v_s and zv have a pitch of 8 NT + 2 values (2 mod 8), so each
// half-warp's B loads fall on distinct banks.
template <int NT>
constexpr int F64_PITCH = 8 * NT + 2;

// Shared memory of the float64 passes: the ring, then their staged
// operands in 3 slots (pass (a): v_c and v_s of a frequency tile; pass
// (b): zv and the mask of a row tile).
template <int NT>
constexpr int F64_ZV_SMEM =
    Body<FMT_F64>::SMEM + 2 * 3 * GN * F64_PITCH<NT> * (int)sizeof(double);
template <int NT>
constexpr int F64_OUT_SMEM =
    Body<FMT_F64>::SMEM + 3 * GN * (F64_PITCH<NT> + 1) * (int)sizeof(double);

// Pass (a) in float64: partial zv over the frequency tiles of this block's
// walk for right-hand sides 8 NT blockIdx.z ...
template <int NT>
__global__ void __launch_bounds__(GT, 1)
    ztzv_zv_f64_kernel(DenseOperands p, ZtzvArgs<double> a,
                       double* __restrict__ zv_part) {
  constexpr int FMT = FMT_F64, KO = 8 * NT, VP = F64_PITCH<NT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = ring_base(smem_raw);
  double* const vcs = reinterpret_cast<double*>(smem_raw + Body<FMT>::SMEM);
  double* const vss = vcs + 3 * GN * VP;
  const DenseWalk w = dense_walk(true, p.n, p.f);
  const int kc = max(1, (p.dp + Body<FMT>::KS - 1) / Body<FMT>::KS);
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int rbase = (tid / 32) * 16 + g;
  const int k0 = blockIdx.z * KO, kcnt = min(KO, a.k - k0);

  double mrow[2], wrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = w.row0(0) + rbase + 8 * h;
    mrow[h] = r < p.n ? a.m[r] : 0.0;
    wrow[h] = mrow[h] * a.scale;
  }
  double z[2][NT][2];  // zv of row rbase + 8h, right-hand side 8nt + 2t4 + e
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) z[h][nt][0] = z[h][nt][1] = 0.0;
  double acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0;

  dense_pipeline<true, FMT>(
      smem, p, w, kc, acc,
      [&](int step) {
        if (step % kc == 0) {  // stage the tile's v_c / v_s
          const int i = step / kc, f0 = w.col0(i);
          double* vc = vcs + (i % 3) * GN * VP;
          double* vs = vss + (i % 3) * GN * VP;
          for (int e = tid; e < GN * KO; e += GT) {
            const int fl = e / KO, q = e % KO, gf = f0 + fl;
            const bool ok = gf < p.f && q < kcnt;
            const size_t at = (size_t)gf * a.k + k0 + q;
            vc[fl * VP + q] = ok ? a.vc[at] : 0.0;
            vs[fl * VP + q] = ok ? a.vs[at] : 0.0;
          }
        }
      },
      [&](int i) {
        const double* vc = vcs + (i % 3) * GN * VP;
        const double* vs = vss + (i % 3) * GN * VP;
        const int f0 = w.col0(i);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int fl = 8 * j + 2 * t4 + e;
            const bool icol = a.intercept && f0 + fl == 0;
            double bc[NT], bs[NT];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              bc[nt] = vc[fl * VP + 8 * nt + g];
              bs[nt] = vs[fl * VP + 8 * nt + g];
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              double c, s;
              sincos_scaled<MODE_EXACT>(acc[4 * j + 2 * h + e] * a.sigma,
                                        wrow[h], &c, &s);
              if (icol) c = mrow[h];
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                dmma(z[h][nt][0], z[h][nt][1], c, bc[nt]);
                dmma(z[h][nt][0], z[h][nt][1], s, bs[nt]);
              }
            }
          }
      });

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = w.row0(0) + rbase + 8 * h;
    if (r >= p.n) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * nt + 2 * t4 + e;
        if (q < kcnt)
          zv_part[((size_t)blockIdx.y * p.n + r) * a.k + k0 + q] =
              z[h][nt][e];
      }
  }
}

// Pass (b) in float64 on the swapped operands t (t.n = F frequencies as
// rows, t.f = R rows of x as columns): partial oc/os of one frequency tile
// over the row tiles of this block's walk, right-hand sides 8 NT
// blockIdx.z ...
template <int NT>
__global__ void __launch_bounds__(GT, 1)
    ztzv_out_f64_kernel(DenseOperands t, ZtzvArgs<double> a,
                        const double* __restrict__ zv_part, int zsplit,
                        double* __restrict__ oc_part,
                        double* __restrict__ os_part) {
  constexpr int FMT = FMT_F64, KO = 8 * NT, ZP = F64_PITCH<NT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = ring_base(smem_raw);
  double* const zvs = reinterpret_cast<double*>(smem_raw + Body<FMT>::SMEM);
  double* const ms = zvs + 3 * GN * ZP;
  const DenseWalk w = dense_walk(true, t.n, t.f);
  const int kc = max(1, (t.dp + Body<FMT>::KS - 1) / Body<FMT>::KS);
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int fbase = w.row0(0) + (tid / 32) * 16 + g;
  const int k0 = blockIdx.z * KO, kcnt = min(KO, a.k - k0);

  // oc (o[0]) and os (o[1]) of frequency fbase + 8h, right-hand side
  // 8nt + 2t4 + e.
  double o[2][2][NT][2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) o[u][h][nt][0] = o[u][h][nt][1] = 0.0;
  double acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0;

  dense_pipeline<true, FMT>(
      smem, t, w, kc, acc,
      [&](int step) {
        if (step % kc == 0) {  // stage the tile's zv and mask
          const int i = step / kc, r0 = w.col0(i);
          double* zt = zvs + (i % 3) * GN * ZP;
          for (int e = tid; e < GN * KO; e += GT) {
            const int rl = e / KO, q = e % KO, r = r0 + rl;
            double v = 0.0;
            if (r < t.f && q < kcnt)
              for (int s = 0; s < zsplit; ++s)
                v += zv_part[((size_t)s * t.f + r) * a.k + k0 + q];
            zt[rl * ZP + q] = v;
          }
          if (tid < GN) {
            const int r = r0 + tid;
            ms[(i % 3) * GN + tid] = r < t.f ? a.m[r] : 0.0;
          }
        }
      },
      [&](int i) {
        const double* zt = zvs + (i % 3) * GN * ZP;
        const double* mt = ms + (i % 3) * GN;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int rl = 8 * j + 2 * t4 + e;
            const double mr = mt[rl], wr = mr * a.scale;
            double bz[NT];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) bz[nt] = zt[rl * ZP + 8 * nt + g];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              double c, s;
              sincos_scaled<MODE_EXACT>(acc[4 * j + 2 * h + e] * a.sigma, wr,
                                        &c, &s);
              if (a.intercept && fbase + 8 * h == 0) c = mr;
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                dmma(o[0][h][nt][0], o[0][h][nt][1], c, bz[nt]);
                dmma(o[1][h][nt][0], o[1][h][nt][1], s, bz[nt]);
              }
            }
          }
      });

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = fbase + 8 * h;
    if (col >= t.n) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * nt + 2 * t4 + e;
        if (q >= kcnt) continue;
        const size_t at = ((size_t)blockIdx.y * t.n + col) * a.k + k0 + q;
        oc_part[at] = o[0][h][nt][e];
        os_part[at] = o[1][h][nt][e];
      }
  }
}

// Right-hand sides a block of the float64 passes carries at K: 8 NT.
__host__ __device__ constexpr int f64_nt(int k) { return k <= 8 ? 1 : 2; }

// The float64 format's three launches, NT = f64_nt(K).
template <int NT>
cudaError_t launch_all_f64(const DenseOperands& p, const ZtzvArgs<double>& a,
                           double* zv_part, double* oc_part, double* os_part,
                           double* oc, double* os, int zsplit, int osplit,
                           cudaStream_t st) {
  constexpr int KO = 8 * NT;
  cudaError_t err = cudaFuncSetAttribute(
      ztzv_zv_f64_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F64_ZV_SMEM<NT>);
  if (err != cudaSuccess) return err;
  const int kblocks = (a.k + KO - 1) / KO;
  const dim3 grid_a((p.n + GM - 1) / GM, zsplit, kblocks);
  ztzv_zv_f64_kernel<NT>
      <<<grid_a, GT, F64_ZV_SMEM<NT>, st>>>(p, a, zv_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ztzv_out_f64_kernel<NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F64_OUT_SMEM<NT>);
  if (err != cudaSuccess) return err;
  const DenseOperands t{p.b_hi, p.b_lo, p.x_hi, p.x_lo, p.f, p.dp, p.n};
  const dim3 grid_b((p.f + GM - 1) / GM, osplit, kblocks);
  ztzv_out_f64_kernel<NT><<<grid_b, GT, F64_OUT_SMEM<NT>, st>>>(
      t, a, zv_part, zsplit, oc_part, os_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t len = (size_t)p.f * a.k;
  sum_splits_kernel<double><<<(unsigned)((len + 255) / 256), 256, 0, st>>>(
      oc_part, os_part, oc, os, osplit, len);
  return cudaGetLastError();
}

// The three launches of one call in one format and sincos mode.
template <int FMT, int MODE, class T = typename Body<FMT>::T>
cudaError_t launch_all(const DenseOperands& p, const ZtzvArgs<T>& a,
                       T* zv_part, T* oc_part, T* os_part, T* oc, T* os,
                       int zsplit, int osplit, cudaStream_t st) {
  cudaError_t err =
      a.k == 1 ? launch_zv<FMT, MODE, 1>(p, a, zv_part, zsplit, st)
               : launch_zv<FMT, MODE, ZV_KC>(p, a, zv_part, zsplit, st);
  if (err != cudaSuccess) return err;
  err = allow_ring_smem<FMT>(ztzv_out_kernel<FMT, MODE>);
  if (err != cudaSuccess) return err;
  const dim3 grid_b((p.f + GN - 1) / GN, osplit, a.k);
  ztzv_out_kernel<FMT, MODE><<<grid_b, GT, Body<FMT>::SMEM, st>>>(
      p, a, zv_part, zsplit, oc_part, os_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t len = (size_t)p.f * a.k;
  sum_splits_kernel<T><<<(unsigned)((len + 255) / 256), 256, 0, st>>>(
      oc_part, os_part, oc, os, osplit, len);
  return cudaGetLastError();
}

// One call in format FMT and sincos mode `mode` (an unknown mode is
// refused).
template <int FMT>
int launch(const DenseOperands& p, const ZtzvArgs<float>& a, float* zv_part,
           float* oc_part, float* os_part, float* oc, float* os, int zsplit,
           int osplit, int mode, cudaStream_t st) {
  switch (mode) {
    case MODE_HI:
      return (int)launch_all<FMT, MODE_HI>(p, a, zv_part, oc_part, os_part,
                                           oc, os, zsplit, osplit, st);
    case MODE_EXACT:
      return (int)launch_all<FMT, MODE_EXACT>(p, a, zv_part, oc_part,
                                              os_part, oc, os, zsplit, osplit,
                                              st);
    case MODE_FAST:
      return (int)launch_all<FMT, MODE_FAST>(p, a, zv_part, oc_part, os_part,
                                             oc, os, zsplit, osplit, st);
    case MODE_POLY:
      return (int)launch_all<FMT, MODE_POLY>(p, a, zv_part, oc_part, os_part,
                                             oc, os, zsplit, osplit, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The bf16 format's call (ztzv_bf16.cu).
int launch_bf16(const DenseOperands& p, const ZtzvArgs<float>& a,
                float* zv_part, float* oc_part, float* os_part, float* oc,
                float* os, int zsplit, int osplit, int mode, cudaStream_t st);

// The float64 format's call (ztzv_f64.cu): the builtin sincos in every
// mode.
int launch_f64(const DenseOperands& p, const ZtzvArgs<double>& a,
               double* zv_part, double* oc_part, double* os_part, double* oc,
               double* os, int zsplit, int osplit, cudaStream_t st);

}  // namespace ztzv
}  // namespace xgpr

