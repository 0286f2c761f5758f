// Fused CG matvec for one chunk on Hopper (K1): Z^T (Z v) without writing Z,
// its projections on the tensor cores in the body of the feature precision
// (3xTF32 for "high" and "highest", one bf16 pass for "default", both on
// dense_wgmma.cuh's pipeline), or in float64 m16n8k8 DMMA for float64
// operands (dense_f64.cuh).
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
//   (a) zv pass: per row tile, slice of the frequency tiles and block of
//       right-hand sides, project, sincos and contract with v_c / v_s tile
//       by tile -> zv_part (SZ, R, K).
//   (b) out pass: per frequency tile, slice of the row tiles and block of
//       right-hand sides, recompute the same features and contract with zv
//       (the SZ partials summed in a fixed order first, by a small launch
//       when SZ > 1) -> oc_part, os_part (SO, F, K).
//   (c) sum_splits_kernel: fixed-order sum over the SO partials -> oc, os.
//
// What bounds it on the H100: at RBF's chunk (8192 x 84 rows, F 4096)
// device memory sees only x, the vectors and the partials (3 MB at K 1),
// and the work is the two projections, 11.3 GFLOP, and the contractions,
// 8 R F K flops: at K 1 0.068 ms as three TF32 products at 495 TFLOP/s
// (0.011 ms as one bf16 product at 989 TFLOP/s), at K 26 0.11 ms (0.019
// ms), plus 2 x 33.5M sincos pairs on the CUDA cores.  Recomputing the
// features instead of writing Z trades 268 MB of traffic per chunk for the
// second projection.  That trade holds while each pass carries every
// right-hand side in one block: in 3xTF32 a block carries at most 16
// (below), so from K 17 these passes project 2 ceil(K / 16) times a call
// (four at SLQ's K 26, 0.64 ms against 0.33 ms at K 16, PERF.md), and
// the wrapper takes the reuse path of ztzv_reuse.cuh instead: the
// features projected and folded once, stored (268 MB) and read by two
// streaming contractions, 0.36 ms at K 26, bound by those 805 MB of
// traffic (0.24 ms).  Up to K 16 the two are as fast (0.33 and 0.34 ms
// at K 16), and these passes move no features through device memory.
//
// Design.  The float32 bodies, 3xTF32 ("high", "highest") and bf16
// ("default"), run the warp-specialised TMA pipeline of dense_wgmma.cuh,
// one template over the format, with the walks below: pass (a) holds 128
// rows of x and walks a slice of the frequency tiles, its two consumer
// warpgroups multiplying 64 rows each in step; pass (b) at K 1 holds a
// 128-frequency tile and its consumers take the halves of the row tiles
// of a slice on rings of their own, so that one folds while the other
// multiplies; at K > 1 it holds 128 frequencies of proj^T (the operands
// swapped: frequencies as the tile's rows, rows of x as its columns) and
// walks a slice of the row tiles of x as pass (a) does, so that in both
// passes the contraction runs over the fragment's columns.
//
// The contractions run on the tensor cores straight from the accumulator
// fragment (mma.sync, the A operand in registers): the fragment holds tile
// row g + 8h by column 8j + 2t + e, which is the A layout of
// m16n8k16.bf16 for columns 16u .. 16u + 15 and, with depth t taking
// column 8j + 2t and depth t + 4 column 8j + 2t + 1, of m16n8k8.tf32 for
// columns 8j .. 8j + 7.  The B operand (v_c / v_s of a frequency tile in
// pass (a), zv of a row tile in pass (b)) is staged in shared memory, fp32,
// one row per right-hand side in the swizzle of staged_at.  A block (in
// 3xTF32 a consumer warpgroup) carries 8 NT right-hand sides (NT n8
// tiles, mma_nt): every right-hand side shares one projection and one
// sincos of each tile, where a CUDA-core contraction carried one
// right-hand side a block in pass (b) and recomputed the features K times
// (3.73 ms at K 26 in 3xTF32).  NT is 1 up to K 8, then 4 for bf16 and 2
// for 3xTF32, whose sums take twice the registers (main and correction
// terms): 32 right-hand sides a block past K 16 measured slower in 3xTF32
// (PERF.md §6), which therefore takes the reuse path from K 17.  The plan, and so each output's summation order, follows
// NT.  At K 1 one-rhs passes contract on the CUDA cores instead (the
// folds of dense_wgmma.cuh's k1_zv_kernel and k1_out1_kernel).
//
// Precision: "default" (bf16) rounds c, s (after scale * mask and the
// intercept column), v_c / v_s and the summed zv to bf16 as the TPU's
// DEFAULT dot rounds its operands in _ztzv_kernel; the products are exact
// and the mma sums them in fp32.  3xTF32 splits c, s and the staged values
// into TF32 high parts and remainders (hi + lo == a) and sums
// lo*hi + hi*lo + hi*hi; the tensor cores align and truncate their sums,
// so each hi*hi product is made afresh (8 terms) and added to the running
// sum with an fp32 add, and only the small terms chain in the mma's
// accumulator: the error stays at fp32 grade (precision_error.py).
//
// The float64 format runs every product, sum and sincos (the builtin, in
// every mode) in float64 on its own passes (ztzv_zv_f64_kernel,
// ztzv_out_f64_kernel, below) over the DMMA loop of dense_f64.cuh:
// m16n8k8 products on a six-stage mbarrier ring, both contractions as
// DMMAs on the projection's accumulators, 32 right-hand sides a block
// from K 9, so K 26 projects once a pass.  What bounds it there: the two
// projections of RBF's chunk, 11.3 GFLOP, 0.17 ms at the tensor cores' 67
// TFLOP/s of FP64, the two folds' 67M double sincos on the FP64 units,
// and at K 26 the contractions' 8.6 GFLOP (at 32 right-hand sides).
//
// Each kernel is instantiated once per sincos mode (common.cuh) and
// format; each format's instantiations are a translation unit of their own
// (ztzv.cu: 3xTF32 on dense_wgmma.cuh with the reuse path of
// ztzv_reuse.cuh, and ztzv_bf16.cu: bf16 on dense_wgmma.cuh; ztzv_f64.cu:
// the float64 passes below), built in parallel, and the host picks the
// instantiation at launch.  The wrapper picks the slice counts
// that fill the SMs in the fewest waves (ops/cuda/ztzv.py: launch_plan).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "dense_f64.cuh"
#include "gemm_common.cuh"

namespace xgpr {
namespace ztzv {

template <class T>
struct ZtzvArgs {
  const T* m;   // (n,) row mask
  const T* vc;  // (f, k)
  const T* vs;  // (f, k)
  T sigma, scale;
  int k, intercept;
  int zbase;  // the launch's first block of right-hand sides (grid z)
};

// The most blocks a launch may have along grid z: a call with more blocks
// of right-hand sides launches each pass in chunks of them (zbase).
constexpr int MAX_GRID_Z = 65535;

// ---------------------------------------------------------------------------
// The mma.sync helpers of the float32 passes at K > 1 (dense_wgmma.cuh's
// k1_zv_kernel and k1_outm_kernel, in both formats).

// n8 tiles of right-hand sides a block carries at K: 8 NT right-hand sides.
__host__ __device__ constexpr int mma_nt(int fmt, int k) {
  return k <= 8 ? 1 : fmt == FMT_BF16 ? 4 : 2;
}
// Slabs of 8 fragment columns one mma takes as its depth: m16n8k8 (TF32)
// one, m16n8k16 (bf16) two.
template <int FMT>
constexpr int MMA_JS = FMT == FMT_BF16 ? 2 : 1;

// Word of element (q, c) of a tile's staged operand (8 NT rows q, one per
// right-hand side, by 128 columns c: frequencies in pass (a), rows of x in
// pass (b)).  The swizzle puts the float2 B loads of a half-warp (q = 8 nt
// + g, g < 4; c = 8j + 2t) and the staging copies (a warp: 8 consecutive
// columns by 4 consecutive right-hand sides) on distinct banks.
__device__ __forceinline__ int staged_at(int q, int c) {
  return q * GN + (c ^ (8 * (q % 4)));
}

// Floats of one slot of a tile's staged operands: pass (a)'s v_c and v_s
// of a frequency tile (8 NT x 128 each); pass (b)'s zv (8 NT x 128) and
// the mask of a row tile.
template <int NT>
constexpr int ZV_SLOT = 2 * 8 * NT * GN;
template <int NT>
constexpr int OUT_SLOT = (8 * NT + 1) * GN;

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// v rounded to TF32 (to nearest, ties away: the host's split_tf32).
__device__ __forceinline__ uint32_t tf32_of(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// (lo, hi) rounded to bf16 (to nearest even) in one register, lo in the
// low half: the order of an mma operand pair.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (16 x 8, fp32) += a (16 x 8, TF32) b (8 x 8, TF32).
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, the same shapes, summed afresh.
__device__ __forceinline__ void mma_tf32_fresh(float d[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// d (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A operand of one mma depth step, from a thread's values v[jj][h][e]
// of fragment slab MMA_JS u + jj (row g + 8h, column 8j + 2t + e): bf16
// pairs in hi, or a TF32 split (hi + lo == v) with depth t at e = 0 and
// depth t + 4 at e = 1.
struct MmaA {
  uint32_t hi[4], lo[4];
};

template <int FMT>
__device__ __forceinline__ MmaA mma_a(const float v[][2][2]) {
  MmaA a;
  if constexpr (FMT == FMT_BF16) {
    a.hi[0] = bf16x2(v[0][0][0], v[0][0][1]);
    a.hi[1] = bf16x2(v[0][1][0], v[0][1][1]);
    a.hi[2] = bf16x2(v[1][0][0], v[1][0][1]);
    a.hi[3] = bf16x2(v[1][1][0], v[1][1][1]);
  } else {
    const float x[4] = {v[0][0][0], v[0][1][0], v[0][0][1], v[0][1][1]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a.hi[r] = tf32_of(x[r]);
      a.lo[r] = __float_as_uint(x[r] - __uint_as_float(a.hi[r]));
    }
  }
  return a;
}

// The B operand of depth step u for right-hand side q (its n8 tile's
// column g) from a staged tile: columns 16u + 2t, + 1 and 16u + 8 + 2t, + 1
// as bf16 pairs, or columns 8u + 2t (depth t) and 8u + 2t + 1 (depth t + 4)
// split into TF32.
struct MmaB {
  uint32_t hi[2], lo[2];
};

template <int FMT>
__device__ __forceinline__ MmaB mma_b(const float* tile, int q, int u,
                                      int t4) {
  MmaB b;
  if constexpr (FMT == FMT_BF16) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(
          tile + staged_at(q, 16 * u + 8 * r + 2 * t4));
      b.hi[r] = bf16x2(v.x, v.y);
    }
  } else {
    const float2 v =
        *reinterpret_cast<const float2*>(tile + staged_at(q, 8 * u + 2 * t4));
    b.hi[0] = tf32_of(v.x);
    b.hi[1] = tf32_of(v.y);
    b.lo[0] = __float_as_uint(v.x - __uint_as_float(b.hi[0]));
    b.lo[1] = __float_as_uint(v.y - __uint_as_float(b.hi[1]));
  }
  return b;
}

// A running sum of products (16 x 8, fp32, the mma's C layout: c[r] is row
// g + 8 (r / 2), column 2t + r % 2).  bf16 chains the mma's fp32
// accumulation in `main`; 3xTF32 adds each hi*hi product, summed afresh, to
// `main` with an fp32 add and chains lo*hi + hi*lo in `corr`.
struct MmaSum {
  float main[4], corr[4];
};

__device__ __forceinline__ void mma_zero(MmaSum& d) {
#pragma unroll
  for (int r = 0; r < 4; ++r) d.main[r] = d.corr[r] = 0.0f;
}

template <int FMT>
__device__ __forceinline__ void mma_add(MmaSum& d, const MmaA& a,
                                        const MmaB& b) {
  if constexpr (FMT == FMT_BF16) {
    mma_bf16(d.main, a.hi, b.hi[0], b.hi[1]);
  } else {
    float p[4];
    mma_tf32_fresh(p, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
    for (int r = 0; r < 4; ++r) d.main[r] += p[r];
    mma_tf32(d.corr, a.lo, b.hi[0], b.hi[1]);
    mma_tf32(d.corr, a.hi, b.lo[0], b.lo[1]);
  }
}

template <int FMT>
__device__ __forceinline__ float mma_value(const MmaSum& d, int r) {
  return FMT == FMT_BF16 ? d.main[r] : d.main[r] + d.corr[r];
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

// Launches `kernel` over `kblocks` blocks of right-hand sides along grid z
// in chunks of at most MAX_GRID_Z, each with its zbase; launch(args,
// nz) issues one.
template <class T, class Launch>
cudaError_t over_rhs_blocks(const ZtzvArgs<T>& a, int kblocks,
                            Launch&& launch) {
  for (int z0 = 0; z0 < kblocks; z0 += MAX_GRID_Z) {
    ZtzvArgs<T> c = a;
    c.zbase = z0;
    launch(c, kblocks - z0 < MAX_GRID_Z ? kblocks - z0 : MAX_GRID_Z);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The float64 format's passes (a) and (b), on the DMMA loop of
// dense_f64.cuh at tiles of 128 x 64 (8 warps of 1 x 8 m16n8k8 tiles: a
// warp's 16 GEMM rows by the tile's 64 columns), two tiles for each
// 128-wide tile of the walk, so the walks and the wrapper's block
// arithmetic are the other formats'.  Pass (a) projects x against the
// frequencies and contracts over them with v_c / v_s; pass (b) projects
// the swapped operands (frequencies x rows of x) and contracts over the
// rows with zv, which a small launch sums over pass (a)'s split first
// (sum_zv_kernel).  Both contractions run on the tensor cores straight
// from the projection's accumulators: an m16n8k8 A operand is lane
// (g, t)'s values of rows g, g + 8 at depths t and t + 4, and the
// accumulators hold rows g, g + 8 at columns 8n + 2t and 8n + 2t + 1, so
// with those two columns as depths t and t + 4 each 8-column slab n of the
// fold is one product's A operand as it stands.  A block carries 8 NT
// right-hand sides (NT n8 tiles: 1 up to K 8, else 4), so at K 26 each
// pass projects once; the sums stay in the products' accumulators (pass
// (a) 4 NT a thread, pass (b) 8 NT).  The staged operand of a tile (v_c
// and v_s of its 64 frequencies in pass (a); zv and the mask of its 64
// rows in pass (b)) goes in by 8-byte cp.async into one of two slots with
// a full and an empty mbarrier each, at the previous tile's first step,
// transposed (a row of 64 values per right-hand side, slot_at), so a B
// operand's two values are one 16-byte load and a quarter warp's loads
// fall on distinct banks.  At D <= 96 the rows of x (pass (a)) or of
// proj^T (pass (b)) stay resident (dense_f64.cuh), so the ring carries
// the walk's operand alone.
using K1Tiling = f64::Tiling<1, 6, true>;

// Element (q, c) of a staged operand: right-hand side q, column c of the
// tile; odd rows' 8-value halves swapped.
__device__ __forceinline__ int slot_at(int q, int c) {
  return q * K1Tiling::BN + (c ^ (8 * (q & 1)));
}
template <int NT>
constexpr int F64_ZV_SLOT = 2 * 8 * NT * K1Tiling::BN;  // doubles
template <int NT>
constexpr int F64_OUT_SLOT = (8 * NT + 1) * K1Tiling::BN;
template <int NT>
constexpr int F64_ZV_SMEM =
    f64::smem_bytes<K1Tiling>(2 * F64_ZV_SLOT<NT> * (int)sizeof(double));
template <int NT>
constexpr int F64_OUT_SMEM =
    f64::smem_bytes<K1Tiling>(2 * F64_OUT_SLOT<NT> * (int)sizeof(double));

// Pass (a) in float64: partial zv over the frequency tiles of this block's
// walk for right-hand sides 8 NT (blockIdx.z + zbase) ...
template <int NT>
__global__ void __launch_bounds__(f64::THREADS, 1)
    ztzv_zv_f64_kernel(DenseOperands p, ZtzvArgs<double> a,
                       double* __restrict__ zv_part) {
  using Tl = K1Tiling;
  constexpr int KO = 8 * NT, BN = Tl::BN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) f64::RingBarriers bar;
  __shared__ __align__(8) f64::Barriers<2> slot;  // the two slots'
  unsigned char* smem = ring_base(smem_raw);
  double* const slots = reinterpret_cast<double*>(smem + Tl::RING);
  bar.init();
  slot.init();
  __syncthreads();
  const DenseWalk w = dense_walk(true, p.n, p.f);
  const int kc = (p.dp + f64::LINE - 1) / f64::LINE;
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int row0 = w.row0(0), rbase = row0 + 16 * (tid / 32) + g;
  const int k0 = (blockIdx.z + a.zbase) * KO, kcnt = min(KO, a.k - k0);
  const int ntiles = 2 * w.count;
  auto col0 = [&](int u) { return w.col0(u / 2) + BN * (u % 2); };

  double mrow[2], wrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rbase + 8 * h;
    mrow[h] = r < p.n ? a.m[r] : 0.0;
    wrow[h] = mrow[h] * a.scale;
  }
  // zv of rows rbase + 8h, right-hand sides k0 + 8nt + 2t4 + e, at
  // z[nt][2h + e] (an m16n8 tile's C).
  double z[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) z[nt][i] = 0.0;

  // Tile u's v_c and v_s into slot u % 2 (v_c then v_s, row q holding
  // right-hand side k0 + q at frequencies col0(u) + [0, 64)).
  auto stage_v = [&](int u) {
    const int sl = u % 2, f0 = col0(u);
    if (u >= 2) mbar_wait(&slot.empty[sl], ((u / 2) - 1) & 1);
    double* vc = slots + sl * F64_ZV_SLOT<NT>;
#pragma unroll 2
    for (int e = tid; e < BN * KO; e += f64::THREADS) {
      const int fl = e / KO, q = e % KO;
      const bool ok = f0 + fl < p.f && q < kcnt;
      const size_t at = ok ? (size_t)(f0 + fl) * a.k + k0 + q : 0;
      f64::cp_async8(vc + slot_at(q, fl), a.vc + at, ok);
      f64::cp_async8(vc + KO * BN + slot_at(q, fl), a.vs + at, ok);
    }
    arrive_on_copies(&slot.full[sl]);
  };
  if (ntiles > 0) stage_v(0);

  double acc[Tl::ACC];
#pragma unroll
  for (int i = 0; i < Tl::ACC; ++i) acc[i] = 0.0;
  f64::dense_loop<Tl>(
      smem, bar, p, ntiles, kc, acc, [&](int) { return row0; }, col0,
      [&](int u) {
        if (u + 1 < ntiles) stage_v(u + 1);
      },
      [&](int u) {  // frequency tile u is complete: its share of zv
        const int sl = u % 2;
        mbar_wait(&slot.full[sl], (u / 2) & 1);
        const double* vc = slots + sl * F64_ZV_SLOT<NT>;
        const double* vs = vc + KO * BN;
        const bool icol = a.intercept && col0(u) == 0 && t4 == 0;
        __syncwarp();
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          double c[2][2], s[2][2];  // [h][e]: row rbase + 8h, column 8n + 2t4 + e
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              sincos_scaled<MODE_EXACT>(acc[4 * n + 2 * h + e] * a.sigma,
                                        wrow[h], &c[h][e], &s[h][e]);
          if (n == 0 && icol) {  // column 0 of the intercept
            c[0][0] = mrow[0];
            c[1][0] = mrow[1];
          }
          const int fl = 8 * n + 2 * t4;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int at = slot_at(8 * nt + g, fl);
            const double2 bc = *reinterpret_cast<const double2*>(vc + at);
            const double2 bs = *reinterpret_cast<const double2*>(vs + at);
            dmma16x8x8(z[nt], c[0][0], c[1][0], c[0][1], c[1][1], bc.x,
                       bc.y);
            dmma16x8x8(z[nt], s[0][0], s[1][0], s[0][1], s[1][1], bs.x,
                       bs.y);
          }
        }
        release(&slot.empty[sl]);
      });

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rbase + 8 * h;
    if (r >= p.n) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * nt + 2 * t4 + e;
        if (q < kcnt)
          zv_part[((size_t)blockIdx.y * p.n + r) * a.k + k0 + q] =
              z[nt][2 * h + e];
      }
  }
}

// Pass (b) in float64 on the swapped operands t (t.n = F frequencies as
// rows, t.f = R rows of x as columns): partial oc/os of one frequency tile
// over the row tiles of this block's walk, right-hand sides 8 NT
// (blockIdx.z + zbase) ...; zv (R, K) is pass (a)'s sum.
template <int NT>
__global__ void __launch_bounds__(f64::THREADS, 1)
    ztzv_out_f64_kernel(DenseOperands t, ZtzvArgs<double> a,
                        const double* __restrict__ zv,
                        double* __restrict__ oc_part,
                        double* __restrict__ os_part) {
  using Tl = K1Tiling;
  constexpr int KO = 8 * NT, BN = Tl::BN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) f64::RingBarriers bar;
  __shared__ __align__(8) f64::Barriers<2> slot;  // the two slots'
  unsigned char* smem = ring_base(smem_raw);
  double* const slots = reinterpret_cast<double*>(smem + Tl::RING);
  bar.init();
  slot.init();
  __syncthreads();
  const DenseWalk w = dense_walk(true, t.n, t.f);
  const int kc = (t.dp + f64::LINE - 1) / f64::LINE;
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int fq0 = w.row0(0), fbase = fq0 + 16 * (tid / 32) + g;
  const int k0 = (blockIdx.z + a.zbase) * KO, kcnt = min(KO, a.k - k0);
  const int ntiles = 2 * w.count;
  auto col0 = [&](int u) { return w.col0(u / 2) + BN * (u % 2); };

  // oc (o[0]) and os (o[1]) of frequencies fbase + 8h, right-hand sides
  // k0 + 8nt + 2t4 + e, at [nt][2h + e].
  double o[2][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[0][nt][i] = o[1][nt][i] = 0.0;

  // Row tile u's zv and mask into slot u % 2 (row q of zv holding
  // right-hand side k0 + q at rows col0(u) + [0, 64), then the mask).
  auto stage_zv = [&](int u) {
    const int sl = u % 2, r0 = col0(u);
    if (u >= 2) mbar_wait(&slot.empty[sl], ((u / 2) - 1) & 1);
    double* zt = slots + sl * F64_OUT_SLOT<NT>;
#pragma unroll 2
    for (int e = tid; e < BN * KO; e += f64::THREADS) {
      const int rl = e / KO, q = e % KO;
      const bool ok = r0 + rl < t.f && q < kcnt;
      const size_t at = ok ? (size_t)(r0 + rl) * a.k + k0 + q : 0;
      f64::cp_async8(zt + slot_at(q, rl), zv + at, ok);
    }
    if (tid < BN) {
      const bool ok = r0 + tid < t.f;
      f64::cp_async8(zt + KO * BN + tid, a.m + (ok ? r0 + tid : 0), ok);
    }
    arrive_on_copies(&slot.full[sl]);
  };
  if (ntiles > 0) stage_zv(0);

  double acc[Tl::ACC];
#pragma unroll
  for (int i = 0; i < Tl::ACC; ++i) acc[i] = 0.0;
  f64::dense_loop<Tl>(
      smem, bar, t, ntiles, kc, acc, [&](int) { return fq0; }, col0,
      [&](int u) {
        if (u + 1 < ntiles) stage_zv(u + 1);
      },
      [&](int u) {  // row tile u is complete: its share of oc, os
        const int sl = u % 2;
        mbar_wait(&slot.full[sl], (u / 2) & 1);
        const double* zt = slots + sl * F64_OUT_SLOT<NT>;
        const double* mt = zt + KO * BN;
        __syncwarp();
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          double c[2][2], s[2][2];  // [h][e]: frequency fbase + 8h, row 8n + 2t4 + e
          const int rl = 8 * n + 2 * t4;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const double mr = mt[rl + e], wr = mr * a.scale;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              sincos_scaled<MODE_EXACT>(acc[4 * n + 2 * h + e] * a.sigma, wr,
                                        &c[h][e], &s[h][e]);
              if (a.intercept && fbase + 8 * h == 0) c[h][e] = mr;
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const double2 b = *reinterpret_cast<const double2*>(
                zt + slot_at(8 * nt + g, rl));
            dmma16x8x8(o[0][nt], c[0][0], c[1][0], c[0][1], c[1][1], b.x,
                       b.y);
            dmma16x8x8(o[1][nt], s[0][0], s[1][0], s[0][1], s[1][1], b.x,
                       b.y);
          }
        }
        release(&slot.empty[sl]);
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
        oc_part[at] = o[0][nt][2 * h + e];
        os_part[at] = o[1][nt][2 * h + e];
      }
  }
}

// zv_part[0] = the sum of pass (a)'s nsplit partials, in split order.
// Internal linkage, as sum_splits_kernel.
template <class T>
static __global__ void sum_zv_kernel(T* __restrict__ zv_part, int nsplit,
                                     size_t len) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  T v = zv_part[i];
  for (int s = 1; s < nsplit; ++s) v += zv_part[(size_t)s * len + i];
  zv_part[i] = v;
}

// Right-hand sides a block of the float64 passes carries at K: 8 NT.
__host__ __device__ constexpr int f64_nt(int k) { return k <= 8 ? 1 : 4; }

// The float64 format's launches, NT = f64_nt(K): pass (a), the sum of its
// split, pass (b), the sum of pass (b)'s split.
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
  err = cudaFuncSetAttribute(ztzv_out_f64_kernel<NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F64_OUT_SMEM<NT>);
  if (err != cudaSuccess) return err;
  const int kblocks = (a.k + KO - 1) / KO;
  err = over_rhs_blocks(a, kblocks, [&](const ZtzvArgs<double>& c, int nz) {
    ztzv_zv_f64_kernel<NT><<<dim3((p.n + GM - 1) / GM, zsplit, nz),
                             f64::THREADS, F64_ZV_SMEM<NT>, st>>>(p, c,
                                                                  zv_part);
  });
  if (err != cudaSuccess) return err;
  const size_t zlen = (size_t)p.n * a.k;
  if (zsplit > 1) {
    sum_zv_kernel<double><<<(unsigned)((zlen + 255) / 256), 256, 0, st>>>(
        zv_part, zsplit, zlen);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const DenseOperands t{p.b_hi, p.b_lo, p.x_hi, p.x_lo, p.f, p.dp, p.n};
  err = over_rhs_blocks(a, kblocks, [&](const ZtzvArgs<double>& c, int nz) {
    ztzv_out_f64_kernel<NT><<<dim3((p.f + GM - 1) / GM, osplit, nz),
                              f64::THREADS, F64_OUT_SMEM<NT>, st>>>(
        t, c, zv_part, oc_part, os_part);
  });
  if (err != cudaSuccess) return err;
  const size_t len = (size_t)p.f * a.k;
  sum_splits_kernel<double><<<(unsigned)((len + 255) / 256), 256, 0, st>>>(
      oc_part, os_part, oc, os, osplit, len);
  return cudaGetLastError();
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
