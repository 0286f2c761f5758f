// K1's reuse path in 3xTF32 (the wrapper takes it from K = REUSE_MIN_K =
// 17 right-hand sides, ops/cuda/ztzv.py: launch_plan): each chunk's
// features are projected, folded and stored once a call, and every
// contraction streams them.  The same sums as ztzv.cuh's passes, to fp32
// grade:
//
//   (f) k1_features_kernel (dense_wgmma.cuh): K2's walk and TMA pipeline
//       with K1's fold (sigma, the mask times scale, the intercept column)
//       -> C = c and S = s, (n, ldf) fp32 each, ldf = F rounded up to 4,
//       in the call's scratch; v_c^T and v_s^T (K, ldf) beside them
//       (pack_vt_kernel);
//   (a) zv_stream_kernel: zv = C v_c + S v_s (n, kp), kp = K rounded up
//       to 4, over zsplit slices of the column stages, summed in slice
//       order by dense_wgmma.cuh's sum_zv_slices_kernel;
//   (b) out_stream_kernel: oc = C^T zv, os = S^T zv over osplit slices of
//       the row stages, summed in slice order (ztzv.cuh:
//       sum_splits_kernel).
//
// Why.  The 3xTF32 passes of ztzv.cuh carry at most 16 right-hand sides a
// block (the main and correction sums of 32 do not fit beside the
// projection's 64 accumulators in 255 registers), so from K 17 they
// project and fold every chunk 2 ceil(K / 16) times a call, four at SLQ's
// K 26: 0.64 ms a call at RBF's chunk (8192 x 84 rows, F 4096), of which
// the projections' products take 0.22 ms and the folds 0.13 (PERF.md).
// Here the projection and the fold run once (5.6 GFLOP, 0.034 ms as three
// TF32 products, and 33.5M sincos pairs), and the contractions (3xTF32
// mma.sync, 7.0 GFLOP at K 26) read the stored features: C and S are 268
// MB at that chunk, written once and read twice (once a pass; a block
// carries 32 right-hand sides, the streams holding no projection
// accumulators), 805 MB or 0.24 ms at 3.35 TB/s, which bounds the path;
// it runs in 0.36 ms (the feature pass 0.123, pass (a) 0.114, pass (b)
// 0.103).  Up to K 16 the passes project twice and move no features
// through device memory, and run as fast (0.33 against 0.34 ms at K 16).
// A pass (a) that also contracted from the fragment, as ztzv.cuh's does,
// would still carry at most 16 right-hand sides, so at K 26 the rest
// would read C and S once more: the same bytes, and a slower feature
// pass.
//
// The streams.  A block of 256 threads (8 warps, two blocks an SM) walks
// stages of 64 x 64 values on a ring of STAGES stages that thread 0 fills
// by TMA (boxes of 32 values, the 128-byte swizzle, zeros past the
// arrays) and refills once the eight warps have released a stage.  Pass
// (a)'s block holds 64 rows of C and S and walks the column stages of C
// (with v_c^T) then of S (with v_s^T); warp w multiplies rows 16 (w % 4)
// .. against the stage's columns 32 (w / 4) ..; pass (b)'s holds 64
// columns of C or S and walks the row stages (with zv's rows); warp w
// takes columns 16 (w % 4) .. against the stage's rows 32 (w / 4) ...
// The products are m16n8k8 TF32 mma.sync, A and B loaded from the boxes
// as fp32 and split on chip into TF32 high parts and remainders (ztzv.cuh:
// MmaSum, lo*hi + hi*lo + hi*hi, each hi*hi product summed afresh), RHS =
// 32 right-hand sides a block (NT = 4 n8 tiles).  Pass (a)'s depth t
// of a k8 step is column t of the step (its A and B loads fall on 32
// banks), pass (b)'s is row 2t and depth t + 4 row 2t + 1 (its transposed
// loads then fall on 32 banks).  The two warps that share rows (pass (a))
// or columns (pass (b)) add their sums, the second to the first, through
// shared memory: each output has one summation order, no atomics, and two
// calls give the same bits.
#pragma once

#include "dense_wgmma.cuh"

namespace xgpr {
namespace reuse {

constexpr int THREADS = 256;
constexpr int ROWS = 64;     // a stage's rows
constexpr int BOX = 32;      // values a box row: 128 bytes
constexpr int COLS = 2 * BOX;  // a stage's columns: two boxes
constexpr int STAGES = 4;
constexpr int NT = 4;          // n8 tiles of right-hand sides a block
constexpr int RHS = 8 * NT;    // right-hand sides a block: 32
constexpr int Z_BOX = ROWS * 128;  // 64 rows of C or S, or of zv
constexpr int V_BOX = RHS * 128;   // 32 rows of v_c^T or v_s^T
constexpr int ZV_STAGE = 2 * Z_BOX + 2 * V_BOX;
constexpr int OUT_STAGE = 3 * Z_BOX;
constexpr int RED_BYTES = 4 * NT * 4 * 32 * 4;  // the second warps' sums
constexpr int ZV_SMEM = STAGES * ZV_STAGE + RED_BYTES + 1024;
constexpr int OUT_SMEM = STAGES * OUT_STAGE + RED_BYTES + 1024;

struct Ring {
  uint64_t full[STAGES], empty[STAGES];
};

// Value (row, col) of a box of 128-byte rows in the 128-byte swizzle.
__device__ __forceinline__ float box_at(const unsigned char* box, int row,
                                        int col) {
  return *reinterpret_cast<const float*>(box + sw128(row, col >> 2) +
                                         ((col & 3) << 2));
}

// The TF32 splits (hi + lo == v) of an mma's A values and of its B values.
__device__ __forceinline__ ztzv::MmaA split_a(float v0, float v1, float v2,
                                              float v3) {
  const float v[4] = {v0, v1, v2, v3};
  ztzv::MmaA a;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a.hi[r] = ztzv::tf32_of(v[r]);
    a.lo[r] = __float_as_uint(v[r] - __uint_as_float(a.hi[r]));
  }
  return a;
}
__device__ __forceinline__ ztzv::MmaB split_b(float v0, float v1) {
  ztzv::MmaB b;
  b.hi[0] = ztzv::tf32_of(v0);
  b.hi[1] = ztzv::tf32_of(v1);
  b.lo[0] = __float_as_uint(v0 - __uint_as_float(b.hi[0]));
  b.lo[1] = __float_as_uint(v1 - __uint_as_float(b.hi[1]));
  return b;
}

// A block's walk of `count` stages: thread 0 fills stage j by
// fill(j, dst, full) (STAGES ahead), every warp runs body(stage) on it and
// releases it, and thread 0 fills it again once all eight warps have.
template <int STAGE, class Fill, class Body>
__device__ __forceinline__ void stream(unsigned char* ring, Ring& bar,
                                       int count, Fill&& fill, Body&& body) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&bar.full[i], 1);
      mbar_init(&bar.empty[i], THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int j = 0; j < min(STAGES, count); ++j)
      fill(j, ring + j * STAGE, &bar.full[j]);
  __syncwarp();
  for (int j = 0; j < count; ++j) {
    const Slot s(j, STAGES);
    mbar_wait(&bar.full[s.stage], s.parity);
    body(ring + s.stage * STAGE);
    release(&bar.empty[s.stage]);
    if (threadIdx.x == 0 && j + STAGES < count) {
      mbar_wait(&bar.empty[s.stage], s.parity);
      fill(j + STAGES, ring + s.stage * STAGE, &bar.full[s.stage]);
    }
    __syncwarp();  // the warp meets again before its next mma
  }
}

// The sums of warps 4 .. 7 added to those of warps 0 .. 3 (the same rows
// or columns of the output), in that order; put(nt, r, value) for warps
// 0 .. 3 (an m16n8 tile's C layout: row g + 8 (r / 2), column 2t + r % 2).
template <class Put>
__device__ __forceinline__ void combine(const ztzv::MmaSum (&sums)[NT],
                                        float* red, Put&& put) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* mine = red + (warp % 4) * NT * 4 * 32 + lane;
  if (warp >= 4) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        mine[(nt * 4 + r) * 32] = ztzv::mma_value<FMT_TF32X3>(sums[nt], r);
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        put(nt, r, ztzv::mma_value<FMT_TF32X3>(sums[nt], r) +
                       mine[(nt * 4 + r) * 32]);
  }
}

// Pass (a): partial zv of the block's 64 rows over slice s of the 2 ctiles
// column stages (C's, then S's), right-hand sides RHS kz ...; block
// (rt, s, kz) is blockIdx.x = (kz * zsplit + s) * row tiles + rt.  zc, zs:
// C and S (ldf, n) in boxes of 32 x 64; vc, vs: v_c^T and v_s^T (ldf, k)
// in boxes of 32 x RHS.  zv_part is (zsplit, n, kp).
__global__ void __launch_bounds__(THREADS, 2)
    zv_stream_kernel(const __grid_constant__ CUtensorMap zc,
                     const __grid_constant__ CUtensorMap zs,
                     const __grid_constant__ CUtensorMap vc,
                     const __grid_constant__ CUtensorMap vs, int n, int ldf,
                     int kp, int zsplit, float* __restrict__ zv_part) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) Ring bar;
  unsigned char* ring = ring_base(smem_raw);
  float* red = reinterpret_cast<float*>(ring + STAGES * ZV_STAGE);
  const int row_tiles = (n + ROWS - 1) / ROWS;
  const int rt = (int)(blockIdx.x % row_tiles);
  const int rest = (int)(blockIdx.x / row_tiles);
  const int s = rest % zsplit, kz = rest / zsplit;
  const int ctiles = (ldf + COLS - 1) / COLS, tiles = 2 * ctiles;
  const int count = s < tiles ? (tiles - 1 - s) / zsplit + 1 : 0;
  const int r0 = rt * ROWS, q0 = RHS * kz;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mrow = 16 * (warp % 4), half = warp / 4;
  ztzv::MmaSum z[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) ztzv::mma_zero(z[nt]);

  auto fill = [&](int j, unsigned char* dst, uint64_t* full) {
    const int tile = s + j * zsplit, col0 = COLS * (tile % ctiles);
    const bool sin_plane = tile >= ctiles;
    const CUtensorMap* zm = sin_plane ? &zs : &zc;
    const CUtensorMap* vm = sin_plane ? &vs : &vc;
    mbar_expect_tx(full, ZV_STAGE);
    tma_box2(dst, zm, full, col0, r0);
    tma_box2(dst + Z_BOX, zm, full, col0 + BOX, r0);
    tma_box2(dst + 2 * Z_BOX, vm, full, col0, q0);
    tma_box2(dst + 2 * Z_BOX + V_BOX, vm, full, col0 + BOX, q0);
  };
  auto body = [&](const unsigned char* st) {
    const unsigned char* zb = st + half * Z_BOX;
    const unsigned char* vb = st + 2 * Z_BOX + half * V_BOX;
#pragma unroll
    for (int u = 0; u < BOX / 8; ++u) {
      const int c0 = 8 * u + t;
      const ztzv::MmaA a =
          split_a(box_at(zb, mrow + g, c0), box_at(zb, mrow + g + 8, c0),
                  box_at(zb, mrow + g, c0 + 4),
                  box_at(zb, mrow + g + 8, c0 + 4));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        ztzv::mma_add<FMT_TF32X3>(
            z[nt], a,
            split_b(box_at(vb, 8 * nt + g, c0),
                    box_at(vb, 8 * nt + g, c0 + 4)));
    }
  };
  stream<ZV_STAGE>(ring, bar, count, fill, body);
  // Every slice's partial is written, an empty one's as zeros.
  combine(z, red, [&](int nt, int r, float v) {
    const int row = r0 + mrow + g + 8 * (r / 2);
    const int q = q0 + 8 * nt + 2 * t + r % 2;
    if (row < n && q < kp) zv_part[((size_t)s * n + row) * kp + q] = v;
  });
}

// Pass (b): partial oc (C's columns) or os (S's) of the block's 64 columns
// over slice s of the row stages, right-hand sides RHS kz ...; block
// (ct, s, kz) is blockIdx.x = (kz * osplit + s) * 2 ctiles + ct, ct <
// ctiles a tile of C.  zvm: zv (kp, n) in boxes of 32 x 64.  oc_part,
// os_part are (osplit, f, k).
__global__ void __launch_bounds__(THREADS, 2)
    out_stream_kernel(const __grid_constant__ CUtensorMap zc,
                      const __grid_constant__ CUtensorMap zs,
                      const __grid_constant__ CUtensorMap zvm, int n, int f,
                      int ldf, int k, int osplit,
                      float* __restrict__ oc_part,
                      float* __restrict__ os_part) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) Ring bar;
  unsigned char* ring = ring_base(smem_raw);
  float* red = reinterpret_cast<float*>(ring + STAGES * OUT_STAGE);
  const int ctiles = (ldf + COLS - 1) / COLS;
  const int ct = (int)(blockIdx.x % (2 * ctiles));
  const int rest = (int)(blockIdx.x / (2 * ctiles));
  const int s = rest % osplit, kz = rest / osplit;
  const bool sin_plane = ct >= ctiles;
  const int col0 = COLS * (ct % ctiles);
  const int tiles = (n + ROWS - 1) / ROWS;
  const int count = s < tiles ? (tiles - 1 - s) / osplit + 1 : 0;
  const int q0 = RHS * kz;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mcol = 16 * (warp % 4), half = warp / 4;
  const CUtensorMap* zm = sin_plane ? &zs : &zc;
  ztzv::MmaSum o[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) ztzv::mma_zero(o[nt]);

  auto fill = [&](int j, unsigned char* dst, uint64_t* full) {
    const int r = ROWS * (s + j * osplit);
    mbar_expect_tx(full, OUT_STAGE);
    tma_box2(dst, zm, full, col0, r);
    tma_box2(dst + Z_BOX, zm, full, col0 + BOX, r);
    tma_box2(dst + 2 * Z_BOX, &zvm, full, q0, r);
  };
  auto body = [&](const unsigned char* st) {
    const unsigned char* zb = st + (mcol / BOX) * Z_BOX;
    const unsigned char* vb = st + 2 * Z_BOX;
    const int cb = mcol % BOX;
#pragma unroll
    for (int u = 0; u < BOX / 8; ++u) {
      const int rr = BOX * half + 8 * u + 2 * t;  // depth t; rr + 1 t + 4
      const ztzv::MmaA a =
          split_a(box_at(zb, rr, cb + g), box_at(zb, rr, cb + g + 8),
                  box_at(zb, rr + 1, cb + g), box_at(zb, rr + 1, cb + g + 8));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        ztzv::mma_add<FMT_TF32X3>(
            o[nt], a,
            split_b(box_at(vb, rr, 8 * nt + g),
                    box_at(vb, rr + 1, 8 * nt + g)));
    }
  };
  stream<OUT_STAGE>(ring, bar, count, fill, body);
  float* out = sin_plane ? os_part : oc_part;
  combine(o, red, [&](int nt, int r, float v) {
    const int col = col0 + mcol + g + 8 * (r / 2);
    const int q = q0 + 8 * nt + 2 * t + r % 2;
    if (col < f && q < k) out[((size_t)s * f + col) * k + q] = v;
  });
}

// vt = [v_c^T; v_s^T], (2k, ldf): vt[q][col] = v[col][q] for col < f,
// zeros to ldf.
static __global__ void pack_vt_kernel(const float* __restrict__ vc,
                                      const float* __restrict__ vs,
                                      float* __restrict__ vt, int f, int ldf,
                                      int k) {
  const size_t len = (size_t)k * ldf;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * len) return;
  const size_t at = i % len;
  const int q = (int)(at / ldf), col = (int)(at % ldf);
  const float* v = i < len ? vc : vs;
  vt[i] = col < f ? v[(size_t)col * k + q] : 0.0f;
}

// The map of a contiguous (rows, cols) fp32 array in boxes of 32 values by
// box_rows rows.
inline bool box_map(CUtensorMap* map, const void* base, int cols, int rows,
                    int box_rows) {
  const int dims[2] = {cols, rows}, box[2] = {BOX, box_rows};
  return swizzled_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, 2, dims,
                      box);
}

// Pass (a), the sum of its slices and pass (b).
inline cudaError_t launch_streams(const CUtensorMap& zc, const CUtensorMap& zs,
                           const float* vt, float* zv, float* oc_part,
                           float* os_part, int n, int f, int ldf, int k,
                           int zsplit, int osplit, cudaStream_t st) {
  const int kp = (k + 3) / 4 * 4;
  CUtensorMap vc, vs, zvm;
  if (!box_map(&vc, vt, ldf, k, RHS) ||
      !box_map(&vs, vt + (size_t)k * ldf, ldf, k, RHS) ||
      !box_map(&zvm, zv, kp, n, ROWS))
    return cudaErrorNotSupported;
  const long long kblocks = (k + RHS - 1) / RHS;
  const long long ctiles = (ldf + COLS - 1) / COLS;
  const long long blocks_a = (n + ROWS - 1) / ROWS * zsplit * kblocks;
  const long long blocks_b = 2 * ctiles * osplit * kblocks;
  if (blocks_a > 0x7fffffff || blocks_b > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaError_t err = dense::allow_smem(zv_stream_kernel, ZV_SMEM);
  if (err != cudaSuccess) return err;
  zv_stream_kernel<<<(unsigned)blocks_a, THREADS, ZV_SMEM, st>>>(
      zc, zs, vc, vs, n, ldf, kp, zsplit, zv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (zsplit > 1) {
    const size_t len = (size_t)n * kp;
    dense::sum_zv_slices_kernel<float>
        <<<(unsigned)((len + 255) / 256), 256, 0, st>>>(zv, zsplit, len);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = dense::allow_smem(out_stream_kernel, OUT_SMEM);
  if (err != cudaSuccess) return err;
  out_stream_kernel<<<(unsigned)blocks_b, THREADS, OUT_SMEM, st>>>(
      zc, zs, zvm, n, f, ldf, k, osplit, oc_part, os_part);
  return cudaGetLastError();
}

// One call on the reuse path: z holds C then S, (n, ldf) each; vt
// (2k, ldf); zv (zsplit, n, kp); rsplit blocks share each frequency
// tile's row tiles in the feature pass.  Anything else is refused.
inline int launch_k1_reuse(const DenseOperands& p,
                           const ztzv::ZtzvArgs<float>& a, float* z,
                           float* vt, float* zv, float* oc_part,
                           float* os_part, float* oc, float* os, int rsplit,
                           int zsplit, int osplit, int mode,
                           cudaStream_t st) {
  if (rsplit < 1 || zsplit < 1 || osplit < 1 ||
      p.dp % 4 != 0 || p.n < 1 || p.f < 1 || a.k < 1 || mode < MODE_HI ||
      mode > MODE_POLY)
    return (int)cudaErrorInvalidValue;
  const int ldf = (p.f + 3) / 4 * 4;
  const long long fblocks =
      (long long)rsplit * ((p.f + dense::B_ROWS - 1) / dense::B_ROWS);
  if (fblocks > 0x7fffffff || 2LL * a.k * ldf > 0x7fffffffLL * 256)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xh, xl, ph, pl, zc, zs;
  float* const s_plane = z + (size_t)p.n * ldf;
  if (!dense::plane_maps<FMT_TF32X3>(&xh, &xl, p.x_hi, p.x_lo, p.n, p.dp,
                                     dense::A_ROWS) ||
      !dense::plane_maps<FMT_TF32X3>(&ph, &pl, p.b_hi, p.b_lo, p.f, p.dp,
                                     dense::B_ROWS) ||
      !box_map(&zc, z, ldf, p.n, ROWS) || !box_map(&zs, s_plane, ldf, p.n, ROWS))
    return (int)cudaErrorNotSupported;
  auto kernel = mode == MODE_HI      ? dense::k1_features_kernel<MODE_HI>
                : mode == MODE_EXACT ? dense::k1_features_kernel<MODE_EXACT>
                : mode == MODE_FAST  ? dense::k1_features_kernel<MODE_FAST>
                                     : dense::k1_features_kernel<MODE_POLY>;
  cudaError_t err = dense::allow_smem(kernel, dense::K2_SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)fblocks, dense::THREADS, dense::K2_SMEM, st>>>(
      xh, xl, ph, pl, zc, zs, p, a, rsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t vlen = 2 * (size_t)a.k * ldf;
  pack_vt_kernel<<<(unsigned)((vlen + 255) / 256), 256, 0, st>>>(
      a.vc, a.vs, vt, p.f, ldf, a.k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_streams(zc, zs, vt, zv, oc_part, os_part, p.n, p.f, ldf, a.k,
                       zsplit, osplit, st);
  if (err != cudaSuccess) return (int)err;
  const size_t len = (size_t)p.f * a.k;
  ztzv::sum_splits_kernel<float>
      <<<(unsigned)((len + 255) / 256), 256, 0, st>>>(oc_part, os_part, oc,
                                                       os, osplit, len);
  return (int)cudaGetLastError();
}

}  // namespace reuse
}  // namespace xgpr
