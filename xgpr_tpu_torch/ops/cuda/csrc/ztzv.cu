// Fused CG matvec for one chunk on Hopper (K1): Z^T (Z v) without writing Z,
// its projections on the tensor cores at fp32 grade.
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
// each at 495 TFLOP/s (0.17 ms as fp32 FMAs on CUDA cores), plus
// 2 x 33.5M sincos pairs on the CUDA cores.  Recomputing the features
// instead of writing Z trades 268 MB of traffic per chunk for the second
// projection.
//
// Design: both passes are the 3xTF32 wgmma body of tf32_gemm.cuh with the
// dense row policy, 128-row x 128-frequency tiles whose stages flow from
// one tile to the next of a block's walk (the role the window-group loop
// plays in conv.cu).  Up to D 96 (RBF's 84) the tile the walk does not
// move stays in shared memory and the ring carries only the other
// operand (dense_pipeline): half the copies a step.  The epilogues work
// on the accumulator fragment; the small per-tile operands (v_c/v_s of a
// frequency tile, zv and the mask of a row tile) are staged in shared
// memory with the tile's first copies, in a ring of three slots.  Pass
// (a) carries KC right-hand sides per block (grid z walks K in chunks of
// 8 when K > 1); pass (b) keeps 64 column sums a thread, so it takes one
// right-hand side per block (grid z = K).
// The wrapper picks the slice counts that fill the SMs in the fewest waves.
#include "common.cuh"
#include "tf32_gemm.cuh"

using namespace xgpr;

namespace {

struct ZtzvArgs {
  const float* m;   // (n,) row mask
  const float* vc;  // (f, k)
  const float* vs;  // (f, k)
  float sigma, scale;
  int k, intercept, exact;
};

// Partial zv over the frequency tiles of this block's walk.
template <int KC>
__global__ void __launch_bounds__(GT, 1)
    ztzv_zv_kernel(DenseOperands p, ZtzvArgs a, float* __restrict__ zv_part) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float vcs[3][GN * KC], vss[3][GN * KC];
  unsigned char* smem = ring_base(smem_raw);
  const DenseWalk w = dense_walk(true, p.n, p.f);
  const int kc = max(1, (p.dp + GK - 1) / GK);
  const int tid = threadIdx.x, lane = tid % 32, t4 = lane % 4;
  const int rbase = (tid / 32) * 16 + lane / 4;
  const int k0 = blockIdx.z * KC, kcnt = min(KC, a.k - k0);

  float mrow[2], wrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = w.row0(0) + rbase + 8 * h;
    mrow[h] = r < p.n ? a.m[r] : 0.0f;
    wrow[h] = mrow[h] * a.scale;
  }
  float part[2][KC];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < KC; ++q) part[h][q] = 0.0f;

  auto stage_v = [&](int step) {
    if (step % kc == 0) {  // stage the tile's v_c / v_s
      const int i = step / kc, f0 = w.col0(i);
      for (int e = tid; e < GN * KC; e += GT) {
        const int fl = e / KC, q = e % KC, gf = f0 + fl;
        const bool ok = gf < p.f && q < kcnt;
        const size_t at = (size_t)gf * a.k + k0 + q;
        vcs[i % 3][e] = ok ? a.vc[at] : 0.0f;
        vss[i % 3][e] = ok ? a.vs[at] : 0.0f;
      }
    }
  };
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // Frequency tile i is complete: its contributions to the rows' partial
  // sums.
  dense_pipeline<true>(smem, p, w, kc, acc, stage_v, [&](int i) {
    const float* vct = vcs[i % 3];
    const float* vst = vss[i % 3];
    const int f0 = w.col0(i);
    with_sincos(acc, a.sigma, a.exact, [&](auto sincos) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int fl = 8 * j + 2 * t4 + e;
          const bool icol = a.intercept && f0 + fl == 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float c, s;
            sincos(acc[4 * j + 2 * h + e] * a.sigma, wrow[h], &c, &s);
            if (icol) c = mrow[h];
#pragma unroll
            for (int q = 0; q < KC; ++q)
              part[h][q] = fmaf(c, vct[fl * KC + q],
                                fmaf(s, vst[fl * KC + q], part[h][q]));
          }
        }
    });
  });

#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      float v = part[h][q];
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
__global__ void __launch_bounds__(GT, 1)
    ztzv_out_kernel(DenseOperands p, ZtzvArgs a,
                    const float* __restrict__ zv_part, int zsplit,
                    float* __restrict__ oc_part, float* __restrict__ os_part) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float zvs[3][GM], ms[3][GM];
  __shared__ float red[2][GT / 32][GN];
  unsigned char* smem = ring_base(smem_raw);
  const DenseWalk w = dense_walk(false, p.n, p.f);
  const int kc = max(1, (p.dp + GK - 1) / GK);
  const int tid = threadIdx.x, lane = tid % 32, t4 = lane % 4;
  const int warp = tid / 32, rbase = warp * 16 + lane / 4;
  const int q = blockIdx.z, f0 = w.col0(0);

  float oc[32], os[32];  // column 8j + 2 t4 + e at [2j + e]
#pragma unroll
  for (int i = 0; i < 32; ++i) oc[i] = os[i] = 0.0f;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  dense_pipeline<true>(
      smem, p, w, kc, acc,
      [&](int step) {
        if (step % kc == 0 && tid < GM) {  // stage the tile's zv and mask
          const int i = step / kc, r = w.row0(i) + tid;
          float v = 0.0f, mr = 0.0f;
          if (r < p.n) {
            for (int s = 0; s < zsplit; ++s)
              v += zv_part[((size_t)s * p.n + r) * a.k + q];
            mr = a.m[r];
          }
          zvs[i % 3][tid] = v;
          ms[i % 3][tid] = mr;
        }
      },
      [&](int i) {
        with_sincos(acc, a.sigma, a.exact, [&](auto sincos) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rl = rbase + 8 * h;
            const float zr = zvs[i % 3][rl], mr = ms[i % 3][rl];
            const float wr = mr * a.scale;
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float c, s;
                sincos(acc[4 * j + 2 * h + e] * a.sigma, wr, &c, &s);
                if (a.intercept && f0 + 8 * j + 2 * t4 + e == 0) c = mr;
                oc[2 * j + e] = fmaf(c, zr, oc[2 * j + e]);
                os[2 * j + e] = fmaf(s, zr, os[2 * j + e]);
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
    float v = 0.0f;
#pragma unroll
    for (int u = 0; u < GT / 32; ++u) v += red[which][u][fl];
    float* out = which ? os_part : oc_part;
    out[((size_t)blockIdx.y * p.f + col) * a.k + q] = v;
  }
}

__global__ void sum_splits_kernel(const float* __restrict__ oc_part,
                                  const float* __restrict__ os_part,
                                  float* __restrict__ oc,
                                  float* __restrict__ os, int nsplit,
                                  size_t len) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float a = 0.0f, b = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    a += oc_part[(size_t)s * len + i];
    b += os_part[(size_t)s * len + i];
  }
  oc[i] = a;
  os[i] = b;
}

template <int KC>
cudaError_t launch_zv(const DenseOperands& p, const ZtzvArgs& a,
                      float* zv_part, int zsplit, cudaStream_t stream) {
  cudaError_t err = allow_ring_smem(ztzv_zv_kernel<KC>);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + GM - 1) / GM, zsplit, (a.k + KC - 1) / KC);
  ztzv_zv_kernel<KC><<<grid, GT, SMEM_BYTES, stream>>>(p, a, zv_part);
  return cudaGetLastError();
}

}  // namespace

// K1's C entry point.  x_hi/x_lo (n, dp) and proj_hi/proj_lo (f, dp) are
// the TF32 splits of x and of proj transposed, dp % 4 == 0; zv_part is
// (zsplit, n, k); oc_part/os_part are (osplit, f, k); oc/os are (f, k).
// All fp32, contiguous, on `stream`.
extern "C" int xgpr_ztzv(const float* x_hi, const float* x_lo, const float* m,
                         const float* proj_hi, const float* proj_lo,
                         float sigma, const float* vc, const float* vs,
                         float* zv_part, float* oc_part, float* os_part,
                         float* oc, float* os, int n, int dp, int f, int k,
                         int zsplit, int osplit, float scale, int intercept,
                         int exact, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  const ZtzvArgs a{m, vc, vs, sigma, scale, k, intercept, exact};
  cudaError_t err = k == 1 ? launch_zv<1>(p, a, zv_part, zsplit, st)
                           : launch_zv<8>(p, a, zv_part, zsplit, st);
  if (err != cudaSuccess) return (int)err;
  err = allow_ring_smem(ztzv_out_kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((f + GN - 1) / GN, osplit, k);
  ztzv_out_kernel<<<grid_b, GT, SMEM_BYTES, st>>>(p, a, zv_part, zsplit,
                                                  oc_part, os_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t len = (size_t)f * k;
  sum_splits_kernel<<<(unsigned)((len + 255) / 256), 256, 0, st>>>(
      oc_part, os_part, oc, os, osplit, len);
  return (int)cudaGetLastError();
}
