// Fused CG matvec for one chunk on Hopper (K1): Z^T (Z v) without writing Z.
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
// two contractions and accumulates in grid order into resident outputs.
// Neither carries over to 227 KB of shared memory and blocks that run in no
// order, so this is three launches that each own their outputs (no atomics:
// results are the same from run to run):
//
//   (a) ztzv_zv_kernel:  per row tile and slice of the frequency tiles,
//       recompute arg/sincos/mask tile by tile and accumulate partial zv in
//       registers; lanes reduce with warp shuffles -> zv_part (SZ, R, K).
//   (b) ztzv_out_kernel: per frequency tile and slice of the row tiles,
//       recompute the same features, contract with zv (the SZ partials are
//       summed as they are staged) -> oc_part, os_part (SO, F, K).
//   (c) sum_splits_kernel: fixed-order sum over the SO partials -> oc, os.
//
// What bounds it on the H100: the projection is done twice (2 x 2RDF fp32
// FMAs on CUDA cores, 11 GFLOP per 8192 x 84 x 4096 chunk) plus 2 x R x F
// sincos pairs; device memory sees only x, the small vectors and the
// partials.  So it is compute-bound on the CUDA cores.  Recomputing the
// features instead of writing Z trades 268 MB of traffic per chunk for one
// more projection; tensor-core projections are later work.
#include "common.cuh"

using namespace xgpr;

namespace {

// Partial zv over the frequency tiles t = blockIdx.y, +gridDim.y, ...
// Thread (tx, ty): rows ty + 16 i, freqs tx + 16 j; reduce over tx lanes.
template <int KC>
__global__ void __launch_bounds__(NT)
    ztzv_zv_kernel(const float* __restrict__ x, const float* __restrict__ m,
                   const float* __restrict__ proj, float sigma,
                   const float* __restrict__ vc, const float* __restrict__ vs,
                   float* __restrict__ zv_part, int n, int d, int f, int k,
                   float scale, int intercept, int exact) {
  __shared__ TileSmem sm;
  __shared__ float vcs[TN][KC], vss[TN][KC];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * TM;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int k0 = blockIdx.z * KC, kc = min(KC, k - k0);

  float mrow[4], w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    mrow[i] = r < n ? m[r] : 0.0f;
    w[i] = mrow[i] * scale;
  }
  float part[4][KC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < KC; ++q) part[i][q] = 0.0f;

  const int ntiles = (f + TN - 1) / TN;
  for (int t = split; t < ntiles; t += nsplit) {
    const int f0 = t * TN;
    __syncthreads();  // the previous tile's reads of vcs/vss are done
    for (int e = tid; e < TN * KC; e += NT) {
      const int fl = e / KC, q = e % KC, gf = f0 + fl;
      const bool ok = gf < f && q < kc;
      vcs[fl][q] = ok ? vc[(size_t)gf * k + k0 + q] : 0.0f;
      vss[fl][q] = ok ? vs[(size_t)gf * k + k0 + q] : 0.0f;
    }
    float acc[4][4];
    project_tile(x, proj, n, d, f, row0, f0, ty, tx, sm, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int fl = tx + 16 * j;
      const bool icol = intercept && f0 + fl == 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float c, s;
        sincos_scaled(acc[i][j] * sigma, w[i], exact, &c, &s);
        if (icol) c = mrow[i];
#pragma unroll
        for (int q = 0; q < KC; ++q)
          part[i][q] = fmaf(c, vcs[fl][q], fmaf(s, vss[fl][q], part[i][q]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      float v = part[i][q];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      part[i][q] = v;
    }
  if (tx != 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
    for (int q = 0; q < kc; ++q)
      zv_part[((size_t)split * n + r) * k + k0 + q] = part[i][q];
  }
}

// Partial oc/os over the row tiles t = blockIdx.y, +gridDim.y, ...
// Thread (tx, ty): rows tx + 16 i, freqs ty + 16 j; reduce over tx lanes.
template <int KC>
__global__ void __launch_bounds__(NT)
    ztzv_out_kernel(const float* __restrict__ x, const float* __restrict__ m,
                    const float* __restrict__ proj, float sigma,
                    const float* __restrict__ zv_part, int zsplit,
                    float* __restrict__ oc_part, float* __restrict__ os_part,
                    int n, int d, int f, int k, float scale, int intercept,
                    int exact) {
  __shared__ TileSmem sm;
  __shared__ float zs[TM][KC];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int f0 = blockIdx.x * TN;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int k0 = blockIdx.z * KC, kc = min(KC, k - k0);

  float oc[4][KC], os[4][KC];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < KC; ++q) oc[j][q] = os[j][q] = 0.0f;

  const int ntiles = (n + TM - 1) / TM;
  for (int t = split; t < ntiles; t += nsplit) {
    const int row0 = t * TM;
    __syncthreads();  // the previous tile's reads of zs are done
    for (int e = tid; e < TM * KC; e += NT) {
      const int rl = e / KC, q = e % KC, r = row0 + rl;
      float v = 0.0f;
      if (r < n && q < kc)
        for (int s = 0; s < zsplit; ++s)
          v += zv_part[((size_t)s * n + r) * k + k0 + q];
      zs[rl][q] = v;
    }
    float acc[4][4];
    project_tile(x, proj, n, d, f, row0, f0, tx, ty, sm, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = tx + 16 * i, r = row0 + rl;
      const float mr = r < n ? m[r] : 0.0f;
      const float w = mr * scale;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float c, s;
        sincos_scaled(acc[i][j] * sigma, w, exact, &c, &s);
        if (intercept && f0 + ty + 16 * j == 0) c = mr;
#pragma unroll
        for (int q = 0; q < KC; ++q) {
          oc[j][q] = fmaf(c, zs[rl][q], oc[j][q]);
          os[j][q] = fmaf(s, zs[rl][q], os[j][q]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      float a = oc[j][q], b = os[j][q];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
      }
      oc[j][q] = a;
      os[j][q] = b;
    }
  if (tx != 0) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gf = f0 + ty + 16 * j;
    if (gf >= f) continue;
    for (int q = 0; q < kc; ++q) {
      const size_t o = ((size_t)split * f + gf) * k + k0 + q;
      oc_part[o] = oc[j][q];
      os_part[o] = os[j][q];
    }
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
int launch(const float* x, const float* m, const float* proj, float sigma,
           const float* vc, const float* vs, float* zv_part, float* oc_part,
           float* os_part, float* oc, float* os, int n, int d, int f, int k,
           int zsplit, int osplit, float scale, int intercept, int exact,
           cudaStream_t stream) {
  const int kchunks = (k + KC - 1) / KC;
  const dim3 grid_a((n + TM - 1) / TM, zsplit, kchunks);
  ztzv_zv_kernel<KC><<<grid_a, NT, 0, stream>>>(
      x, m, proj, sigma, vc, vs, zv_part, n, d, f, k, scale, intercept,
      exact);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((f + TN - 1) / TN, osplit, kchunks);
  ztzv_out_kernel<KC><<<grid_b, NT, 0, stream>>>(
      x, m, proj, sigma, zv_part, zsplit, oc_part, os_part, n, d, f, k, scale,
      intercept, exact);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t len = (size_t)f * k;
  sum_splits_kernel<<<(unsigned)((len + 255) / 256), 256, 0, stream>>>(
      oc_part, os_part, oc, os, osplit, len);
  return (int)cudaGetLastError();
}

}  // namespace

// K1's C entry point.  zv_part is (zsplit, n, k); oc_part/os_part are
// (osplit, f, k); oc/os are (f, k).  All fp32, contiguous, on `stream`.
extern "C" int xgpr_ztzv(const float* x, const float* m, const float* proj,
                         float sigma, const float* vc, const float* vs,
                         float* zv_part, float* oc_part, float* os_part,
                         float* oc, float* os, int n, int d, int f, int k,
                         int zsplit, int osplit, float scale, int intercept,
                         int exact, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k == 1)
    return launch<1>(x, m, proj, sigma, vc, vs, zv_part, oc_part, os_part, oc,
                     os, n, d, f, k, zsplit, osplit, scale, intercept, exact,
                     st);
  return launch<8>(x, m, proj, sigma, vc, vs, zv_part, oc_part, os_part, oc,
                   os, n, d, f, k, zsplit, osplit, scale, intercept, exact, st);
}
