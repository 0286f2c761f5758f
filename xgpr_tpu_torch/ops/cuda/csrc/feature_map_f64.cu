// K2 in the float64 format (float64 operands, the builtin sincos): the
// DMMA loop of dense_f64.cuh at tiles of 64 rows x 128 frequencies (8
// warps of 1 x 8 m16n8k8 tiles, 4 along the rows by 2 along the
// frequencies), the features stored from the accumulators; see
// feature_map.cuh for what the kernel computes and dense_f64.cuh for the
// loop.
#include "dense_f64.cuh"
#include "feature_map.cuh"

namespace xgpr {
namespace features {

using K2Tiling = f64::Tiling<2, 8, false>;

// A block takes one frequency tile (blockIdx.x) and walks a slice of the
// 128-row tiles (dense_walk), as the float32 bodies do, each as two tiles
// of 64 rows.  Lane (g, t) of warp (wm, wn) stores, for each of its rows
// 16 wm + g + 8h and 8-column slabs n, the cos pair and the sin pair of
// frequencies 64 wn + 8n + 2t and + 1 as one 16-byte store each: a warp's
// store covers 64 contiguous bytes of each of 8 rows, whole 32-byte
// sectors.
__global__ void __launch_bounds__(f64::THREADS, 1)
    feature_map_f64_kernel(DenseOperands p, FeatureArgs<double> a) {
  using Tl = K2Tiling;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) f64::RingBarriers bar;
  unsigned char* smem = ring_base(smem_raw);
  bar.init();
  __syncthreads();
  // RS tiles of BM rows for each GM-row tile of the walk.
  constexpr int RS = GM / Tl::BM;
  const DenseWalk w = dense_walk(false, p.n, p.f);
  const int kc = (p.dp + f64::LINE - 1) / f64::LINE;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rbase = 16 * (warp / Tl::WN) + lane / 4;  // + 8h
  const int fb = w.col0(0) + 64 * (warp % Tl::WN) + 2 * (lane % 4);  // + 8n
  const size_t ld = 2 * (size_t)p.f;
  // With blocks a multiple of the tile wide, the tile is in one block.
  const int tile_blk = a.padded % GN == 0 ? w.col0(0) / a.padded : -1;

  double acc[Tl::ACC];
#pragma unroll
  for (int i = 0; i < Tl::ACC; ++i) acc[i] = 0.0;
  auto row0 = [&](int u) { return w.row0(u / RS) + Tl::BM * (u % RS); };
  f64::dense_loop<Tl>(
      smem, bar, p, RS * w.count, kc, acc, row0,
      [&](int) { return w.col0(0); }, [](int) {},
      [&](int u) {  // row tile u is complete: its features go out
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0(u) + rbase + 8 * h;
          if (r >= p.n) continue;
          double* o = a.out + (size_t)r * ld;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int f = fb + 8 * n;
            if (f >= p.f) continue;
            double c0, s0, c1, s1;
            sincos_scaled<MODE_EXACT>(acc[4 * n + 2 * h], a.scale, &c0, &s0);
            sincos_scaled<MODE_EXACT>(acc[4 * n + 2 * h + 1], a.scale, &c1,
                                      &s1);
            const int blk = tile_blk >= 0 ? tile_blk : f / a.padded;
            const int width = min(a.padded, p.f - blk * a.padded);
            // f is even, so with even blocks f and f + 1 share a block and
            // both columns of the pair are aligned to their store.
            if (f + 1 < p.f && a.padded % 2 == 0 && width % 2 == 0) {
              const int col = f + blk * a.padded;
              store2(o + col, c0, c1);
              store2(o + col + width, s0, s1);
            } else {
              store_feature(a, o, p.f, f, c0, s0);
              if (f + 1 < p.f) store_feature(a, o, p.f, f + 1, c1, s1);
            }
          }
        }
      });
}

int launch_f64(const DenseOperands& p, const FeatureArgs<double>& a,
               int rsplit, cudaStream_t stream) {
  constexpr int smem = f64::smem_bytes<K2Tiling>(0);
  cudaError_t err = cudaFuncSetAttribute(
      feature_map_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.f + GN - 1) / GN, rsplit);
  feature_map_f64_kernel<<<grid, f64::THREADS, smem, stream>>>(p, a);
  return (int)cudaGetLastError();
}

}  // namespace features
}  // namespace xgpr
