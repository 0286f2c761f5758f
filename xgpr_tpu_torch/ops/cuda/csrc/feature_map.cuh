// Dense RBF feature map for Hopper (K2), on the tensor cores at fp32 grade
// (3xTF32) for float32 operands, in fp32 FMAs on the CUDA cores at the
// "highest" feature precision, and in float64 m16n8k8 DMMA for float64
// ones.
//
// Replaces the TPU kernel xgpr_tpu/ops/pallas/sorf_pallas.py:_feature_kernel
// (pallas_call in _rbf_feature_map_impl).  For sigma-scaled rows x (N, D)
// and the dense projection proj (D, F), chi folded in:
//
//   arg = x @ proj
//   out[r, blockstart(f) + f_in_block]          = cos(arg[r, f]) * scale
//   out[r, blockstart(f) + width(f) + f_in_block] = sin(arg[r, f]) * scale
//
// i.e. straight into the block [cos b | sin b] layout of ops/layout.py, for
// any block split, including a ragged last block (the Pallas gate rejects
// that case), any N, F and D (edges are zero-filled and masked).
//
// What bounds it on the H100.  At RBF's chunk (8192 x 84 rows, F 4096) it
// reads 2.8 MB and writes 268 MB of features, 0.081 ms at 3.35 TB/s, and
// does 5.6 GFLOP of projection (0.034 ms as three TF32 products each at
// 495 TFLOP/s): bound by the write.  At Conv1dTwoLayer's second layer
// (8192 x 1024 rows, F 2048) the projection is 34.4 GFLOP (0.21 ms on the
// tensor cores) against 168 MB of traffic (0.05 ms): bound by operations.
//
// Design (the wrapper in ../feature_map.py prepares the operands):
// - float32 operands at "high" and "default" run the 3xTF32 body, the
//   warp-specialised TMA pipeline of dense_tf32.cuh (its
//   feature_map_kernel): a block takes one 128-frequency tile of proj^T,
//   resident up to D 96, and its two consumer warpgroups take the halves
//   of the row tiles of its walk,
//   so that one evaluates sincos and stores while the other's products
//   run; a tile in one block of the layout (blocks a multiple of 128 wide,
//   F even) leaves through shared memory as TMA bulk stores of 64 x 32
//   boxes, the others from the fragment.  The wrapper splits x and projT
//   into TF32 high parts and remainders (projT's split is cached with
//   proj) and picks the slice count that fills the SMs in the fewest
//   waves.
// - The epilogue evaluates sincos on the accumulator fragment
//   (with_sincos: a straight-line polynomial body unless an argument needs
//   the builtin), in one of the four modes of xgpr_tpu's sincos switch ("hi",
//   "exact", "fast", "poly"): each kernel is instantiated once per mode and
//   the host picks the instantiation at launch, so no mode branch sits in the
//   64-value loop.  No (N, F) intermediate reaches device memory, and each
//   feature is written once.
// - At the "highest" feature precision (the "reference" preset) float32
//   operands run feature_map_kernel below, the last body of K2 on
//   tf32_gemm.cuh's shared cp.async ring: fp32 FMAs of fma_gemm.cuh,
//   fp32-exact as xgpr_tpu's Pallas feature map, which pins HIGHEST
//   (sorf_pallas.py:48-50): the 3xTF32 body's tensor-core sums measured
//   2.05x the error of a plain fp32 product against a float64 witness
//   (PERF.md).  A block takes one frequency tile and walks a slice of the
//   row tiles; each thread stores its pairs of adjacent frequencies from
//   the fragment as 8-byte stores (scalars where a pair is split or
//   unaligned).  What bounds it: the projection as fp32 FMAs, 5.6 GFLOP at
//   RBF's chunk, 0.084 ms at the CUDA cores' 67 TFLOP/s, against the
//   0.081 ms write.
// - float64 operands run a kernel of their own, feature_map_f64_kernel in
//   feature_map_f64.cu: the m16n8k8 DMMA loop of dense_f64.cuh (a
//   six-stage mbarrier ring, tiles of 128 rows x 128 frequencies) with the
//   builtin sincos, every feature stored from the accumulators as 16-byte
//   pairs (a float64 tile is 256 KB of features, more than shared memory
//   holds beside the ring).  What bounds it there: at RBF's chunk the 537
//   MB of float64 features, 0.16 ms at 3.35 TB/s, against 0.084 ms for the
//   5.6 GFLOP of projection at the tensor cores' 67 TFLOP/s of FP64 and
//   ~0.1 ms of double sincos on the FP64 units; at D 1024 the 34.4 GFLOP
//   of projection, 0.51 ms.
// The 3xTF32 instantiations are in feature_map.cu (with the C entry
// point), the fp32 FMA ones in feature_map_fma.cu, the float64 kernel in
// feature_map_f64.cu, built in parallel.
#pragma once

#include "common.cuh"
#include "tf32_gemm.cuh"

namespace xgpr {
namespace features {

template <class T>
struct FeatureArgs {
  T* out;  // (n, 2f)
  int padded;
  T scale;
};

// (a, b) into p and p + 1 with one 8-byte (float) or 16-byte (double)
// store; p is aligned to it.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

template <class T>
__device__ __forceinline__ void store_feature(const FeatureArgs<T>& a, T* o,
                                              int f, int fc, T c, T s) {
  const int blk = fc / a.padded;
  const int width = min(a.padded, f - blk * a.padded);
  const int col = fc + blk * a.padded;
  o[col] = c;
  o[col + width] = s;
}

template <int FMT, int MODE>
__global__ void __launch_bounds__(GT, 1)
    feature_map_kernel(DenseOperands p, FeatureArgs<typename Body<FMT>::T> a) {
  using T = typename Body<FMT>::T;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = ring_base(smem_raw);
  const DenseWalk w = dense_walk(false, p.n, p.f);
  const int kc = max(1, (p.dp + Body<FMT>::KS - 1) / Body<FMT>::KS);
  const int lane = threadIdx.x % 32, t4 = lane % 4;
  const int rbase = (threadIdx.x / 32) * 16 + lane / 4;  // row in the tile
  const size_t ld = 2 * (size_t)p.f;
  // With blocks a multiple of the tile wide, the tile is in one block.
  const int tile_blk = a.padded % GN == 0 ? w.col0(0) / a.padded : -1;

  T acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = T(0);

  dense_pipeline<false, FMT>(
      smem, p, w, kc, acc, [](int) {},
      [&](int i) {  // row tile i is complete: its features go out
        const int row0 = w.row0(i);
        const int fb = w.col0(i) + 2 * t4;
        with_sincos<MODE>(acc, T(1), [&](auto sincos) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + rbase + 8 * h;
            if (r >= p.n) continue;
            T* o = a.out + (size_t)r * ld;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int f = fb + 8 * j;
              if (f >= p.f) continue;
              T c0, s0, c1, s1;
              sincos(acc[4 * j + 2 * h], a.scale, &c0, &s0);
              sincos(acc[4 * j + 2 * h + 1], a.scale, &c1, &s1);
              const int blk = tile_blk >= 0 ? tile_blk : f / a.padded;
              const int width = min(a.padded, p.f - blk * a.padded);
              // f is even, so with even blocks f and f + 1 share a block
              // and both columns of the pair are aligned to their store.
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
      });
}

template <int FMT, int MODE>
int launch(const DenseOperands& p, const FeatureArgs<typename Body<FMT>::T>& a,
           int rsplit, cudaStream_t stream) {
  cudaError_t err = allow_ring_smem<FMT>(feature_map_kernel<FMT, MODE>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.f + GN - 1) / GN, rsplit);
  feature_map_kernel<FMT, MODE>
      <<<grid, GT, Body<FMT>::SMEM, stream>>>(p, a);
  return (int)cudaGetLastError();
}

// The fp32 FMA body's launch in sincos mode `mode` (feature_map_fma.cu).
int launch_fma32(const DenseOperands& p, const FeatureArgs<float>& a,
                 int mode, int rsplit, cudaStream_t stream);

// The float64 body's launch (feature_map_f64.cu): the builtin sincos in
// every mode.
int launch_f64(const DenseOperands& p, const FeatureArgs<double>& a,
               int rsplit, cudaStream_t stream);

}  // namespace features
}  // namespace xgpr

