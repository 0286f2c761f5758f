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
// - The projection is the 3xTF32 wgmma body of tf32_gemm.cuh with the
//   dense row policy: tiles of 128 rows x 128 frequencies, depth in
//   32-channel stages (3 at D 84, 32 at D 1024).  The wrapper pads D to a
//   multiple of 4 and splits x and projT into TF32 high parts and
//   remainders (projT's split is cached with proj).
// - A block takes one frequency tile and walks a slice of the row tiles,
//   so the copies of a tile's first stages run during the previous tile's
//   epilogue; the wrapper picks the slice count that fills the SMs in the
//   fewest waves.  The blocks in flight then share a few row tiles of x and
//   all of projT, which stay in L2, and write whole rows of the output
//   between them (at D 1024 this measured 0.398 ms against 0.423 ms for
//   blocks that walk the frequency tiles of one row tile; PERF.md).
// - The epilogue evaluates sincos on the accumulator fragment
//   (with_sincos: a straight-line polynomial body unless an argument needs
//   the builtin), in one of the four modes of xgpr_tpu's sincos switch ("hi",
//   "exact", "fast", "poly"): the kernel is instantiated once per mode and
//   the host picks the instantiation at launch, so no mode branch sits in the
//   64-value loop.  Where a tile lies in one block of the layout (blocks a
//   multiple of 128 wide, F even), its cos and then its sin values go through
//   shared memory, in the stage the tile's last step read, and out as
//   512-byte rows; elsewhere each thread stores its pairs of adjacent
//   frequencies from the fragment as 8-byte stores (scalars where a pair is
//   split or unaligned).  At RBF's chunk the rows measured 0.203 ms against
//   0.231-0.240 ms for the fragment stores (PERF.md).
//   No (N, F) intermediate reaches device memory, and each feature is
//   written once.
// - At the "highest" feature precision (the "reference" preset) float32
//   operands run the same kernel on the fp32 FMA body of fma_gemm.cuh,
//   fp32-exact as xgpr_tpu's Pallas feature map, which pins HIGHEST
//   (sorf_pallas.py:48-50): the 3xTF32 body's tensor-core sums measured
//   2.05x the error of a plain fp32 product against a float64 witness
//   (PERF.md).  Its 32 KB stages do not hold a 64 KB tile, so every
//   feature is stored from the fragment.  What bounds it: the projection
//   as fp32 FMAs, 5.6 GFLOP at RBF's chunk, 0.084 ms at the CUDA cores' 67
//   TFLOP/s, against the 0.081 ms write.
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
  const int tile_width =
      tile_blk >= 0 ? min(a.padded, p.f - tile_blk * a.padded) : 0;
  // Whole tiles of such blocks go out through shared memory in 512-byte
  // rows (the 3xTF32 body, whose 64 KB stages hold a tile); the others
  // from the fragments.
  const bool staged = FMT == FMT_TF32X3 && tile_blk >= 0 &&
                      w.col0(0) + GN <= p.f && tile_width % 4 == 0 &&
                      p.f % 2 == 0;

  T acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = T(0);

  // Nothing resident: the epilogue takes a 64 KB stage as scratch.
  dense_pipeline<false, FMT>(
      smem, p, w, kc, acc, [](int) {},
      [&](int i) {  // row tile i is complete: its features go out
        const int row0 = w.row0(i);
        if constexpr (FMT == FMT_TF32X3) if (staged) {
          // The stage the tile's last step read is free until the next
          // barrier of the pipeline: cos then sin of the tile go through
          // it, element (r, c) at word r * GN + (c ^ 4 (r % 8)).
          float* buf = reinterpret_cast<float*>(
              smem + (((i + 1) * kc - 1) % STAGES) * STAGE_BYTES);
          float sn[64];
          __syncthreads();  // both warpgroups' products are done
          with_sincos<MODE>(acc, 1.0f, [&](auto sincos) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int j = 0; j < 16; ++j) {
                const int r = rbase + 8 * h;
                const int c = (8 * j + 2 * t4) ^ (4 * (r % 8));
                float c0, c1;
                sincos(acc[4 * j + 2 * h], a.scale, &c0,
                       &sn[4 * j + 2 * h]);
                sincos(acc[4 * j + 2 * h + 1], a.scale, &c1,
                       &sn[4 * j + 2 * h + 1]);
                *reinterpret_cast<float2*>(buf + r * GN + c) =
                    make_float2(c0, c1);
              }
          });
          // Warp u writes rows 16u .. 16u + 15, one 512-byte row a store.
          const int lane4 = 4 * lane, warp = threadIdx.x / 32;
          float* out = a.out + (size_t)w.col0(i) +
                       (size_t)tile_blk * a.padded + lane4;
          auto rows_out = [&](int off) {
            __syncthreads();
#pragma unroll 4
            for (int rr = 0; rr < GM / (GT / 32); ++rr) {
              const int r = warp * (GM / (GT / 32)) + rr;
              if (row0 + r >= p.n) break;
              const float4 v = *reinterpret_cast<const float4*>(
                  buf + r * GN + (lane4 ^ (4 * (r % 8))));
              *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * ld +
                                         off) = v;
            }
            __syncthreads();
          };
          rows_out(0);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int r = rbase + 8 * h;
              const int c = (8 * j + 2 * t4) ^ (4 * (r % 8));
              *reinterpret_cast<float2*>(buf + r * GN + c) =
                  make_float2(sn[4 * j + 2 * h], sn[4 * j + 2 * h + 1]);
            }
          rows_out(tile_width);
          return;
        }
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

