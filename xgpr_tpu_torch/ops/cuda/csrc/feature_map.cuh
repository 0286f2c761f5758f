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
//   warp-specialised TMA pipeline of dense_wgmma.cuh (its
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
//   operands run fp32 FMAs on the CUDA cores, fp32-exact as xgpr_tpu's
//   Pallas feature map, which pins HIGHEST (sorf_pallas.py:48-50): the
//   3xTF32 body's tensor-core sums measured 2.05x the error of a plain
//   fp32 product against a float64 witness (PERF.md).  That body is a
//   kernel of its own in feature_map_fma.cu (its design is written there):
//   fma_gemm.cuh's 8 x 8 register tile a thread, channel-major operands
//   (x^T and proj, which the wrapper lays out) on a cp.async ring with
//   full and empty mbarriers, each output one fmaf chain over the
//   channels in order, and the fold and stores on the thread's tile
//   (16-byte runs of 4 frequencies).  What bounds it: the CUDA cores,
//   the projection's 5.6 GFLOP of fp32 FMAs at RBF's chunk (0.084 ms at
//   67 TFLOP/s) plus the fold's sincos instructions, against the 0.081 ms
//   write.
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
// point), the fp32 FMA kernel in feature_map_fma.cu, the float64 kernel in
// feature_map_f64.cu, built in parallel.
#pragma once

#include "common.cuh"
#include "gemm_common.cuh"

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

// The fp32 FMA body's launch in sincos mode `mode` (feature_map_fma.cu).
int launch_fma32(const DenseOperands& p, const FeatureArgs<float>& a,
                 int mode, int rsplit, cudaStream_t stream);

// The float64 body's launch (feature_map_f64.cu): the builtin sincos in
// every mode.
int launch_f64(const DenseOperands& p, const FeatureArgs<double>& a,
               int rsplit, cudaStream_t stream);

}  // namespace features
}  // namespace xgpr

