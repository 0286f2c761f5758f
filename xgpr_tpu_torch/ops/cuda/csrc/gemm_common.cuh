// What every GEMM body of the library shares: the operand formats the
// wrappers choose (Format, and as_operand, a value as a format's product
// reads it), the 16-byte cp.async copy, the wgmma descriptor of a
// 128-byte-swizzled K-major tile and the wgmma wrappers, the aligned base
// of a block's dynamic shared memory, and the dense kernels' operands and
// walks (DenseOperands, DenseWalk, dense_walk).  Four operand formats
// (Format below), which the wrappers choose from the operands' dtype and
// xgpr_tpu's feature precision (ops/pallas/ztzv_pallas.py: _make_dot;
// ops/cuda/feature_map.py: kernel_body):
//
// - FMT_TF32X3, "high" (and "highest" for K1): wgmma in 3xTF32.  The
//   wrapper splits each operand into a TF32 high part and the remainder
//   (hi + lo == a exactly), and each warpgroup accumulates lo*hi + hi*lo +
//   hi*hi in fp32 (the lo*lo term, ~2^-22 relative, is dropped; keeping it
//   measured no closer to a float64 witness, PERF.md).  K1 and K2 run it
//   on the warp-specialised TMA pipeline of dense_wgmma.cuh (m64n128k8,
//   wgmma_tf32 below), K3 and K4 on conv_tf32.cuh's (m64n64k8);
// - FMT_BF16, "default": wgmma.m64n128k16 on bf16 operands, one product
//   per 32-byte depth slice, fp32 accumulation: the TPU's DEFAULT dot,
//   which rounds both operands to bf16.  K1 runs it on dense_wgmma.cuh's
//   pipeline (wgmma_bf16 below), K3 and K4 on conv_ws.cuh's;
// - FMT_FMA32, "highest" for K2, K3 and K4: fp32 FMAs on the CUDA cores,
//   each thread an 8 x 8 register tile (fma_gemm.cuh): K2's kernel in
//   feature_map_fma.cu, K3 and K4's in conv_sync.cuh;
// - FMT_F64, float64 operands: m16n8k8 DMMA, K1 and K2 on dense_f64.cuh's
//   loop, K3 and K4 in conv_sync.cuh.
//
// The wgmma accumulator fragment of warp q of a warpgroup, lane (g, t) =
// (lane / 4, lane % 4): acc[4j + 2h + e] is the warpgroup's row
// 16q + g + 8h and column 8j + 2t + e, for j < 16 and h, e < 2 (the same
// for the m64n128 shapes of both formats).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xgpr {

constexpr int GM = 128;  // rows of a dense kernel's tile
constexpr int GN = 128;  // columns (frequencies) of a tile: the wgmma N

// The operand formats, by the host's body flag
// (ops/cuda/feature_map.py: kernel_body, BODY_FLAGS).
enum Format : int { FMT_TF32X3 = 0, FMT_FMA32 = 1, FMT_BF16 = 2,
                    FMT_F64 = 3 };

// v as the product of format FMT reads it: rounded to bf16 (to nearest
// even) for FMT_BF16, whole otherwise.  K1's bf16 epilogues round their
// CUDA-core products' operands with it, as the TPU's DEFAULT dot does.
template <int FMT, class T>
__device__ __forceinline__ T as_operand(T v) {
  if constexpr (FMT == FMT_BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Descriptor of a K-major tile of 128-byte rows in the 128-byte swizzle
// (8-row atoms of 1024 bytes, SBO 1024); +2 steps 32 bytes along K.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float d[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) += a (64 x 8) @ b (8 x 128), TF32 operands in shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_tf32(float d[64], uint64_t desc_a,
                                           uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, fp32) += a (64 x 16) @ b (16 x 128), bf16 operands in shared
// memory, both K-major (no transpose).
__device__ __forceinline__ void wgmma_bf16(float d[64], uint64_t desc_a,
                                           uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The dynamic shared memory of a block, aligned to the 1024-byte swizzle
// atom.
__device__ __forceinline__ unsigned char* ring_base(unsigned char* raw) {
  return raw +
         ((1024 - ((unsigned)__cvta_generic_to_shared(raw) & 1023)) & 1023);
}

// The dense kernels' operands: x's rows and proj^T's, each in the planes
// of a format (the float64 body's loop and the wgmma pipelines read them
// K-major; K2's fp32 FMA kernel reads x^T and proj, channel-major).
struct DenseOperands {
  const void* x_hi;  // (n, dp): TF32 high parts, bf16 or the values;
                     // x^T (dp, np) for FMT_FMA32's K2
  const void* x_lo;  // the same, TF32 remainders (unused by the others)
  const void* b_hi;  // (f, dp), K-major (proj transposed): the same;
                     // proj (dp, fp) for FMT_FMA32's K2
  const void* b_lo;
  int n, dp, f;
};

// The float64 loop's walk (dense_f64.cuh): a block walks a list of tiles
// along one axis (the column tiles of row tile blockIdx.x, or the row
// tiles of column tile blockIdx.x), tile i being blockIdx.y + i *
// gridDim.y of that axis.
struct DenseWalk {
  int fixed, first, stride, count;
  bool by_cols;  // walk the column tiles of one row tile
  __device__ __forceinline__ int row0(int i) const {
    return (by_cols ? fixed : first + i * stride) * GM;
  }
  __device__ __forceinline__ int col0(int i) const {
    return (by_cols ? first + i * stride : fixed) * GN;
  }
};

__device__ __forceinline__ DenseWalk dense_walk(bool by_cols, int n, int f) {
  const int tiles = by_cols ? (f + GN - 1) / GN : (n + GM - 1) / GM;
  DenseWalk w;
  w.by_cols = by_cols;
  w.fixed = blockIdx.x;
  w.first = blockIdx.y;
  w.stride = gridDim.y;
  w.count = w.first < tiles ? (tiles - 1 - w.first) / w.stride + 1 : 0;
  return w;
}

}  // namespace xgpr
