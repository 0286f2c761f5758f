// The TMA and wgmma-wait helpers of the warp-specialised pipelines
// (conv_ws.cuh: K3/K4's bf16 body; conv_tf32.cuh: their 3xTF32 body;
// dense_wgmma.cuh: K1 and K2's 3xTF32 and K1's bf16 bodies): a tensor
// map's encoding through the runtime (the library links no libcuda), box
// copies into shared memory that complete on an mbarrier (2-D, 3-D and
// 4-D), bulk stores of a 2-D box from shared memory with their commit and
// waits, and a ring position (a stage and its fill's parity).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "mbarrier.cuh"

namespace xgpr {

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(saddr(b)),
               "r"(bytes)
               : "memory");
}
// A 2-D TMA box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_box2(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(saddr(bar))
      : "memory");
}
// A 2-D box of shared memory at src stored by TMA to the tensor at
// (c0, c1) (the hardware clips what falls past the tensor), in this
// thread's current bulk group.
__device__ __forceinline__ void tma_store2(const CUtensorMap* map,
                                           const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(saddr(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most PENDING of this thread's bulk groups are still
// reading their shared memory.
template <int PENDING>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(PENDING)
               : "memory");
}
// Waits until at most PENDING of this thread's bulk groups are incomplete.
template <int PENDING>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
// Orders this thread's shared-memory writes before later TMA reads of them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A 3-D TMA box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1,
                                        int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(saddr(bar))
      : "memory");
}
// The same for a 4-D box.
__device__ __forceinline__ void tma_box4(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(saddr(bar))
      : "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}
__device__ __forceinline__ void fence_acc32(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A ring position: a stage and the parity of its current fill; step()
// moves to the next fill.
struct Slot {
  int stage;
  uint32_t parity;
  __device__ __forceinline__ Slot(uint32_t fill, int stages)
      : stage(fill % stages), parity((fill / stages) & 1) {}
  __device__ __forceinline__ void step(int n, int stages) {
    stage += n;
    while (stage >= stages) {
      stage -= stages;
      parity ^= 1;
    }
  }
};

// cuTensorMapEncodeTiled, reached through the runtime (the library links
// no libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// What a tensor map encodes: maps of equal keys are equal, so the last
// few encoded are kept (a wrapper's operands mostly come back at the same
// addresses from PyTorch's caching allocator, and an encoding costs the
// host microseconds a launch).
struct MapKey {
  const void* base;
  int type, elem, rank, dims[4], box[4];
};

inline bool swizzled_map_uncached(CUtensorMap* map, CUtensorMapDataType type,
                                  int elem, const void* base, int rank,
                                  const int* dims, const int* box);

// The tensor map of a contiguous array of `rank` (2 to 4) axes, dims[0]
// innermost, of `elem`-byte values, in boxes of box[0..rank) values, in
// the 128-byte swizzle (box[0] * elem must be 128); reads past the array
// are zero-filled.
inline bool swizzled_map(CUtensorMap* map, CUtensorMapDataType type,
                         int elem, const void* base, int rank,
                         const int* dims, const int* box) {
  if (rank < 2 || rank > 4) return false;
  MapKey key;
  memset(&key, 0, sizeof(key));
  key.base = base;
  key.type = (int)type;
  key.elem = elem;
  key.rank = rank;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
  }
  constexpr int N = 32;
  static MapKey keys[N];
  static CUtensorMap maps[N];
  static int used = 0, next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (memcmp(&keys[i], &key, sizeof(key)) == 0) {
      *map = maps[i];
      return true;
    }
  if (!swizzled_map_uncached(map, type, elem, base, rank, dims, box))
    return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % N;
  if (used < N) ++used;
  return true;
}

inline bool swizzled_map_uncached(CUtensorMap* map, CUtensorMapDataType type,
                                  int elem, const void* base, int rank,
                                  const int* dims, const int* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t size[4], strides[3];
  cuuint32_t bx[4], unit[4];
  cuuint64_t stride = (cuuint64_t)elem;
  for (int i = 0; i < rank; ++i) {
    size[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    unit[i] = 1;
    if (i > 0) strides[i - 1] = stride;
    stride *= size[i];
  }
  return encode(map, type, (cuuint32_t)rank, const_cast<void*>(base), size,
                strides, bx, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace xgpr
