// Two rates of one card that size K3/K4's 3xTF32 pipeline
// (csrc/conv_tf32.cuh), each over 132 SMs (one block an SM):
//
// - TF32 wgmma from shared memory at m64n64k8 (two accumulator chains, a
//   window pair, as the kernel issues them) and m64n128k8 (one chain),
//   with one and with two warpgroups a block issuing, wait_group 1 after
//   each commit of 4 k8 slices: cycles a wgmma per SM against the peak
//   (N / 4 at 1024 TF32 multiply-adds a cycle) and TFLOP/s;
// - TMA boxes from L2 into shared memory (an 8 MB source, warm in L2, 16
//   KB a stage, 8 stages, a producer thread and a consumer warp a block):
//   alone (cluster 1) and multicast to clusters of 2 and 4 CTAs, each CTA
//   issuing 1/C of every box to all: TB/s written into shared memory over
//   the card, and TB/s read from L2 (the same over C).
//
// Build and run on the card, from the root of a checkout:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/tf32_rate tests/torch_port/tf32_rate.cu
//   build/tf32_rate
#include <cstdio>

#include "../../xgpr_tpu_torch/ops/cuda/csrc/conv_tf32.cuh"
using namespace xgpr;
using namespace xgpr::conv::tf32;

// A 3-D box written at the same shared-memory offset of every CTA of the
// cluster in `mask`, each completing on its own barrier at `bar`'s offset.
__device__ __forceinline__ void tma_box_multicast(void* dst,
                                                  const CUtensorMap* map,
                                                  uint64_t* bar, int c0,
                                                  int c1, int c2,
                                                  uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::
          "r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
// Every thread of every CTA of the cluster: the writes before it (barrier
// initialisation, arrivals) are seen by the others after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}
// One arrival on the barrier at `b`'s offset in CTA `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* b, int cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(saddr(b)),
      "r"(cta)
      : "memory");
}

constexpr int T_STAGES = 8;
constexpr int T_BOX = 16384;  // 128 rows of 128 bytes
constexpr int SMEM_ONE = 160 * 1024;  // more than half an SM's

template <int N>
__device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
  if constexpr (N == 64)
    wgmma_tf32_n64(d, a, b, 1);
  else
    wgmma_tf32(d, a, b, 1);
}

template <int N, int CHAINS>
__global__ void __launch_bounds__(256, 1) mma_bench(long long* out,
                                                     int iters) {
  extern __shared__ __align__(1024) unsigned char raw[];
  unsigned char* smem = ring_base(raw);
  float acc[CHAINS][N / 2];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[c][i] = 0.f;
  for (int i = threadIdx.x; i < 65536 / 4; i += blockDim.x)
    reinterpret_cast<float*>(smem)[i] = 0.001f * (i % 7);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const uint64_t da = sw128_desc(smem + wg * 16384);
  const uint64_t db = sw128_desc(smem + 32768);
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < CHAINS; ++c)
        mma<N>(acc[c], da + 2 * kk + 512 * c, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  long long t1 = clock64();
  float s = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s += acc[c][i];
  if (threadIdx.x % 128 == 0) out[blockIdx.x * 2 + wg] = t1 - t0;
  if (s == 1234.5f) out[0] = -1;
}

template <int N, int CHAINS>
void run_mma(long long* d, int iters, int warpgroups) {
  auto k = mma_bench<N, CHAINS>;
  const int threads = 128 * warpgroups;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_ONE);
  k<<<132, threads, SMEM_ONE>>>(d, iters);
  if (cudaDeviceSynchronize() != cudaSuccess) {
    printf("RATE wgmma m64n%dk8 failed: %s\n", N,
           cudaGetErrorString(cudaGetLastError()));
    return;
  }
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  k<<<132, threads, SMEM_ONE>>>(d, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  long long h[264];
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  double cyc = 0;
  for (int i = 0; i < 132; ++i)
    for (int w = 0; w < warpgroups; ++w) cyc += h[2 * i + w];
  cyc /= 132 * warpgroups;
  const double per = cyc / ((double)iters * 4 * CHAINS * warpgroups);
  const double flops = 2.0 * 64 * N * 8 * 4 * CHAINS * warpgroups *
                       (double)iters * 132;
  printf("RATE wgmma tf32 m64n%dk8 chains %d warpgroups %d: %.1f cycles a "
         "wgmma per SM (peak %d), %.1f TFLOP/s\n",
         N, CHAINS, warpgroups, per, N / 4, flops / (ms * 1e-3) / 1e12);
}

// Block: thread 0 issues this CTA's 1/C of every box (multicast to the
// cluster when C > 1), warp 1 waits for each stage and releases it to
// every CTA of the cluster.
template <int C>
__global__ void __launch_bounds__(64, 1) tma_bench(
    const __grid_constant__ CUtensorMap map, int rows, int iters) {
  extern __shared__ __align__(1024) unsigned char raw[];
  __shared__ __align__(8) uint64_t full[T_STAGES], empty[T_STAGES];
  unsigned char* ring = ring_base(raw);
  const int rank = C > 1 ? cluster_rank() : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < T_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (C > 1)
    cluster_sync();
  else
    __syncthreads();
  const int cid = blockIdx.x / C;
  constexpr int piece = 128 / C;
  if (threadIdx.x == 0) {
    for (int it = 0; it < iters; ++it) {
      const int st = it % T_STAGES;
      mbar_wait(&empty[st], ((it / T_STAGES) & 1) ^ 1);
      mbar_expect_tx(&full[st], T_BOX);
      const int row = (int)(((long long)(cid * 97 + it) * 128) % rows);
      unsigned char* dst = ring + st * T_BOX + rank * piece * 128;
      if (C > 1)
        tma_box_multicast(dst, &map, &full[st], 0, 0, row + rank * piece,
                          (uint16_t)((1u << C) - 1));
      else
        tma_box(dst, &map, &full[st], 0, 0, row);
    }
  } else if (threadIdx.x / 32 == 1) {
    const int lane = threadIdx.x % 32;
    for (int it = 0; it < iters; ++it) {
      const int st = it % T_STAGES;
      mbar_wait(&full[st], (it / T_STAGES) & 1);
      __syncwarp();
      if (lane == 0) {
        if (C > 1)
          for (int r = 0; r < C; ++r) mbar_arrive_cluster(&empty[st], r);
        else
          mbar_arrive(&empty[st]);
      }
    }
  }
  if (C > 1) cluster_sync();
}

template <int C>
void run_tma(const CUtensorMap& map, int rows, int iters) {
  auto k = tma_bench<C>;
  // One block an SM: a block asks for more than half an SM's shared
  // memory.
  const int smem = SMEM_ONE;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.blockDim = dim3(64);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(C);
  int clusters = 0;
  cudaOccupancyMaxActiveClusters(&clusters, (void*)k, &cfg);
  // At most one block an SM (132 SMs).
  clusters = clusters < 132 / C ? clusters : 132 / C;
  cfg.gridDim = dim3(clusters * C);
  if (cudaLaunchKernelEx(&cfg, k, map, rows, 64) != cudaSuccess ||
      cudaDeviceSynchronize() != cudaSuccess) {
    printf("RATE tma cluster %d failed: %s\n", C,
           cudaGetErrorString(cudaGetLastError()));
    return;
  }
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  cudaLaunchKernelEx(&cfg, k, map, rows, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double bytes = (double)clusters * C * iters * T_BOX;
  printf("RATE tma box 16 KB cluster %d (%d clusters, %d blocks): %.2f TB/s "
         "into shared memory, %.2f TB/s from L2 [%s]\n",
         C, clusters, clusters * C, bytes / (ms * 1e-3) / 1e12,
         bytes / C / (ms * 1e-3) / 1e12,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  long long* d;
  cudaMalloc(&d, 264 * sizeof(long long));
  const int it = 20000;
  run_mma<64, 2>(d, it, 1);
  run_mma<64, 2>(d, it, 2);
  run_mma<128, 1>(d, it, 1);
  run_mma<128, 1>(d, it, 2);
  run_mma<64, 1>(d, it, 2);

  const int rows = 65536;  // 8 MB of 128-byte rows
  float* src;
  cudaMalloc(&src, (size_t)rows * 128);
  cudaMemset(src, 0, (size_t)rows * 128);
  CUtensorMap map;
  const int dims[3] = {32, 1, rows}, box[3] = {32, 1, 128};
  const int dims2[3] = {32, 1, rows}, box2[3] = {32, 1, 64};
  const int dims4[3] = {32, 1, rows}, box4[3] = {32, 1, 32};
  CUtensorMap map2, map4;
  if (!swizzled_map(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, src, 3, dims,
                    box) ||
      !swizzled_map(&map2, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, src, 3, dims2,
                    box2) ||
      !swizzled_map(&map4, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, src, 3, dims4,
                    box4)) {
    printf("RATE tma: no tensor map\n");
    return 1;
  }
  for (int rep = 0; rep < 2; ++rep) {
    run_tma<1>(map, rows, 20000);
    run_tma<2>(map2, rows, 20000);
    run_tma<4>(map4, rows, 20000);
  }
  return 0;
}
