// The rate of wgmma.m64nNk16 (bf16, both operands in shared memory) on
// one card, 132 blocks of two warpgroups, by N, accumulator chains a
// warpgroup and wgmma.wait_group depth, alone and with a satisfied
// mbarrier wait (EXTRA 1) and an mbarrier arrive (EXTRA 2) a step, as
// csrc/conv_ws.cuh's lines do.  Prints cycles a wgmma per SM against the
// peak and TFLOP/s.  Build and run on the card, from the root of a
// checkout:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/wgmma_rate tests/torch_port/wgmma_rate.cu
//   build/wgmma_rate
#include <cstdio>
#include "../../xgpr_tpu_torch/ops/cuda/csrc/conv_ws.cuh"
using namespace xgpr;
using namespace xgpr::conv::ws;

template <int N>
__device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
  if constexpr (N == 64) wgmma_bf16_n64(d, a, b, 1);
  else wgmma_bf16(d, a, b, 1);
}

template <int N, int CHAINS, int WAITN, int EXTRA = 0>
__global__ void __launch_bounds__(256, 1) bench(long long* out, int iters) {
  __shared__ __align__(8) uint64_t bars[4];
  if (threadIdx.x == 0) { mbar_init(&bars[0], 1); mbar_init(&bars[1], (1 << 20) - 1); mbar_arrive(&bars[0]); }
  __syncthreads();
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
    wgmma_wait<WAITN>();
    if constexpr (EXTRA & 1) mbar_wait(&bars[0], 0);
    if constexpr (EXTRA & 2) release(&bars[1]);
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

template <int N, int CHAINS, int WAITN, int EXTRA = 0>
void run(long long* d, int iters) {
  auto k = bench<N, CHAINS, WAITN, EXTRA>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 66560);
  k<<<132, 256, 66560>>>(d, iters);
  if (cudaDeviceSynchronize() != cudaSuccess) { printf("extra %d failed: %s\n", EXTRA, cudaGetErrorString(cudaGetLastError())); return; }
  cudaEvent_t a, b;
  cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  k<<<132, 256, 66560>>>(d, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  long long h[264];
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  double cyc = 0; for (int i = 0; i < 264; ++i) cyc += h[i]; cyc /= 264;
  const double per = cyc / ((double)iters * 4 * CHAINS * 2);  // cycles per wgmma per SM
  const double flops = 2.0 * 64 * N * 16 * 4 * CHAINS * 2 * (double)iters * 132;
  printf("extra %d N %d chains %d wait<%d>: %.1f cycles a wgmma per SM (peak %d), %.0f TFLOP/s [%s]\n",
         EXTRA, N, CHAINS, WAITN, per, N / 2, flops / (ms * 1e-3) / 1e12, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  long long* d; cudaMalloc(&d, 264 * sizeof(long long));
  const int it = 20000;
  run<64, 1, 0>(d, it); run<64, 1, 1>(d, it); run<64, 2, 1>(d, it);
  run<64, 1, 1, 1>(d, it); run<64, 1, 1, 2>(d, it); run<64, 1, 1, 3>(d, it);
  run<64, 2, 1, 3>(d, it); run<128, 1, 1>(d, it);
  return 0;
}
