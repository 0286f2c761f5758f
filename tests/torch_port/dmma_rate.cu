// The rates the synchronous conv bodies (csrc/conv_sync.cuh) can reach on
// one card: float64 mma.sync (DMMA) at each shape PTX offers for sm_90
// (m8n8k4, m16n8k4, m16n8k8, m16n8k16) and fp32 FFMA at a thread tile of
// 8 rows x 8 columns, each with its operands from registers and from
// shared memory.  From shared memory a warp computes a 32 x 32 tile per 16
// of depth (every shape the same work) from sixteen 16-byte loads a thread
// (eight of A, eight of B; the FFMA tile two and two per depth step), as
// the kernels do.  132 x BLOCKS blocks of 256 threads; prints TFLOP/s (2 flops
// a multiply-add) against the published peaks (67 TFLOP/s FP64 on the
// tensor cores, 67 fp32 on the CUDA cores), after a check of the f64
// fragment layouts (LAYOUT lines).  Build and run on the card,
// from the root of a checkout:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/dmma_rate tests/torch_port/dmma_rate.cu
//   build/dmma_rate
#include <cstdio>
#include <cstdlib>

enum Shape { M8N8K4, M16N8K4, M16N8K8, M16N8K16 };
static const char* kName[] = {"m8n8k4", "m16n8k4", "m16n8k8", "m16n8k16"};

__device__ __forceinline__ void mma884(double* c, const double* a,
                                       const double* b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a[0]), "d"(b[0]));
}
__device__ __forceinline__ void mma1684(double* c, const double* a,
                                        const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
__device__ __forceinline__ void mma1688(double* c, const double* a,
                                        const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void mma16816(double* c, const double* a,
                                         const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// A warp's 32 x 32 tile over 16 of depth, given the fragments of the two
// 8-deep halves (a[h][i]: A chunk i of half h, 2 doubles; b[h][j]: B chunk
// j): m16 shapes as 2 x 4 tiles of 16 x 8, m8n8k4 as 4 x 4 tiles of 8 x 8.
template <int S>
__device__ __forceinline__ void tile16(double (&acc)[64], double (&a)[2][8],
                                       double (&b)[2][8]) {
  if constexpr (S == M8N8K4) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            double av = a[h][2 * i + v], bv = b[h][2 * j + v];
            mma884(&acc[8 * i + 2 * j], &av, &bv);
          }
  } else if constexpr (S == M16N8K4) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            double av[2] = {a[h][4 * i + v], a[h][4 * i + 2 + v]};
            double bv = b[h][2 * j + v];
            mma1684(&acc[16 * i + 4 * j], av, &bv);
          }
  } else if constexpr (S == M16N8K8) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          double av[4] = {a[h][4 * i], a[h][4 * i + 2], a[h][4 * i + 1],
                          a[h][4 * i + 3]};
          double bv[2] = {b[h][2 * j], b[h][2 * j + 1]};
          mma1688(&acc[16 * i + 4 * j], av, bv);
        }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        double av[8] = {a[0][4 * i], a[0][4 * i + 2], a[0][4 * i + 1],
                        a[0][4 * i + 3], a[1][4 * i], a[1][4 * i + 2],
                        a[1][4 * i + 1], a[1][4 * i + 3]};
        double bv[4] = {b[0][2 * j], b[0][2 * j + 1], b[1][2 * j],
                        b[1][2 * j + 1]};
        mma16816(&acc[16 * i + 4 * j], av, bv);
      }
  }
}

// SHARED: fragments from shared memory every 16 of depth (16 16-byte
// loads a thread, conflict-free: lane (g, t) reads chunk 2t + h of row g
// of a 128-byte-row tile in the 128-byte swizzle); else from registers.
template <int S, bool SHARED>
__global__ void __launch_bounds__(256) dmma_bench(double* out, int iters) {
  __shared__ __align__(16) double tile[2][64 * 16];
  for (int i = threadIdx.x; i < 2 * 64 * 16; i += 256)
    (&tile[0][0])[i] = 1e-3 * (i % 13);
  __syncthreads();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  double acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0;
  double a[2][8], b[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i) a[h][i] = b[h][i] = 1e-3 * (lane + i + h);
  const int w = threadIdx.x / 32;
  for (int it = 0; it < iters; ++it) {
    if constexpr (SHARED) {
      const int r0 = ((it + w) % 2) * 32;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ra = r0 + 8 * i + g, rb = r0 + 8 * i + g;
          const int ca = (2 * t + h) ^ (ra % 8), cb = (2 * t + h) ^ (rb % 8);
          const double2 va =
              *reinterpret_cast<const double2*>(&tile[0][ra * 16 + 2 * ca]);
          const double2 vb =
              *reinterpret_cast<const double2*>(&tile[1][rb * 16 + 2 * cb]);
          a[h][2 * i] = va.x;
          a[h][2 * i + 1] = va.y;
          b[h][2 * i] = vb.x;
          b[h][2 * i + 1] = vb.y;
        }
    }
    tile16<S>(acc, a, b);
  }
  double s = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += acc[i];
  if (s == 1234.5) out[0] = s;
}

// fp32 FFMA, a thread's 8 x TN tile per depth step: from registers, or
// from shared memory (two 16-byte loads of A and TN / 4 of B a step, the
// rows a warp's 4 x 8 threads read broadcast and conflict-free).
template <bool SHARED, int TN = 8>
__global__ void __launch_bounds__(256) ffma_bench(float* out, int iters) {
  constexpr int BW = 16 * TN;  // B row: 2 warps x 8 lanes x TN
  __shared__ __align__(16) float tile[32 * 128 + 32 * BW];
  for (int i = threadIdx.x; i < 32 * 128 + 32 * BW; i += 256)
    tile[i] = 1e-3f * (i % 13);
  __syncthreads();
  const int lane = threadIdx.x % 32, ty = lane / 8, tx = lane % 8;
  const int w = threadIdx.x / 32;
  float acc[8 * TN];
#pragma unroll
  for (int i = 0; i < 8 * TN; ++i) acc[i] = 0.f;
  float a[8], b[TN];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = 1e-3f * (lane + i);
#pragma unroll
  for (int i = 0; i < TN; ++i) b[i] = 1e-3f * (lane + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      if constexpr (SHARED) {
        const float* ar = &tile[k * 128 + 16 * (w / 2) + 4 * ty];
        const float* br = &tile[32 * 128 + k * BW + 8 * TN * (w % 2) + 4 * tx];
        const float4 a0 = *reinterpret_cast<const float4*>(ar);
        const float4 a1 = *reinterpret_cast<const float4*>(ar + 64);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
        for (int j = 0; j < TN / 4; ++j) {
          const float4 bj = *reinterpret_cast<const float4*>(br + 32 * j);
          b[4 * j] = bj.x; b[4 * j + 1] = bj.y;
          b[4 * j + 2] = bj.z; b[4 * j + 3] = bj.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[TN * i + j] = fmaf(a[i], b[j], acc[TN * i + j]);
    }
  }
  float s = 0;
#pragma unroll
  for (int i = 0; i < 8 * TN; ++i) s += acc[i];
  if (s == 1234.5f) out[0] = s;
}

template <class K, class P>
double tflops(K kernel, P* out, int iters, int blocks, double flops_per_it) {
  kernel<<<132 * blocks, 256>>>(out, 8);
  if (cudaDeviceSynchronize() != cudaSuccess) return -1.0;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  kernel<<<132 * blocks, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  if (cudaGetLastError() != cudaSuccess) return -1.0;
  return flops_per_it * iters * 132 * blocks * 8 / (ms * 1e-3) / 1e12;
}

template <int S>
void dmma_rows(double* out) {
  // 32 x 32 x 16 multiply-adds a warp an iteration, 2 flops each.
  const double per_warp = 2.0 * 32 * 32 * 16;
  for (int blocks : {1, 2}) {
    const double reg = tflops(dmma_bench<S, false>, out, 20000, blocks,
                              per_warp);
    const double shm = tflops(dmma_bench<S, true>, out, 20000, blocks,
                              per_warp);
    printf("RATE f64 mma.sync.%s, %d x 132 blocks: registers %.2f "
           "TFLOP/s, shared memory %.2f TFLOP/s (peak 67)\n",
           kName[S], blocks, reg, shm);
  }
}

// The fragment layout of f64 m16n8k8 and m16n8k4: one product of known A
// (16 x 8) and B (8 x 8) with lane (g, t)'s A registers taken as
// (row, k) by one of two candidate orders (ORDER 0: (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); ORDER 1: (g, t), (g, t + 4), (g + 8, t),
// (g + 8, t + 4)), B's as (t, g), (t + 4, g); C read as (g, 2t + e),
// (g + 8, 2t + e).  K4: a (g, t), (g + 8, t), b (t, g), k < 4.
__device__ double probe_a(int r, int k) { return 1.0 + r + 0.0625 * k; }
__device__ double probe_b(int k, int n) { return 1.0 + 0.125 * k - n; }

template <int K, int ORDER>
__global__ void layout_probe(double* out) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  double c[4] = {0, 0, 0, 0};
  if constexpr (K == 8) {
    double a0 = probe_a(g, t), a3 = probe_a(g + 8, t + 4);
    double a1 = ORDER == 0 ? probe_a(g + 8, t) : probe_a(g, t + 4);
    double a2 = ORDER == 0 ? probe_a(g, t + 4) : probe_a(g + 8, t);
    double a[4] = {a0, a1, a2, a3};
    double b[2] = {probe_b(t, g), probe_b(t + 4, g)};
    mma1688(c, a, b);
  } else {
    double a[2] = {probe_a(g, t), probe_a(g + 8, t)};
    double b = probe_b(t, g);
    mma1684(c, a, &b);
  }
  double err = 0;
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), n = 2 * t + i % 2;
    double want = 0;
    for (int k = 0; k < K; ++k) want += probe_a(r, k) * probe_b(k, n);
    err = fmax(err, fabs(c[i] - want));
  }
  out[lane] = err;
}

template <int K, int ORDER>
void probe(double* out) {
  layout_probe<K, ORDER><<<1, 32>>>(out);
  double h[32];
  cudaMemcpy(h, out, sizeof(h), cudaMemcpyDeviceToHost);
  double err = 0;
  for (double e : h) err = e > err ? e : err;
  printf("LAYOUT f64 m16n8k%d, A order %d: max error %.3e (%s)\n", K, ORDER,
         err, err == 0 ? "matches" : "does not match");
}

int main() {
  double* out;
  cudaMalloc(&out, 64 * sizeof(double));
  probe<8, 0>(out);
  probe<8, 1>(out);
  probe<4, 0>(out);
  if (getenv("DMMA_LAYOUT_ONLY")) return 0;
  dmma_rows<M8N8K4>(out);
  dmma_rows<M16N8K4>(out);
  dmma_rows<M16N8K8>(out);
  dmma_rows<M16N8K16>(out);
  const double per_warp = 2.0 * 32 * 64 * 32;  // 32 depth, 8 x 8 a thread
  for (int blocks : {1, 2}) {
    const double reg = tflops(ffma_bench<false>, (float*)out, 4000, blocks,
                              per_warp);
    const double shm = tflops(ffma_bench<true>, (float*)out, 4000, blocks,
                              per_warp);
    printf("RATE fp32 FFMA 8 x 8 thread tile, %d x 132 blocks: registers "
           "%.2f TFLOP/s, shared memory %.2f TFLOP/s (peak 67)\n",
           blocks, reg, shm);
  }
  const double shm16 = tflops(ffma_bench<true, 16>, (float*)out, 2000, 1,
                              2 * per_warp);
  printf("RATE fp32 FFMA 8 x 16 thread tile, 1 x 132 blocks: shared memory "
         "%.2f TFLOP/s (peak 67)\n", shm16);
  cudaFree(out);
  return 0;
}
