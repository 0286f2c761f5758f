// The rate of the float64 fold's sincos on one card, in the shapes an
// epilogue can give it: the builtin sincos (CUDA's accurate routine, the
// float64 bodies' choice) and a straight-line polynomial pair (a two-part
// FMA reduction by pi/2 and fdlibm's kernels, sincos_poly below), each
// over 32 independent arguments a thread fully unrolled (as an epilogue
// evaluates its accumulators) or in a loop unrolled by U.  132 x BLOCKS
// blocks of 256 threads; every thread evaluates REPS x 32 pairs of
// arguments up to |x| ~ 60, and prints the pairs a second and the ms that
// 33.5M pairs (one fold of RBF's chunk at F 4096) take at that rate, the
// largest difference between the two routines, and whether DMMA products
// on four warps and the builtin fold on the other four of an SM overlap
// (the time of both against each alone).  Build and run on the
// card, from the root of a checkout:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/sincos_rate tests/torch_port/sincos_rate.cu
//   build/sincos_rate
#include <cmath>
#include <cstdio>

constexpr int REPS = 64;
constexpr int VALS = 32;

// fdlibm's __kernel_sin / __kernel_cos on |r| <= pi/4 after a reduction by
// whole quarter periods (n = rint(x 2/pi), r = x - n pi/2 in two FMA
// steps), the quadrant's swap and signs from n's low bits.
__device__ __forceinline__ void sincos_poly(double x, double* s, double* c) {
  const double n = rint(x * 0.63661977236758138);
  double r = fma(-n, 1.5707963267948966, x);
  r = fma(-n, 6.123233995736766e-17, r);
  const double z = r * r;
  double sp = 1.58969099521155010221e-10;
  sp = fma(sp, z, -2.50507602534068634195e-08);
  sp = fma(sp, z, 2.75573137070700676789e-06);
  sp = fma(sp, z, -1.98412698298579493134e-04);
  sp = fma(sp, z, 8.33333333332248946124e-03);
  sp = fma(sp, z, -1.66666666666666324348e-01);
  const double sr = fma(sp * z, r, r);
  double cp = -1.13596475577881948265e-11;
  cp = fma(cp, z, 2.08757232129817482790e-09);
  cp = fma(cp, z, -2.75573143513906633035e-07);
  cp = fma(cp, z, 2.48015872894767294178e-05);
  cp = fma(cp, z, -1.38888888888741095749e-03);
  cp = fma(cp, z, 4.16666666666666019037e-02);
  const double cr = fma(cp * z, z, fma(-0.5, z, 1.0));
  const int q = (int)n & 3;
  double sv = (q & 1) ? cr : sr;
  double cv = (q & 1) ? sr : cr;
  *s = (q & 2) ? -sv : sv;
  *c = ((q + 1) & 2) ? -cv : cv;
}

template <int KIND>
__device__ __forceinline__ void eval(double x, double* s, double* c) {
  if constexpr (KIND == 0)
    sincos(x, s, c);
  else
    sincos_poly(x, s, c);
}

// KIND 0 builtin, 1 polynomial; U 0: VALS values in straight-line code,
// else a loop over them unrolled by U.
template <int KIND, int U>
__global__ void __launch_bounds__(256, 1) rate(double* out, double step) {
  double x[VALS];
  const double base = (threadIdx.x + 256.0 * blockIdx.x) * 1e-6;
#pragma unroll
  for (int i = 0; i < VALS; ++i) x[i] = base + i * 1.87 - 30.0;
  double acc = 0.0;
  for (int rep = 0; rep < REPS; ++rep) {
    if constexpr (U == 0) {
#pragma unroll
      for (int i = 0; i < VALS; ++i) {
        double s, c;
        eval<KIND>(x[i], &s, &c);
        acc += s * c;
        x[i] += step;
      }
    } else {
      double y = x[0] + rep * step;
#pragma unroll U
      for (int i = 0; i < VALS; ++i) {
        double s, c;
        eval<KIND>(y + i * 1.87, &s, &c);
        acc += s * c;
      }
    }
  }
  out[threadIdx.x + 256 * blockIdx.x] = acc;
}

// Whether the fold and the products overlap on one scheduler: warps 0-3
// run DMMA_ITERS x 8 independent m16n8k8 products from registers (WHO &
// 1), warps 4-7 the builtin fold of REPS x 32 pairs (WHO & 2); one block
// of 8 warps an SM, as the dense float64 kernels run.
constexpr int DMMA_ITERS = 2048;

template <int WHO>
__global__ void __launch_bounds__(256, 1) mixed(double* out, double step) {
  const int warp = threadIdx.x / 32;
  double acc = 0.0;
  if (warp < 4) {
    if constexpr ((WHO & 1) != 0) {
      double c[8][4] = {}, a[4], b[2];
      for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 1e-3 + i;
      b[0] = step;
      b[1] = 2.0 * step;
      for (int it = 0; it < DMMA_ITERS; ++it)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          asm volatile(
              "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, "
              "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+d"(c[j][0]), "+d"(c[j][1]), "+d"(c[j][2]), "+d"(c[j][3])
              : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
                "d"(b[1]));
      for (int j = 0; j < 8; ++j) acc += c[j][0] + c[j][3];
    }
  } else if constexpr ((WHO & 2) != 0) {
    double x[VALS];
    const double base = (threadIdx.x + 256.0 * blockIdx.x) * 1e-6;
#pragma unroll
    for (int i = 0; i < VALS; ++i) x[i] = base + i * 1.87 - 30.0;
    for (int rep = 0; rep < REPS; ++rep)
#pragma unroll
      for (int i = 0; i < VALS; ++i) {
        double s, c;
        sincos(x[i], &s, &c);
        acc += s * c;
        x[i] += step;
      }
  }
  out[threadIdx.x + 256 * blockIdx.x] = acc;
}

template <int WHO>
float mixed_ms(double* out) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  mixed<WHO><<<132, 256>>>(out, 1e-3);
  cudaEventRecord(a);
  for (int r = 0; r < 5; ++r) mixed<WHO><<<132, 256>>>(out, 1e-3);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms / 5;
}

__global__ void diff(double* out) {
  const int i = threadIdx.x + 256 * blockIdx.x;
  const double x = (i - 16896.0) * 3.7e-3;
  double s0, c0, s1, c1;
  sincos(x, &s0, &c0);
  sincos_poly(x, &s1, &c1);
  out[i] = fmax(fabs(s0 - s1), fabs(c0 - c1));
}

template <int KIND, int U>
void run(const char* name, double* out, int blocks) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  rate<KIND, U><<<132 * blocks, 256>>>(out, 1e-3);
  cudaEventRecord(a);
  for (int r = 0; r < 5; ++r) rate<KIND, U><<<132 * blocks, 256>>>(out, 1e-3);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double pairs = 5.0 * 132 * blocks * 256 * REPS * VALS;
  printf("SINCOS %s, %d x 132 blocks: %.3f Gpairs/s, 33.5M pairs in %.4f ms\n",
         name, blocks, pairs / (ms * 1e6), 33554432.0 / (pairs / ms));
}

int main() {
  double* out;
  cudaMalloc(&out, sizeof(double) * 132 * 4 * 256);
  for (int blocks = 1; blocks <= 2; ++blocks) {
    run<0, 0>("builtin straight-line", out, blocks);
    run<0, 1>("builtin loop", out, blocks);
    run<0, 4>("builtin loop unrolled 4", out, blocks);
    run<1, 0>("polynomial straight-line", out, blocks);
    run<1, 1>("polynomial loop", out, blocks);
    run<1, 4>("polynomial loop unrolled 4", out, blocks);
  }
  const float p = mixed_ms<1>(out), f = mixed_ms<2>(out),
              both = mixed_ms<3>(out);
  printf("SINCOS overlap, 1 x 132 blocks: products alone (warps 0-3) %.4f "
         "ms, fold alone (warps 4-7) %.4f ms, both %.4f ms (sum %.4f, "
         "max %.4f)\n", p, f, both, p + f, p > f ? p : f);
  diff<<<132, 256>>>(out);
  double host[132 * 256], worst = 0.0;
  cudaMemcpy(host, out, sizeof(host), cudaMemcpyDeviceToHost);
  for (double v : host) worst = v > worst ? v : worst;
  printf("SINCOS largest |builtin - polynomial| on |x| < 63: %.3e\n", worst);
  return cudaDeviceSynchronize() != cudaSuccess;
}
