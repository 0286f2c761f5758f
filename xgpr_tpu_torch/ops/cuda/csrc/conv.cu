// Conv window-loop kernels for Hopper: K3 (masked cos/sin window sums) and
// K4 (ReLU + global max over windows), one implicit-GEMM body on the
// tensor cores at fp32 grade (3xTF32 wgmma), templated on the epilogue.
//
// Replace the TPU kernels xgpr_tpu/ops/pallas/conv_pallas.py:
//   K3 _conv_parts_kernel   (pallas_call in _conv_parts_impl)
//   K4 _conv_maxpool_kernel (pallas_call in _conv_maxpool_impl)
// For zero-padded sequences x (N, L, D), the dense projection (w*D, F) in
// window-major row order (row t*D + c), chi folded in, nw = L - w + 1
// windows and nk_i = clamp(lengths_i - w + 1, 0, nw):
//
//   g[i, j, :] = x[i, j : j + w, :].flatten() @ proj        (j < nw)
//   K3: c[i, f] = scale_i * sum_{j < nk_i} cos(g[i, j, f] * sigma)
//       s[i, f] = scale_i * sum_{j < nk_i} sin(g[i, j, f] * sigma)
//   K4: out[i, f] = max(0, max_{j < nk_i} g[i, j, f])
//
// scale_i is the optional per-row scale (averaging factor times
// rbf_norm_constant; 1 when the pointer is null).  Masked windows add 0 to
// K3 and are -inf against K4's zero start, the implicit ReLU of
// conv_pallas.py:157-164.
//
// What bounds it on the H100.  At the motif slice (8192 rows, L 16, D 64,
// w 9, F 4096) the valid windows need 173 GFLOP of fp32-grade products
// against 34 MB of x, 9.4 MB of proj and 268 MB of outputs (0.09 ms at
// 3.35 TB/s): bound by operations.  On CUDA cores (67 TFLOP/s) that is
// 2.6 ms; on the tensor cores, three TF32 products per multiply-add at
// 495 TFLOP/s, 1.05 ms.
//
// Design (the wrapper in ../conv.py prepares the operands):
// - Implicit GEMM with no im2col array.  GEMM rows are (sequence, window)
//   pairs, the depth is (tap t, channel c), the columns are frequencies.
//   For tap t and channels c0 : c0 + 32 the A slice of a tile is
//   x[rows, j0 + t : j0 + t + WG, c0 : c0 + 32], a box of the input, and
//   the B slice projT[f0 : f0 + 128, t*D + c0 : + 32] serves every
//   (sequence, window) row of the tile: B is read once per depth step per
//   tile, not once per window.  cp.async brings both, as 128-byte rows in
//   the 128-byte swizzle, into a 3-stage ring of shared memory.
// - 3xTF32 on wgmma.m64n128k8.  The wrapper splits x and projT into a TF32
//   high part and the remainder (hi + lo == a exactly); each warpgroup
//   accumulates lo*hi + hi*lo + hi*hi in fp32 (the lo*lo term, ~2^-22
//   relative, is dropped), both operands read from shared memory.  Step
//   s's products run while the block waits for step s + 1's copies and
//   issues step s + 2's.  A group's first product overwrites the
//   accumulators (scale-d 0): zeroing them in the loop is a non-wgmma write
//   to registers of products in flight, and ptxas then serialises every
//   wgmma.  The register-A form (x split in registers, no extra bytes)
//   leaves too few registers for products in flight; it measured slower
//   (PERF.md).
// - Rows ordered by window count.  The wrapper passes a stable order of
//   the rows by nk; a tile is 64 consecutive rows of that order, so its
//   rows have near-equal nk, and it loops over groups of WG = 2 windows
//   only up to its own largest nk.  At the motif slice that projects
//   1.12 window slots per valid window instead of 1.79.  Outputs go to
//   each row's own index, so callers see the input order.
// - Epilogue on the accumulator fragment.  Both windows of a group sit in
//   the same thread's registers (accumulator rows g and g + 8 of a warp),
//   so K3's sincos sums and K4's max fold into register accumulators at
//   the end of each group, and each output is written once, with no
//   atomics: results are the same from run to run.
// - Any shape: rows past N, windows past nw, channel chunks past D and
//   frequencies past F are zero-filled by the copies and masked at the
//   store.  The wrapper pads D to a multiple of 4 (16-byte copies).
#include <stdint.h>

#include "common.cuh"

using namespace xgpr;

namespace {

constexpr int WR = 64;               // sequences per tile
constexpr int WG = 2;                // windows per group
constexpr int WM = WR * WG;          // GEMM rows per tile: 2 warpgroups x 64
constexpr int WN = 128;              // frequencies per tile (the wgmma N)
constexpr int WK = 32;               // channels per stage: one 128-byte row
constexpr int STAGES = 3;
constexpr int WT = 256;
constexpr int B_BYTES = WN * WK * 4;  // one of projT hi / lo
constexpr int A_BYTES = WM * WK * 4;  // one of x hi / lo
constexpr int STAGE_BYTES = 2 * (A_BYTES + B_BYTES);      // 64 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack

struct ConvArgs {
  const float* x_hi;     // (n, l, dp), dp % 4 == 0: TF32 high parts
  const float* x_lo;     // the same, remainders
  const int* order;      // (n,) rows in tile order
  const int* nk;         // (n,) valid windows of each row, in [0, nw]
  const float* proj_hi;  // (f, width * dp), K-major: TF32 high parts
  const float* proj_lo;  // the same, remainders
  int n, l, dp, width, f;
};

__device__ __forceinline__ void cp_async16(void* dst, const float* src,
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

// Byte offset of 16-byte chunk c of row r in a tile of 128-byte rows in
// the 128-byte swizzle, the layout wgmma's descriptors below read.
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r % 8)) << 4);
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// K3: running cos/sin sums of this thread's sequence x 32 frequencies.
struct PartsEpilogue {
  struct Args {
    const float* row_scale;
    float* c_out;
    float* s_out;
    float sigma;
    int exact;
  };
  Args a;
  float cs[16][2], sn[16][2];

  __device__ __forceinline__ explicit PartsEpilogue(const Args& args)
      : a(args) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) cs[j][e] = sn[j][e] = 0.0f;
  }
  __device__ __forceinline__ void fold(int j, int e, float g) {
    float c, s;
    sincos_scaled(g * a.sigma, 1.0f, a.exact, &c, &s);
    cs[j][e] += c;
    sn[j][e] += s;
  }
  __device__ __forceinline__ float row_factor(int row) const {
    return a.row_scale ? a.row_scale[row] : 1.0f;
  }
  __device__ __forceinline__ void store(size_t at, float w, int j,
                                        int e) const {
    a.c_out[at] = cs[j][e] * w;
    a.s_out[at] = sn[j][e] * w;
  }
};

// K4: running max against a zero start.
struct MaxpoolEpilogue {
  struct Args {
    float* out;
  };
  Args a;
  float mx[16][2];

  __device__ __forceinline__ explicit MaxpoolEpilogue(const Args& args)
      : a(args) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) mx[j][e] = 0.0f;
  }
  __device__ __forceinline__ void fold(int j, int e, float g) {
    mx[j][e] = fmaxf(mx[j][e], g);
  }
  __device__ __forceinline__ float row_factor(int) const { return 1.0f; }
  __device__ __forceinline__ void store(size_t at, float, int j,
                                        int e) const {
    a.out[at] = mx[j][e];
  }
};

// One block: 64 sequences (rows order[row0 : row0 + 64]) x 128 frequencies,
// two warpgroups of 32 sequences each.  Warp q of warpgroup w owns the 16
// GEMM rows of sequences s = 32w + 8q + [0, 8), row window * 8 + s % 8, so
// lane (g, t) = (lane / 4, lane % 4) holds sequence 32w + 8q + g for both
// windows of the group (accumulator rows g and g + 8) and frequencies
// 8j + 2t + e.  A's shared rows follow the same order:
// (s / 8) * 16 + window * 8 + s % 8.
template <class Epi>
__global__ void __launch_bounds__(WT, 1)
    conv_window_kernel(ConvArgs p, typename Epi::Args ea) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int s_row[WR], s_nk[WR], s_nkmax;
  unsigned char* smem =
      smem_raw +
      ((1024 - ((unsigned)__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int seq = (tid / 32) * 8 + g;  // this thread's sequence in the tile
  const int row0 = blockIdx.x * WR, f0 = blockIdx.y * WN;
  const int nw = p.l - p.width + 1;
  const int kdim = p.width * p.dp;

  if (tid == 0) s_nkmax = 0;
  if (tid < WR) {
    const int r = row0 + tid;
    const int orig = r < p.n ? p.order[r] : 0;
    s_row[tid] = orig;
    s_nk[tid] = r < p.n ? p.nk[orig] : 0;
  }
  __syncthreads();
  if (tid < WR) atomicMax(&s_nkmax, s_nk[tid]);
  __syncthreads();

  // Copy assignment: 16-byte chunk lc of a 32-channel row; sequences lr and
  // lr + 32 (both windows), and frequencies lr + 32q, hi and lo each.
  const int lc = tid % 8, lr = tid / 8;
  size_t xoff[2];
  bool xok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = lr + 32 * h;
    xok[h] = row0 + s < p.n;
    xoff[h] = (size_t)s_row[s] * p.l * p.dp;
  }
  size_t boff[4];
  bool bok[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int fr = f0 + lr + 32 * q;
    bok[q] = fr < p.f;
    boff[q] = (size_t)(bok[q] ? fr : 0) * kdim;
  }

  const int kc = (p.dp + WK - 1) / WK;  // channel chunks per tap
  const int spg = p.width * kc;         // pipeline steps per window group
  const int nsteps = (s_nkmax + WG - 1) / WG * spg;

  // Stage layout: projT hi, projT lo, x hi, x lo.
  auto load_stage = [&](int step) {
    const int gi = step / spg, rem = step - gi * spg;
    const int tap = rem / kc, c = (rem - tap * kc) * WK + 4 * lc;
    const int j0 = gi * WG;
    const bool cok = c < p.dp;
    unsigned char* st = smem + (step % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = bok[q] && cok;
      const size_t off = ok ? boff[q] + tap * p.dp + c : 0;
      const int dst = sw128(lr + 32 * q, lc);
      cp_async16(st + dst, p.proj_hi + off, ok);
      cp_async16(st + B_BYTES + dst, p.proj_lo + off, ok);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int win = 0; win < WG; ++win) {
        const int s = lr + 32 * h;
        const bool ok = xok[h] && cok && j0 + win < nw;
        const size_t off =
            ok ? xoff[h] + (size_t)(j0 + win + tap) * p.dp + c : 0;
        const int dst =
            2 * B_BYTES + sw128((s / 8) * 16 + win * 8 + s % 8, lc);
        cp_async16(st + dst, p.x_hi + off, ok);
        cp_async16(st + A_BYTES + dst, p.x_lo + off, ok);
      }
  };

  const int nk_s = s_nk[seq];
  Epi epi(ea);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // The three products of a step on its stage: this warpgroup's 64 A rows.
  const int a_rows = (tid / 128) * 64 * 128;
  auto issue = [&](int step) {
    const unsigned char* st = smem + (step % STAGES) * STAGE_BYTES;
    const uint64_t bh = sw128_desc(st), bl = sw128_desc(st + B_BYTES);
    const uint64_t ah = sw128_desc(st + 2 * B_BYTES + a_rows);
    const uint64_t al = sw128_desc(st + 2 * B_BYTES + A_BYTES + a_rows);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 8; ++kk) {
      // A group's first product overwrites the accumulators.
      wgmma_tf32(acc, al + 2 * kk, bh + 2 * kk, kk > 0 || step % spg != 0);
      wgmma_tf32(acc, ah + 2 * kk, bl + 2 * kk, 1);
      wgmma_tf32(acc, ah + 2 * kk, bh + 2 * kk, 1);
    }
    wgmma_commit();
  };

  // Step s's products run while the block waits for step s + 1's copies
  // and issues step s + 2's into the slot step s - 1 read (every warp has
  // waited for those products before the barrier).
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s);
    cp_async_commit();
  }
  if (nsteps > 0) {
    cp_async_wait<STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    issue(0);
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (step + 2 < nsteps) load_stage(step + 2);
    cp_async_commit();
    wgmma_wait_all();
    fence_acc(acc);
    if ((step + 1) % spg == 0) {  // the group's products are complete
      const int j0 = (step / spg) * WG;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (j0 + h < nk_s) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              epi.fold(j, e, acc[4 * j + 2 * h + e]);
        }
    }
    if (step + 1 < nsteps) issue(step + 1);
  }

  if (row0 + seq < p.n) {
    const int orig = s_row[seq];
    const float w = epi.row_factor(orig);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = f0 + 8 * j + 2 * t4 + e;
        if (col < p.f) epi.store((size_t)orig * p.f + col, w, j, e);
      }
  }
}

template <class Epi>
int launch(const ConvArgs& p, const typename Epi::Args& ea, void* stream) {
  auto kernel = conv_window_kernel<Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.n + WR - 1) / WR, (p.f + WN - 1) / WN);
  kernel<<<grid, WT, SMEM_BYTES, (cudaStream_t)stream>>>(p, ea);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int xgpr_conv_parts(const float* x_hi, const float* x_lo,
                               const int* order, const int* nk,
                               const float* proj_hi, const float* proj_lo,
                               const float* row_scale, float* c_out,
                               float* s_out, int n, int l, int dp, int width,
                               int f, float sigma, int exact, void* stream) {
  const ConvArgs p{x_hi, x_lo, order, nk, proj_hi, proj_lo,
                   n,    l,    dp,    width, f};
  return launch<PartsEpilogue>(p, {row_scale, c_out, s_out, sigma, exact},
                               stream);
}

extern "C" int xgpr_conv_maxpool(const float* x_hi, const float* x_lo,
                                 const int* order, const int* nk,
                                 const float* proj_hi, const float* proj_lo,
                                 float* out, int n, int l, int dp, int width,
                                 int f, void* stream) {
  const ConvArgs p{x_hi, x_lo, order, nk, proj_hi, proj_lo,
                   n,    l,    dp,    width, f};
  return launch<MaxpoolEpilogue>(p, {out}, stream);
}
