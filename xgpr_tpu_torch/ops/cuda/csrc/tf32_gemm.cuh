// The GEMM body shared by every kernel of the library: K3 and K4
// (conv.cu), K2 (feature_map.cu) and K1 (ztzv.cu), in four operand
// formats (Format below), which the wrappers choose from the operands'
// dtype and xgpr_tpu's feature precision (ops/pallas/ztzv_pallas.py:
// _make_dot; ops/cuda/feature_map.py: kernel_body):
//
// - FMT_TF32X3, "high" (and "highest" for K1, K2 in every preset):
//   wgmma.m64n128k8 in 3xTF32.  The wrapper splits each operand into a
//   TF32 high part and the remainder (hi + lo == a exactly), and each
//   warpgroup accumulates lo*hi + hi*lo + hi*hi in fp32 (the lo*lo term,
//   ~2^-22 relative, is dropped; keeping it measured no closer to a
//   float64 witness, PERF.md);
// - FMT_BF16, "default": wgmma.m64n128k16 on bf16 operands, one product
//   per depth step, fp32 accumulation: the TPU's DEFAULT dot, which rounds
//   both operands to bf16.  K1's bf16 passes run on this body; K3 and K4's
//   bf16 body is the warp-specialised pipeline of conv_ws.cuh (TMA, full
//   and empty mbarriers, the projection tile resident in shared memory),
//   which keeps this format's numbers;
// - FMT_FMA32, "highest" for K2: fp32 FMAs on the CUDA cores
//   (fma_gemm.cuh).  Its stages hold one plane of each operand in the
//   same layout, and its products are done when issued.  K3 and K4 take
//   this format in a kernel of their own, conv_sync.cuh, which keeps the
//   fp32 body's numbers.
//
// Float64 operands (FMT_F64) do not run on this file's ring: K1 and K2's
// float64 bodies are the DMMA loop of dense_f64.cuh (m16n8k8 on an
// mbarrier ring of six stages), K3 and K4's conv_sync.cuh.
//
// Both operands are read from shared memory, K-major, each row of a stage
// one 128-byte line in the 128-byte swizzle: 32 fp32 or 64 bf16 values of
// depth.  A block of two warpgroups computes acc = A @ B^T for a tile of
// GM = 128 GEMM rows by GN = 128 columns (frequencies), in depth steps of
// one such line (Body<FMT>::KS values).  Warpgroup w owns the tile's GEMM
// rows 64w .. 64w + 63.  A stage holds each operand's planes (TF32: hi
// and lo, 16 KB each; bf16: the values, 16 KB), so a bf16 stage is 32 KB
// against the TF32 bodies' 64 KB, for twice the depth.
//
// The caller's policies decide what a step loads and what a finished group
// of steps does (gemm_loop is the schedule; gemm_pipeline gives it a ring
// of stages for the conv kernels' row policy; dense_pipeline the dense row
// policy of K1 and K2, with one operand resident when the depth is short):
// - the copies of a step go into its stage: B's planes (GN rows, K-major)
//   then A's (GM rows, K-major), hi before lo.  Out-of-range rows and depth
//   are zero-filled (cp_async16 with valid == false).
// - done(group) runs the epilogue on the accumulators after every spg
//   steps.  A group's first product overwrites the accumulators (scale-d
//   0): zeroing them in the loop would be a non-wgmma write to registers
//   of products in flight, and ptxas would then serialise every wgmma.
//   After a barrier, done may use the stage of the group's last step
//   (step % STAGES) as scratch: no copy targets it before the next
//   iteration's barrier.
//
// Pipeline: a 3-stage cp.async ring.  Step s's products run while the
// block waits for step s + 1's copies and issues step s + 2's into the
// slot step s - 1 read (every warp has waited for those products before
// the barrier).  The epilogue runs after step s's products complete and
// before step s + 1's are issued, so no product is in flight during it;
// the copies of the next two steps are.
//
// Accumulator fragment of warp q (of its warpgroup), lane (g, t) =
// (lane / 4, lane % 4): acc[4j + 2h + e] is the warpgroup's row
// 16q + g + 8h and column 8j + 2t + e, for j < 16 and h, e < 2 (the same
// for the m64n128 shapes of every format).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fma_gemm.cuh"

namespace xgpr {

constexpr int GM = 128;  // GEMM rows per tile: 2 warpgroups x 64
constexpr int GN = 128;  // columns per tile (the wgmma N)
constexpr int GK = 32;   // depth per step of the TF32 bodies (fp32 values)
constexpr int STAGES = 3;
constexpr int GT = 256;                  // threads per block
constexpr int B_BYTES = GN * 128;        // one plane of B: 128-byte rows
constexpr int A_BYTES = GM * 128;        // one plane of A
constexpr int STAGE_BYTES = 2 * (A_BYTES + B_BYTES);     // TF32: 64 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack

// The operand formats, by the host's body flag
// (ops/cuda/feature_map.py: kernel_body, BODY_FLAGS); FMT_F64 is the flag
// of float64 operands, whose products run on dense_f64.cuh's DMMA loop
// (K1, K2) or in conv_sync.cuh (K3, K4), not on this ring.
enum Format : int { FMT_TF32X3 = 0, FMT_FMA32 = 1, FMT_BF16 = 2,
                    FMT_F64 = 3 };

template <int FMT>
struct Body {
  static_assert(FMT != FMT_F64, "float64 runs dense_f64.cuh's loop");
  static constexpr bool BF16 = FMT == FMT_BF16;
  // Products complete when issued (fma_gemm.cuh), no wgmma in flight.
  static constexpr bool SYNC = FMT == FMT_FMA32;
  using T = float;  // the accumulators' type
  static constexpr int PLANES = FMT == FMT_TF32X3 ? 2 : 1;  // TF32 hi, lo
  static constexpr int ELEM = BF16 ? 2 : 4;                 // bytes a value
  static constexpr int VEC = 16 / ELEM;        // values per 16-byte copy
  static constexpr int KS = 128 / ELEM;        // depth per step
  static constexpr int STAGE = PLANES * (A_BYTES + B_BYTES);
  static constexpr int SMEM = STAGES * STAGE + 1024;
};

// v as the product of format FMT reads it: rounded to bf16 (to nearest
// even) for FMT_BF16, whole otherwise.  The K1 epilogues round their
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

// The products of a step in format FMT: this warpgroup's 64 rows of the A
// tile against the B tile, each given by its first plane (a TF32 lo plane
// 16 KB after its hi plane).  Each 32-byte depth slice of the 128-byte
// rows is one wgmma; overwrite: the group's first step.  The fp32 FMA
// format computes the thread's fragment at once (fma_products).
template <int FMT>
__device__ __forceinline__ void issue_products(
    const unsigned char* a, const unsigned char* b,
    typename Body<FMT>::T acc[64], bool overwrite) {
  if constexpr (FMT == FMT_FMA32) {
    fma_products(a, b, acc, overwrite);
  } else {
    const int a_rows = (threadIdx.x / 128) * 64 * 128;
    const uint64_t ah = sw128_desc(a + a_rows), bh = sw128_desc(b);
    fence_acc(acc);
    wgmma_fence();
    if constexpr (FMT == FMT_BF16) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16(acc, ah + 2 * kk, bh + 2 * kk, kk > 0 || !overwrite);
    } else {
      const uint64_t al = sw128_desc(a + A_BYTES + a_rows);
      const uint64_t bl = sw128_desc(b + B_BYTES);
#pragma unroll
      for (int kk = 0; kk < GK / 8; ++kk) {
        wgmma_tf32(acc, al + 2 * kk, bh + 2 * kk, kk > 0 || !overwrite);
        wgmma_tf32(acc, ah + 2 * kk, bl + 2 * kk, 1);
        wgmma_tf32(acc, ah + 2 * kk, bh + 2 * kk, 1);
      }
    }
    wgmma_commit();
  }
}

// The same on a stage of the ring: B's planes, then A's.
template <int FMT>
__device__ __forceinline__ void issue_stage(const unsigned char* st,
                                            typename Body<FMT>::T acc[64],
                                            bool overwrite) {
  issue_products<FMT>(st + Body<FMT>::PLANES * B_BYTES, st, acc, overwrite);
}

// The main loop over nsteps steps in groups of spg; see the top of the
// file.  load(step) issues the step's copies into its stage,
// issue(step, overwrite) its products, done(group) the epilogue.  All
// threads of the block call it.
template <int FMT, class Load, class Issue, class Done>
__device__ __forceinline__ void gemm_loop(int nsteps, int spg,
                                          typename Body<FMT>::T acc[64],
                                          Load&& load, Issue&& issue,
                                          Done&& done) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }
  if (nsteps > 0) {
    cp_async_wait<STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    issue(0, true);
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (step + 2 < nsteps) load(step + 2);
    cp_async_commit();
    if constexpr (!Body<FMT>::SYNC) {
      wgmma_wait_all();
      fence_acc(acc);
    }
    if ((step + 1) % spg == 0) done(step / spg);  // the group is complete
    if (step + 1 < nsteps) issue(step + 1, (step + 1) % spg == 0);
  }
}

// gemm_loop on a ring of Body<FMT>::STAGE-byte stages (B's planes, A's
// planes); load(step, stage) fills one.
template <int FMT, class Load, class Done>
__device__ __forceinline__ void gemm_pipeline(unsigned char* smem,
                                              int nsteps, int spg,
                                              typename Body<FMT>::T acc[64],
                                              Load&& load, Done&& done) {
  auto stage = [&](int step) {
    return smem + (step % STAGES) * Body<FMT>::STAGE;
  };
  gemm_loop<FMT>(
      nsteps, spg, acc, [&](int step) { load(step, stage(step)); },
      [&](int step, bool first) { issue_stage<FMT>(stage(step), acc, first); },
      done);
}

// The dense row policy of K1 and K2: GEMM row r of a tile is row row0 + r
// of x.  A block walks a list of tiles along one axis (the column tiles of
// row tile blockIdx.x, or the row tiles of column tile blockIdx.x), tile i
// being blockIdx.y + i * gridDim.y of that axis, kc = ceil(dp / KS) steps
// each; the stages flow from one tile to the next, so a tile's first
// copies are in flight during the previous tile's epilogue.
struct DenseOperands {
  const void* x_hi;  // (n, dp), 16-byte rows: TF32 high parts, bf16 or
                     // the values (the CUDA-core formats)
  const void* x_lo;  // the same, TF32 remainders (unused by the others)
  const void* b_hi;  // (f, dp), K-major (proj transposed): the same
  const void* b_lo;
  int n, dp, f;
};

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

// The copies of depth chunk kk (one 128-byte line of each row) of rows
// base .. base + 127 of a K-major (nrows, dp) operand in format FMT, its
// planes (hi, lo) into dst and dst + 16 KB: thread (lr, lc) = (tid / 8,
// tid % 8) brings 16-byte chunk lc of rows lr + 32q.  Rows past nrows and
// depth past dp are zero-filled.
template <int FMT>
__device__ __forceinline__ void load_rows(const void* hi, const void* lo,
                                          int nrows, int dp, int base, int kk,
                                          unsigned char* dst) {
  using B = Body<FMT>;
  const int lc = threadIdx.x % 8, lr = threadIdx.x / 8;
  const int c = kk * B::KS + B::VEC * lc;
  const bool cok = c < dp;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = base + lr + 32 * q;
    const bool ok = cok && r < nrows;
    const size_t off = ok ? ((size_t)r * dp + c) * B::ELEM : 0;
    const int d = sw128(lr + 32 * q, lc);
    cp_async16(dst + d, static_cast<const char*>(hi) + off, ok);
    if constexpr (B::PLANES == 2)
      cp_async16(dst + A_BYTES + d, static_cast<const char*>(lo) + off, ok);
  }
}

// The dense kernels' main loop: gemm_loop over the tiles of the block's
// walk, kc depth steps each.  With RESIDENT and a depth of at most RES_K
// steps, the block keeps the tile of the operand its walk does not move
// (A when it walks column tiles, B when it walks row tiles), all its
// depth chunks, in shared memory, and the ring carries only the other
// one, half the bytes a step; the layout is then the fixed tile's chunks
// (its planes: 32 KB TF32, 16 KB bf16), then STAGES ring stages of the
// same size.  Otherwise the ring has gemm_pipeline's stages, so done(tile)
// may use the stage of the tile's last step as scratch.  extra(step) runs
// beside each step's copies (the kernels stage small per-tile operands
// there).
constexpr int RES_K = 3;

template <bool RESIDENT, int FMT = FMT_TF32X3, class Extra, class Done>
__device__ __forceinline__ void dense_pipeline(
    unsigned char* smem, const DenseOperands& p, const DenseWalk& w, int kc,
    typename Body<FMT>::T acc[64], Extra&& extra, Done&& done) {
  static_assert(A_BYTES == B_BYTES, "a ring stage holds an A or a B tile");
  constexpr int HALF = Body<FMT>::PLANES * A_BYTES;  // one operand's planes
  const bool resident = RESIDENT && kc <= RES_K;
  const int nsteps = w.count * kc;
  auto stage = [&](int step) {
    return resident ? smem + RES_K * HALF + (step % STAGES) * HALF
                    : smem + (step % STAGES) * Body<FMT>::STAGE;
  };
  auto load = [&](int step) {
    unsigned char* st = stage(step);
    const int i = step / kc, kk = step - i * kc;
    if (!resident) {
      load_rows<FMT>(p.b_hi, p.b_lo, p.f, p.dp, w.col0(i), kk, st);
      load_rows<FMT>(p.x_hi, p.x_lo, p.n, p.dp, w.row0(i), kk, st + HALF);
    } else if (w.by_cols) {
      load_rows<FMT>(p.b_hi, p.b_lo, p.f, p.dp, w.col0(i), kk, st);
    } else {
      load_rows<FMT>(p.x_hi, p.x_lo, p.n, p.dp, w.row0(i), kk, st);
    }
    extra(step);
  };
  auto issue = [&](int step, bool first) {
    const unsigned char* st = stage(step);
    const unsigned char* f = smem + (step % kc) * HALF;
    if (!resident)
      issue_stage<FMT>(st, acc, first);
    else if (w.by_cols)
      issue_products<FMT>(f, st, acc, first);
    else
      issue_products<FMT>(st, f, acc, first);
  };
  if (resident && nsteps > 0) {  // joins step 0's copy group
    for (int kk = 0; kk < kc; ++kk) {
      unsigned char* dst = smem + kk * HALF;
      if (w.by_cols)
        load_rows<FMT>(p.x_hi, p.x_lo, p.n, p.dp, w.row0(0), kk, dst);
      else
        load_rows<FMT>(p.b_hi, p.b_lo, p.f, p.dp, w.col0(0), kk, dst);
    }
  }
  gemm_loop<FMT>(nsteps, kc, acc, load, issue, done);
}

// Lets a kernel of format FMT's body take its ring's dynamic shared memory
// (Body<FMT>::SMEM; SMEM_BYTES for the TF32 bodies).
template <int FMT = FMT_TF32X3, class Kernel>
cudaError_t allow_ring_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Body<FMT>::SMEM);
}

}  // namespace xgpr
