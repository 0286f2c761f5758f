// K3 and K4's 3xTF32 body ("high", under the "balanced" default preset),
// redesigned for Hopper: a warp-specialised TMA pipeline in which the taps
// of a window pair share each position box of x.  What the kernels
// compute, and the TPU kernels they replace
// (xgpr_tpu/ops/pallas/conv_pallas.py: _conv_parts_kernel in
// _conv_parts_impl, _conv_maxpool_kernel in _conv_maxpool_impl), is
// written in conv.cuh, with the epilogues.
//
// What bounds it.  At the motif chunk (8192 rows, L 16, D 64, w 9, F
// 4096) the valid windows need 173 GFLOP of fp32-grade products: three
// TF32 products a multiply-add at 495 TFLOP/s, 1.05 ms, against 0.09 ms
// for the bytes of device memory (268 MB of outputs).  The copies from L2
// into shared memory come next: a 128-frequency tile of projT in hi and
// lo planes is 576 KB at D 64, w 9, more than a block's shared memory, so
// it streams, one (tap, line) box of 32 KB a step, and every window pair
// of every row tile reads all of it: 9.45 GB a call with the boxes below,
// ~1.15 ms at the ~8.2 TB/s that TMA moves from L2 into the SMs' shared
// memory (tests/torch_port/tf32_rate.cu).  They overlap the products:
// compiled out, they save 0.03 ms of 1.56 (PERF.md §6); the products and
// the fold bound it, with the card at its power limit.
//
// Design (the wrapper, ops/cuda/conv.py, lays the operands out):
// - Persistent blocks: block (b, ft) = blockIdx.x = ft * split + b walks
//   row tiles b, b + split, ... of frequency tile ft (split from the
//   host's plan, ops/cuda/conv.py tf32_plan).  A row tile is 64 rows of
//   the wrapper's tile order (rows by window count), so its windows stop
//   at its own largest count (`top`), taken in pairs.
// - x: the wrapper writes x in tile order as TF32 hi and lo planes
//   (2, n, l, dp).  A position box is position p of the tile's 64 rows,
//   one 32-channel line, both planes (16 KB); the pair (j, j + 1) reads
//   positions j .. j + w, and each box serves both taps that read it (tap
//   t of window j and tap t - 1 of window j + 1): (w + 1) boxes a line of
//   channels for the pair where reading each tap's rows anew took 2w.
//   The ring holds the boxes from the tap that first reads one to the tap
//   that reads it last, kc + 1 fills for kc lines a tap; past
//   X_STAGES - 2 lines a tap (dp > 128) every line copies its two
//   positions.
// - projT: one (tap, line) box of 128 frequencies x 32 channels x 2
//   planes (32 KB) a ring stage.  Multicasting each box to a cluster of
//   CTAs on neighbouring row tiles would divide its reads from L2, but
//   the card delivers multicast boxes at a third of the rate of plain ones
//   (2.55 against 8.2 TB/s into shared memory, tf32_rate.cu), and a
//   cluster of 2 ran this kernel at 1.7x the time of none (PERF.md §6).
// - Warp specialisation as in conv_ws.cuh: thread 0 of the first
//   warpgroup issues every copy, by TMA from tensor maps (the hardware
//   zero-fills rows past n, positions past l, channels past dp and
//   frequencies past f); full and empty mbarriers per stage; two consumer
//   warpgroups split the 128 frequencies (wgmma.m64n64k8 in TF32: 486
//   TFLOP/s from shared memory with one or two warpgroups issuing,
//   tf32_rate.cu) and read the same position boxes, each pair's two
//   accumulator chains interleaved, a line at a time; a line waits for the
//   line before (wgmma.wait_group 1), whose stages are then freed.  A
//   tile of an odd largest count skips window j + 1's products in its
//   last pair (a tenth of the motif chunk's products).  After a pair the
//   warpgroup folds both windows (PartsEpilogue::fold_row, the
//   straight-line fold with __fadd_rn).
// - The parent's numbers: each accumulator takes its window's products
//   tap-major, then channel lines, then k8 slices, then lo*hi, hi*lo,
//   hi*hi (x's plane first), the group's first product overwriting, and
//   the fold adds windows in order with the same sincos arithmetic, as the
//   implicit GEMM it replaced did.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "conv.cuh"
#include "tma.cuh"

namespace xgpr {
namespace conv {
namespace tf32 {

constexpr int THREADS = 384;           // a producer warpgroup, two consumers
constexpr int ROWS = 64;               // rows per row tile: the wgmma M
constexpr int HALF = 64;               // frequencies per consumer: the N
constexpr int CH = 32;                 // channels per line: 128 bytes
constexpr int X_PLANE = ROWS * 128;    // a position box's plane, 8 KB
constexpr int X_BOX = 2 * X_PLANE;     // hi then lo, 16 KB
constexpr int P_PLANE = GN * 128;      // a projT box's plane, 16 KB
constexpr int P_BOX = 2 * P_PLANE;     // hi then lo, 32 KB
constexpr int P_STAGES = 4;
constexpr int X_STAGES = 6;
constexpr int SMEM = P_STAGES * P_BOX + X_STAGES * X_BOX + 1024;

// The launch plan (ops/cuda/conv.py: tf32_plan) and the row-tile arrays.
struct Args {
  const int* order;  // (n,) input row of each tile-order row
  const int* nk;     // (n,) valid windows, in tile order
  const int* top;    // (row tiles,) each tile's largest nk
  int n, l, dp, width, f;
  int split;         // blocks per frequency tile
};

__host__ __device__ constexpr int chunks(int dp) { return (dp + CH - 1) / CH; }
// Whether a pair's taps share its position boxes (the ring holds the
// kc + 1 fills between a box's two reads, and one more).
__host__ __device__ constexpr bool shares(int dp) {
  return chunks(dp) + 2 <= X_STAGES;
}

// d (64 x 64, fp32) += a (64 x 8) @ b (8 x 64), TF32 operands in shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_tf32_n64(float d[32], uint64_t desc_a,
                                               uint64_t desc_b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// One 32-channel line of a window pair's depth: for each k8 slice, lo*hi,
// hi*lo and hi*hi of each window's position box (descriptors x0, x1 of
// the hi planes; the lo planes follow) against this warpgroup's 64 rows of
// the projT box (pb, its hi plane), the two accumulator chains
// interleaved; window j + 1's chain only when `both` (a tile of an odd
// largest count has no row with it in its last pair).
__device__ __forceinline__ void issue_line(float (&acc)[2][32], uint64_t x0,
                                           uint64_t x1, uint64_t pb,
                                           bool overwrite, bool both) {
  constexpr uint64_t XL = X_PLANE / 16, PL = P_PLANE / 16;
  wgmma_fence();
  if (both) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int acc_first = kk > 0 || !overwrite;
      wgmma_tf32_n64(acc[0], x0 + XL + 2 * kk, pb + 2 * kk, acc_first);
      wgmma_tf32_n64(acc[1], x1 + XL + 2 * kk, pb + 2 * kk, acc_first);
      wgmma_tf32_n64(acc[0], x0 + 2 * kk, pb + PL + 2 * kk, 1);
      wgmma_tf32_n64(acc[1], x1 + 2 * kk, pb + PL + 2 * kk, 1);
      wgmma_tf32_n64(acc[0], x0 + 2 * kk, pb + 2 * kk, 1);
      wgmma_tf32_n64(acc[1], x1 + 2 * kk, pb + 2 * kk, 1);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tf32_n64(acc[0], x0 + XL + 2 * kk, pb + 2 * kk,
                     kk > 0 || !overwrite);
      wgmma_tf32_n64(acc[0], x0 + 2 * kk, pb + PL + 2 * kk, 1);
      wgmma_tf32_n64(acc[0], x0 + 2 * kk, pb + 2 * kk, 1);
    }
  }
  wgmma_commit();
}

// The block: warpgroup 0 produces (thread 0 issues every TMA copy),
// warpgroups 1 and 2 consume, each the frequencies f0 + 64c .. f0 + 64c +
// 63 of the block's row tiles, two windows at a time.  Warp q of a
// consumer owns the tile rows 16q + g and 16q + g + 8, lane (g, t) =
// (lane / 4, lane % 4), and frequencies 8j + 2t + e of its half:
// acc[v][4j + 2h + e] is row 16q + g + 8h of the pair's window v (the
// wgmma m64n64 fragment), as in conv_ws.cuh.
//
// Ring fills.  projT: fill q0 + jp * steps + t * kc + kk holds box (t, kk)
// for pair jp of the block's row tiles so far, steps = w * kc.  x, when
// the taps share (shares(dp)): fill x0 + pos * kc + kk of a pair is
// position j + pos, line kk; line (t, kk) reads fills t * kc + kk (window
// j) and (t + 1) * kc + kk (window j + 1), frees the first, and the second
// too at the last tap.  Otherwise fill x0 + 2 * line + v is window v's
// position j + v + t, freed after its line.
template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    conv_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap hmap,
                     const __grid_constant__ CUtensorMap lmap, const Args p,
                     const typename Epi::Args ea) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t pfull[P_STAGES], pempty[P_STAGES];
  __shared__ __align__(8) uint64_t xfull[X_STAGES], xempty[X_STAGES];
  unsigned char* pring = ring_base(smem_raw);
  unsigned char* xring = pring + P_STAGES * P_BOX;

  // Block b of frequency tile ft is blockIdx.x = ft * split + b (a 1-D
  // grid: any number of frequency tiles).
  const int b0 = (int)(blockIdx.x % p.split);
  const int f0 = (int)(blockIdx.x / p.split) * GN;
  const int kc = chunks(p.dp), w = p.width, steps = w * kc;
  const bool share = shares(p.dp);
  const int tiles = (p.n + ROWS - 1) / ROWS;
  const int count = b0 < tiles ? (tiles - 1 - b0) / p.split + 1 : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < P_STAGES; ++i) {
      mbar_init(&pfull[i], 1);
      mbar_init(&pempty[i], 8);  // the consumer warps
    }
    for (int i = 0; i < X_STAGES; ++i) {
      mbar_init(&xfull[i], 1);
      mbar_init(&xempty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    uint32_t pq = 0, xq = 0;
    auto load_x = [&](int pos, int kk, int row0) {
      const int st = xq % X_STAGES;
      mbar_wait(&xempty[st], ((xq / X_STAGES) & 1) ^ 1);
      mbar_expect_tx(&xfull[st], X_BOX);
      tma_box4(xring + st * X_BOX, &xmap, &xfull[st], CH * kk, pos, row0, 0);
      ++xq;
    };
    for (int i = 0; i < count; ++i) {
      const int rt = b0 + i * p.split, row0 = rt * ROWS;
      const int pairs = (p.top[rt] + 1) / 2;
      for (int jp = 0; jp < pairs; ++jp)
        for (int t = 0, line = 0; t < w; ++t)
          for (int kk = 0; kk < kc; ++kk, ++line) {
            const int j = 2 * jp;
            if (!share) {
              load_x(j + t, kk, row0);
              load_x(j + t + 1, kk, row0);
            } else {
              for (int fx = line == 0 ? 0 : line + kc; fx <= line + kc; ++fx)
                load_x(j + fx / kc, fx % kc, row0);
            }
            const int st = pq % P_STAGES;
            mbar_wait(&pempty[st], ((pq / P_STAGES) & 1) ^ 1);
            mbar_expect_tx(&pfull[st], P_BOX);
            unsigned char* dst = pring + st * P_BOX;
            tma_box(dst, &hmap, &pfull[st], CH * kk, t, f0);
            tma_box(dst + P_PLANE, &lmap, &pfull[st], CH * kk, t, f0);
            ++pq;
          }
    }
    return;
  }

  // The consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // Descriptors of the rings' first stages (this half's projT rows); a
  // descriptor's address counts 16 bytes.
  const uint64_t p_desc = sw128_desc(pring + c * HALF * 128);
  const uint64_t x_desc = sw128_desc(xring);
  constexpr uint64_t P_STEP = P_BOX / 16, X_STEP = X_BOX / 16;
  const int x_next = share ? 1 : 2;  // fills between a window's lines
  // Stage s's predecessor in a ring of n.
  auto before = [](int s, int n, int k) { return s >= k ? s - k : s + n - k; };
  uint32_t pq = 0, xq = 0;
  // Each window's first product overwrites its accumulators: zeroing them
  // in the loop would serialise the products.
  float acc[2][32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[0][k] = acc[1][k] = 0.0f;

  for (int i = 0; i < count; ++i) {
    const int rt = b0 + i * p.split, row0 = rt * ROWS;
    const int top = p.top[rt], pairs = (top + 1) / 2;
    Epi epi(ea);
    int nk_h[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * warp + g + 8 * h;
      nk_h[h] = r < p.n ? p.nk[r] : 0;
    }

    for (int jp = 0; jp < pairs; ++jp) {
      const int j = 2 * jp;
      Slot ps(pq, P_STAGES), xa(xq, X_STAGES), xb = xa;
      xb.step(share ? kc : 1, X_STAGES);
      pq += steps;
      xq += share ? (w + 1) * kc : 2 * steps;
      for (int t = 0; t < w; ++t)
        for (int kk = 0; kk < kc; ++kk) {
          mbar_wait(&pfull[ps.stage], ps.parity);
          mbar_wait(&xfull[xa.stage], xa.parity);
          mbar_wait(&xfull[xb.stage], xb.parity);
          issue_line(acc, x_desc + xa.stage * X_STEP,
                     x_desc + xb.stage * X_STEP, p_desc + ps.stage * P_STEP,
                     t == 0 && kk == 0, j + 1 < top);
          if (t > 0 || kk > 0) {  // the line before is complete: free it
            wgmma_wait<1>();
            release(&pempty[before(ps.stage, P_STAGES, 1)]);
            release(&xempty[before(xa.stage, X_STAGES, x_next)]);
            if (!share || (t == w - 1 && kk > 0))
              release(&xempty[before(xb.stage, X_STAGES, x_next)]);
          }
          ps.step(1, P_STAGES);
          xa.step(x_next, X_STAGES);
          xb.step(x_next, X_STAGES);
        }
      wgmma_wait<0>();
      fence_acc32(acc[0]);
      fence_acc32(acc[1]);
      release(&pempty[before(ps.stage, P_STAGES, 1)]);
      release(&xempty[before(xa.stage, X_STAGES, x_next)]);
      release(&xempty[before(xb.stage, X_STAGES, x_next)]);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const bool builtin = epi.needs_builtin(acc[v]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (j + v < nk_h[h]) epi.fold_row(acc[v], h, builtin);
      }
    }

    // The rows' input indices and scales load once the sums are done (the
    // registers go to the products and the fold until then).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * warp + g + 8 * h;
      if (r >= p.n) continue;
      const int orig = p.order[r];
      const float scale = epi.row_factor(orig);
      const size_t at = (size_t)orig * p.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = f0 + c * HALF + 8 * jj + 2 * t4;
        if (col + 1 < p.f && p.f % 2 == 0) {
          epi.store_pair(at + col, scale, h, jj);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col + e < p.f) epi.store(at + col + e, scale, h, jj, e);
        }
      }
    }
  }
}

// xt: (2, n, l, dp) float32, TF32 hi and lo planes of x's rows in tile
// order; proj_hi, proj_lo: (f, width, dp) float32, projT's planes.  A plan
// the kernel cannot run is refused, as is a failed tensor map.
template <class Epi>
int launch(const Args& p, const void* xt, const void* proj_hi,
           const void* proj_lo, const typename Epi::Args& ea, void* stream) {
  if (p.split < 1 || p.dp % 4 != 0 || p.n < 1 || p.f < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)p.split * ((p.f + GN - 1) / GN);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, hmap, lmap;
  const int xd[4] = {p.dp, p.l, p.n, 2}, xb[4] = {CH, 1, ROWS, 2};
  const int pd[3] = {p.dp, p.width, p.f}, pb[3] = {CH, 1, GN};
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!swizzled_map(&xmap, f32, 4, xt, 4, xd, xb) ||
      !swizzled_map(&hmap, f32, 4, proj_hi, 3, pd, pb) ||
      !swizzled_map(&lmap, f32, 4, proj_lo, 3, pd, pb))
    return (int)cudaErrorNotSupported;
  auto kernel = conv_tf32_kernel<Epi>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      xmap, hmap, lmap, p, ea);
  return (int)cudaGetLastError();
}

}  // namespace tf32
}  // namespace conv
}  // namespace xgpr
