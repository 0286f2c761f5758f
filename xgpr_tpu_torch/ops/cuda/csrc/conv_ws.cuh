// K3 and K4's bf16 body ("default", the "max" preset), redesigned for
// Hopper: a warp-specialised pipeline with the projection tile resident in
// shared memory.  The 3xTF32 body is the pipeline of conv_tf32.cuh, the
// fp32 FMA and float64 bodies the kernel of conv_sync.cuh; what the
// kernels compute, and the TPU kernels they replace
// (xgpr_tpu/ops/pallas/conv_pallas.py: _conv_parts_kernel,
// _conv_maxpool_kernel), is written in conv.cuh.
//
// What bounds it.  At the motif chunk (8192 rows, L 16, D 64, w 9, F
// 4096) the valid windows need 173 GFLOP, 0.175 ms on the bf16 tensor
// cores, against 0.09 ms for the bytes (268 MB of outputs).  The implicit
// GEMM it replaced (a cp.async ring shared by the dense kernels, since
// removed) took 1.11 ms there (the
// launch alone; PERF.md §6): one block per SM behind a block barrier each
// 64-deep step, projT re-read from L2 on every step (~1.5 GB a call of
// 4.7 MB that are distinct), each x line read by 9 taps, and no product in
// flight while a window group's sincos fold ran (0.62 ms of the 1.11 with
// the fold compiled out).
//
// Design:
// - Persistent blocks: block (b, ft) walks row tiles b, b + split, ... of
//   frequency tile ft (split from the host's plan, ops/cuda/conv.py
//   ws_plan; block (b, ft) is blockIdx.x = ft * split + b), so ~4 blocks
//   share a frequency tile at F 4096 and each loads its projT tile once.
//   A row tile is 64 rows of the wrapper's tile order (rows by window
//   count), so its windows stop at its own largest count (`top`).
// - Resident projT: the block keeps its tile, 128 frequencies x w * dp
//   bf16 (144 KB at the motif shape), in shared memory, as w * kc TMA boxes
//   of 128 rows x 64 channels in the 128-byte swizzle.  x streams through
//   a ring of position boxes: box (p, kk) is position p of the tile's 64
//   rows, channels 64kk .. 64kk + 63, 8 KB, which a wgmma descriptor reads
//   as the A operand of every (tap t, window j) with j + t == p: the 9
//   taps of the motif shape share one copy of each position, and a tile
//   loads 2 * ceil(top / 2) + w - 1 positions for its top windows (taken
//   in pairs, below).  When the resident tile and a ring of (w + 1) * kc
//   positions (a pair's) do not fit the 227 KB of a block, the plan
//   streams: each ring stage then holds a (tap, chunk) box of projT
//   beside the pair's two position boxes of that line.
// - Warp specialisation: one thread of the first warpgroup issues every
//   copy, by TMA from a tensor map (the wrapper writes x in tile order, so
//   a box is a plain 3-D box; the hardware zero-fills rows past N,
//   channels past dp and frequencies past F), and hands its registers to
//   the consumers (setmaxnreg).  Full and empty mbarriers per stage
//   replace the block barrier: a stage is refilled once all eight
//   consumer warps have released it, and a position is released by the
//   product that reads it last, so the ring runs ahead within a pair.
// - Two consumer warpgroups split the 128 frequencies (wgmma.m64n64k16:
//   with two warpgroups issuing, that shape runs at the tensor cores' peak
//   on the card) and read the same position boxes.  Each takes its row
//   tile's windows in pairs (j, j + 1), two accumulator chains whose
//   products interleave, a line (one tap's 64-channel box) at a time; a
//   line waits for the line before (wgmma.wait_group 1), whose stages are
//   then freed.  After a pair the warpgroup folds both windows, a row's
//   32 evaluations in straight-line code (with_sincos's choice of
//   evaluator per warp).  The fold does not overlap the warpgroup's own
//   products: a second accumulator set for the next pair needs more than
//   the 168 registers a thread has at 384 threads (it spilled, and ran
//   at 1.7x the time), and an ordered ping-pong of the two warpgroups'
//   issue left the tensor cores to one warpgroup at a time (1.2x).
// - A row tile's rows and the next tile's window count load under the
//   products; the outputs leave as float2 stores.
// - The same numbers as the implicit GEMM's bf16 body: each accumulator
//   takes its window's products tap-major, then channel lines, 4 x k16 a
//   line, the first overwriting, and the fold adds windows in order per
//   (row, frequency), with the same sincos arithmetic.
// - The row operands (x in tile order, the counts) are made on the card
//   by conv_layout.cuh's kernels, shared with the 3xTF32 pipeline.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "conv.cuh"
#include "tma.cuh"

namespace xgpr {
namespace conv {
namespace ws {

constexpr int THREADS = 384;        // a producer warpgroup, two consumers
constexpr int ROWS = 64;            // rows per row tile: the wgmma M
constexpr int HALF = 64;            // frequencies per consumer: the N
constexpr int CH = 64;              // channels per box: one 128-byte line
constexpr int X_BOX = ROWS * 128;   // a position box, 8 KB
constexpr int P_BOX = GN * 128;     // a projT box, 16 KB
constexpr int MAX_STAGES = 32;
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory
constexpr int RESERVED = 2048;      // alignment slack and the barriers

// The launch plan (ops/cuda/conv.py: ws_plan) and the row-tile arrays.
struct Args {
  const int* order;  // (n,) input row of each tile-order row
  const int* nk;     // (n,) valid windows, in tile order
  const int* top;    // (row tiles,) each tile's largest nk
  int n, l, dp, width, f;
  int resident;      // projT tile in shared memory
  int stages;        // ring stages
  int split;         // blocks per frequency tile
};

__host__ __device__ constexpr int chunks(int dp) { return (dp + CH - 1) / CH; }

// Dynamic shared memory of a plan: the resident tile, the ring, and the
// 1024-byte alignment slack.
__host__ __device__ inline int smem_bytes(const Args& p) {
  const int steps = p.width * chunks(p.dp);
  return (p.resident ? steps * P_BOX : 0) +
         p.stages * (p.resident ? X_BOX : P_BOX + 2 * X_BOX) + 1024;
}

// d (64 x 64, fp32) += a (64 x 16) @ b (16 x 64), bf16 operands in shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_bf16_n64(float d[32], uint64_t desc_a,
                                               uint64_t desc_b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
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

// One 64-channel line of a window pair's depth: 4 x k16 products of each
// window's position box (descriptors d0, d1) against this warpgroup's 64
// projT rows (db), the two accumulator chains interleaved.
__device__ __forceinline__ void issue_pair(float (&acc)[2][32], uint64_t d0,
                                           uint64_t d1, uint64_t db,
                                           bool overwrite) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_bf16_n64(acc[0], d0 + 2 * kk, db + 2 * kk, kk > 0 || !overwrite);
    wgmma_bf16_n64(acc[1], d1 + 2 * kk, db + 2 * kk, kk > 0 || !overwrite);
  }
  wgmma_commit();
}

// The block: warpgroup 0 produces (thread 0 issues every TMA copy; the
// rest exit), warpgroups 1 and 2 consume, each the frequencies
// f0 + 64c .. f0 + 64c + 63 of every row tile, two windows at a time
// (j, j + 1: a pair, two accumulator chains).  Warp q of a consumer owns
// the tile rows 16q + g and 16q + g + 8, lane (g, t) = (lane / 4,
// lane % 4), and frequencies 8j + 2t + e of its half: acc[v][4j + 2h + e]
// is row 16q + g + 8h of the pair's window v (the wgmma m64n64 fragment).
// A line is one tap's 64-channel box: its products wait for the line
// before (wgmma.wait_group 1), whose stages are then freed.
//
// Ring fills.  Resident: fill q0 + p * kc + kk is position p, channel line
// kk of the tile (positions 0 .. 2 * pairs + w - 2; past L the box is
// zeros), and a line frees each position whose last product it held: in
// pair j, line t is the last for position j + t when t <= 1 or the pair
// is the tile's last, and line w - 1 also for position j + w when w == 1
// or the pair is the last.  So a position's stage refills while the pair
// that last read it still runs, and the next tile's first positions load
// during this tile's last pair.  Streamed: fill q0 + (pair * w + t) * kc +
// kk holds projT's box (t, kk) and the position boxes j + t and j + 1 + t,
// freed after its line.
template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    conv_ws_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap pmap, const Args p,
                   const typename Epi::Args ea) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t proj_full;
  unsigned char* smem = ring_base(smem_raw);

  const int S = p.stages, kc = chunks(p.dp), w = p.width;
  const int steps = w * kc;  // depth lines of a window
  constexpr int STREAM_STAGE = P_BOX + 2 * X_BOX;
  unsigned char* ring = smem + (p.resident ? steps * P_BOX : 0);
  // Block b of frequency tile ft is blockIdx.x = ft * split + b (a 1-D
  // grid: any number of frequency tiles).
  const int b0 = (int)(blockIdx.x % p.split);
  const int f0 = (int)(blockIdx.x / p.split) * GN;
  const int tiles = (p.n + ROWS - 1) / ROWS;
  const int count = b0 < tiles ? (tiles - 1 - b0) / p.split + 1 : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // the consumer warps
    }
    mbar_init(&proj_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    uint32_t q = 0;  // ring fills so far
    auto acquire = [&](uint32_t bytes) {
      const int st = q % S;
      mbar_wait(&empty[st], ((q / S) & 1) ^ 1);
      mbar_expect_tx(&full[st], bytes);
      ++q;
      return st;
    };
    if (p.resident && count > 0) {
      mbar_expect_tx(&proj_full, steps * P_BOX);
      for (int t = 0; t < w; ++t)
        for (int kk = 0; kk < kc; ++kk)
          tma_box(smem + (t * kc + kk) * P_BOX, &pmap, &proj_full, CH * kk,
                  t, f0);
    }
    for (int i = 0; i < count; ++i) {
      const int rt = b0 + i * p.split, row0 = rt * ROWS;
      const int pairs = (p.top[rt] + 1) / 2;
      if (p.resident) {
        const int np = pairs > 0 ? 2 * pairs + w - 1 : 0;
        for (int pos = 0; pos < np; ++pos)
          for (int kk = 0; kk < kc; ++kk) {
            const int st = acquire(X_BOX);
            tma_box(ring + st * X_BOX, &xmap, &full[st], CH * kk, pos, row0);
          }
      } else {
        for (int jp = 0; jp < pairs; ++jp)
          for (int t = 0; t < w; ++t)
            for (int kk = 0; kk < kc; ++kk) {
              const int st = acquire(STREAM_STAGE);
              unsigned char* dst = ring + st * STREAM_STAGE;
              tma_box(dst, &pmap, &full[st], CH * kk, t, f0);
              tma_box(dst + P_BOX, &xmap, &full[st], CH * kk, 2 * jp + t,
                      row0);
              tma_box(dst + P_BOX + X_BOX, &xmap, &full[st], CH * kk,
                      2 * jp + 1 + t, row0);
            }
      }
    }
    return;
  }

  // The consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // Descriptors of the ring's first stage and of this half's rows of the
  // resident projT tile; a descriptor's address counts 16 bytes.
  const uint64_t ring_desc = sw128_desc(ring);
  const uint64_t proj_desc = sw128_desc(smem + c * HALF * 128);
  const uint64_t half_desc = (uint64_t)(c * HALF * 128 / 16);
  constexpr uint64_t X_STEP = X_BOX / 16, P_STEP = P_BOX / 16;
  constexpr uint64_t S_STEP = STREAM_STAGE / 16;
  uint32_t q0 = 0;  // ring fills of the earlier tiles
  // Each window's first product overwrites its accumulators: zeroing them
  // in the loop would serialise the products.
  float acc[2][32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[0][k] = acc[1][k] = 0.0f;
  if (p.resident && count > 0) mbar_wait(&proj_full, 0);

  int top = count > 0 ? p.top[b0] : 0;
  for (int i = 0; i < count; ++i) {
    const int row0 = (b0 + i * p.split) * ROWS;
    // The next tile's count and this tile's rows load under the products.
    const int next_top =
        i + 1 < count ? p.top[b0 + (i + 1) * p.split] : 0;
    Epi epi(ea);
    int nk_h[2], orig_h[2];
    float scale_h[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * warp + g + 8 * h;
      nk_h[h] = r < p.n ? p.nk[r] : 0;
      orig_h[h] = r < p.n ? p.order[r] : -1;
      scale_h[h] = orig_h[h] >= 0 ? epi.row_factor(orig_h[h]) : 0.0f;
    }
    const int pairs = (top + 1) / 2;

    for (int jp = 0; jp < pairs; ++jp) {
      const int j = 2 * jp;
      const bool last = jp == pairs - 1;
      // Resident: a and b are the fills of (position j + t, line kk) and
      // (j + 1 + t, kk); streamed: a is the line's stage.
      Slot a(p.resident ? q0 + j * kc : q0 + jp * steps, S), b = a;
      if (p.resident) b.step(kc, S);
      int free_a = -1, free_b = -1;  // the line before's stages to free
      for (int t = 0; t < w; ++t)
        for (int kk = 0; kk < kc; ++kk) {
          const int line = t * kc + kk;
          uint64_t d0, d1, db;
          mbar_wait(&full[a.stage], a.parity);
          if (p.resident) {
            mbar_wait(&full[b.stage], b.parity);
            d0 = ring_desc + a.stage * X_STEP;
            d1 = ring_desc + b.stage * X_STEP;
            db = proj_desc + line * P_STEP;
          } else {
            db = ring_desc + a.stage * S_STEP + half_desc;
            d0 = ring_desc + a.stage * S_STEP + P_STEP;
            d1 = d0 + X_STEP;
          }
          issue_pair(acc, d0, d1, db, line == 0);
          if (line > 0) {  // the line before is complete
            wgmma_wait<1>();
            if (free_a >= 0) release(&empty[free_a]);
            if (free_b >= 0) release(&empty[free_b]);
          }
          if (p.resident) {
            free_a = t <= 1 || last ? a.stage : -1;
            free_b = t == w - 1 && (w == 1 || last) ? b.stage : -1;
            b.step(1, S);
          } else {
            free_a = a.stage;
          }
          a.step(1, S);
        }
      wgmma_wait<0>();
      fence_acc32(acc[0]);
      fence_acc32(acc[1]);
      if (free_a >= 0) release(&empty[free_a]);
      if (free_b >= 0) release(&empty[free_b]);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const bool builtin = epi.needs_builtin(acc[v]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (j + v < nk_h[h]) epi.fold_row(acc[v], h, builtin);
      }
    }
    q0 += p.resident ? (pairs > 0 ? 2 * pairs + w - 1 : 0) * kc
                     : pairs * steps;

#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (orig_h[h] >= 0) {
        const size_t at = (size_t)orig_h[h] * p.f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = f0 + c * HALF + 8 * jj + 2 * t4;
          if (col + 1 < p.f && p.f % 2 == 0) {
            epi.store_pair(at + col, scale_h[h], h, jj);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (col + e < p.f) epi.store(at + col + e, scale_h[h], h, jj, e);
          }
        }
      }
    top = next_top;
  }
}

// The tensor map of a bf16 array (d2, d1, d0), contiguous, in boxes of
// 64 values of d0 x 1 x `rows` of d2, in the 128-byte swizzle; reads
// past the array are zero-filled.
inline bool box_map(CUtensorMap* map, const void* base, int d0, int d1,
                    int d2, int rows) {
  const int dims[3] = {d0, d1, d2}, box[3] = {CH, 1, rows};
  return swizzled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, 3,
                      dims, box);
}

// xt: (n, l, dp) bf16 rows in tile order; projT: (f, width, dp) bf16.
// A plan the kernel cannot run is refused, as is a failed tensor map.
template <class Epi>
int launch(const Args& p, const void* xt, const void* projT,
           const typename Epi::Args& ea, void* stream) {
  const int steps = p.width * chunks(p.dp);
  if (p.stages < 2 || p.stages > MAX_STAGES || p.split < 1 ||
      p.dp % 8 != 0 ||
      (p.resident && p.stages < (p.width + 1) * chunks(p.dp)) ||
      smem_bytes(p) + RESERVED - 1024 > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, pmap;
  if (!box_map(&xmap, xt, p.dp, p.l, p.n, ROWS) ||
      !box_map(&pmap, projT, p.dp, p.width, p.f, GN))
    return (int)cudaErrorNotSupported;
  auto kernel = conv_ws_kernel<Epi>;
  const int smem = smem_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)p.split * ((p.f + GN - 1) / GN);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(xmap, pmap, p, ea);
  return (int)cudaGetLastError();
}

}  // namespace ws
}  // namespace conv
}  // namespace xgpr
