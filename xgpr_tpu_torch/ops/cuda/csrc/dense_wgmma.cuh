// K1 and K2's 3xTF32 bodies ("high", under the "balanced" default; K1
// also under "highest") and K1's bf16 body ("default", under the "max"
// preset), redesigned for Hopper: a warp-specialised TMA pipeline whose
// two consumer warpgroups own whole tiles of a block's walk, so that one
// warpgroup's fold (the sincos, K1's contractions, K2's staging) runs
// while the other's products are in flight.  One template over the
// format (Fmt): the walks, rings, plan and epilogues are the same in
// both; a line, its boxes and its products are the format's.  What the
// kernels compute, and the TPU kernels they replace
// (xgpr_tpu/ops/pallas/ztzv_pallas.py: _ztzv_kernel in _ztzv_parts_impl;
// sorf_pallas.py: _feature_kernel in _rbf_feature_map_impl), is written in
// ztzv.cuh and feature_map.cuh, with what bounds each on the card.
//
// The GEMM.  A consumer computes acc = A B^T for a tile of 64 A rows by
// 128 B rows (64 accumulators a thread), one 128-byte line of depth a
// step, the tile's first product overwriting, in the order the shared
// cp.async ring these bodies ran on before used (issue_line), so each
// accumulator holds that ring's bits:
// - 3xTF32: a line is 32 channels in two planes, the wrapper's TF32 hi
//   and lo splits, and each k8 slice of it three wgmma.m64n128k8 products
//   lo*hi, hi*lo, hi*hi (A's plane first); a line of 64 A rows is 16 KB,
//   of 128 B rows 32 KB;
// - bf16: a line is 64 channels in one plane of bf16 values, and each
//   32-byte slice of it one wgmma.m64n128k16; a line of 64 A rows is 8
//   KB, of 128 B rows 16 KB, so RBF's D 84 is two lines and up to D 192
//   (RES_K lines) the fixed tile stays resident.
// A is x's rows (K2, K1's pass (a) and K1's pass (b) at K 1) or proj^T's
// (K1's pass (b) at K > 1, the operands swapped); B the other.  TMA reads
// the planes from 2-D tensor maps in the 128-byte swizzle and zero-fills
// rows past the operand and depth past dp.
//
// The walk.  A block holds one fixed tile and walks tiles of the other
// operand:
// - "fixed B" (K2; K1's pass (b) at K 1): the fixed tile is 128
//   frequencies of proj^T, the walk the 128-row tiles b, b + split, ...
//   of x; consumer c takes rows 64c .. 64c + 63 of each, so the two read
//   disjoint boxes.  K1's per-warp sums over the walk are the
//   parent's (warp 4c + q holds the parent's warp 4c + q rows).
// - "fixed A" (K1's pass (a), and pass (b) at K > 1): the fixed tile is
//   128 rows of A (consumer c multiplies rows 64c .. 64c + 63), and both
//   consumers walk the 128-wide tiles s, s + split, ... of slice s of the
//   plan's split (ops/cuda/ztzv.py: launch_plan), reading each box of B
//   once between them: a 64-row tile of A on a ring of its own streamed
//   twice the bytes a product (K1 at K 26 ran 1.03 ms against the
//   parent's 0.74).  Each warp's partial sums are the parent's.
// K2's and K1's per-row or per-frequency sums thus run in the parent's
// order, and the plan is the parent's: K1's outputs are its bits.
// A block's grid index is 1-D, so any number of tiles or right-hand-side
// blocks runs.
//
// The pipeline (256 threads: two consumer warpgroups; a producer warp of
// its own would put a third warp on one of the SM's schedulers and cap
// every thread at 168 registers, where the K1 passes spilled):
// - with a fixed B tile each consumer walks its own tiles on a ring of its
//   own (WS stages, full and empty mbarriers, mbarrier.cuh) whose TMA
//   boxes its thread 0 issues: WS ahead at the start, then each stage
//   again once the consumer's four warps have freed it, so the consumers
//   never wait for each other's stages.  With the fixed tile resident,
//   consumer 1 starts once consumer 0's first tile is multiplied, and
//   from then on each folds while the other multiplies.
// - with a fixed A tile both consumers read one ring, which consumer 0's
//   thread 0 fills as both free its stages: they multiply and fold
//   together, as the parent's two warpgroups did, on TMA boxes in place
//   of every thread's cp.async.
// - consumer 0's thread 0 issues the fixed tile: up to RES_K = 3 lines
//   (D 96 in 3xTF32, 192 in bf16; RBF's 84) once, resident; deeper, a
//   box a line of every round into a ring of F_STAGES stages that both
//   consumers free.
// - a consumer waits for a line's boxes, issues its products, and
//   frees the line before once those are done (wgmma.wait_group 1); after
//   a tile it waits for all, frees the last line and folds.
// - K1's staged operands (v_c / v_s, or zv and the mask) go into two
//   slots.  With a fixed A tile both consumers read one copy, which the
//   block's 256 threads stage by cp.async a tile ahead, after the tile's
//   first products are issued, into the slot the fold of the tile before
//   read, behind a barrier of both consumers (bar.sync 3); at K 1 pass
//   (b) each thread loads its two rows' zv and mask into registers.  When
//   the plan splits pass (a), a small launch between the passes sums its
//   partials in slice order from zero, as the parent's pass (b) did while
//   it staged each tile (every block again, with loads it waited on: the
//   bf16 K 26 launch spent half its time there, PERF.md §6).
//
// Shared memory (232,448 bytes a block), in 3xTF32: the fixed region, 3
// boxes of 128 rows (96 KB), the walk's ring(s), then each kernel's own:
// K2 224 KB with 2 stages of 16 KB a consumer and its output staging (2 x
// 32 KB); K1's pass (b) at K 1 200 KB with 3 stages a consumer and the 8
// KB of its cross-warp sums; pass (a) 193 KB (3 stages of 32 KB, K 1) or
// 224 KB (two 16 KB slots of 16 right-hand sides); pass (b) at K > 1 209
// KB (17 KB of slots).  bf16's boxes are half as large: its pass (a)
// takes 161 KB at K > 8 (two 32 KB slots of 32 right-hand sides, NT 4).
//
// K1's feature pass on the reuse path (ztzv_reuse.cuh: 3xTF32 from K 17,
// where the passes below would project four times a call at SLQ's K 26)
// is K2's kernel with K1's fold: the walk, the ring and the staged TMA
// stores are K2's, the fold multiplies the argument by sigma and the
// values by the row's mask times scale (the mask of a tile's rows loaded
// while its products run) and puts the mask in cos column 0 with an
// intercept, and every tile leaves as boxes of the call's scratch planes
// C and S, (n, ldf) each, which the hardware clips at their edges.
//
// K2 stores its features through shared memory by TMA: a tile lies in
// one block of the [cos | sin] layout when the blocks are a multiple of
// 128 wide, F is even and the block's width a multiple of 4; then for
// each half of its 128 frequencies a consumer writes the cos and the sin
// values of its 64 rows as four 8 KB boxes (64 rows x 32 values, the
// 128-byte swizzle), and its thread 0 stores them with
// cp.async.bulk.tensor (the hardware clips rows past N), committing a bulk
// group; the staging is written again only after that group has been
// read (cp.async.bulk.wait_group.read), so the stores run under the next
// half's fold and the other consumer's products.  Other tiles (a
// ragged last block, blocks not a multiple of 128 wide, an odd F) store
// each pair of adjacent frequencies from the fragment, as the parent did.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "feature_map.cuh"
#include "fma_gemm.cuh"
#include "tma.cuh"
#include "ztzv.cuh"

namespace xgpr {
namespace dense {

// The block: two consumer warpgroups, 256 threads, so that ptxas may give
// a thread 255 registers (a ninth warp, a producer's, puts three warps on
// one of the SM's four schedulers and caps them at 168: the K1 passes then
// spilled, and setmaxnreg with spills gave wrong sums on the card).
constexpr int THREADS = 256;
constexpr int A_ROWS = 64;            // the wgmma M
constexpr int B_ROWS = 128;           // the wgmma N
constexpr int CH = 32;                // float32 values a 128-byte line
constexpr int A_PLANE = A_ROWS * 128;  // a plane of 64 rows' line, 8 KB
constexpr int B_PLANE = B_ROWS * 128;  // of 128 rows', 16 KB
constexpr int RES_K = 3;     // the deepest resident fixed tile, in lines
constexpr int F_STAGES = 3;  // the fixed tile's ring when it streams

// A line of format FMT: one 128-byte row of depth a row in each plane,
// 32 channels in two planes (TF32 hi, lo) for 3xTF32, 64 in one for bf16.
template <int FMT>
struct Fmt {
  static_assert(FMT == FMT_TF32X3 || FMT == FMT_BF16,
                "the pipeline's formats are 3xTF32 and bf16");
  static constexpr bool BF16 = FMT == FMT_BF16;
  static constexpr int PLANES = BF16 ? 1 : 2;
  static constexpr int CH = BF16 ? 64 : 32;         // channels a line
  static constexpr int A_BOX = PLANES * A_PLANE;    // 64 rows, hi then lo
  static constexpr int B_BOX = PLANES * B_PLANE;    // 128 rows
};

template <int FMT>
__host__ __device__ constexpr int lines(int dp) {
  return (dp + Fmt<FMT>::CH - 1) / Fmt<FMT>::CH;
}

// Bytes of a block's fixed region (128 rows a line) and its walk rings:
// FIXED_B, the fixed tile is B and each consumer walks its own 64-row
// tiles on a ring of its own; otherwise the fixed tile is A (consumer c
// multiplies its rows 64c .. 64c + 63) and both consumers read one ring
// of 128-row B tiles.  WS: a ring's stages.
template <int FMT, bool FIXED_B, int WS>
struct Layout {
  static constexpr int FB = Fmt<FMT>::B_BOX;  // a fixed box
  static constexpr int WB = FIXED_B ? Fmt<FMT>::A_BOX : Fmt<FMT>::B_BOX;
  static constexpr int RINGS = FIXED_B ? 2 : 1;
  static constexpr int RING = RES_K * FB + RINGS * WS * WB;
};
static_assert(F_STAGES == RES_K, "the fixed ring fills the resident region");

template <int WS>
struct Bars {
  uint64_t ffull[F_STAGES], fempty[F_STAGES], wfull[2][WS], wempty[2][WS];
  uint64_t go;  // consumer 0's first tile is multiplied
};

// What a block walks: `count` tiles, tile i at walk row first + i *
// stride (with a fixed B tile, consumer c's rows 64c .. 64c + 63 of it).
// Kept by value: state held by reference to a kernel's parameters, or
// indexed by the consumer at run time, lands in local memory.
struct Walk {
  int fixed0;  // the fixed tile's first row
  int first, stride, count;
};

// Synchronises the 128 threads of consumer c.
__device__ __forceinline__ void consumer_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}
// Synchronises both consumers (256 threads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// One line's products of A (64 rows, descriptor of its hi plane; its lo
// plane AL descriptor units on) against B (128 rows; lo B_PLANE after),
// in the order of the parent's shared ring: in bf16 one m64n128k16 a
// 32-byte depth slice; in 3xTF32, for each k8 slice, lo*hi, hi*lo and
// hi*hi (A's plane first).  overwrite: the tile's first line.
template <int FMT, uint64_t AL>
__device__ __forceinline__ void issue_line(float acc[64], uint64_t ah,
                                           uint64_t bh, bool overwrite) {
  constexpr uint64_t BL = B_PLANE / 16;
  fence_acc(acc);
  wgmma_fence();
  if constexpr (FMT == FMT_BF16) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16(acc, ah + 2 * kk, bh + 2 * kk, kk > 0 || !overwrite);
  } else {
#pragma unroll
    for (int kk = 0; kk < CH / 8; ++kk) {
      wgmma_tf32(acc, ah + AL + 2 * kk, bh + 2 * kk, kk > 0 || !overwrite);
      wgmma_tf32(acc, ah + 2 * kk, bh + BL + 2 * kk, 1);
      wgmma_tf32(acc, ah + 2 * kk, bh + 2 * kk, 1);
    }
  }
  wgmma_commit();
}

// The TMA boxes (each plane's) of one operand line into dst, on `bar`.
template <int FMT>
__device__ __forceinline__ void box_pair(unsigned char* dst, int bytes,
                                         const CUtensorMap* hi,
                                         const CUtensorMap* lo,
                                         uint64_t* bar, int kk, int row) {
  mbar_expect_tx(bar, bytes);
  tma_box2(dst, hi, bar, Fmt<FMT>::CH * kk, row);
  if constexpr (Fmt<FMT>::PLANES == 2)
    tma_box2(dst + bytes / 2, lo, bar, Fmt<FMT>::CH * kk, row);
}

// A block's pipeline.  With a fixed B tile each consumer walks its own
// 64-row halves of the tiles, a line a step, on a ring of its own whose
// boxes its thread 0 issues: WS ahead at the start, then each stage again
// once the consumer's four warps have freed it (a wait on its own warps
// alone, so the two consumers never wait for each other there); consumer
// 1 starts its products once consumer 0's first tile is multiplied, so
// that from then on one folds while the other multiplies.  With a fixed A
// tile both consumers read each walk box (the ring's empty barriers count
// both consumers' warps), which consumer 0's thread 0 issues.  Consumer
// 0's thread 0 also issues the fixed tile: resident (up to RES_K lines)
// once, else a box a line of every tile into F_STAGES stages that both
// consumers free.
template <int FMT, bool FIXED_B, int WS>
struct Pipe {
  using L = Layout<FMT, FIXED_B, WS>;
  const CUtensorMap *fh, *fl, *wh, *wl;  // fixed and walk operands' maps
  Walk w;
  int kc, c;
  unsigned char *fixed, *ring;  // ring: the one this consumer reads
  Bars<WS>& bar;
  bool resident, issuer;  // issuer: the thread that fills `ring`
  int steps;              // boxes of each ring (kc a tile)
  int r;                  // the ring's barriers: FIXED_B ? c : 0

  __device__ __forceinline__ void fill_walk(int j) {
    const int st = j % WS, i = j / kc;
    box_pair<FMT>(ring + st * L::WB, L::WB, wh, wl, &bar.wfull[r][st],
                  j - i * kc,
                  w.first + i * w.stride + (FIXED_B ? A_ROWS * c : 0));
  }
  __device__ __forceinline__ void fill_fixed(int q) {
    const int st = q % F_STAGES;
    box_pair<FMT>(fixed + st * L::FB, L::FB, fh, fl, &bar.ffull[st], q % kc,
                  w.fixed0);
  }

  // The boxes every ring starts with.
  __device__ __forceinline__ void prologue() {
    if (issuer) {
      for (int j = 0; j < min(WS, steps); ++j) fill_walk(j);
    }
    if (c == 0 && threadIdx.x == 0) {
      if (resident && w.count > 0) {
        mbar_expect_tx(&bar.ffull[0], kc * L::FB);
        for (int kk = 0; kk < kc; ++kk) {
          unsigned char* dst = fixed + kk * L::FB;
          tma_box2(dst, fh, &bar.ffull[0], Fmt<FMT>::CH * kk, w.fixed0);
          if constexpr (Fmt<FMT>::PLANES == 2)
            tma_box2(dst + L::FB / 2, fl, &bar.ffull[0], Fmt<FMT>::CH * kk,
                     w.fixed0);
        }
      } else if (!resident) {
        for (int q = 0; q < min(F_STAGES, steps); ++q) fill_fixed(q);
      }
    }
    __syncwarp();  // the warp meets again before its next wgmma
  }

  // Step j is multiplied: free its stages and fill them again.
  __device__ __forceinline__ void done(int j) {
    release(&bar.wempty[r][j % WS]);
    if (!resident) release(&bar.fempty[j % F_STAGES]);
    if (issuer && j + WS < steps) {
      mbar_wait(&bar.wempty[r][j % WS], (j / WS) & 1);
      fill_walk(j + WS);
    }
    if (c == 0 && threadIdx.x == 0 && !resident && j + F_STAGES < steps) {
      mbar_wait(&bar.fempty[j % F_STAGES], (j / F_STAGES) & 1);
      fill_fixed(j + F_STAGES);
    }
    __syncwarp();
  }

  // The consumer's tiles: epi.stage(i) after a tile's first line is
  // issued, epi.fold(i, acc) after its last is done.
  template <class Epi>
  __device__ __forceinline__ void consume(float acc[64], Epi& epi) {
    constexpr uint64_t FSTEP = L::FB / 16, WSTEP = L::WB / 16;
    // A's lo plane: a 64-row walk box's, or the fixed 128-row box's.
    constexpr uint64_t AL = (FIXED_B ? A_PLANE : B_PLANE) / 16;
    // This consumer's rows of a fixed A box.
    const uint64_t fdesc = sw128_desc(fixed) + (FIXED_B ? 0 : c * A_PLANE / 16);
    const uint64_t wdesc = sw128_desc(ring);
    if (FIXED_B && resident && c == 1 && w.count > 0) mbar_wait(&bar.go, 0);
    if (resident && w.count > 0) mbar_wait(&bar.ffull[0], 0);
    for (int i = 0, j = 0; i < w.count; ++i) {
      for (int kk = 0; kk < kc; ++kk, ++j) {  // step j of the walk
        const Slot ws(j, WS), fs(j, F_STAGES);
        mbar_wait(&bar.wfull[r][ws.stage], ws.parity);
        uint64_t fd = fdesc + kk * FSTEP;
        if (!resident) {
          mbar_wait(&bar.ffull[fs.stage], fs.parity);
          fd = fdesc + fs.stage * FSTEP;
        }
        const uint64_t wd = wdesc + ws.stage * WSTEP;
        issue_line<FMT, AL>(acc, FIXED_B ? wd : fd, FIXED_B ? fd : wd,
                            kk == 0);
        if (kk == 0) epi.stage(i);
        if (kk > 0) {  // the line before is complete
          wgmma_wait<1>();
          done(j - 1);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      done(j - 1);
      if (FIXED_B && c == 0 && i == 0 && threadIdx.x == 0)
        mbar_arrive(&bar.go);
      epi.fold(i, acc);
    }
  }
};

// The block's set-up and its consumer's loop; returns the consumer's
// index (0, 1).  fh/fl and wh/wl are the fixed and walk operands' maps.
template <int FMT, bool FIXED_B, int WS, class Epi>
__device__ __forceinline__ int run(const CUtensorMap* fh,
                                   const CUtensorMap* fl,
                                   const CUtensorMap* wh,
                                   const CUtensorMap* wl, const Walk& w,
                                   int kc, unsigned char* smem,
                                   Bars<WS>& bar, Epi& epi) {
  using L = Layout<FMT, FIXED_B, WS>;
  if (threadIdx.x == 0) {
    for (int i = 0; i < F_STAGES; ++i) {
      mbar_init(&bar.ffull[i], 1);
      mbar_init(&bar.fempty[i], 8);  // both consumers' warps
    }
    for (int c = 0; c < 2; ++c)
      for (int i = 0; i < WS; ++i) {
        mbar_init(&bar.wfull[c][i], 1);
        // the reading consumers' warps
        mbar_init(&bar.wempty[c][i], FIXED_B ? 4 : 8);
      }
    mbar_init(&bar.go, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int c = threadIdx.x / 128;
  const bool resident = kc <= RES_K;
  const int r = FIXED_B ? c : 0;
  Pipe<FMT, FIXED_B, WS> pipe{fh, fl, wh, wl, w, kc, c, smem,
                         smem + RES_K * L::FB + r * WS * L::WB, bar,
                         resident,
                         FIXED_B ? threadIdx.x % 128 == 0 : threadIdx.x == 0,
                         w.count * kc, r};
  pipe.prologue();
  // Each tile's first product overwrites the accumulators: zeroing them in
  // the loop would be a non-wgmma write to registers of products in
  // flight, and ptxas would then serialise every wgmma.
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  pipe.consume(acc, epi);
  return c;
}

// A consumer thread's place: its index in the warpgroup, warp, lane.
struct Lane {
  int tid, warp, g, t4;
  __device__ __forceinline__ explicit Lane(int c)
      : tid((int)threadIdx.x - 128 * c),
        warp(tid / 32),
        g(tid % 32 / 4),
        t4(tid % 4) {}
};

// ---------------------------------------------------------------------------
// K2: the features of the block's frequency tile for its walk of row
// tiles, into the block [cos | sin] layout.

constexpr int K2_WS = 2;
constexpr int K2_STAGING = 32768;  // a consumer's: 4 boxes of 64 x 32
constexpr int K2_SMEM =
    Layout<FMT_TF32X3, true, K2_WS>::RING + 2 * K2_STAGING + 1024;

template <int MODE>
struct K2Epi {
  DenseOperands p;
  features::FeatureArgs<float> a;
  const CUtensorMap* omap;
  Walk w;
  unsigned char* staging;  // this consumer's
  int c, tile_blk, tile_width;
  bool staged;
  Lane ln;

  __device__ __forceinline__ void stage(int) {}

  __device__ __forceinline__ void fold(int i, const float acc[64]) {
    const int row0 = w.first + i * w.stride + A_ROWS * c;
    const int rbase = ln.warp * 16 + ln.g;
    const int f0 = w.fixed0;
    if (staged) {
      const int col = f0 + tile_blk * a.padded;
      with_sincos<MODE>(acc, 1.0f, [&](auto sincos) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // 64 frequencies at a time
          // The staging is free once the last stores have read it.
          if (ln.tid == 0) bulk_wait_read<0>();
          consumer_sync(c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rbase + 8 * h;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int j = 8 * hf + jj;
              float c0, s0, c1, s1;
              sincos(acc[4 * j + 2 * h], a.scale, &c0, &s0);
              sincos(acc[4 * j + 2 * h + 1], a.scale, &c1, &s1);
              // Value 8 (jj % 4) + 2 t4 of row r in cos box jj / 4; the
              // sin boxes follow.
              const int chunk = 2 * (jj % 4) + (ln.t4 >> 1);
              const int off = (jj / 4) * A_PLANE + r * 128 +
                              ((chunk ^ (r & 7)) << 4) + 8 * (ln.t4 & 1);
              *reinterpret_cast<float2*>(staging + off) =
                  make_float2(c0, c1);
              *reinterpret_cast<float2*>(staging + 2 * A_PLANE + off) =
                  make_float2(s0, s1);
            }
          }
          fence_async_shared();
          consumer_sync(c);
          if (ln.tid == 0) {
            const int cc = col + 64 * hf;
            tma_store2(omap, staging, cc, row0);
            tma_store2(omap, staging + A_PLANE, cc + 32, row0);
            tma_store2(omap, staging + 2 * A_PLANE, cc + tile_width, row0);
            tma_store2(omap, staging + 3 * A_PLANE, cc + tile_width + 32,
                       row0);
            bulk_commit();
          }
        }
      });
      return;
    }
    const size_t ld = 2 * (size_t)p.f;
    const int fb = f0 + 2 * ln.t4;
    with_sincos<MODE>(acc, 1.0f, [&](auto sincos) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + rbase + 8 * h;
        if (r >= p.n) continue;
        float* orow = a.out + (size_t)r * ld;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int f = fb + 8 * j;
          if (f >= p.f) continue;
          float c0, s0, c1, s1;
          sincos(acc[4 * j + 2 * h], a.scale, &c0, &s0);
          sincos(acc[4 * j + 2 * h + 1], a.scale, &c1, &s1);
          const int blk = tile_blk >= 0 ? tile_blk : f / a.padded;
          const int width = min(a.padded, p.f - blk * a.padded);
          // f is even, so with even blocks f and f + 1 share a block and
          // both columns of the pair are aligned to their store.
          if (f + 1 < p.f && a.padded % 2 == 0 && width % 2 == 0) {
            const int col = f + blk * a.padded;
            features::store2(orow + col, c0, c1);
            features::store2(orow + col + width, s0, s1);
          } else {
            features::store_feature(a, orow, p.f, f, c0, s0);
            if (f + 1 < p.f)
              features::store_feature(a, orow, p.f, f + 1, c1, s1);
          }
        }
      }
    });
  }
};

// Block b of frequency tile ft is blockIdx.x = ft * rsplit + b; omap is
// the output's tensor map, valid when `has_omap`.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    feature_map_kernel(const __grid_constant__ CUtensorMap xh,
              const __grid_constant__ CUtensorMap xl,
              const __grid_constant__ CUtensorMap ph,
              const __grid_constant__ CUtensorMap pl,
              const __grid_constant__ CUtensorMap omap, DenseOperands p,
              features::FeatureArgs<float> a, int rsplit, int has_omap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) Bars<K2_WS> bar;
  unsigned char* smem = ring_base(smem_raw);
  const int b = (int)(blockIdx.x % rsplit);
  const int f0 = (int)(blockIdx.x / rsplit) * B_ROWS;
  const int tiles = (p.n + B_ROWS - 1) / B_ROWS;
  const int count = b < tiles ? (tiles - 1 - b) / rsplit + 1 : 0;
  const Walk w{f0, b * B_ROWS, rsplit * B_ROWS, count};
  // With blocks a multiple of the tile wide, the tile is in one block.
  const int tile_blk = a.padded % B_ROWS == 0 ? f0 / a.padded : -1;
  const int tile_width =
      tile_blk >= 0 ? min(a.padded, p.f - tile_blk * a.padded) : 0;
  const bool staged = has_omap && tile_blk >= 0 && f0 + B_ROWS <= p.f &&
                      tile_width % 4 == 0 && p.f % 2 == 0;
  const int c = threadIdx.x / 128;
  unsigned char* staging =
      smem + Layout<FMT_TF32X3, true, K2_WS>::RING + c * K2_STAGING;
  K2Epi<MODE> epi{p, a, &omap, w, staging, c, tile_blk,
                  tile_width, staged, Lane(c)};
  run<FMT_TF32X3, true, K2_WS>(&ph, &pl, &xh, &xl, w,
                                lines<FMT_TF32X3>(p.dp), smem, bar, epi);
  if (epi.ln.tid == 0) bulk_wait<0>();
}

// The 2-D tensor maps of a (rows, dp) K-major operand's planes in format
// FMT in boxes of `box_rows` rows by one line (bf16 has one plane: lo is
// a copy of hi, never read).
template <int FMT>
bool plane_maps(CUtensorMap* hi, CUtensorMap* lo, const void* h,
                const void* l, int rows, int dp, int box_rows) {
  const int dims[2] = {dp, rows}, box[2] = {Fmt<FMT>::CH, box_rows};
  if constexpr (Fmt<FMT>::BF16) {
    if (!swizzled_map(hi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, h, 2, dims,
                      box))
      return false;
    *lo = *hi;
    return true;
  } else {
    const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    return swizzled_map(hi, f32, 4, h, 2, dims, box) &&
           swizzled_map(lo, f32, 4, l, 2, dims, box);
  }
}

template <int MODE>
int launch_k2(const DenseOperands& p, const features::FeatureArgs<float>& a,
              int rsplit, cudaStream_t st) {
  if (rsplit < 1 || p.dp % 4 != 0 || p.n < 1 || p.f < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)rsplit * ((p.f + B_ROWS - 1) / B_ROWS);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  CUtensorMap xh, xl, ph, pl, omap;
  if (!plane_maps<FMT_TF32X3>(&xh, &xl, p.x_hi, p.x_lo, p.n, p.dp, A_ROWS) ||
      !plane_maps<FMT_TF32X3>(&ph, &pl, p.b_hi, p.b_lo, p.f, p.dp, B_ROWS))
    return (int)cudaErrorNotSupported;
  // The output (n, 2f) in boxes of 64 rows x 32 values, when its rows are
  // whole 16-byte units (F even).
  int has_omap = 0;
  if (p.f % 2 == 0) {
    const int dims[2] = {2 * p.f, p.n}, box[2] = {CH, A_ROWS};
    if (!swizzled_map(&omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.out, 2,
                      dims, box))
      return (int)cudaErrorNotSupported;
    has_omap = 1;
  } else {
    omap = xh;  // not read
  }
  auto kernel = feature_map_kernel<MODE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K2_SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, THREADS, K2_SMEM, st>>>(xh, xl, ph, pl, omap, p,
                                                     a, rsplit, has_omap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1's feature pass on the reuse path (ztzv_reuse.cuh): K2's walk, ring and
// staged TMA stores with K1's fold, c = cos(acc * sigma) * (m * scale) and
// s = sin(...) * (m * scale), c's column 0 the mask with an intercept, into
// the call's scratch planes C and S, (n, ldf) each (cmap, smap: boxes of
// 64 rows x 32 values; the hardware clips the stores at n rows and ldf
// columns).  Block (ft, b) is blockIdx.x = ft * rsplit + b, as K2's.

template <int MODE>
struct K1FeatEpi {
  ztzv::ZtzvArgs<float> a;
  DenseOperands p;
  const CUtensorMap *cmap, *smap;
  Walk w;
  unsigned char* staging;  // this consumer's
  int c;
  Lane ln;
  float mr[2];  // the mask of this thread's two rows of the tile

  // Loaded while the tile's products run.
  __device__ __forceinline__ void stage(int i) {
    const int row0 = w.first + i * w.stride + A_ROWS * c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + ln.warp * 16 + ln.g + 8 * h;
      mr[h] = r < p.n ? a.m[r] : 0.0f;
    }
  }

  __device__ __forceinline__ void fold(int i, const float acc[64]) {
    const int row0 = w.first + i * w.stride + A_ROWS * c;
    const int rbase = ln.warp * 16 + ln.g;
    const float wr[2] = {mr[0] * a.scale, mr[1] * a.scale};
    const bool icol = a.intercept && w.fixed0 == 0 && ln.t4 == 0;
    with_sincos<MODE>(acc, a.sigma, [&](auto sincos) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // 64 frequencies at a time
        // The staging is free once the last stores have read it.
        if (ln.tid == 0) bulk_wait_read<0>();
        consumer_sync(c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + 8 * h;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * hf + jj;
            float c0, s0, c1, s1;
            sincos(acc[4 * j + 2 * h] * a.sigma, wr[h], &c0, &s0);
            sincos(acc[4 * j + 2 * h + 1] * a.sigma, wr[h], &c1, &s1);
            if (j == 0 && icol) c0 = mr[h];  // column 0 of the intercept
            // Value 8 (jj % 4) + 2 t4 of row r in cos box jj / 4; the
            // sin boxes follow (K2Epi's staging).
            const int chunk = 2 * (jj % 4) + (ln.t4 >> 1);
            const int off = (jj / 4) * A_PLANE + r * 128 +
                            ((chunk ^ (r & 7)) << 4) + 8 * (ln.t4 & 1);
            *reinterpret_cast<float2*>(staging + off) = make_float2(c0, c1);
            *reinterpret_cast<float2*>(staging + 2 * A_PLANE + off) =
                make_float2(s0, s1);
          }
        }
        fence_async_shared();
        consumer_sync(c);
        if (ln.tid == 0) {
          const int cc = w.fixed0 + 64 * hf;
          tma_store2(cmap, staging, cc, row0);
          tma_store2(cmap, staging + A_PLANE, cc + 32, row0);
          tma_store2(smap, staging + 2 * A_PLANE, cc, row0);
          tma_store2(smap, staging + 3 * A_PLANE, cc + 32, row0);
          bulk_commit();
        }
      }
    });
  }
};

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    k1_features_kernel(const __grid_constant__ CUtensorMap xh,
                       const __grid_constant__ CUtensorMap xl,
                       const __grid_constant__ CUtensorMap ph,
                       const __grid_constant__ CUtensorMap pl,
                       const __grid_constant__ CUtensorMap cmap,
                       const __grid_constant__ CUtensorMap smap,
                       DenseOperands p, ztzv::ZtzvArgs<float> a, int rsplit) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) Bars<K2_WS> bar;
  unsigned char* smem = ring_base(smem_raw);
  const int b = (int)(blockIdx.x % rsplit);
  const int f0 = (int)(blockIdx.x / rsplit) * B_ROWS;
  const int tiles = (p.n + B_ROWS - 1) / B_ROWS;
  const int count = b < tiles ? (tiles - 1 - b) / rsplit + 1 : 0;
  const Walk w{f0, b * B_ROWS, rsplit * B_ROWS, count};
  const int c = threadIdx.x / 128;
  unsigned char* staging =
      smem + Layout<FMT_TF32X3, true, K2_WS>::RING + c * K2_STAGING;
  K1FeatEpi<MODE> epi{a, p, &cmap, &smap, w, staging, c, Lane(c)};
  run<FMT_TF32X3, true, K2_WS>(&ph, &pl, &xh, &xl, w,
                                lines<FMT_TF32X3>(p.dp), smem, bar, epi);
  if (epi.ln.tid == 0) bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// K1's pass (a): partial zv of the block's 128 rows of x (consumer c's
// rows 64c ..) over its slice of the frequency tiles, for right-hand
// sides 8 NT kz ... (NT 0: the one right-hand side of K 1, contracted on
// the CUDA cores; else on mma.sync from the fragment).  Block (rt, s, kz)
// is blockIdx.x = (kz * zsplit + s) * row tiles + rt.
//
// At K 1 both formats contract on the CUDA cores, two FMAs a feature: in
// 3xTF32 the tensor-core passes' splits and fresh products cost more
// (0.323 against 0.256 ms at RBF's chunk, PERF.md); in bf16 they were
// faster (0.173 against 0.185 ms on the ring bf16 ran on before), but
// their other summation order cost slice A's fit under "max" a CG
// iteration (18 against 17), so bf16 keeps the one-rhs passes, whose sums
// run in the earlier body's order.  bf16 rounds c, s (after scale * mask
// and the intercept column), v_c / v_s and zv to bf16 (as_operand) before
// the fp32 FMAs, as the TPU's DEFAULT dot rounds its operands.

constexpr int ZV_WS = 3;
template <int NT>
constexpr int ZV_SLOT_FLOATS = NT == 0 ? 2 * B_ROWS : ztzv::ZV_SLOT<NT>;
template <int FMT, int NT>
constexpr int ZV_SMEM = Layout<FMT, false, ZV_WS>::RING +
                        2 * ZV_SLOT_FLOATS<NT> * (int)sizeof(float) + 1024;

template <int FMT, int MODE, int NT>
struct ZvEpi {
  ztzv::ZtzvArgs<float> a;
  DenseOperands p;
  Walk w;
  float* slots;  // two, both consumers'
  int c, k0, kcnt;
  Lane ln;
  float mrow[2], wrow[2];
  float part[2];                    // NT 0
  ztzv::MmaSum z[NT == 0 ? 1 : NT];  // NT > 0

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w.fixed0 + 64 * c + ln.warp * 16 + ln.g + 8 * h;
      mrow[h] = r < p.n ? a.m[r] : 0.0f;
      wrow[h] = mrow[h] * a.scale;
      part[h] = 0.0f;
    }
#pragma unroll
    for (int nt = 0; nt < (NT == 0 ? 1 : NT); ++nt) ztzv::mma_zero(z[nt]);
  }

  // Tile t's v_c / v_s into slot t % 2 by cp.async, the block's 256
  // threads between them, as one group: a warp takes 8 consecutive
  // columns by 4 consecutive right-hand sides (16-byte runs of the (., K)
  // operand; its stores fall on 32 distinct banks).
  __device__ __forceinline__ void copy(int t) {
    if (t < w.count) {
      const int f0 = w.first + t * w.stride, tid = threadIdx.x;
      float* vc = slots + (t % 2) * ZV_SLOT_FLOATS<NT>;
      if constexpr (NT == 0) {  // v_c by threads 0-127, v_s by 128-255
        const int f = f0 + tid % B_ROWS;
        const bool ok = f < p.f;
        const size_t at = ok ? (size_t)f * a.k + k0 : 0;
        ztzv::cp_async4(vc + tid, (tid < B_ROWS ? a.vc : a.vs) + at, ok);
      } else {
        constexpr int KO = 8 * NT;
        float* vs = vc + KO * B_ROWS;
#pragma unroll
        for (int it = 0; it < KO / 2; ++it) {
          const int e = tid + THREADS * it, lane = e % 32, wi = e / 32;
          const int cc = 8 * (wi % 16) + lane % 8;
          const int q = 4 * (wi / 16) + lane / 8;
          const bool ok = f0 + cc < p.f && q < kcnt;
          const size_t at = ok ? (size_t)(f0 + cc) * a.k + k0 + q : 0;
          ztzv::cp_async4(vc + ztzv::staged_at(q, cc), a.vc + at, ok);
          ztzv::cp_async4(vs + ztzv::staged_at(q, cc), a.vs + at, ok);
        }
      }
    }
    cp_async_commit();
  }

  // Both consumers walk tile i together: its v_c / v_s was copied a tile
  // ahead (tile 0's here), and tile i + 1's goes into the slot the fold of
  // tile i - 1 read, which both consumers have left (the barrier).
  __device__ __forceinline__ void stage(int i) {
    consumers_sync();
    if (i == 0) copy(0);
    copy(i + 1);
  }

  __device__ __forceinline__ void fold(int i, const float acc[64]) {
    cp_async_wait<1>();  // all but tile i + 1's group
    consumers_sync();
    const int f0 = w.first + i * w.stride;
    const float* vc = slots + (i % 2) * ZV_SLOT_FLOATS<NT>;
    if constexpr (NT == 0) {
      const float* vs = vc + B_ROWS;
      with_sincos<MODE>(acc, a.sigma, [&](auto sincos) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int fl = 8 * j + 2 * ln.t4 + e;
            const bool icol = a.intercept && f0 + fl == 0;
            const float vcf = as_operand<FMT>(vc[fl]);
            const float vsf = as_operand<FMT>(vs[fl]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float cv, sv;
              sincos(acc[4 * j + 2 * h + e] * a.sigma, wrow[h], &cv, &sv);
              if (icol) cv = mrow[h];
              cv = as_operand<FMT>(cv);
              sv = as_operand<FMT>(sv);
              part[h] = fma_t(cv, vcf, fma_t(sv, vsf, part[h]));
            }
          }
      });
    } else {
      // Slabs of 8 fragment columns an mma takes: m16n8k8 (TF32) one,
      // m16n8k16 (bf16) two.
      constexpr int KO = 8 * NT, JS = ztzv::MMA_JS<FMT>;
      const float* vs = vc + KO * B_ROWS;
      const bool icol = a.intercept && f0 == 0 && ln.t4 == 0;
      with_sincos<MODE>(acc, a.sigma, [&](auto sincos) {
#pragma unroll
        for (int u = 0; u < 16 / JS; ++u) {
          float cv[JS][2][2], sv[JS][2][2];
#pragma unroll
          for (int jj = 0; jj < JS; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                sincos(acc[4 * (JS * u + jj) + 2 * h + e] * a.sigma, wrow[h],
                       &cv[jj][h][e], &sv[jj][h][e]);
          if (u == 0 && icol) {  // column 0 of the intercept
            cv[0][0][0] = mrow[0];
            cv[0][1][0] = mrow[1];
          }
          const ztzv::MmaA ac = ztzv::mma_a<FMT>(cv),
                           as = ztzv::mma_a<FMT>(sv);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            ztzv::mma_add<FMT>(
                z[nt], ac, ztzv::mma_b<FMT>(vc, 8 * nt + ln.g, u, ln.t4));
            ztzv::mma_add<FMT>(
                z[nt], as, ztzv::mma_b<FMT>(vs, 8 * nt + ln.g, u, ln.t4));
          }
        }
      });
    }
  }

  // The rows' partial sums of slice s.
  __device__ __forceinline__ void write(int s, float* zv_part) {
    const int rbase = w.fixed0 + 64 * c + ln.warp * 16 + ln.g;
    if constexpr (NT == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = part[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        part[h] = v;
      }
      if (ln.t4 != 0) return;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rbase + 8 * h;
        if (r < p.n) zv_part[((size_t)s * p.n + r) * a.k + k0] = part[h];
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = rbase + 8 * (r / 2);
        if (row >= p.n) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int q = 8 * nt + 2 * ln.t4 + r % 2;
          if (q < kcnt)
            zv_part[((size_t)s * p.n + row) * a.k + k0 + q] =
                ztzv::mma_value<FMT>(z[nt], r);
        }
      }
    }
  }
};

// A fixed-A walk: slice s of the walk's `tiles` 128-wide tiles (split
// `split`), which both consumers read.
__device__ __forceinline__ Walk slice_walk(int fixed0, int s, int split,
                                           int tiles) {
  const int count = s < tiles ? (tiles - 1 - s) / split + 1 : 0;
  return Walk{fixed0, s * B_ROWS, split * B_ROWS, count};
}

template <int FMT, int MODE, int NT>
__global__ void __launch_bounds__(THREADS, 1)
    k1_zv_kernel(const __grid_constant__ CUtensorMap xh,
                 const __grid_constant__ CUtensorMap xl,
                 const __grid_constant__ CUtensorMap ph,
                 const __grid_constant__ CUtensorMap pl, DenseOperands p,
                 ztzv::ZtzvArgs<float> a, float* __restrict__ zv_part,
                 int zsplit) {
  constexpr int WS = ZV_WS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) Bars<WS> bar;
  unsigned char* smem = ring_base(smem_raw);
  const int row_tiles = (p.n + B_ROWS - 1) / B_ROWS;
  const int rt = (int)(blockIdx.x % row_tiles);
  const int rest = (int)(blockIdx.x / row_tiles);
  const int s = rest % zsplit, kz = rest / zsplit;
  const Walk w = slice_walk(rt * B_ROWS, s, zsplit,
                            (p.f + B_ROWS - 1) / B_ROWS);
  const int c = threadIdx.x / 128;
  const int k0 = NT == 0 ? kz : kz * 8 * NT;
  float* slots = reinterpret_cast<float*>(
      smem + Layout<FMT, false, WS>::RING);
  ZvEpi<FMT, MODE, NT> epi{a, p, w, slots, c, k0,
                           min(NT == 0 ? 1 : 8 * NT, a.k - k0), Lane(c)};
  epi.init();
  run<FMT, false, WS>(&xh, &xl, &ph, &pl, w, lines<FMT>(p.dp), smem, bar,
                      epi);
  // Every slice's partial is written, an empty one's as zeros: pass (b)
  // sums all of them.
  epi.write(s, zv_part);
}

// ---------------------------------------------------------------------------
// K1's pass (b) at K 1: partial oc / os of the block's frequency tile over
// its slice of the row tiles (the 8 warps of the parent's one-rhs out
// pass now the two consumers'), block (ft, b) = blockIdx.x = ft * osplit
// + b.

constexpr int OUT1_WS = 3;
template <int FMT>
constexpr int OUT1_SMEM = Layout<FMT, true, OUT1_WS>::RING +
                          2 * 8 * B_ROWS * (int)sizeof(float) + 1024;

template <int FMT, int MODE>
struct Out1Epi {
  ztzv::ZtzvArgs<float> a;
  DenseOperands p;
  Walk w;
  const float* zv;  // (n, k): pass (a)'s partials summed
  int c;
  Lane ln;
  float zr[2], mr[2];
  float oc[32], os[32];  // column 8j + 2 t4 + e at [2j + e]

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 32; ++i) oc[i] = os[i] = 0.0f;
  }

  // The tile's zv (as the format's product reads it) and mask of this
  // thread's two rows.
  __device__ __forceinline__ void stage(int i) {
    const int row0 = w.first + i * w.stride + A_ROWS * c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + ln.warp * 16 + ln.g + 8 * h;
      const bool ok = r < p.n;
      zr[h] = as_operand<FMT>(ok ? zv[(size_t)r * a.k] : 0.0f);
      mr[h] = ok ? a.m[r] : 0.0f;
    }
  }

  __device__ __forceinline__ void fold(int, const float acc[64]) {
    const int f0 = w.fixed0;
    with_sincos<MODE>(acc, a.sigma, [&](auto sincos) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float wr = mr[h] * a.scale;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float cv, sv;
            sincos(acc[4 * j + 2 * h + e] * a.sigma, wr, &cv, &sv);
            if (a.intercept && f0 + 8 * j + 2 * ln.t4 + e == 0) cv = mr[h];
            cv = as_operand<FMT>(cv);
            sv = as_operand<FMT>(sv);
            oc[2 * j + e] = fma_t(cv, zr[h], oc[2 * j + e]);
            os[2 * j + e] = fma_t(sv, zr[h], os[2 * j + e]);
          }
      }
    });
  }

  // Sum over the warp's rows (lanes with the same t4), then over the 8
  // consumer warps in the parent's order; red is (2, 8, 128) floats.
  __device__ __forceinline__ void write(int b, float* red, float* oc_part,
                                        float* os_part) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        oc[i] += __shfl_xor_sync(0xffffffffu, oc[i], off);
        os[i] += __shfl_xor_sync(0xffffffffu, os[i], off);
      }
    const int warp8 = 4 * c + ln.warp;
    if (ln.tid % 32 < 4) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[(0 * 8 + warp8) * B_ROWS + 8 * j + 2 * ln.t4 + e] =
              oc[2 * j + e];
          red[(1 * 8 + warp8) * B_ROWS + 8 * j + 2 * ln.t4 + e] =
              os[2 * j + e];
        }
    }
    consumers_sync();
    const int tid = ln.tid + 128 * c;
    const int which = tid / B_ROWS, fl = tid % B_ROWS, col = w.fixed0 + fl;
    if (col < p.f) {
      float v = 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u) v += red[(which * 8 + u) * B_ROWS + fl];
      float* out = which ? os_part : oc_part;
      out[((size_t)b * p.f + col) * a.k] = v;
    }
  }
};

template <int FMT, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    k1_out1_kernel(const __grid_constant__ CUtensorMap xh,
                   const __grid_constant__ CUtensorMap xl,
                   const __grid_constant__ CUtensorMap ph,
                   const __grid_constant__ CUtensorMap pl, DenseOperands p,
                   ztzv::ZtzvArgs<float> a, const float* __restrict__ zv,
                   int osplit, float* __restrict__ oc_part,
                   float* __restrict__ os_part) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) Bars<OUT1_WS> bar;
  unsigned char* smem = ring_base(smem_raw);
  const int b = (int)(blockIdx.x % osplit);
  const int f0 = (int)(blockIdx.x / osplit) * B_ROWS;
  const int tiles = (p.n + B_ROWS - 1) / B_ROWS;
  const int count = b < tiles ? (tiles - 1 - b) / osplit + 1 : 0;
  const Walk w{f0, b * B_ROWS, osplit * B_ROWS, count};
  const int c = threadIdx.x / 128;
  Out1Epi<FMT, MODE> epi{a, p, w, zv, c, Lane(c)};
  epi.init();
  run<FMT, true, OUT1_WS>(&ph, &pl, &xh, &xl, w, lines<FMT>(p.dp), smem, bar,
                          epi);
  epi.write(b,
            reinterpret_cast<float*>(smem + Layout<FMT, true, OUT1_WS>::RING),
            oc_part, os_part);
}

// ---------------------------------------------------------------------------
// K1's pass (b) at K > 1, on the swapped operands (A = proj^T's rows, B =
// x's): partial oc / os of the block's 128 frequencies (consumer c's 64c
// ..) over its slice of the row tiles of x, right-hand sides 8 NT kz ....
// Block (ft, s, kz) = blockIdx.x = (kz * osplit + s) * frequency tiles +
// ft.

constexpr int OUTM_WS = 3;
template <int FMT, int NT>
constexpr int OUTM_SMEM = Layout<FMT, false, OUTM_WS>::RING +
                          2 * ztzv::OUT_SLOT<NT> * (int)sizeof(float) + 1024;

template <int FMT, int MODE, int NT>
struct OutMmaEpi {
  ztzv::ZtzvArgs<float> a;
  DenseOperands p;  // the unswapped operands: n rows, f frequencies
  Walk w;
  const float* zv;  // (n, k): pass (a)'s partials summed
  float* slots;     // two, both consumers'
  int c, k0, kcnt;
  Lane ln;
  ztzv::MmaSum sums[2][NT];  // oc, os

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      ztzv::mma_zero(sums[0][nt]);
      ztzv::mma_zero(sums[1][nt]);
    }
  }

  // Tile t's zv and mask into slot t % 2 by cp.async, the block's 256
  // threads between them (as ZvEpi's copies), as one group.
  __device__ __forceinline__ void fill(int t) {
    if (t < w.count) {
      constexpr int KO = 8 * NT;
      const int r0 = w.first + t * w.stride, tid = threadIdx.x;
      float* zt = slots + (t % 2) * ztzv::OUT_SLOT<NT>;
#pragma unroll
      for (int it = 0; it < KO / 2; ++it) {
        const int e = tid + THREADS * it, lane = e % 32, wi = e / 32;
        const int cc = 8 * (wi % 16) + lane % 8;
        const int q = 4 * (wi / 16) + lane / 8;
        const bool ok = r0 + cc < p.n && q < kcnt;
        const size_t at = ok ? (size_t)(r0 + cc) * a.k + k0 + q : 0;
        ztzv::cp_async4(zt + ztzv::staged_at(q, cc), zv + at, ok);
      }
      if (tid < B_ROWS) {
        const bool ok = r0 + tid < p.n;
        ztzv::cp_async4(zt + KO * B_ROWS + tid, a.m + (ok ? r0 + tid : 0),
                        ok);
      }
    }
    cp_async_commit();
  }

  // Both consumers walk tile i together: its zv was staged a tile ahead
  // (tile 0's here), and tile i + 1's goes into the slot the fold of tile
  // i - 1 read, which both consumers have left (the barrier).
  __device__ __forceinline__ void stage(int i) {
    consumers_sync();
    if (i == 0) fill(0);
    fill(i + 1);
  }

  __device__ __forceinline__ void fold(int i, const float acc[64]) {
    constexpr int KO = 8 * NT, JS = ztzv::MMA_JS<FMT>;
    cp_async_wait<1>();  // all but tile i + 1's group
    consumers_sync();
    const float* zt = slots + (i % 2) * ztzv::OUT_SLOT<NT>;
    const float* mt = zt + KO * B_ROWS;
    const int fbase = w.fixed0 + 64 * c + ln.warp * 16 + ln.g;
    with_sincos<MODE>(acc, a.sigma, [&](auto sincos) {
#pragma unroll
      for (int u = 0; u < 16 / JS; ++u) {
        float cv[JS][2][2], sv[JS][2][2];
#pragma unroll
        for (int jj = 0; jj < JS; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = JS * u + jj;
            const float mr = mt[8 * j + 2 * ln.t4 + e], wr = mr * a.scale;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              sincos(acc[4 * j + 2 * h + e] * a.sigma, wr, &cv[jj][h][e],
                     &sv[jj][h][e]);
              if (a.intercept && fbase + 8 * h == 0) cv[jj][h][e] = mr;
            }
          }
        const ztzv::MmaA ac = ztzv::mma_a<FMT>(cv),
                         as = ztzv::mma_a<FMT>(sv);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const ztzv::MmaB bz =
              ztzv::mma_b<FMT>(zt, 8 * nt + ln.g, u, ln.t4);
          ztzv::mma_add<FMT>(sums[0][nt], ac, bz);
          ztzv::mma_add<FMT>(sums[1][nt], as, bz);
        }
      }
    });
  }

  __device__ __forceinline__ void write(int s, float* oc_part,
                                        float* os_part) {
    const int fbase = w.fixed0 + 64 * c + ln.warp * 16 + ln.g;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = fbase + 8 * (r / 2);
      if (col >= p.f) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int q = 8 * nt + 2 * ln.t4 + r % 2;
        if (q >= kcnt) continue;
        const size_t at = ((size_t)s * p.f + col) * a.k + k0 + q;
        oc_part[at] = ztzv::mma_value<FMT>(sums[0][nt], r);
        os_part[at] = ztzv::mma_value<FMT>(sums[1][nt], r);
      }
    }
  }
};

template <int FMT, int MODE, int NT>
__global__ void __launch_bounds__(THREADS, 1)
    k1_outm_kernel(const __grid_constant__ CUtensorMap ph,
                   const __grid_constant__ CUtensorMap pl,
                   const __grid_constant__ CUtensorMap xh,
                   const __grid_constant__ CUtensorMap xl, DenseOperands p,
                   ztzv::ZtzvArgs<float> a, const float* __restrict__ zv,
                   int osplit, float* __restrict__ oc_part,
                   float* __restrict__ os_part) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) Bars<OUTM_WS> bar;
  unsigned char* smem = ring_base(smem_raw);
  const int f_tiles = (p.f + B_ROWS - 1) / B_ROWS;
  const int ft = (int)(blockIdx.x % f_tiles);
  const int rest = (int)(blockIdx.x / f_tiles);
  const int s = rest % osplit, kz = rest / osplit;
  const Walk w = slice_walk(ft * B_ROWS, s, osplit,
                            (p.n + B_ROWS - 1) / B_ROWS);
  const int c = threadIdx.x / 128;
  const int k0 = kz * 8 * NT;
  float* slots = reinterpret_cast<float*>(
      smem + Layout<FMT, false, OUTM_WS>::RING);
  OutMmaEpi<FMT, MODE, NT> epi{a, p, w, zv, slots, c, k0,
                               min(8 * NT, a.k - k0), Lane(c)};
  epi.init();
  run<FMT, false, OUTM_WS>(&ph, &pl, &xh, &xl, w, lines<FMT>(p.dp), smem,
                           bar, epi);
  epi.write(s, oc_part, os_part);
}

// ---------------------------------------------------------------------------
// K1's launches in format FMT: pass (a) over zsplit slices of each row
// tile's frequency tiles; with more than one slice, the sum of its
// partials; pass (b) over osplit slices of each frequency tile's row
// tiles; the fixed-order sum of pass (b)'s partials.

// zv_part[0] = 0 + pass (a)'s nsplit partials in slice order, in place
// (each thread owns one element of every slice): the sum the parent's
// pass (b) made as it staged each tile, made once, so that pass (b)
// copies it.  Internal linkage, as ztzv.cuh's sum kernels.
template <class T>
static __global__ void sum_zv_slices_kernel(T* __restrict__ zv_part,
                                            int nsplit, size_t len) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  T v = T(0);
  for (int s = 0; s < nsplit; ++s) v += zv_part[(size_t)s * len + i];
  zv_part[i] = v;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int FMT, int MODE, int NT>
cudaError_t launch_k1_passes(const DenseOperands& p,
                             const ztzv::ZtzvArgs<float>& a, float* zv_part,
                             float* oc_part, float* os_part, int zsplit,
                             int osplit, cudaStream_t st) {
  // x in boxes of 128 rows (a fixed A or a walked B) and of 64 (pass (b)
  // at K 1 walks it), proj^T in boxes of 128.
  CUtensorMap xh, xl, xbh, xbl, ph, pl;
  if (!plane_maps<FMT>(&xh, &xl, p.x_hi, p.x_lo, p.n, p.dp, A_ROWS) ||
      !plane_maps<FMT>(&xbh, &xbl, p.x_hi, p.x_lo, p.n, p.dp, B_ROWS) ||
      !plane_maps<FMT>(&ph, &pl, p.b_hi, p.b_lo, p.f, p.dp, B_ROWS))
    return cudaErrorNotSupported;
  const long long kblocks = NT == 0 ? a.k : (a.k + 8 * NT - 1) / (8 * NT);
  const long long row_tiles = (p.n + B_ROWS - 1) / B_ROWS;
  const long long f_tiles = (p.f + B_ROWS - 1) / B_ROWS;
  const long long blocks_a = row_tiles * zsplit * kblocks;
  const long long blocks_b = f_tiles * osplit * kblocks;
  if (blocks_a > 0x7fffffff || blocks_b > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(k1_zv_kernel<FMT, MODE, NT>, ZV_SMEM<FMT, NT>);
  if (err != cudaSuccess) return err;
  k1_zv_kernel<FMT, MODE, NT>
      <<<(unsigned)blocks_a, THREADS, ZV_SMEM<FMT, NT>, st>>>(
          xbh, xbl, ph, pl, p, a, zv_part, zsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (zsplit > 1) {
    const size_t len = (size_t)p.n * a.k;
    sum_zv_slices_kernel<float><<<(unsigned)((len + 255) / 256), 256, 0,
                                  st>>>(zv_part, zsplit, len);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (NT == 0) {
    err = allow_smem(k1_out1_kernel<FMT, MODE>, OUT1_SMEM<FMT>);
    if (err != cudaSuccess) return err;
    k1_out1_kernel<FMT, MODE>
        <<<(unsigned)blocks_b, THREADS, OUT1_SMEM<FMT>, st>>>(
            xh, xl, ph, pl, p, a, zv_part, osplit, oc_part, os_part);
  } else {
    err = allow_smem(k1_outm_kernel<FMT, MODE, NT>, OUTM_SMEM<FMT, NT>);
    if (err != cudaSuccess) return err;
    k1_outm_kernel<FMT, MODE, NT>
        <<<(unsigned)blocks_b, THREADS, OUTM_SMEM<FMT, NT>, st>>>(
            ph, pl, xbh, xbl, p, a, zv_part, osplit, oc_part, os_part);
  }
  return cudaGetLastError();
}

template <int FMT, int MODE>
cudaError_t launch_k1_mode(const DenseOperands& p,
                           const ztzv::ZtzvArgs<float>& a, float* zv_part,
                           float* oc_part, float* os_part, float* oc,
                           float* os, int zsplit, int osplit,
                           cudaStream_t st) {
  cudaError_t err;
  if (a.k == 1)
    err = launch_k1_passes<FMT, MODE, 0>(p, a, zv_part, oc_part, os_part,
                                         zsplit, osplit, st);
  else if (ztzv::mma_nt(FMT, a.k) == 1)
    err = launch_k1_passes<FMT, MODE, 1>(p, a, zv_part, oc_part, os_part,
                                         zsplit, osplit, st);
  else
    err = launch_k1_passes<FMT, MODE, ztzv::mma_nt(FMT, 9)>(
        p, a, zv_part, oc_part, os_part, zsplit, osplit, st);
  if (err != cudaSuccess) return err;
  const size_t len = (size_t)p.f * a.k;
  ztzv::sum_splits_kernel<float>
      <<<(unsigned)((len + 255) / 256), 256, 0, st>>>(oc_part, os_part, oc,
                                                       os, osplit, len);
  return cudaGetLastError();
}

// One K1 call in format FMT (3xTF32 or bf16) in sincos mode `mode` (an
// unknown mode, a split below 1 or a depth that is not whole 16-byte rows
// is refused).
template <int FMT>
int launch_k1(const DenseOperands& p, const ztzv::ZtzvArgs<float>& a,
              float* zv_part, float* oc_part, float* os_part, float* oc,
              float* os, int zsplit, int osplit, int mode, cudaStream_t st) {
  if (zsplit < 1 || osplit < 1 || p.dp % (Fmt<FMT>::BF16 ? 8 : 4) != 0 ||
      a.k < 1)
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case MODE_HI:
      return (int)launch_k1_mode<FMT, MODE_HI>(p, a, zv_part, oc_part,
                                               os_part, oc, os, zsplit,
                                               osplit, st);
    case MODE_EXACT:
      return (int)launch_k1_mode<FMT, MODE_EXACT>(p, a, zv_part, oc_part,
                                                  os_part, oc, os, zsplit,
                                                  osplit, st);
    case MODE_FAST:
      return (int)launch_k1_mode<FMT, MODE_FAST>(p, a, zv_part, oc_part,
                                                 os_part, oc, os, zsplit,
                                                 osplit, st);
    case MODE_POLY:
      return (int)launch_k1_mode<FMT, MODE_POLY>(p, a, zv_part, oc_part,
                                                 os_part, oc, os, zsplit,
                                                 osplit, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dense
}  // namespace xgpr
