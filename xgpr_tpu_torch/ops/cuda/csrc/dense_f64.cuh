// The main loop of K1 and K2's float64 bodies (ztzv.cuh: the passes
// ztzv_zv_f64_kernel and ztzv_out_f64_kernel; feature_map_f64.cu:
// feature_map_f64_kernel): a GEMM acc = A B^T of K-major float64 operands
// tile by tile along a block's walk, with the kernel's epilogue on every
// finished tile.
//
// What bounds them on the H100: the float64 projection (5.6 GFLOP at
// RBF's chunk, 8192 x 84 by 84 x 4096: 0.084 ms at 67 TFLOP/s), the
// builtin double sincos of the fold (33.5M pairs a projection, 0.13 ms at
// the 263G pairs a second tests/torch_port/sincos_rate.cu measured with
// one block of 8 warps an SM), and for K2 the 537 MB of float64 features
// it writes (0.16 ms at 3.35 TB/s); K1 at K 26 adds 8.6 GFLOP of
// contractions.  The fold runs with no product in flight and at the
// builtin's rate: warps 4-7 started three lines after warps 0-3, so that
// one warp of each scheduler would fold while the other ran products,
// measured no faster (PERF.md §6).
//
// Design:
// - 8 warps; warp (wm, wn) = (warp / WN, warp % WN) owns 1 x 8 DMMA
//   tiles of 16 x 8 (dmma.cuh: m16n8k8): GEMM rows 16 wm + g + 8h and
//   columns 64 wn + 8n + 2t + e, in acc[4n + 2h + e] (lane (g, t), n < 8,
//   h, e < 2): 32 accumulators a thread beside the contractions' and the
//   fold's (2 x 8 tiles a warp spilled in K2, and its builtin sincos then
//   ran 3x slower).  K1 takes tiles of 128 x 64 (WN 1), K2 of 64 x 128
//   (WN 2).
// - A ring of stages filled by every thread's cp.async, with a full and
//   an empty mbarrier a stage: a thread's copies arrive on the full
//   barrier when they land, each warp releases a stage after its
//   products, and a stage is refilled `ahead` steps after it was read
//   (half the ring).  A step is one 128-byte line of depth (16 values).
//   When A is the same for every tile of the walk (K1's passes: the
//   block's rows of x, or of proj^T) and at most RES_LINES lines deep
//   (D 96; RBF's 84), its lines stay resident and the ring carries B
//   alone: RES_STAGES stages of a line of B.  Otherwise a stage is a line
//   of A then a line of B, STAGES of them.  Deeper rings (up to 15
//   stages, the shared memory K1's slots leave) measured no faster.  The
//   copies of a tile's first lines land during the previous tile's
//   epilogue.
// - Rows past the operands' counts and depth past dp are zero-filled by
//   the copies; each sum runs over the depth in a fixed order (line by
//   line, the two halves of a line in order), so two calls give the same
//   bits.  A tile's accumulators are zeroed after its epilogue, never
//   beside its first products: float64 products issued right after their
//   accumulators were zeroed gave wrong rows g + 8 on the card
//   (conv_sync.cuh).
#pragma once

#include <stdint.h>

#include "dmma.cuh"
#include "gemm_common.cuh"
#include "mbarrier.cuh"

namespace xgpr {
namespace f64 {

constexpr int THREADS = 256;   // 8 warps
constexpr int LINE = 16;       // float64 values of depth a step
constexpr int RES_LINES = 6;   // the deepest resident A
constexpr int RES_STAGES = 8;  // B's ring with A resident
constexpr int MAX_STAGES = 8;

// WN warps across; STAGES stages of a line of A and one of B; RESIDENT:
// the walk keeps A's rows, which may then stay resident.
template <int WN_, int STAGES_, bool RESIDENT_>
struct Tiling {
  static constexpr int WN = WN_, WM = 8 / WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr bool RESIDENT = RESIDENT_;
  static constexpr int BM = 16 * WM;       // GEMM rows a tile
  static constexpr int BN = 64 * WN;       // GEMM columns a tile
  static constexpr int A_LINE = BM * 128;
  static constexpr int B_LINE = BN * 128;
  static constexpr int STAGE = A_LINE + B_LINE;
  static constexpr int RES_RING = RES_LINES * A_LINE + RES_STAGES * B_LINE;
  static constexpr int RING = RESIDENT && RES_RING > STAGES * STAGE
                                  ? RES_RING
                                  : STAGES * STAGE;
  static constexpr int ACC = 32;
  static_assert(STAGES <= MAX_STAGES, "the barriers hold MAX_STAGES");
};

// Dynamic shared memory of a kernel on tiling Tl with `extra` bytes after
// its ring, aligned to the swizzle's 1024-byte atom.
template <class Tl>
constexpr int smem_bytes(int extra) {
  return Tl::RING + extra + 1024;
}

// 8-byte cp.async (zero-filled unless valid), for the staged operands.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// The full (one arrival a thread) and empty (one a warp) barriers of N
// buffers, in static shared memory; init by thread 0 before a block
// barrier.
template <int N>
struct Barriers {
  uint64_t full[N], empty[N];
  __device__ __forceinline__ void init() {
    if (threadIdx.x == 0)
      for (int s = 0; s < N; ++s) {
        mbar_init(&full[s], THREADS);
        mbar_init(&empty[s], THREADS / 32);
      }
  }
};
using RingBarriers = Barriers<MAX_STAGES>;

// The loop over ntiles tiles of kc lines each: p.x_hi holds A (p.n rows of
// p.dp values), p.b_hi holds B (p.f rows); tile u's first rows are
// a_row(u) and b_row(u) (with Tl::RESIDENT, a_row is the same for every
// tile).  stage(u) runs at tile u's first step, before its copies are
// issued (the kernels stage the next tile's small operands there); done(u)
// runs in each warp once the warp's products of tile u are in acc.  All
// threads of the block call it; smem holds Tl::RING bytes.
template <class Tl, class ARow, class BRow, class Stage, class Done>
__device__ __forceinline__ void dense_loop(unsigned char* smem,
                                           RingBarriers& bar,
                                           const DenseOperands& p,
                                           int ntiles, int kc, double* acc,
                                           ARow&& a_row, BRow&& b_row,
                                           Stage&& stage, Done&& done) {
  const int tid = threadIdx.x, lc = tid % 8, warp = tid / 32;
  const int g = (tid % 32) / 4;
  const double* xa = static_cast<const double*>(p.x_hi);
  const double* xb = static_cast<const double*>(p.b_hi);
  const bool resident = Tl::RESIDENT && kc <= RES_LINES;
  // The ring: stages of B after A's resident lines, or of A and B.
  unsigned char* const ring = resident ? smem + RES_LINES * Tl::A_LINE : smem;
  const int stage_bytes = resident ? Tl::B_LINE : Tl::STAGE;
  const int b_at = resident ? 0 : Tl::A_LINE;
  const int nst = resident ? RES_STAGES : Tl::STAGES;
  const int ahead = nst / 2;
  const int nsteps = ntiles * kc;

  // The line of depth col0.. of A's rows ar.. into dst.
  auto copy_a = [&](int ar, int col0, unsigned char* dst) {
#pragma unroll
    for (int i = 0; i < Tl::BM / 32; ++i) {
      const int r = tid / 8 + 32 * i, col = col0 + 2 * lc;
      const bool ok = col < p.dp && ar + r < p.n;
      cp_async16(dst + sw128(r, lc),
                 ok ? xa + (size_t)(ar + r) * p.dp + col : xa, ok);
    }
  };
  int q = 0;  // the next fill: step q into stage q % nst
  auto issue = [&]() {
    const int s = q % nst, u = q / kc;
    if (q >= nst) mbar_wait(&bar.empty[s], ((q / nst) - 1) & 1);
    unsigned char* st = ring + s * stage_bytes;
    const int col0 = (q - u * kc) * LINE, col = col0 + 2 * lc;
    if (!resident) copy_a(a_row(u), col0, st);
    const int br = b_row(u);
#pragma unroll
    for (int i = 0; i < Tl::BN / 32; ++i) {
      const int r = tid / 8 + 32 * i;
      const bool ok = col < p.dp && br + r < p.f;
      cp_async16(st + b_at + sw128(r, lc),
                 ok ? xb + (size_t)(br + r) * p.dp + col : xb, ok);
    }
    arrive_on_copies(&bar.full[s]);
    ++q;
  };
  if (resident && nsteps > 0)  // A's lines join the first fill's copies
    for (int l = 0; l < kc; ++l)
      copy_a(a_row(0), l * LINE, smem + l * Tl::A_LINE);
  while (q < ahead && q < nsteps) issue();

  const int arow = 16 * (warp / Tl::WN) + g;
  const int brow = 64 * (warp % Tl::WN) + g;
  int st = 0, phase = 0, u = 0, l = 0;
  for (int step = 0; step < nsteps; ++step) {
    if (l == 0) stage(u);
    if (q < nsteps) issue();
    mbar_wait(&bar.full[st], phase);
    const unsigned char* line = ring + st * stage_bytes;
    const unsigned char* a = resident ? smem + l * Tl::A_LINE : line;
    __syncwarp();  // mma.sync.aligned: the waits may leave the warp split
    dmma_line<1, 8>(a, arow, line + b_at, brow, acc);
    release(&bar.empty[st]);
    if (++st == nst) {
      st = 0;
      phase ^= 1;
    }
    if (++l == kc) {
      done(u);
#pragma unroll
      for (int i = 0; i < Tl::ACC; ++i) acc[i] = 0.0;
      l = 0;
      ++u;
    }
  }
}

}  // namespace f64
}  // namespace xgpr
