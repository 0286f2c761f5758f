// K3 and K4's synchronous bodies, redesigned for Hopper: fp32 FMAs on the
// CUDA cores ("highest", the "reference" preset's fp32-exact products) and
// float64 mma.sync (DMMA) on the tensor cores (float64 operands).  What
// the kernels compute, and the TPU kernels they replace
// (xgpr_tpu/ops/pallas/conv_pallas.py: _conv_parts_kernel in
// _conv_parts_impl, _conv_maxpool_kernel in _conv_maxpool_impl), is
// written in conv.cuh: masked window projections g = x[i, j:j+w, :] @ proj
// over j < nk_i, then K3 scale_i * sum cos/sin(g * sigma) and K4
// max(0, max_j g).  The epilogues are conv.cuh's (PartsEpilogue,
// MaxpoolEpilogue), here at H rows by J frequency pairs a thread.
//
// What bounds them.  At the motif chunk (8192 rows, L 16, D 64, w 9, F
// 4096) the valid windows need 173 GFLOP: 2.58 ms at 67 TFLOP/s in both
// formats (fp32 FMAs on the CUDA cores, FP64 on the tensor cores), ~2.9
// ms for the window slots the row order projects (1.12 a valid window,
// conv.cuh), against 0.09 ms of device-memory traffic.  conv.cuh's ring
// ran them at 31% (fp32) and 25% (float64) of that bound (PERF.md §6):
// the wgmma fragment as thread tile (2 rows x 32 frequencies a thread:
// 34 shared loads per 256 FMAs), one block of 8 warps per SM behind a
// block barrier every 128-byte line of depth, and the fold with no
// product in flight.
//
// Design:
// - One block: 64 sequences (rows order[row0 : row0 + 64], the wrapper's
//   order by window count, as conv.cuh) by a tile of frequencies, two
//   windows at a time (a window group), in depth steps of (tap t, a chunk
//   of channels).  A thread owns every window of its sequences, so K3 and
//   K4 fold a finished group into register sums and write each output
//   once, with no atomics.
// - A ring of STAGES stages filled by every thread's cp.async, with a
//   full and an empty mbarrier a stage instead of a block barrier: a
//   thread's copies arrive on the stage's full barrier when they land
//   (cp.async.mbarrier.arrive.noinc), each warp releases a stage after
//   its products, and a stage is refilled two steps after it was read, so
//   the warps can drift a step apart (the fold's end of a group, shared
//   loads) without waiting for the slowest.  STAGES - 2 steps are in
//   flight ahead of the products (6 stages of 32 KB in fp32, 4 of 48 KB
//   in float64; refilling a stage one step after its read, S - 1 ahead,
//   measured slower on the card).
// - fp32 FMAs (FmaTile): the classic register tile of a CUDA-core GEMM, 8
//   GEMM rows (4 sequences x both windows) by 8 frequencies a thread,
//   operands K-major in shared memory: a depth step of 32 channels holds
//   A as [channel][window][sequence] and B as [channel][frequency], so a
//   thread reads its 8 rows and 8 frequencies of one channel in four
//   16-byte loads (A broadcast within a quarter warp, B 128 contiguous
//   bytes) for 64 FMAs.  The wrapper writes x with the rows in tile order
//   and last (position, channel, row), one gather, and reads proj
//   (w*D, F) as it is.
//   Each output's depth is one fmaf chain in conv.cuh's order (tap-major,
//   channel within tap, from an overwritten zero) and the fold is
//   conv.cuh's, so the outputs keep that body's bits.
// - float64 (DmmaTile): mma.sync.m16n8k8.f64, 2 x 4 tiles of 16 x 8 a
//   warp (32 GEMM rows: 16 sequences x both windows, rows g and g + 8 of a
//   tile the two windows of sequence g; 32 frequencies), so a thread's
//   accumulators and sums stay within the register file beside the fold's
//   (conv.cuh's layout of x and projT: channel-contiguous 128-byte lines
//   in the 128-byte swizzle).  Lane (g, t) reads 16 bytes, two channels,
//   of its rows a load and feeds them as the k = t and k = t + 4 of a
//   product, so one 16-byte load serves two depths; 8 loads a thread per
//   8 products (the fragment code is dmma.cuh's, shared with K1 and K2's
//   float64 bodies).  A step is two lines (32 channels): one line a step,
//   8 stages, ran 8% slower.  m16n8k8 reaches 64 TFLOP/s from shared
//   memory on the card, m8n8k4 33 (tests/torch_port/dmma_rate.cu).
// - Any shape: windows past nw, channels past D and frequencies past F are
//   zero-filled by the copies and masked at the store; sequences past N
//   are zero-filled (float64) or repeat a row (fp32), and never stored.
#pragma once

#include <stdint.h>

#include "conv.cuh"
#include "dmma.cuh"
#include "fma_gemm.cuh"
#include "mbarrier.cuh"

namespace xgpr {
namespace conv {
namespace sync {

constexpr int THREADS = 256;  // 8 warps
constexpr int SEQ = 64;       // sequences per tile
constexpr int PAIR = 2;       // windows per group

// x: fp32, (l, d, np), the rows in tile order and last (np = n rounded up
// to whole tiles; the rows past n are not read back); float64, (n, l, d)
// with d even.  proj:
// fp32, (width * d, fp), F contiguous, fp a multiple of 4 >= f; float64,
// projT (f, width * d), K-major.
struct Args {
  const void* x;
  const int* order;  // (n,) input row of each tile-order row
  const int* nk;     // (n,) valid windows of each input row
  const void* proj;
  int n, l, d, width, f, fp;
};

// The step a ring fill holds: window group j0 (its first window), tap and
// channel chunk kk; next() walks them in the products' order (kk, then
// tap, then the group).
struct Cursor {
  int j0 = 0, tap = 0, kk = 0;
  __device__ __forceinline__ void next(int kc, int width) {
    if (++kk == kc) {
      kk = 0;
      if (++tap == width) {
        tap = 0;
        j0 += PAIR;
      }
    }
  }
};

// The fp32 body.  Warp q owns sequences 16 (q / 2) + 4 ty + [0, 4) and
// frequencies 64 (q % 2) + 4 tx + [0, 4) and + 32 + [0, 4), lane (ty, tx)
// = (lane / 8, lane % 8); acc[8r + c] is GEMM row r = 4 * window + i
// (sequence i of the thread) and frequency c (c < 4: 4 tx + c, else
// 32 + 4 tx + c - 4 of the warp's half).  Copies: thread (warp w, lane)
// brings channel w + 8i (i < 4) of the step's chunk: of A, 16 bytes of
// window (lane / 16)'s sequences 4 (lane % 16) + [0, 4); of B, 16 bytes
// of frequencies 4 lane + [0, 4).
struct FmaTile {
  using T = float;
  static constexpr int BN = 128;   // frequencies per block
  static constexpr int KS = 32;    // channels per step
  static constexpr int STAGES = 6;
  static constexpr int A_BYTES = KS * PAIR * SEQ * 4;  // 16 KB
  static constexpr int STAGE = A_BYTES + KS * BN * 4;  // + 16 KB
  static constexpr int ACC = 64;
  static constexpr int H = 4, J = 4;  // epilogue rows, frequency pairs

  int sb, fb;        // this thread's first sequence and frequency
  int ch, win;       // its copies' first channel and window
  size_t a_src, b_src;  // their offsets, less the step's
  int a_dst, b_dst;
  bool b_ok;

  __device__ __forceinline__ void setup(const Args& p, const int*, int row0,
                                        int f0) {
    const int q = threadIdx.x / 32, lane = threadIdx.x % 32;
    sb = 16 * (q / 2) + 4 * (lane / 8);
    fb = 64 * (q % 2) + 4 * (lane % 8);
    ch = q;
    win = lane / 16;
    a_src = ((size_t)win * p.d + ch) * rows(p) + row0 +
            4 * (lane % 16);
    a_dst = (ch * PAIR * SEQ + win * SEQ + 4 * (lane % 16)) * 4;
    b_src = (size_t)ch * p.fp + f0 + 4 * lane;
    b_dst = A_BYTES + (ch * BN + 4 * lane) * 4;
    b_ok = f0 + 4 * lane < p.fp;
  }

  // x's row count as laid out: whole tiles.
  __device__ __forceinline__ static size_t rows(const Args& p) {
    return (size_t)(p.n + SEQ - 1) / SEQ * SEQ;
  }

  // Step c into stage st: A [channel][window][sequence] from the
  // transposed rows, B [channel][frequency] from proj.
  __device__ __forceinline__ void load(const Args& p, const Cursor& c,
                                       unsigned char* st) const {
    const float* x = static_cast<const float*>(p.x) + a_src +
                     ((size_t)(c.j0 + c.tap) * p.d + c.kk * KS) * rows(p);
    const float* pr = static_cast<const float*>(p.proj) + b_src +
                      (size_t)(c.tap * p.d + c.kk * KS) * p.fp;
    const bool pos_ok = c.j0 + c.tap + win < p.l;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool cok = c.kk * KS + ch + 8 * i < p.d;
      cp_async16(st + a_dst + i * 8 * PAIR * SEQ * 4,
                 cok && pos_ok ? x + i * 8 * rows(p) : p.x, cok && pos_ok);
      cp_async16(st + b_dst + i * 8 * BN * 4,
                 cok && b_ok ? pr + (size_t)i * 8 * p.fp : p.proj,
                 cok && b_ok);
    }
  }

  // The step's products: KS channels, one fmaf chain per accumulator
  // (from the zero the kernel sets at each group's start), fma_gemm.cuh's
  // 8 x 8 register tile: A's rows at sb and SEQ + sb of a channel's
  // [window][sequence] row, B's frequencies at fb and fb + 32.
  __device__ __forceinline__ void products(const unsigned char* st,
                                           float acc[ACC]) const {
    const float* as = reinterpret_cast<const float*>(st);
    const float* bs = reinterpret_cast<const float*>(st + A_BYTES);
    fma_step<KS>(as + sb, PAIR * SEQ, SEQ, bs + fb, BN, 32, acc);
  }

  // Sequence i of the thread in its tile, and its frequency pair j
  // (values 2j, 2j + 1 of its 8) in its block.
  __device__ __forceinline__ int seq(int i) const { return sb + i; }
  __device__ __forceinline__ int col(int j) const {
    return fb + (j < 2 ? 2 * j : 32 + 2 * (j - 2));
  }

  // The group's valid windows into the epilogue, window by window.
  template <class Epi>
  __device__ __forceinline__ void fold(Epi& epi, const float acc[ACC],
                                       const int* nk, int j0) const {
#pragma unroll
    for (int h = 0; h < PAIR; ++h)
#pragma unroll
      for (int i = 0; i < H; ++i)
        if (j0 + h < nk[i]) {
#pragma unroll
          for (int c = 0; c < 8; ++c)
            epi.fold(i, c / 2, c % 2, acc[8 * (4 * h + i) + c]);
        }
  }
};

// The float64 body.  Warp q owns sequences 16 (q / 2) + 8m + g (m < 2)
// and frequencies 32 (q % 2) + 8n + 2t + e (n < 4, e < 2), lane (g, t) =
// (lane / 4, lane % 4): acc[4 (4m + n) + 2h + e] is window h of sequence
// 8m + g and frequency 8n + 2t + e of the warp's (a DMMA tile's c).  A
// stage is LINES 128-byte lines (16 channels each) of A's 128 rows, row
// (s / 8) * 16 + window * 8 + s % 8 for sequence s (conv.cuh's order),
// then of B's 64 frequency rows.  Copies: thread tid brings 16-byte chunk
// tid % 8 of A rows tid / 8 + 32i (i < 4) and of B rows tid / 8 + 32i
// (i < 2), each line.
struct DmmaTile {
  using T = double;
  static constexpr int BN = 64;
  static constexpr int LINES = 2;
  static constexpr int KS = 16 * LINES;
  static constexpr int STAGES = 4;
  static constexpr int A_LINE = PAIR * SEQ * 128;      // 16 KB
  static constexpr int LINE = A_LINE + BN * 128;       // + 8 KB
  static constexpr int STAGE = LINES * LINE;
  static constexpr int ACC = 32;
  static constexpr int H = 2, J = 4;

  int arow, brow, sb, fb, win, lc;
  size_t xoff[4], boff[2];
  bool xok[4], bok[2];

  __device__ __forceinline__ void setup(const Args& p, const int* s_row,
                                        int row0, int f0) {
    const int q = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    arow = 32 * (q / 2) + g;    // + 16m + 8h
    brow = 32 * (q % 2) + g;    // + 8n
    sb = 16 * (q / 2) + g;      // + 8m
    fb = 32 * (q % 2) + 2 * t;  // + 8n + e
    lc = threadIdx.x % 8;
    win = (threadIdx.x / 64) % 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = threadIdx.x / 8 + 32 * i;
      const int s = (r / 16) * 8 + r % 8;
      xok[i] = row0 + s < p.n;
      xoff[i] = (size_t)s_row[s] * p.l * p.d + 2 * lc;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = threadIdx.x / 8 + 32 * i;
      bok[i] = f0 + r < p.f;
      boff[i] = (size_t)(f0 + r) * p.width * p.d + 2 * lc;
    }
  }

  __device__ __forceinline__ void load(const Args& p, const Cursor& c,
                                       unsigned char* st) const {
    const double* x = static_cast<const double*>(p.x);
    const double* pr = static_cast<const double*>(p.proj);
    const int pos = c.j0 + win + c.tap;
    const size_t xat = (size_t)pos * p.d + c.kk * KS;
    const size_t bat = (size_t)c.tap * p.d + c.kk * KS;
#pragma unroll
    for (int line = 0; line < LINES; ++line) {
      const bool cok = c.kk * KS + 16 * line + 2 * lc < p.d;
      unsigned char* dst = st + line * LINE;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = xok[i] && cok && pos < p.l;
        cp_async16(dst + sw128(threadIdx.x / 8 + 32 * i, lc),
                   ok ? x + xoff[i] + xat + 16 * line : x, ok);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool ok = bok[i] && cok;
        cp_async16(dst + A_LINE + sw128(threadIdx.x / 8 + 32 * i, lc),
                   ok ? pr + boff[i] + bat + 16 * line : pr, ok);
      }
    }
  }

  // The stage's products, line by line (dmma.cuh: dmma_line).
  __device__ __forceinline__ void products(const unsigned char* st,
                                           double acc[ACC]) const {
    // mma.sync.aligned needs the warp converged: the fold's masks and the
    // barrier waits may leave it split.
    __syncwarp();
#pragma unroll
    for (int line = 0; line < LINES; ++line)
      dmma_line<2, 4>(st + line * LINE, arow, st + line * LINE + A_LINE,
                      brow, acc);
  }

  __device__ __forceinline__ int seq(int m) const { return sb + 8 * m; }
  __device__ __forceinline__ int col(int n) const { return fb + 8 * n; }

  template <class Epi>
  __device__ __forceinline__ void fold(Epi& epi, const double acc[ACC],
                                       const int* nk, int j0) const {
#pragma unroll
    for (int h = 0; h < PAIR; ++h)
#pragma unroll
      for (int m = 0; m < H; ++m)
        if (j0 + h < nk[m]) {
#pragma unroll
          for (int n = 0; n < J; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              epi.fold(m, n, e, acc[4 * (4 * m + n) + 2 * h + e]);
        }
  }
};

// The block: row tile blockIdx.x % tiles of the row order (64
// sequences), frequency tile blockIdx.x / tiles (a 1-D grid: any number
// of frequency tiles); window groups up to the tile's largest count, each
// width * ceil(d / KS) steps; see the top of the file.
template <class Tile, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    conv_sync_kernel(Args p, typename Epi::Args ea) {
  using T = typename Tile::T;
  constexpr int S = Tile::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ int s_row[SEQ], s_nk[SEQ], s_nkmax;
  unsigned char* smem = ring_base(smem_raw);

  const int tid = threadIdx.x;
  const int tiles = (p.n + SEQ - 1) / SEQ;
  const int row0 = (int)(blockIdx.x % tiles) * SEQ;
  const int f0 = (int)(blockIdx.x / tiles) * Tile::BN;
  if (tid == 0) {
    s_nkmax = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], THREADS);
      mbar_init(&empty[s], THREADS / 32);
    }
  }
  if (tid < SEQ) {
    const int r = row0 + tid;
    const int orig = r < p.n ? p.order[r] : 0;
    s_row[tid] = orig;
    s_nk[tid] = r < p.n ? p.nk[orig] : 0;
  }
  __syncthreads();
  if (tid < SEQ) atomicMax(&s_nkmax, s_nk[tid]);
  __syncthreads();

  Tile tile;
  tile.setup(p, s_row, row0, f0);
  int nk[Tile::H];
#pragma unroll
  for (int i = 0; i < Tile::H; ++i) nk[i] = s_nk[tile.seq(i)];

  const int kc = (p.d + Tile::KS - 1) / Tile::KS;
  const int spg = p.width * kc;  // steps per window group
  const int nsteps = (s_nkmax + PAIR - 1) / PAIR * spg;

  // Fill q of the ring (stage q % S) is step q; its stage is refilled two
  // steps after it was read, once every warp has released it.
  Cursor next;
  int q = 0;
  auto issue = [&]() {
    const int st = q % S;
    if (q >= S) mbar_wait(&empty[st], ((q / S) - 1) & 1);
    tile.load(p, next, smem + st * Tile::STAGE);
    arrive_on_copies(&full[st]);
    next.next(kc, p.width);
    ++q;
  };

  Epi epi(ea);
  T acc[Tile::ACC];
#pragma unroll
  for (int i = 0; i < Tile::ACC; ++i) acc[i] = T(0);

  while (q < S - 2 && q < nsteps) issue();
  int st = 0, phase = 0, in_group = 0, j0 = 0;
  for (int step = 0; step < nsteps; ++step) {
    if (q < nsteps) issue();
    mbar_wait(&full[st], phase);
    tile.products(smem + st * Tile::STAGE, acc);
    release(&empty[st]);
    if (++st == S) {
      st = 0;
      phase ^= 1;
    }
    if (++in_group == spg) {
      tile.fold(epi, acc, nk, j0);
      // The next group's sums start from zero, set here and not beside
      // its first products: float64 products issued right after their
      // accumulators were zeroed gave wrong rows g + 8 on the card.
#pragma unroll
      for (int i = 0; i < Tile::ACC; ++i) acc[i] = T(0);
      in_group = 0;
      j0 += PAIR;
    }
  }

#pragma unroll
  for (int i = 0; i < Tile::H; ++i) {
    const int s = tile.seq(i);
    if (row0 + s >= p.n) continue;
    const int orig = s_row[s];
    const T w = epi.row_factor(orig);
#pragma unroll
    for (int j = 0; j < Tile::J; ++j) {
      const int col = f0 + tile.col(j);
      const size_t at = (size_t)orig * p.f + col;
      if (p.f % 2 == 0) {
        if (col < p.f) epi.store_pair(at, w, i, j);
      } else {
        if (col < p.f) epi.store(at, w, i, j, 0);
        if (col + 1 < p.f) epi.store(at + 1, w, i, j, 1);
      }
    }
  }
}

template <class Tile, class Epi>
int launch(const Args& p, const typename Epi::Args& ea, void* stream) {
  auto kernel = conv_sync_kernel<Tile, Epi>;
  constexpr int smem = Tile::STAGES * Tile::STAGE + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((p.n + SEQ - 1) / SEQ) *
                           ((p.f + Tile::BN - 1) / Tile::BN);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(p, ea);
  return (int)cudaGetLastError();
}

// K3 in sincos mode `mode` (an unknown mode is refused; float64 has the
// builtin's one instantiation) and K4, in the body of T: fp32 FMAs
// (conv_fma.cu) or float64 DMMA (conv_f64.cu).
template <class Tile, class T = typename Tile::T>
int launch_parts(const Args& p, const T* row_scale, T* c_out, T* s_out,
                 T sigma, int mode, void* stream) {
  if (mode < MODE_HI || mode > MODE_POLY) return (int)cudaErrorInvalidValue;
  constexpr int H = Tile::H, J = Tile::J;
  if constexpr (std::is_same<T, double>::value) {
    return launch<Tile, PartsEpilogue<T, MODE_EXACT, H, J>>(
        p, {row_scale, c_out, s_out, sigma}, stream);
  } else {
    switch (mode) {
      case MODE_HI:
        return launch<Tile, PartsEpilogue<T, MODE_HI, H, J>>(
            p, {row_scale, c_out, s_out, sigma}, stream);
      case MODE_EXACT:
        return launch<Tile, PartsEpilogue<T, MODE_EXACT, H, J>>(
            p, {row_scale, c_out, s_out, sigma}, stream);
      case MODE_FAST:
        return launch<Tile, PartsEpilogue<T, MODE_FAST, H, J>>(
            p, {row_scale, c_out, s_out, sigma}, stream);
      default:
        return launch<Tile, PartsEpilogue<T, MODE_POLY, H, J>>(
            p, {row_scale, c_out, s_out, sigma}, stream);
    }
  }
}

template <class Tile, class T = typename Tile::T>
int launch_maxpool(const Args& p, T* out, void* stream) {
  return launch<Tile, MaxpoolEpilogue<T, Tile::H, Tile::J>>(p, {out},
                                                            stream);
}

// The float64 launches, in conv_f64.cu; conv_fma.cu holds the fp32 ones
// and the C entry points of both.
int launch_parts_f64(const Args& p, const double* row_scale, double* c_out,
                     double* s_out, double sigma, int mode, void* stream);
int launch_maxpool_f64(const Args& p, double* out, void* stream);

}  // namespace sync
}  // namespace conv
}  // namespace xgpr
