// K2 in the fp32 CUDA-core format ("highest": fp32 FMAs, the "reference"
// preset's fp32-exact products), redesigned for Hopper.  What the kernel
// computes, and the TPU kernel it replaces (xgpr_tpu/ops/pallas/
// sorf_pallas.py: _feature_kernel in _rbf_feature_map_impl), is written
// in feature_map.cuh.
//
// What bounds it: the CUDA cores.  At RBF's chunk (8192 x 84 rows, F
// 4096) the projection is 2.8G fp32 FMAs (5.6 GFLOP, 0.084 ms at the
// H100's 67 TFLOP/s) and the fold 33.5M (cos, sin) pairs, each a
// polynomial of ~30 instructions ("hi") or the builtin sincosf
// ("exact"), beside the 268 MB write (0.081 ms at 3.35 TB/s).  At D 1024,
// F 2048 the projection is 17.2G FMAs, 0.51 ms.  The body it replaces ran
// the wgmma fragment as its thread tile (2 rows x 32 frequencies: 34
// shared loads per 256 FMAs) on a 3-stage cp.async ring with a block
// barrier every 32 channels and no product in flight during the fold:
// 11% of its bound at D 84, and at D 1024 slower than cuBLAS's SGEMM plus
// an elementwise sincos.
//
// Design (K3 and K4's fp32 body, conv_sync.cuh, takes the same register
// tile on its own layout):
// - A block computes a frequency tile of 128 columns of proj for its walk
//   of 128-row tiles (b, b + rsplit, ...; blockIdx.x = tile * rsplit + b).
//   Thread (warp q, lane (ty, tx) = (lane / 8, lane % 8)) owns rows
//   32 (q / 2) + 8 ty + [0, 8) and frequencies 64 (q % 2) + 4 tx +
//   [0, 4) and + 32 + [0, 4) of a tile: fma_gemm.cuh's 8 x 8 register
//   tile, acc[8i + j].
// - Operands channel-major in shared memory: a stage of KS channels holds
//   A as [channel][row] (128 rows of x^T, the wrapper's transpose) and B
//   as [channel][frequency] (proj's 128 frequencies), so that one
//   channel's 8 A and 8 B values are four 16-byte loads for 64 FMAs: A's
//   a broadcast within a quarter warp, B's 128 contiguous bytes a quarter
//   warp.
// - A ring of STAGES stages filled by every thread's cp.async, with a
//   full and an empty mbarrier a stage (mbarrier.cuh), no block barrier:
//   a thread's copies arrive on the full barrier when they land, each warp
//   releases a stage after its products, and a stage is refilled two steps
//   after it was read, so STAGES - 2 steps are in flight and the warps may
//   drift a step apart.  The stages flow from one tile to the next, so a
//   tile's first copies land during the fold of the one before.  Two
//   blocks an SM (128 registers a thread, 96 KB each): one block's fold
//   runs beside the other's products.
// - Each output is one fmaf chain over the channels in order from zero:
//   the parent's sum, whose chain ran over the same channels (its
//   zero-filled depth past D adds +0 to a sum that is never -0).  A
//   ragged last step runs its channels alone.
// - The fold evaluates sincos on the thread's tile (common.cuh:
//   with_sincos; "exact", whose builtin sincosf is large, a row a turn)
//   and stores each row's two runs of 4 frequencies of cos
//   and of sin as 16-byte stores where the run lies in one layout block
//   whose columns are 16-byte aligned (F even, blocks and the block's
//   width multiples of 4), else value by value (a ragged layout).  A
//   warp's store then covers 128 contiguous bytes of each of its rows,
//   whole 32-byte sectors: a thread's 8 adjacent frequencies (two
//   16-byte stores 32 bytes apart a warp, half-sectors each) ran K2's D 84
//   "hi" at 0.435 ms against 0.203 (PERF.md §6).
#include "feature_map.cuh"
#include "fma_gemm.cuh"
#include "mbarrier.cuh"

namespace xgpr {
namespace features {
namespace fma32 {

constexpr int THREADS = 256;
constexpr int TILE = 128;                   // rows and frequencies a tile
constexpr int KS = 16;                      // channels a stage
constexpr int STAGES = 6;
constexpr int A_BYTES = KS * TILE * 4;      // 8 KB
constexpr int STAGE = 2 * A_BYTES;          // A then B, 16 KB
constexpr int SMEM = STAGES * STAGE;        // 96 KB
constexpr int MIN_BLOCKS = 2;               // blocks an SM holds
constexpr int F_RUN = 32;  // a thread's second run of 4 frequencies

// A row of the thread's tile, by value (kept in registers).
struct Row8 {
  float v[8];
  __device__ __forceinline__ static Row8 of(const float acc[64], int r) {
    Row8 row;
#pragma unroll
    for (int j = 0; j < 8; ++j) row.v[j] = acc[8 * r + j];
    return row;
  }
};

template <int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    fma_feature_kernel(DenseOperands p, FeatureArgs<float> a, int rsplit) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int tid = threadIdx.x, q = tid / 32, lane = tid % 32;
  const int b = (int)(blockIdx.x % rsplit);
  const int f0 = (int)(blockIdx.x / rsplit) * TILE;
  const int tiles = (p.n + TILE - 1) / TILE;
  const int count = b < tiles ? (tiles - 1 - b) / rsplit + 1 : 0;
  const int d = p.dp, np = (p.n + 3) & ~3, fp = (p.f + 3) & ~3;
  const int kc = (d + KS - 1) / KS;
  const int nsteps = count * kc;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], THREADS);
      mbar_init(&empty[s], THREADS / 32);
    }
  }
  __syncthreads();

  // Fill j (stage j % STAGES) is step j: tile j / kc, channels KS (j % kc)
  // ...; thread (q, lane) copies channels q and q + 8 of it: 4 rows of x^T
  // (rows 4 lane ..) and 4 frequencies of proj (chunk lane).
  const float* xt = static_cast<const float*>(p.x_hi);  // (d, np)
  const float* pr = static_cast<const float*>(p.b_hi);  // (d, fp)
  const int a_dst = (q * TILE + 4 * lane) * 4;
  const int b_dst = A_BYTES + (q * TILE + 4 * lane) * 4;
  const bool f_ok = f0 + 4 * lane < fp;
  int fill = 0;
  auto issue = [&]() {
    const int st = fill % STAGES;
    if (fill >= STAGES) mbar_wait(&empty[st], ((fill / STAGES) - 1) & 1);
    const int i = fill / kc, kk = fill - i * kc;
    const int r = (b + i * rsplit) * TILE + 4 * lane;
    unsigned char* dst = smem + st * STAGE;
#pragma unroll
    for (int u = 0; u < KS / 8; ++u) {
      const int ch = kk * KS + q + 8 * u;
      const bool a_ok = ch < d && r < np, b_ok = ch < d && f_ok;
      cp_async16(dst + a_dst + u * 8 * TILE * 4,
                 a_ok ? xt + (size_t)ch * np + r : xt, a_ok);
      cp_async16(dst + b_dst + u * 8 * TILE * 4,
                 b_ok ? pr + (size_t)ch * fp + f0 + 4 * lane : pr, b_ok);
    }
    arrive_on_copies(&full[st]);
    ++fill;
  };

  const int ty = lane / 8, tx = lane % 8;
  const int rb = 32 * (q / 2) + 8 * ty;             // the thread's rows
  const int b_at = 64 * (q % 2) + 4 * tx;           // and frequencies
  const int fb = f0 + b_at;
  const size_t ld = 2 * (size_t)p.f;
  // With blocks a multiple of the tile wide, the tile is in one block.
  const int tile_blk = a.padded % TILE == 0 ? f0 / a.padded : -1;
  const bool wide = p.f % 2 == 0 && a.padded % 4 == 0;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  while (fill < STAGES - 2 && fill < nsteps) issue();
  int st = 0;
  uint32_t phase = 0;
  for (int i = 0; i < count; ++i) {
    for (int kk = 0; kk < kc; ++kk) {
      if (fill < nsteps) issue();
      mbar_wait(&full[st], phase);
      const float* as = reinterpret_cast<const float*>(smem + st * STAGE);
      const float* bs = as + KS * TILE;
      const int kn = min(KS, d - kk * KS);
      if (kn == KS)
        fma_step<KS>(as + rb, TILE, 4, bs + b_at, TILE, F_RUN, acc);
      else
        fma_step_n(as + rb, TILE, 4, bs + b_at, TILE, F_RUN, kn, acc);
      release(&empty[st]);
      if (++st == STAGES) {
        st = 0;
        phase ^= 1;
      }
    }
    // Row tile i is complete: its features go out, row r's 8 values in v.
    const int row0 = (b + i * rsplit) * TILE + rb;
    auto row_out = [&](int r, const Row8 v, auto sincos) {
      if (row0 + r >= p.n) return;
      float* o = a.out + (size_t)(row0 + r) * ld;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int f = fb + F_RUN * hh;
        float cv[4], sv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sincos(v.v[4 * hh + j], a.scale, &cv[j], &sv[j]);
        const int blk = tile_blk >= 0 ? tile_blk : f / a.padded;
        const int width = min(a.padded, p.f - blk * a.padded);
        if (wide && f + 3 < p.f && width % 4 == 0) {
          const int col = f + blk * a.padded;
          *reinterpret_cast<float4*>(o + col) =
              make_float4(cv[0], cv[1], cv[2], cv[3]);
          *reinterpret_cast<float4*>(o + col + width) =
              make_float4(sv[0], sv[1], sv[2], sv[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (f + j < p.f) store_feature(a, o, p.f, f + j, cv[j], sv[j]);
        }
      }
    };
    if constexpr (MODE == MODE_EXACT) {
      // One row a turn, the tile's rows shifted down after it, so that
      // the builtin sincosf (with its slow path) is inlined 8 times, not
      // 64: D 84 ran 0.33 ms with 64 (PERF.md §6).
#pragma unroll 1
      for (int r = 0; r < 8; ++r) {
        row_out(r, Row8::of(acc, 0), [](float x, float w, float* c, float* s) {
          sincos_scaled<MODE_EXACT>(x, w, c, s);
        });
#pragma unroll
        for (int j = 0; j < 56; ++j) acc[j] = acc[j + 8];
      }
    } else {
      with_sincos<MODE>(acc, 1.0f, [&](auto sincos) {
#pragma unroll
        for (int r = 0; r < 8; ++r) row_out(r, Row8::of(acc, r), sincos);
      });
    }
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
  }
}

template <int MODE>
int launch(const DenseOperands& p, const FeatureArgs<float>& a, int rsplit,
           cudaStream_t stream) {
  auto kernel = fma_feature_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)rsplit * ((p.f + TILE - 1) / TILE);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, SMEM, stream>>>(p, a, rsplit);
  return (int)cudaGetLastError();
}

}  // namespace fma32

// x_hi is x^T (dp, np) and b_hi proj (dp, fp), fp32, np and fp n and f
// rounded up to multiples of 4 (ops/cuda/feature_map.py); rsplit blocks
// share each frequency tile's row tiles.
int launch_fma32(const DenseOperands& p, const FeatureArgs<float>& a,
                 int mode, int rsplit, cudaStream_t stream) {
  if (rsplit < 1 || p.n < 1 || p.f < 1 || p.dp < 1)
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case MODE_HI: return fma32::launch<MODE_HI>(p, a, rsplit, stream);
    case MODE_EXACT: return fma32::launch<MODE_EXACT>(p, a, rsplit, stream);
    case MODE_FAST: return fma32::launch<MODE_FAST>(p, a, rsplit, stream);
    default: return fma32::launch<MODE_POLY>(p, a, rsplit, stream);
  }
}

}  // namespace features
}  // namespace xgpr
