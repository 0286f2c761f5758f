"""Split and time K1 and K2's dense bodies on the card: 3xTF32 (K1, K2),
bf16 (K1, ``--body bf16``) and fp32 FMAs (K2, ``--body fma32``).

Each variant is a copy of a tree's package and chip_smoke.py under
build/variants/<name> whose sources take one named set of patches
(below).  A copy builds only a small entry file this script writes (the
body's branches of ``xgpr_ztzv``, ``xgpr_ztzv_rhs_per_block`` and
``xgpr_feature_map``, over the tree's headers; for bf16 and fp32 FMAs in
this tree also the body's own translation unit), so a build takes
seconds to a minute, not the minutes of the whole library.  All builds
run side by side (``-Xptxas -v``: every variant prints the registers,
spills and stack of its kernels); then each variant times, in a process
of its own, the launch alone (the C entry point on operands prepared as
the wrappers prepare them; CUDA events, 2 x 20 calls after a warm-up) at
chip_smoke.py's shapes and prints one line:

    VARIANT <name> K1 K=1 hi <ms>/<ms> | K1 K=1 exact ... | K1 K=26 ... |
        K1 F16384 K=1 ... | K1 F16384 K=5 ... | K2 D84 ... | K2 D1024 ...

3xTF32: K1 runs slice A's chunk (8192 x 84 rows, F 4096) at K 1 in "hi"
and in "exact" (the 3xTF32 body of "highest") and at K 26, and E2(b)'s
width (F 16384) at K 1 and 5; K2 slice A's rows (padded 128),
Conv1dTwoLayer's second layer (8192 x 1024 rows, F 2048, padded 1024),
and slice A's rows at the tuning width (F 1024), the auxiliary tools'
(F 2048, no intercept) and E2(b)'s (F 16384).  bf16: K1 at K 1 and 26,
"fast" (the "max" preset's) and "hi".  fp32 FMAs: K2 at D 84 "exact"
(the "reference" preset's) and "hi", and at D 1024 "exact".  The base
variants also print each output's error against the plain version and a
SHA-256 of its bits.

From the root of a checkout on the card:

    python tests/torch_port/dense_tf32_variants.py [--body B] [name ...]
    python tests/torch_port/dense_tf32_variants.py [--body B] --parent DIR [name ...]
    python tests/torch_port/dense_tf32_variants.py [--body B] --time <label>
    python tests/torch_port/dense_tf32_variants.py --stress

``--parent DIR`` splits an older tree: for 3xTF32 a tree from before
dense_tf32.cuh (both bodies on tf32_gemm.cuh's 3-stage cp.async ring,
e.g. ``git archive c2803c7 | tar -x -C build/parent``;
PARENT_VARIANTS), for bf16 and fp32 FMAs the ring those two bodies kept
until 5cf5d0c (RING_PARENT_VARIANTS): as it is, with the fold (the
sincos), the projections, K1's contractions, K2's stores or the copies
compiled out, and a clock64 timeline (thread 0 of every block: the share
of its cycles in the copy wait and barrier, the copies' issue, the
epilogue and the products).  Without it this tree's bodies
(csrc/dense_wgmma.cuh, csrc/feature_map_fma.cu; VARIANTS) are timed as
they are (``base``), with the fold compiled out (``nofold``) or with one
of the named changes of VARIANTS.  ``--time <label>`` times the package
of the working directory (the launch alone and the whole wrapper, 2 x 20
calls each, the host's time to issue a wrapper call, and each output's
error and SHA-256), so that two trees are compared in turns in one call:
``(cd build/parent && python ../../tests/torch_port/dense_tf32_variants.py
--time parent)``, then the root, the root again and the parent.
``--stress`` calls K1 300 times in each float32 body, mode and K and
checks the bits stay the first call's.
"""
import hashlib
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import conv_sync_variants as csv_  # noqa: E402
import conv_ws_variants as wsv  # noqa: E402
import dense_f64_variants as dfv  # noqa: E402

ROOT = Path.cwd()
CSRC = "xgpr_tpu_torch/ops/cuda/csrc/"
COMMON = CSRC + "common.cuh"
GEMM = CSRC + "tf32_gemm.cuh"
ZTZV = CSRC + "ztzv.cuh"
FEAT = CSRC + "feature_map.cuh"
DENSE = CSRC + "dense_tf32.cuh"
WGMMA = CSRC + "dense_wgmma.cuh"
REUSE = CSRC + "ztzv_reuse.cuh"
ENTRY_TU = CSRC + "tf32_entry.cu"
SOURCES = ["tf32_entry.cu"]

# The 3xTF32 branches of the parent's C entry points (ztzv.cu,
# feature_map.cu), in a file of their own.
PARENT_ENTRY = """#include "ztzv.cuh"
#include "feature_map.cuh"

using namespace xgpr;

extern "C" int xgpr_ztzv(const void* x_hi, const void* x_lo, const void* m,
                         const void* proj_hi, const void* proj_lo,
                         double sigma, const void* vc, const void* vs,
                         void* zv_part, void* oc_part, void* os_part,
                         void* oc, void* os, int n, int dp, int f, int k,
                         int zsplit, int osplit, double scale, int intercept,
                         int mode, int body, void* stream) {
  if (body != FMT_TF32X3) return (int)cudaErrorInvalidValue;
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  const ztzv::ZtzvArgs<float> a{static_cast<const float*>(m),
                                static_cast<const float*>(vc),
                                static_cast<const float*>(vs), (float)sigma,
                                (float)scale, k, intercept};
  return ztzv::launch<FMT_TF32X3>(
      p, a, static_cast<float*>(zv_part), static_cast<float*>(oc_part),
      static_cast<float*>(os_part), static_cast<float*>(oc),
      static_cast<float*>(os), zsplit, osplit, mode, (cudaStream_t)stream);
}

extern "C" int xgpr_ztzv_rhs_per_block(int body, int k, int pass) {
  (void)pass;
  return k == 1 ? 1 : 8 * ztzv::mma_nt(body, k);
}

extern "C" int xgpr_feature_map(const void* x_hi, const void* x_lo,
                                const void* proj_hi, const void* proj_lo,
                                void* out, int n, int dp, int f, int padded,
                                double scale, int mode, int body, int rsplit,
                                void* stream) {
  if (body != FMT_TF32X3) return (int)cudaErrorInvalidValue;
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  const features::FeatureArgs<float> a{static_cast<float*>(out), padded,
                                       (float)scale};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case MODE_HI: return features::launch<FMT_TF32X3, MODE_HI>(p, a, rsplit, st);
    case MODE_EXACT:
      return features::launch<FMT_TF32X3, MODE_EXACT>(p, a, rsplit, st);
    case MODE_FAST:
      return features::launch<FMT_TF32X3, MODE_FAST>(p, a, rsplit, st);
    default: return features::launch<FMT_TF32X3, MODE_POLY>(p, a, rsplit, st);
  }
}
"""

# --- the parent's bodies (tf32_gemm.cuh's gemm_loop and dense_pipeline;
# K1's passes in ztzv.cuh, K2's kernel in feature_map.cuh) ----------------
_WITH_SINCOS = """  if constexpr (MODE == MODE_EXACT) {
    body(scaled);
  } else {"""
# The sincos replaced by two operations a value that keep it live.
_NO_SINCOS = """  if constexpr (true) {
    (void)scaled;
    (void)acc;
    (void)sigma;
    body([](float x, float w, float* c, float* s) {
      *c = x * w;
      *s = x + w;
    });
  } else {"""
_PARENT_PRODUCTS = """#pragma unroll
      for (int kk = 0; kk < GK / 8; ++kk) {
        wgmma_tf32(acc, al + 2 * kk, bh + 2 * kk, kk > 0 || !overwrite);
        wgmma_tf32(acc, ah + 2 * kk, bl + 2 * kk, 1);
        wgmma_tf32(acc, ah + 2 * kk, bh + 2 * kk, 1);
      }
"""
_K1_ZV_ONE = """              part[h][q] = fma_t(c, vct[fl * KC + q],
                                 fma_t(s, vst[fl * KC + q], part[h][q]));
"""
_K1_OUT_ONE = """                oc[2 * j + e] = fma_t(c, zr, oc[2 * j + e]);
                os[2 * j + e] = fma_t(s, zr, os[2 * j + e]);
"""
_MMA_ADD = """    float p[4];
    mma_tf32_fresh(p, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
    for (int r = 0; r < 4; ++r) d.main[r] += p[r];
    mma_tf32(d.corr, a.lo, b.hi[0], b.hi[1]);
    mma_tf32(d.corr, a.hi, b.lo[0], b.lo[1]);
"""
# One fp32 add a value in place of the three products.
_NO_MMA_ADD = """#pragma unroll
    for (int r = 0; r < 4; ++r)
      d.main[r] += __uint_as_float(a.hi[r]) + __uint_as_float(b.lo[r % 2]);
"""
_K2_ROWS = """              *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * ld +
                                         off) = v;
"""
_COPY = """    cp_async16(dst + d, static_cast<const char*>(hi) + off, ok);
    if constexpr (B::PLANES == 2)
      cp_async16(dst + A_BYTES + d, static_cast<const char*>(lo) + off, ok);
"""
_RING_BASE = """__device__ __forceinline__ unsigned char* ring_base(unsigned char* raw) {
  return raw +
         ((1024 - ((unsigned)__cvta_generic_to_shared(raw) & 1023)) & 1023);
}
"""
_ZEROED_RING_BASE = """__device__ __forceinline__ unsigned char* ring_base(unsigned char* raw) {
  unsigned char* p =
      raw + ((1024 - ((unsigned)__cvta_generic_to_shared(raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < STAGES * STAGE_BYTES / 16; i += blockDim.x)
    reinterpret_cast<int4*>(p)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  return p;
}
"""
_CP4 = """  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
"""
_K1_ONE_STAGE = """        vcs[i % 3][e] = ok ? as_operand<FMT>(a.vc[at]) : T(0);
        vss[i % 3][e] = ok ? as_operand<FMT>(a.vs[at]) : T(0);
"""
_K1_OUT_STAGE = """            for (int s = 0; s < zsplit; ++s)
              v += zv_part[((size_t)s * p.n + r) * a.k + q];
            mr = a.m[r];
"""
_K1_MMA_OUT_STAGE = """              for (int s = 0; s < zsplit; ++s)
                v += zv_part[((size_t)s * t.f + r0 + c) * a.k + k0 + q];
"""

PARENT_VARIANTS = {
    "parent": [],
    "parent_nofold": [(COMMON, _WITH_SINCOS, _NO_SINCOS)],
    "parent_noproducts": [(GEMM, _PARENT_PRODUCTS,
                           "      (void)al; (void)bl;\n")],
    # K1's contractions: the K 1 passes' FMAs become one add a value,
    # the tensor-core contractions' three mma.sync one add a value.
    "parent_nocontract": [
        (ZTZV, _K1_ZV_ONE, "              part[h][q] += c + s;\n"),
        (ZTZV, _K1_OUT_ONE, "                oc[2 * j + e] += c;\n"
                            "                os[2 * j + e] += s;\n"),
        (ZTZV, _MMA_ADD, _NO_MMA_ADD)],
    # K2's stores kept live behind a test no value passes.
    "parent_nostores": [(FEAT, _K2_ROWS,
                         "              if (v.x == -1.25e30f)\n" + _K2_ROWS)],
    # The ring's cp.async copies and K1's staging loads compiled out; the
    # ring zeroed once.
    "parent_nocopies": [
        (GEMM, _COPY, "    (void)d;\n    (void)off;\n    (void)ok;\n"),
        (GEMM, _RING_BASE, _ZEROED_RING_BASE),
        (ZTZV, _CP4, "  (void)d;\n  (void)src;\n  (void)valid;\n"),
        (ZTZV, _K1_ONE_STAGE, "        vcs[i % 3][e] = T(0);\n"
                              "        vss[i % 3][e] = T(0);\n"
                              "        (void)ok;\n        (void)at;\n"),
        (ZTZV, _K1_OUT_STAGE, "            mr = T(1);\n"),
        (ZTZV, _K1_MMA_OUT_STAGE, "")],
    "parent_timeline": [(GEMM, "namespace xgpr {\n", csv_._TL_DECL),
                        (GEMM, csv_._PARENT_LOOP, csv_._TIMED_LOOP),
                        (ENTRY_TU, "using namespace xgpr;\n",
                         "using namespace xgpr;\n" + csv_._reader("k1")
                         + csv_._reader("k2"))],
}

# --- the parent's ring bodies (5cf5d0c: K1's bf16 passes in ztzv.cuh and
# K2's fp32 FMA kernel in feature_map.cuh, both on tf32_gemm.cuh's
# gemm_loop and dense_pipeline; fma_gemm.cuh's fma_products) --------------
FMA = CSRC + "fma_gemm.cuh"
_RING_BF16_PRODUCTS = """#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16(acc, ah + 2 * kk, bh + 2 * kk, kk > 0 || !overwrite);
"""
_RING_FMA_PRODUCTS = "    fma_products(a, b, acc, overwrite);\n"
_RING_MMA_BF16 = "    mma_bf16(d.main, a.hi, b.hi[0], b.hi[1]);\n"
_RING_K2_STORES = """                store2(o + col, c0, c1);
                store2(o + col + width, s0, s1);
"""
_RING_COPY = """    cp_async16(dst + sw128(lr + 32 * q, lc),
               static_cast<const char*>(src) + off, ok);
"""
_RING_ZEROED_BASE = """__device__ __forceinline__ unsigned char* ring_base(unsigned char* raw) {
  unsigned char* p =
      raw + ((1024 - ((unsigned)__cvta_generic_to_shared(raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < STAGES * (A_BYTES + B_BYTES) / 16;
       i += blockDim.x)
    reinterpret_cast<int4*>(p)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  return p;
}
"""
RING_PARENT_VARIANTS = {
    "parent": [],
    "parent_nofold": [(COMMON, _WITH_SINCOS, _NO_SINCOS)],
    # The products compiled out, the accumulators kept opaque.
    "parent_noproducts": [
        (GEMM, _RING_BF16_PRODUCTS, "    (void)ah;\n    (void)bh;\n"),
        (GEMM, _RING_FMA_PRODUCTS,
         "    (void)a;\n    (void)b;\n    (void)overwrite;\n"
         "    fence_acc(acc);\n")],
    # K1's contractions: the K 1 passes' FMAs and the tensor-core
    # contractions' mma.sync each one add a value.
    "parent_nocontract": [
        (ZTZV, _K1_ZV_ONE, "              part[h][q] += c + s;\n"),
        (ZTZV, _K1_OUT_ONE, "                oc[2 * j + e] += c;\n"
                            "                os[2 * j + e] += s;\n"),
        (ZTZV, _RING_MMA_BF16,
         "    for (int r = 0; r < 4; ++r)\n"
         "      d.main[r] += __uint_as_float(a.hi[r]) +\n"
         "                   __uint_as_float(b.hi[r % 2]);\n")],
    # K2's stores kept live behind a test no value passes.
    "parent_nostores": [(FEAT, _RING_K2_STORES,
                         "                if (c0 == -1.25e30f) {\n"
                         + _RING_K2_STORES + "                }\n")],
    # The ring's cp.async copies and K1's staging loads compiled out; the
    # ring zeroed once.
    "parent_nocopies": [
        (GEMM, _RING_COPY, "    (void)off;\n    (void)ok;\n"),
        (GEMM, _RING_BASE, _RING_ZEROED_BASE),
        (ZTZV, _CP4, "  (void)d;\n  (void)src;\n  (void)valid;\n"),
        (ZTZV, _K1_ONE_STAGE, "        vcs[i % 3][e] = T(0);\n"
                              "        vss[i % 3][e] = T(0);\n"
                              "        (void)ok;\n        (void)at;\n"),
        (ZTZV, _K1_OUT_STAGE, "            mr = T(1);\n"),
        (ZTZV, _K1_MMA_OUT_STAGE, "")],
    # thread 0's clock64 split of gemm_loop: wait and barrier, copy issue
    # (bf16: and the wait for the step's products), epilogue, products
    # (bf16: their issue).
    "parent_timeline": [(GEMM, "namespace xgpr {\n", csv_._TL_DECL),
                        (GEMM, csv_._PARENT_LOOP, csv_._TIMED_LOOP),
                        (ENTRY_TU, "using namespace xgpr;\n",
                         "using namespace xgpr;\n" + csv_._reader("k1")
                         + csv_._reader("k2"))],
}

# The bf16 and fp32 FMA branches of the parent's C entry points.
RING_PARENT_ENTRY = """#include "ztzv.cuh"
#include "feature_map.cuh"

using namespace xgpr;

extern "C" int xgpr_ztzv(const void* x_hi, const void* x_lo, const void* m,
                         const void* proj_hi, const void* proj_lo,
                         double sigma, const void* vc, const void* vs,
                         void* zv_part, void* oc_part, void* os_part,
                         void* oc, void* os, int n, int dp, int f, int k,
                         int zsplit, int osplit, double scale, int intercept,
                         int mode, int body, void* stream) {
  if (body != FMT_BF16) return (int)cudaErrorInvalidValue;
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  const ztzv::ZtzvArgs<float> a{static_cast<const float*>(m),
                                static_cast<const float*>(vc),
                                static_cast<const float*>(vs), (float)sigma,
                                (float)scale, k, intercept};
  return ztzv::launch<FMT_BF16>(
      p, a, static_cast<float*>(zv_part), static_cast<float*>(oc_part),
      static_cast<float*>(os_part), static_cast<float*>(oc),
      static_cast<float*>(os), zsplit, osplit, mode, (cudaStream_t)stream);
}

extern "C" int xgpr_ztzv_rhs_per_block(int body, int k, int pass) {
  (void)pass;
  return k == 1 ? 1 : 8 * ztzv::mma_nt(body, k);
}

extern "C" int xgpr_feature_map(const void* x_hi, const void* x_lo,
                                const void* proj_hi, const void* proj_lo,
                                void* out, int n, int dp, int f, int padded,
                                double scale, int mode, int body, int rsplit,
                                void* stream) {
  if (body != FMT_FMA32) return (int)cudaErrorInvalidValue;
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  const features::FeatureArgs<float> a{static_cast<float*>(out), padded,
                                       (float)scale};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case MODE_HI: return features::launch<FMT_FMA32, MODE_HI>(p, a, rsplit, st);
    case MODE_EXACT:
      return features::launch<FMT_FMA32, MODE_EXACT>(p, a, rsplit, st);
    case MODE_FAST:
      return features::launch<FMT_FMA32, MODE_FAST>(p, a, rsplit, st);
    default: return features::launch<FMT_FMA32, MODE_POLY>(p, a, rsplit, st);
  }
}
"""

# --- this tree's pipeline (csrc/dense_tf32.cuh) ------------------------------
_TF32_PRODUCTS = """      wgmma_tf32(acc, ah + AL + 2 * kk, bh + 2 * kk, kk > 0 || !overwrite);
      wgmma_tf32(acc, ah + 2 * kk, bh + BL + 2 * kk, 1);
      wgmma_tf32(acc, ah + 2 * kk, bh + 2 * kk, 1);
"""
_STAGED = "  const bool staged = has_omap && tile_blk >= 0 && f0 + B_ROWS <= p.f &&"
_RSPLIT = "    rsplit = tile_split(row_tiles, f_tiles, slots, 64)"
VARIANTS = {
    "base": [],
    "nofold": [(COMMON, _WITH_SINCOS, _NO_SINCOS)],
    # K2's tiles all stored from the fragment, not by TMA boxes.
    "nostage": [(WGMMA, _STAGED, _STAGED.replace("has_omap &&",
                                                 "false && has_omap &&"))],
    # K2's row tiles split over at least two blocks a frequency tile.
    "rsplit2": [(CSRC + "../feature_map.py", _RSPLIT,
                 _RSPLIT.replace("rsplit = tile_split", "rsplit = max(2, "
                                 "tile_split") + ")")],
    # The projections' three wgmma a k8 slice compiled out (K1 and K2),
    # the accumulators kept opaque.
    "noproducts": [(WGMMA, _TF32_PRODUCTS,
                    "      (void)ah;\n      (void)bh;\n")],
    # K1's tensor-core contractions (K > 1): one add a value in place of
    # the three mma.sync.
    "nocontract": [(ZTZV, _MMA_ADD, _NO_MMA_ADD)],
}

# --- this tree's fp32 FMA feature map (csrc/feature_map_fma.cu) and the
# bf16 instantiations of dense_wgmma.cuh ---------------------------------
FMAF = CSRC + "feature_map_fma.cu"
_FMA_PRODUCTS = """      if (kn == KS)
        fma_step<KS>(as + rb, TILE, 4, bs + b_at, TILE, F_RUN, acc);
      else
        fma_step_n(as + rb, TILE, 4, bs + b_at, TILE, F_RUN, kn, acc);
"""
_FMA_STORES = """          *reinterpret_cast<float4*>(o + col) =
              make_float4(cv[0], cv[1], cv[2], cv[3]);
          *reinterpret_cast<float4*>(o + col + width) =
              make_float4(sv[0], sv[1], sv[2], sv[3]);
"""
_BF16_PRODUCTS = """      wgmma_bf16(acc, ah + 2 * kk, bh + 2 * kk, kk > 0 || !overwrite);
"""
_ZV_ONE = "              part[h] = fma_t(cv, vcf, fma_t(sv, vsf, part[h]));\n"
_OUT_ONE = """            oc[2 * j + e] = fma_t(cv, zr[h], oc[2 * j + e]);
            os[2 * j + e] = fma_t(sv, zr[h], os[2 * j + e]);
"""
_ZV_COPY1 = """        ztzv::cp_async4(vc + tid, (tid < B_ROWS ? a.vc : a.vs) + at, ok);
"""
_ZV_COPY = """          ztzv::cp_async4(vc + ztzv::staged_at(q, cc), a.vc + at, ok);
          ztzv::cp_async4(vs + ztzv::staged_at(q, cc), a.vs + at, ok);
"""
_OUT_FILL = """        ztzv::cp_async4(zt + ztzv::staged_at(q, cc), zv + at, ok);
"""
_OUT1_STAGE = """      zr[h] = as_operand<FMT>(ok ? zv[(size_t)r * a.k] : 0.0f);
      mr[h] = ok ? a.m[r] : 0.0f;
"""
_WS = ("constexpr int ZV_WS = 3;", "constexpr int OUT1_WS = 3;",
       "constexpr int OUTM_WS = 3;")
VARIANTS.update({
    # K2's FMA products compiled out, the accumulators kept opaque.
    "fma_noproducts": [(FMAF, _FMA_PRODUCTS,
                        "      (void)kn;\n      (void)as;\n      (void)bs;\n"
                        "      fence_acc(acc);\n")],
    # Its 16-byte runs kept live behind a test no value passes.
    "fma_nostores": [(FMAF, _FMA_STORES,
                      "          if (cv[0] == -1.25e30f) {\n" + _FMA_STORES
                      + "          }\n")],
    # A thread's 8 frequencies adjacent (two 16-byte stores 32 bytes
    # apart a warp: half-sectors), B's chunks permuted so a quarter warp's
    # loads stay contiguous.
    "fma_runs8": [
        (FMAF, "  const int b_at = 64 * (q % 2) + 4 * tx;",
         "  const int b_at = 4 * (16 * (q % 2) + tx);"),
        (FMAF, "  const int fb = f0 + b_at;",
         "  const int fb = f0 + 64 * (q % 2) + 8 * tx;"),
        (FMAF, "  const int b_dst = A_BYTES + (q * TILE + 4 * lane) * 4;",
         "  const int b_dst = A_BYTES + (q * TILE + 4 * (16 * (lane / 16) + "
         "8 * (lane % 2) + (lane % 16) / 2)) * 4;"),
        (FMAF, "constexpr int F_RUN = 32;", "constexpr int F_RUN = 4;")],
    # "exact" over the whole tile at once (64 inlined sincosf, not 8).
    "fma_exact64": [(FMAF, "    if constexpr (MODE == MODE_EXACT) {",
                     "    if constexpr (false) {")],
    # Steps of 32 channels, 3 stages.
    "fma_ks32": [(FMAF, "constexpr int KS = 16; ", "constexpr int KS = 32; "),
                 (FMAF, "constexpr int STAGES = 6;", "constexpr int STAGES = 3;")],
    # One block an SM on 12 stages.
    "fma_minb1": [(FMAF, "constexpr int MIN_BLOCKS = 2; ",
                   "constexpr int MIN_BLOCKS = 1; "),
                  (FMAF, "constexpr int STAGES = 6;",
                   "constexpr int STAGES = 12;"),
                  (CSRC + "../feature_map.py", "FMA_BLOCKS_PER_SM = 2",
                   "FMA_BLOCKS_PER_SM = 1")],
    # K1 bf16: its products, contractions or staged operands compiled out;
    # six walk stages (bf16's boxes are half 3xTF32's).
    "bf16_noproducts": [(WGMMA, _BF16_PRODUCTS, "      (void)ah;\n")],
    "bf16_nocontract": [
        (WGMMA, _ZV_ONE, "              part[h] += cv + sv;\n"),
        (WGMMA, _OUT_ONE, "            oc[2 * j + e] += cv;\n"
                          "            os[2 * j + e] += sv;\n"),
        (ZTZV, _RING_MMA_BF16,
         "    for (int r = 0; r < 4; ++r)\n"
         "      d.main[r] += __uint_as_float(a.hi[r]) +\n"
         "                   __uint_as_float(b.hi[r % 2]);\n")],
    "bf16_nostage": [
        (WGMMA, _ZV_COPY1, "        (void)at;\n"),
        (WGMMA, _ZV_COPY, "          (void)at;\n"),
        (WGMMA, _OUT_FILL, "        (void)at;\n"),
        (WGMMA, _OUT1_STAGE, "      zr[h] = 0.0f;\n      mr[h] = 1.0f;\n"
                             "      (void)ok;\n")],
    "bf16_ws6": [(WGMMA, w, w.replace("3;", "6;")) for w in _WS],
    # The sincos of the tensor-core zv pass (K > 1) or of the out pass
    # alone replaced by two operations a value.
    "bf16_stubzv": [(WGMMA, """                sincos(acc[4 * (JS * u + jj) + 2 * h + e] * a.sigma, wrow[h],
                       &cv[jj][h][e], &sv[jj][h][e]);
""", """                (void)sincos, cv[jj][h][e] = acc[4 * (JS * u + jj) + 2 * h + e] *
                                        wrow[h],
                sv[jj][h][e] = acc[4 * (JS * u + jj) + 2 * h + e] + wrow[h];
""")],
    "bf16_stubout": [(WGMMA, """              sincos(acc[4 * j + 2 * h + e] * a.sigma, wr, &cv[jj][h][e],
                     &sv[jj][h][e]);
""", """              (void)sincos, cv[jj][h][e] = acc[4 * j + 2 * h + e] * wr;
              sv[jj][h][e] = acc[4 * j + 2 * h + e] + wr;
""")],
})

# The same branches of this tree's entry points, on dense_tf32.cuh.
ENTRY = """#include "dense_tf32.cuh"

using namespace xgpr;

extern "C" int xgpr_ztzv(const void* x_hi, const void* x_lo, const void* m,
                         const void* proj_hi, const void* proj_lo,
                         double sigma, const void* vc, const void* vs,
                         void* zv_part, void* oc_part, void* os_part,
                         void* oc, void* os, int n, int dp, int f, int k,
                         int zsplit, int osplit, double scale, int intercept,
                         int mode, int body, void* stream) {
  if (body != FMT_TF32X3) return (int)cudaErrorInvalidValue;
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  const ztzv::ZtzvArgs<float> a{static_cast<const float*>(m),
                                static_cast<const float*>(vc),
                                static_cast<const float*>(vs), (float)sigma,
                                (float)scale, k, intercept};
  return dtf32::launch_k1(
      p, a, static_cast<float*>(zv_part), static_cast<float*>(oc_part),
      static_cast<float*>(os_part), static_cast<float*>(oc),
      static_cast<float*>(os), zsplit, osplit, mode, (cudaStream_t)stream);
}

extern "C" int xgpr_ztzv_rhs_per_block(int body, int k, int pass) {
  (void)pass;
  return k == 1 ? 1 : 8 * ztzv::mma_nt(body, k);
}

extern "C" int xgpr_feature_map(const void* x_hi, const void* x_lo,
                                const void* proj_hi, const void* proj_lo,
                                void* out, int n, int dp, int f, int padded,
                                double scale, int mode, int body, int rsplit,
                                void* stream) {
  if (body != FMT_TF32X3) return (int)cudaErrorInvalidValue;
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  const features::FeatureArgs<float> a{static_cast<float*>(out), padded,
                                       (float)scale};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case MODE_HI: return dtf32::launch_k2<MODE_HI>(p, a, rsplit, st);
    case MODE_EXACT: return dtf32::launch_k2<MODE_EXACT>(p, a, rsplit, st);
    case MODE_FAST: return dtf32::launch_k2<MODE_FAST>(p, a, rsplit, st);
    default: return dtf32::launch_k2<MODE_POLY>(p, a, rsplit, st);
  }
}
"""


# This tree's bf16 and fp32 FMA branches: the bodies' own translation
# units (ztzv_bf16.cu, feature_map_fma.cu) built as they are, beside an
# entry file that calls them: K1's branch, then K2's.
RING_ENTRY = """#include "ztzv.cuh"

using namespace xgpr;

extern "C" int xgpr_ztzv(const void* x_hi, const void* x_lo, const void* m,
                         const void* proj_hi, const void* proj_lo,
                         double sigma, const void* vc, const void* vs,
                         void* zv_part, void* oc_part, void* os_part,
                         void* oc, void* os, int n, int dp, int f, int k,
                         int zsplit, int osplit, double scale, int intercept,
                         int mode, int body, void* stream) {
  if (body != FMT_BF16) return (int)cudaErrorInvalidValue;
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  const ztzv::ZtzvArgs<float> a{static_cast<const float*>(m),
                                static_cast<const float*>(vc),
                                static_cast<const float*>(vs), (float)sigma,
                                (float)scale, k, intercept};
  return ztzv::launch_bf16(
      p, a, static_cast<float*>(zv_part), static_cast<float*>(oc_part),
      static_cast<float*>(os_part), static_cast<float*>(oc),
      static_cast<float*>(os), zsplit, osplit, mode, (cudaStream_t)stream);
}

extern "C" int xgpr_ztzv_rhs_per_block(int body, int k, int pass) {
  (void)pass;
  return k == 1 ? 1 : 8 * ztzv::mma_nt(body, k);
}
"""
# K2's branch, alone (each body's variants build its own unit only).
RING_ENTRY_K2 = """#include "feature_map.cuh"

using namespace xgpr;

extern "C" int xgpr_feature_map(const void* x_hi, const void* x_lo,
                                const void* proj_hi, const void* proj_lo,
                                void* out, int n, int dp, int f, int padded,
                                double scale, int mode, int body, int rsplit,
                                void* stream) {
  if (body != FMT_FMA32) return (int)cudaErrorInvalidValue;
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  const features::FeatureArgs<float> a{static_cast<float*>(out), padded,
                                       (float)scale};
  return features::launch_fma32(p, a, mode, rsplit, (cudaStream_t)stream);
}
"""
# The trees: those before dense_tf32.cuh (every float32 body on
# tf32_gemm.cuh's ring, c2803c7 and earlier), those with it (3xTF32 on it,
# bf16 and fp32 FMAs on the ring, 5cf5d0c) and later ones (3xTF32 and bf16
# on dense_wgmma.cuh, fp32 FMAs on a register tile of their own).


def entry_for(src, body):
    """(entry file, translation units to build) of a tree for ``body``."""
    if (src / WGMMA).exists():
        if body == "tf32x3":
            text = ENTRY.replace('"dense_tf32.cuh"', '"dense_wgmma.cuh"') \
                .replace("dtf32::launch_k1(", "dense::launch_k1<FMT_TF32X3>(") \
                .replace("dtf32::", "dense::")
            if (src / REUSE).exists():  # K1's reuse path and its entry
                tu = (src / CSRC / "ztzv.cu").read_text()
                text = text.replace('"dense_wgmma.cuh"', '"ztzv_reuse.cuh"') \
                    + "\nusing namespace xgpr::ztzv;\n" \
                    + tu[tu.index('extern "C" int xgpr_ztzv_reuse('):]
            return text, SOURCES
        if body == "bf16":
            return RING_ENTRY, SOURCES + ["ztzv_bf16.cu"]
        return RING_ENTRY_K2, SOURCES + ["feature_map_fma.cu"]
    if body != "tf32x3":
        return RING_PARENT_ENTRY, SOURCES
    return (ENTRY if (src / DENSE).exists() else PARENT_ENTRY), SOURCES


def make(src, name, patches, body="tf32x3"):
    entry = [p for p in patches if p[0] == ENTRY_TU]
    rest = [p for p in patches if p[0] != ENTRY_TU]
    text, sources = entry_for(src, body)
    dst = wsv.make(src, name, rest, sources)
    for _, old, new in entry:
        text = text.replace(old, new, 1)
    (dst / ENTRY_TU).write_text(text)
    return dst


def sha(tensors):
    return hashlib.sha256(b"".join(a.cpu().numpy().tobytes()
                                   for a in tensors)).hexdigest()[:12]


def ring_cases(body, t, rng, p1, p2, xr, m, sigma, rbf, two):
    """The bf16 body's K1 rows ("default": K 1 and 26, "fast" and "hi") or
    the fp32 FMA body's K2 rows ("highest": D 84 "exact" and "hi", D
    1024 "exact"), through the wrappers' launchers."""
    from xgpr_tpu_torch.ops.cuda import feature_map, ztzv
    out = []
    if body == "bf16":
        for label, k, mode in (("K1 K=1 fast", 1, "fast"),
                               ("K1 K=1 hi", 1, "hi"),
                               ("K1 K=26 fast", 26, "fast"),
                               ("K1 K=26 hi", 26, "hi")):
            vc = t(rng.standard_normal((p1.shape[1], k)))
            vs = t(rng.standard_normal((p1.shape[1], k)))
            args = (xr, m, p1, sigma, vc, vs, True, mode, "default")
            out.append((label, ztzv.launcher(*args),
                        lambda args=args: ztzv.ztzv_parts(*args),
                        ztzv.ztzv_parts_plain(*args)))
        return out
    x_tab = t(rng.standard_normal((xr.shape[0], p1.shape[0])) * 0.5)
    x_two = t(rng.random((xr.shape[0], p2.shape[0])) * 0.1)
    for label, xk, pr, padded, mode in (
            ("K2 D84 exact", x_tab, p1, rbf.padded_dims, "exact"),
            ("K2 D84 hi", x_tab, p1, rbf.padded_dims, "hi"),
            ("K2 D1024 exact", x_two, p2, two._feature_padded, "exact")):
        args = (xk, pr, True, padded, mode, "highest")
        out.append((label, lambda f=feature_map.launcher(*args): (f(),),
                    lambda args=args: (feature_map.rbf_feature_map(*args),),
                    (feature_map.rbf_feature_map_plain(*args),)))
    return out


def cases(body="tf32x3"):
    """(label, launch alone, wrapper, plain outputs) of each timed row of
    ``body``, on the package of the working directory: the launch through
    the wrapper's ``launcher`` where the tree has one, else through the
    parent's C entry points on the operands its wrappers prepare."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from xgpr_tpu_torch.kernels import RBF, Conv1dTwoLayer
    from xgpr_tpu_torch.ops.cuda import build, feature_map, ztzv
    from xgpr_tpu_torch.ops.cuda.operands import (pad_depth, projT_planes,
                                                  sm_count, split_tf32,
                                                  tile_split)
    from xgpr_tpu_torch.ops.sorf import rbf_norm_constant
    lib = build.library()
    dev = "cuda"
    rng = np.random.default_rng(7)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)
    rbf = RBF((cs.CHUNK, cs.N_FEATURES), cs.NUM_RFFS, cs.SEED, device=dev)
    wide = RBF((cs.CHUNK, cs.N_FEATURES), cs.MSHARD_RFFS, cs.SEED,
               device=dev)
    two = Conv1dTwoLayer((cs.CHUNK, cs.MOTIF_L, cs.MOTIF_D), cs.K4_RFFS,
                         cs.SEED, device=dev,
                         kernel_spec_parms={"conv_width": cs.MOTIF_W,
                                            "init_rffs": cs.INIT_RFFS})
    p1, pw, p2 = rbf._dense_proj(), wide._dense_proj(), \
        two._dense_projs()[1]
    stream = torch.cuda.current_stream().cuda_stream
    sms = sm_count(0)
    sigma = float(np.exp(cs.HPARAMS[1]))
    xr = t(rng.standard_normal((cs.CHUNK, p1.shape[0])))
    m = t((rng.random(cs.CHUNK) > 0.25).astype(np.float32))
    out = []
    new = hasattr(ztzv, "launcher")
    if body != "tf32x3":
        return lib, ring_cases(body, t, rng, p1, p2, xr, m, sigma, rbf, two)

    for label, pr, k, mode, precision in (
            ("K1 K=1 hi", p1, 1, "hi", "high"),
            ("K1 K=1 exact", p1, 1, "exact", "highest"),
            ("K1 K=26", p1, 26, "hi", "high"),
            ("K1 F16384 K=1", pw, 1, "hi", "high"),
            ("K1 F16384 K=5", pw, 5, "hi", "high")):
        vc = t(rng.standard_normal((pr.shape[1], k)))
        vs = t(rng.standard_normal((pr.shape[1], k)))
        args = (xr, m, pr, sigma, vc, vs, True, mode, precision)
        if new:
            launch = ztzv.launcher(*args)
        else:
            n, f = xr.shape[0], pr.shape[1]
            plan = ztzv.launch_plan(lib.xgpr_ztzv_rhs_per_block(0, k, 0), n,
                                    f, k, sms)
            xh, xl = split_tf32(pad_depth(xr, 4))
            ph, pl = projT_planes(pr, "tf32x3")
            bufs = [torch.empty(s, dtype=torch.float32, device=dev) for s in
                    ((plan.zsplit, n, k), (plan.osplit, f, k),
                     (plan.osplit, f, k), (f, k), (f, k))]

            def launch(xh=xh, xl=xl, ph=ph, pl=pl, vc=vc, vs=vs, bufs=bufs,
                       plan=plan, n=n, f=f, k=k, mode=mode):
                build.check(lib.xgpr_ztzv(
                    xh.data_ptr(), xl.data_ptr(), m.data_ptr(),
                    ph.data_ptr(), pl.data_ptr(), sigma, vc.data_ptr(),
                    vs.data_ptr(), *[b.data_ptr() for b in bufs], n,
                    xh.shape[1], f, k, plan.zsplit, plan.osplit,
                    rbf_norm_constant(f, True), 1,
                    feature_map.kernel_sincos_flag(mode), 0, stream), "ztzv")
                return bufs[3], bufs[4]
        out.append((label, launch,
                    lambda args=args: ztzv.ztzv_parts(*args),
                    ztzv.ztzv_parts_plain(*args)))

    tune = RBF((cs.CHUNK, cs.N_FEATURES), cs.TUNE_RFFS, cs.SEED, device=dev)
    aux = RBF((cs.CHUNK, cs.N_FEATURES), cs.KMEANS_RFFS, cs.SEED,
              device=dev)
    x_tab = t(rng.standard_normal((cs.CHUNK, p1.shape[0])) * 0.5)
    for label, xk, pr, padded, intercept in (
            ("K2 D84", x_tab, p1, rbf.padded_dims, True),
            ("K2 D1024", t(rng.random((cs.CHUNK, p2.shape[0])) * 0.1), p2,
             two._feature_padded, True),
            ("K2 F1024", x_tab, tune._dense_proj(), tune.padded_dims, True),
            ("K2 F2048 no intercept", x_tab, aux._dense_proj(),
             aux.padded_dims, False),
            ("K2 F16384", x_tab, pw, wide.padded_dims, True)):
        args = (xk, pr, intercept, padded, "hi", "high")
        if new:
            launch = (lambda f=feature_map.launcher(*args): (f(),))
        else:
            n, f = xk.shape[0], pr.shape[1]
            xh, xl = split_tf32(pad_depth(xk, 4))
            ph, pl = projT_planes(pr, "tf32x3")
            res = torch.empty((n, 2 * f), dtype=torch.float32, device=dev)
            rsplit = tile_split(-(-n // feature_map.TILE),
                                -(-f // feature_map.TILE), sms, 64)

            def launch(xh=xh, xl=xl, ph=ph, pl=pl, res=res, n=n, f=f,
                       padded=padded, rsplit=rsplit, intercept=intercept):
                build.check(lib.xgpr_feature_map(
                    xh.data_ptr(), xl.data_ptr(), ph.data_ptr(),
                    pl.data_ptr(), res.data_ptr(), n, xh.shape[1], f,
                    int(padded), rbf_norm_constant(f, intercept), 0, 0,
                    rsplit, stream), "feature map")
                return (res,)
        out.append((label, launch,
                    lambda args=args: (feature_map.rbf_feature_map(*args),),
                    (feature_map.rbf_feature_map_plain(*args[:5]),)))
    return lib, out[:4] + out[5:] + out[4:5]   # E2(b)'s K 5 last


def timing(name, wrapper=False, body="tf32x3"):
    """Runs in a variant's copy (or, with ``wrapper``, in a tree): each
    launch alone, twice 20 calls, and with ``wrapper`` the whole wrapper
    too; the base variants also check and hash the outputs, the timeline
    variant reads its clock64 sums."""
    import ctypes
    sys.path.insert(0, str(Path.cwd()))
    import torch
    import chip_smoke as cs
    lib, launches = cases(body)
    rows, notes = [], []

    def twice(fn):
        return "/".join(f"{cs.time_ms(torch, fn, reps=20):.4f}"
                        for _ in range(2))
    for label, fn, wrap, want in launches:
        print("CASE", name, label, file=sys.stderr, flush=True)
        row = f"{label} {twice(fn)}"
        if wrapper:
            row += f" wrapper {twice(wrap)}"
            # the host's time to issue a wrapper call, with no sync
            wrap()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                wrap()
            row += f" (host {(time.perf_counter() - t0) * 50:.4f})"
            torch.cuda.synchronize()
        rows.append(row)
        if name in ("base", "parent") or wrapper:
            got = fn()
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            top = max(float(b.abs().max()) for b in want)
            again = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            notes.append(f"{label} err {err:.3e} (max|ref| {top:.3e}) "
                         f"sha {sha(got)} repeat-bitwise {same}")
        reader = getattr(lib, "xgpr_timeline_" + label[:2].lower(), None)
        if reader is not None:
            buf = (ctypes.c_ulonglong * 5)()
            fn()
            torch.cuda.synchronize()
            reader(buf)
            fn()
            torch.cuda.synchronize()
            reader(buf)
            total = sum(buf[:4]) or 1
            notes.append(
                f"{label} timeline [thread 0: {buf[4]} blocks, "
                f"{total / max(buf[4], 1):.0f} cycles a block; wait+barrier "
                f"{buf[0] / total:.1%}, copy issue {buf[1] / total:.1%}, "
                f"epilogue {buf[2] / total:.1%}, products "
                f"{buf[3] / total:.1%}]")
    print("VARIANT", name, " | ".join(rows), f"[{cs.card_line()}]",
          flush=True)
    for note in notes:
        print("CHECK", name, note, flush=True)


def stress(calls=300):
    """K1 in its 3xTF32 and bf16 bodies, "fast" and "hi", at K 1, 5, 9,
    26, 33 and 64 on slice A's chunk: ``calls`` calls each, checked every
    50 against the first call's bits; one line a case (a hang shows as
    the last line printed)."""
    sys.path.insert(0, str(Path.cwd()))
    import numpy as np
    import torch
    from xgpr_tpu_torch.ops.cuda import ztzv
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")
    x, m = t(rng.standard_normal((8192, 84))), t(rng.random(8192) > 0.25)
    proj = t(rng.standard_normal((84, 4096)) * 0.3)
    for precision in ("default", "high"):
        for mode in ("fast", "hi"):
            for k in (26, 1, 9, 33, 64, 5):
                vc, vs = (t(rng.standard_normal((4096, k))) for _ in "cs")
                args = (x, m, proj, 0.05, vc, vs, True, mode, precision)
                first = ztzv.ztzv_parts(*args)
                same = True
                for it in range(calls):
                    out = ztzv.ztzv_parts(*args)
                    if it % 50 == 49:
                        torch.cuda.synchronize()
                        same = same and all(torch.equal(a, b)
                                            for a, b in zip(out, first))
                torch.cuda.synchronize()
                print("STRESS", precision, mode, f"K={k}", calls, "calls",
                      "bitwise", same, flush=True)


def main(argv):
    body = "tf32x3"
    if argv == ["--stress"]:
        stress()
        return
    if "--body" in argv:
        at = argv.index("--body")
        body = argv[at + 1]
        argv = argv[:at] + argv[at + 2:]
        if body not in ("tf32x3", "bf16", "fma32"):
            raise SystemExit(f"unknown body {body!r}")
    if len(argv) > 1 and argv[0] == "--time":
        timing(argv[1], wrapper=True, body=body)
        return
    if len(argv) > 1 and argv[0] == "--variant":
        timing(argv[1], body=body)
        return
    if len(argv) > 1 and argv[0] == "--build":
        dfv.build_variant(argv[1])
        return
    if argv and argv[0] == "--parent":
        src = Path(argv[1]).resolve()
        table = PARENT_VARIANTS if body == "tf32x3" or \
            (src / WGMMA).exists() else RING_PARENT_VARIANTS
        names = argv[2:] or list(table)
    else:
        src, table = ROOT, VARIANTS
        names = argv or list(table)
    dirs = {n: make(src, n, table[n], body) for n in names}
    built = dfv.build_all(dirs)
    for n, d in dirs.items():
        if not built[n]:
            print("VARIANT", n, "build failed", flush=True)
            continue
        try:
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--variant", n, "--body", body], cwd=d,
                           check=False, timeout=150)
        except subprocess.TimeoutExpired:
            print("VARIANT", n, "timed out", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
