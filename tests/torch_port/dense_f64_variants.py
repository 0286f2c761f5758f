"""Split and time K1 and K2's float64 bodies on the card.

Each variant is a copy of a tree's package and chip_smoke.py under
build/variants/<name> whose sources take one named set of patches
(below).  A copy builds only the float64 sources of K1 and K2
(``ztzv_f64.cu``, ``feature_map_f64.cu``) and a small entry file this
script writes beside them (ENTRY: the float64 branches of ``xgpr_ztzv``,
``xgpr_ztzv_rhs_per_block`` and ``xgpr_feature_map``), so a build takes
seconds, not the minutes of the float32 sources.  All builds run side by
side (``-Xptxas -v``: every variant prints the registers, spills and
stack of its float64 kernels); then each variant times, in a process of
its own, the launch alone (the C entry point on operands prepared as the
wrappers prepare them; CUDA events, 2 x 20 calls after a warm-up) at
slice A's chunk (chip_smoke.py's shapes and models), and prints one
line:

    VARIANT <name> K1 K=1 <ms>/<ms> | K1 K=26 ... | K2 D84 ... | K2 D1024 ...

The base variants also print each output's error against the plain
float64 version and a SHA-256 of its bits.

From the root of a checkout on the card:

    python tests/torch_port/dense_f64_variants.py [name ...]
    python tests/torch_port/dense_f64_variants.py --parent DIR [name ...]
    python tests/torch_port/dense_f64_variants.py --turns DIR

``--parent DIR`` splits the tree at DIR as it was before the redesign
of the float64 bodies (DMMA m8n8k4 on tf32_gemm.cuh's 3-stage ring,
e.g. ``git archive 9b5f331 | tar -x -C build/parent``; PARENT_VARIANTS):
as it is, with the fold (the double sincos), the projections, K1's
contractions, K2's stores or the copies compiled out, and a clock64
timeline (thread 0 of every block: the share of its cycles in the copy
wait and barrier, the copies' issue, the epilogue and the products).
Without it the variants of this tree's kernels (VARIANTS: dense_f64.cuh's
DMMA loop) are split the same way: base; nofold, noproducts, nocontract,
nostores, nocopies (each compiled out; a contraction DMMA becomes four
FP64 FMAs, so the fold's values stay live); poly (the straight-line
polynomial sincos of tests/torch_port/sincos_rate.cu in place of the
builtin); noresident (K1's A streamed through the ring with B); timeline
(thread 0's cycles in the full-barrier wait, the copies' issue with its
empty-barrier wait, the epilogue and the products).  ``--turns DIR``
times DIR's launches and this tree's in turns (parent, change, change,
parent), each in a process of its own.
"""
import hashlib
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import conv_sync_variants as csv_  # noqa: E402
import conv_ws_variants as wsv  # noqa: E402

ROOT = Path.cwd()
CSRC = "xgpr_tpu_torch/ops/cuda/csrc/"
COMMON = CSRC + "common.cuh"
GEMM = CSRC + "tf32_gemm.cuh"
ZTZV = CSRC + "ztzv.cuh"
FEAT = CSRC + "feature_map.cuh"
K1_TU = CSRC + "ztzv_f64.cu"
K2_TU = CSRC + "feature_map_f64.cu"
SOURCES = ["ztzv_f64.cu", "feature_map_f64.cu", "f64_entry.cu"]

# The float64 branches of the library's C entry points (ztzv.cu,
# feature_map.cu), in a file of their own.
ENTRY = """#include "ztzv.cuh"
#include "feature_map.cuh"

using namespace xgpr;

extern "C" int xgpr_ztzv(const void* x_hi, const void* x_lo, const void* m,
                         const void* proj_hi, const void* proj_lo,
                         double sigma, const void* vc, const void* vs,
                         void* zv_part, void* oc_part, void* os_part,
                         void* oc, void* os, int n, int dp, int f, int k,
                         int zsplit, int osplit, double scale, int intercept,
                         int mode, int body, void* stream) {
  (void)mode;
  if (body != FMT_F64) return (int)cudaErrorInvalidValue;
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  const ztzv::ZtzvArgs<double> a{static_cast<const double*>(m),
                                 static_cast<const double*>(vc),
                                 static_cast<const double*>(vs), sigma,
                                 scale, k, intercept};
  return ztzv::launch_f64(p, a, static_cast<double*>(zv_part),
                          static_cast<double*>(oc_part),
                          static_cast<double*>(os_part),
                          static_cast<double*>(oc),
                          static_cast<double*>(os), zsplit, osplit,
                          (cudaStream_t)stream);
}

extern "C" int xgpr_ztzv_rhs_per_block(int body, int k, int pass) {
  (void)body;
  (void)pass;
  return 8 * ztzv::f64_nt(k);
}

extern "C" int xgpr_feature_map(const void* x_hi, const void* x_lo,
                                const void* proj_hi, const void* proj_lo,
                                void* out, int n, int dp, int f, int padded,
                                double scale, int mode, int body, int rsplit,
                                void* stream) {
  (void)mode;
  if (body != FMT_F64) return (int)cudaErrorInvalidValue;
  const DenseOperands p{x_hi, x_lo, proj_hi, proj_lo, n, dp, f};
  return features::launch_f64(p, {static_cast<double*>(out), padded, scale},
                              rsplit, (cudaStream_t)stream);
}
"""

# --- the parent's bodies (fma_gemm.cuh's dmma_products on the ring of
# tf32_gemm.cuh; K1's own passes in ztzv.cuh, K2's fragment stores) ----
_SINCOS = "  double sv, cv;\n  sincos(x, &sv, &cv);\n"
_NO_SINCOS = "  double sv = x, cv = x;\n"
_PARENT_PRODUCTS = "    dmma_products(a, b, acc, overwrite);\n"
_NO_PRODUCTS = """    (void)a;
    (void)b;
    if (overwrite)
      for (int i = 0; i < 64; ++i) acc[i] = 0.0;
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+d"(acc[i]));
"""
_ZV_CONTRACT = """                dmma(z[h][nt][0], z[h][nt][1], c, bc[nt]);
                dmma(z[h][nt][0], z[h][nt][1], s, bs[nt]);
"""
_OUT_CONTRACT = """                dmma(o[0][h][nt][0], o[0][h][nt][1], c, bz[nt]);
                dmma(o[1][h][nt][0], o[1][h][nt][1], s, bz[nt]);
"""
_STORES = """                store2(o + col, c0, c1);
                store2(o + col + width, s0, s1);
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
  for (int i = threadIdx.x; i < 3 * 32768 / 16; i += blockDim.x)
    reinterpret_cast<int4*>(p)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  return p;
}
"""
_ZV_STAGE = """            vc[fl * VP + q] = ok ? a.vc[at] : 0.0;
            vs[fl * VP + q] = ok ? a.vs[at] : 0.0;
"""
_OUT_STAGE = """            if (r < t.f && q < kcnt)
              for (int s = 0; s < zsplit; ++s)
                v += zv_part[((size_t)s * t.f + r) * a.k + k0 + q];
"""

PARENT_VARIANTS = {
    "parent": [],
    "parent_nofold": [(COMMON, _SINCOS, _NO_SINCOS)],
    "parent_noproducts": [(GEMM, _PARENT_PRODUCTS, _NO_PRODUCTS)],
    # Each contraction DMMA pair replaced by one FP64 FMA per value.
    "parent_nocontract": [
        (ZTZV, _ZV_CONTRACT, "                z[h][nt][0] += c * bc[nt];\n"
                             "                z[h][nt][1] += s * bs[nt];\n"),
        (ZTZV, _OUT_CONTRACT,
         "                o[0][h][nt][0] += c * bz[nt];\n"
         "                o[1][h][nt][0] += s * bz[nt];\n")],
    # The stores kept live behind a test no value passes.
    "parent_nostores": [(FEAT, _STORES,
                         "                if (c0 == -1.25e-300) {\n"
                         + _STORES + "                }\n")],
    # The ring's cp.async copies and K1's staging loads compiled out; the
    # ring zeroed once.
    "parent_nocopies": [
        (GEMM, _COPY, "    (void)d;\n    (void)off;\n    (void)ok;\n"),
        (GEMM, _RING_BASE, _ZEROED_RING_BASE),
        (ZTZV, _ZV_STAGE, "            vc[fl * VP + q] = 0.0;\n"
                          "            vs[fl * VP + q] = 0.0;\n"
                          "            (void)ok;\n            (void)at;\n"),
        (ZTZV, _OUT_STAGE, "")],
    "parent_timeline": [(GEMM, "namespace xgpr {\n", csv_._TL_DECL),
                        (GEMM, csv_._PARENT_LOOP, csv_._TIMED_LOOP),
                        (K1_TU, "}  // namespace xgpr\n",
                         "}  // namespace xgpr\n" + csv_._reader("k1")),
                        (K2_TU, "}  // namespace xgpr\n",
                         "}  // namespace xgpr\n" + csv_._reader("k2"))],
}

# --- this tree's kernels (dense_f64.cuh's loop; K1's passes in ztzv.cuh,
# K2's kernel in feature_map_f64.cu) -----------------------------------------
DENSE = CSRC + "dense_f64.cuh"
_PRODUCTS = "    dmma_line<1, 8>(a, arow, line + b_at, brow, acc);\n"
_NO_LINE = """    (void)a;
    (void)line;
#pragma unroll
    for (int i = 0; i < Tl::ACC; ++i) asm volatile("" : "+d"(acc[i]));
"""
_CONTRACT = ("            dmma16x8x8(z[nt], c[0][0], c[1][0], c[0][1], c[1][1], bc.x,\n"
             "                       bc.y);\n"
             "            dmma16x8x8(z[nt], s[0][0], s[1][0], s[0][1], s[1][1], bs.x,\n"
             "                       bs.y);\n")
_OUT_CONTRACT_NEW = (
    "            dmma16x8x8(o[0][nt], c[0][0], c[1][0], c[0][1], c[1][1], b.x,\n"
    "                       b.y);\n"
    "            dmma16x8x8(o[1][nt], s[0][0], s[1][0], s[0][1], s[1][1], b.x,\n"
    "                       b.y);\n")
_NEW_STORES = """              store2(o + col, c0, c1);
              store2(o + col + width, s0, s1);
"""
_DENSE_COPIES = """      cp_async16(dst + sw128(r, lc),
                 ok ? xa + (size_t)(ar + r) * p.dp + col : xa, ok);
"""
_DENSE_COPIES_B = """      cp_async16(st + b_at + sw128(r, lc),
                 ok ? xb + (size_t)(br + r) * p.dp + col : xb, ok);
"""
_LOOP_START = "  while (q < ahead && q < nsteps) issue();\n"
_ZERO_RING = """  for (int i = tid; i < Tl::RING / 16; i += THREADS)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  while (q < ahead && q < nsteps) issue();
"""
_CP8 = """  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
"""
_POLY = """  const double n = rint(x * 0.63661977236758138);
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
  const int qd = (int)n & 3;
  const double sq = (qd & 1) ? cr : sr, cq = (qd & 1) ? sr : cr;
  const double sv = (qd & 2) ? -sq : sq, cv = ((qd + 1) & 2) ? -cq : cq;
"""
_TL = """namespace xgpr {
namespace f64 {

// clock64 sums of thread 0 of every block: full-barrier wait, copy issue,
// epilogue, products; blocks.
static __device__ unsigned long long xgpr_tl[5];
"""
_LOOP = """    if (q < nsteps) issue();
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
"""
_TIMED = """    const long long c0 = clock64();
    if (q < nsteps) issue();
    const long long c1 = clock64();
    mbar_wait(&bar.full[st], phase);
    const long long c2 = clock64();
    const unsigned char* line = ring + st * stage_bytes;
    const unsigned char* a = resident ? smem + l * Tl::A_LINE : line;
    __syncwarp();  // mma.sync.aligned: the waits may leave the warp split
    dmma_line<1, 8>(a, arow, line + b_at, brow, acc);
#pragma unroll
    for (int i = 0; i < Tl::ACC; ++i) asm volatile("" : "+d"(acc[i])::"memory");
    const long long c3 = clock64();
    tl[1] += c1 - c0;
    tl[0] += c2 - c1;
    tl[3] += c3 - c2;
    release(&bar.empty[st]);
    if (++st == nst) {
      st = 0;
      phase ^= 1;
    }
    if (++l == kc) {
      const long long c4 = clock64();
      done(u);
#pragma unroll
      for (int i = 0; i < Tl::ACC; ++i) asm volatile("" : "+d"(acc[i])::"memory");
      tl[2] += clock64() - c4;
"""
_TL_START = "  int st = 0, phase = 0, u = 0, l = 0;\n"
_TL_END = """      l = 0;
      ++u;
    }
  }
}
"""
_TL_END_NEW = """      l = 0;
      ++u;
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      atomicAdd(&xgpr_tl[i], (unsigned long long)tl[i]);
    atomicAdd(&xgpr_tl[4], 1ull);
  }
}
"""


def _fmas(acc, v, b):
    """acc's four values += v's four values times B's two, as FMAs."""
    return "".join(f"            {acc}[{i}] += {v}[{i // 2}][{i % 2}] * "
                   f"{b}.{'xy'[i % 2]};\n" for i in range(4))


def _reader(tag):
    return csv_._reader(tag).replace("xgpr::xgpr_tl", "xgpr::f64::xgpr_tl")


VARIANTS = {
    "base": [],
    "nofold": [(COMMON, _SINCOS, _NO_SINCOS)],
    "noproducts": [(DENSE, _PRODUCTS, _NO_LINE)],
    # Each contraction DMMA replaced by four FP64 FMAs, one a value.
    "nocontract": [(ZTZV, _CONTRACT, _fmas("z[nt]", "c", "bc")
                    + _fmas("z[nt]", "s", "bs")),
                   (ZTZV, _OUT_CONTRACT_NEW, _fmas("o[0][nt]", "c", "b")
                    + _fmas("o[1][nt]", "s", "b"))],
    "nostores": [(K2_TU, _NEW_STORES, "              if (c0 == -1.25e-300) {\n"
                  + _NEW_STORES + "              }\n")],
    # The ring's and the slots' copies compiled out, the ring zeroed once.
    "nocopies": [(DENSE, _DENSE_COPIES, "      (void)ok;\n"),
                 (DENSE, _DENSE_COPIES_B, "      (void)ok;\n"),
                 (DENSE, _LOOP_START, _ZERO_RING),
                 (DENSE, _CP8, "  (void)dst;\n  (void)src;\n  (void)valid;\n")],
    # The straight-line polynomial sincos of tests/torch_port/sincos_rate.cu
    # in place of the builtin.
    "poly": [(COMMON, _SINCOS, _POLY)],
    # A streamed through the ring with B in K1's passes too.
    "noresident": [(DENSE, "  const bool resident = Tl::RESIDENT && kc <= RES_LINES;",
                    "  const bool resident = false && kc;")],
    "timeline": [(DENSE, "namespace xgpr {\nnamespace f64 {\n", _TL),
                 (DENSE, _LOOP, _TIMED),
                 (DENSE, _TL_START, _TL_START + "  long long tl[4] = {0, 0, 0, 0};\n"),
                 (DENSE, _TL_END, _TL_END_NEW),
                 (K1_TU, "}  // namespace xgpr\n",
                  "}  // namespace xgpr\n" + _reader("k1")),
                 (K2_TU, "}  // namespace xgpr\n",
                  "}  // namespace xgpr\n" + _reader("k2"))],
}


def ptxas_report(log):
    """(kernel, registers, spill bytes, stack bytes) of the float64
    kernels of K1 and K2 in an nvcc -Xptxas -v log."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            rows.append([name, None, int(m.group(1)),
                         (int(m.group(2)), int(m.group(3)))])
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1][0] == name:
            rows[-1][1] = int(m.group(1))
    return rows


def make(src, name, patches):
    dst = wsv.make(src, name, patches, SOURCES)
    (dst / CSRC / "f64_entry.cu").write_text(ENTRY)
    return dst


def build_variant(name):
    """Runs in a variant's copy: the build, with ptxas's report."""
    sys.path.insert(0, str(Path.cwd()))
    from xgpr_tpu_torch.ops.cuda import build
    build.build(["-Xptxas", "-v"])
    for kernel, regs, stack, spills in ptxas_report(build.BUILD_LOG):
        if regs is None:
            continue
        print(f"PTXAS {name} {kernel[:90]} registers {regs}, stack {stack}, "
              f"spill stores/loads {spills} bytes", flush=True)


def cases():
    """The four float64 launches at slice A's chunk, each as a function
    that launches the kernel alone, with its plain version's outputs."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from xgpr_tpu_torch.kernels import RBF, Conv1dTwoLayer
    from xgpr_tpu_torch.ops.cuda import build, feature_map, ztzv
    from xgpr_tpu_torch.ops.cuda.operands import (pad_depth, projT_planes,
                                                  sm_count, tile_split)
    from xgpr_tpu_torch.ops.sorf import rbf_norm_constant
    lib = build.library()
    dev, f64 = "cuda", torch.float64
    rng = np.random.default_rng(7)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=f64,
                               device=dev)
    kern = RBF((cs.CHUNK, cs.N_FEATURES), cs.NUM_RFFS, cs.SEED, device=dev,
               double_precision=True)
    proj = kern._dense_proj()
    two = Conv1dTwoLayer((cs.CHUNK, cs.MOTIF_L, cs.MOTIF_D), cs.K4_RFFS,
                         cs.SEED, device=dev, double_precision=True,
                         kernel_spec_parms={"conv_width": cs.MOTIF_W,
                                            "init_rffs": cs.INIT_RFFS})
    proj2 = two._dense_projs()[1]
    stream = torch.cuda.current_stream().cuda_stream
    sms = sm_count(0)
    out = []

    sigma = float(np.exp(cs.HPARAMS[1]))
    x = t(rng.standard_normal((cs.CHUNK, proj.shape[0])))
    m = t((rng.random(cs.CHUNK) > 0.25).astype(np.float32))
    for k in (1, 26):
        vc = t(rng.standard_normal((proj.shape[1], k)))
        vs = t(rng.standard_normal((proj.shape[1], k)))
        n, f = x.shape[0], proj.shape[1]
        plan = ztzv.launch_plan(lib.xgpr_ztzv_rhs_per_block(3, k, 0), n, f,
                                k, sms, "f64")
        xh = pad_depth(x, 2)
        ph = projT_planes(proj, "f64")[0]
        bufs = [torch.empty(s, dtype=f64, device=dev) for s in
                ((plan.zsplit, n, k), (plan.osplit, f, k),
                 (plan.osplit, f, k), (f, k), (f, k))]
        scale = rbf_norm_constant(f, True)

        def k1(xh=xh, ph=ph, vc=vc, vs=vs, bufs=bufs, plan=plan, k=k,
               scale=scale):
            build.check(lib.xgpr_ztzv(
                xh.data_ptr(), None, m.data_ptr(), ph.data_ptr(), None,
                sigma, vc.data_ptr(), vs.data_ptr(),
                *[b.data_ptr() for b in bufs], x.shape[0], xh.shape[1],
                proj.shape[1], k, plan.zsplit, plan.osplit, scale, 1, 1, 3,
                stream), "ztzv")
            return bufs[3], bufs[4]
        want = ztzv.ztzv_parts_plain(x, m, proj, sigma, vc, vs, True)
        out.append((f"K1 K={k}", k1, want))

    for xk, pr, padded, label in (
            (t(rng.standard_normal((cs.CHUNK, proj.shape[0])) * 0.5), proj,
             kern.padded_dims, "K2 D84"),
            (t(rng.random((cs.CHUNK, proj2.shape[0])) * 0.1), proj2,
             two._feature_padded, "K2 D1024")):
        n, f = xk.shape[0], pr.shape[1]
        xh = pad_depth(xk, 2)
        ph = projT_planes(pr, "f64")[0]
        res = torch.empty((n, 2 * f), dtype=f64, device=dev)
        rsplit = tile_split(-(-n // feature_map.TILE),
                            -(-f // feature_map.TILE), sms, 64)
        scale = rbf_norm_constant(f, True)

        def k2(xh=xh, ph=ph, res=res, n=n, f=f, padded=padded,
               rsplit=rsplit, scale=scale):
            build.check(lib.xgpr_feature_map(
                xh.data_ptr(), None, ph.data_ptr(), None, res.data_ptr(), n,
                xh.shape[1], f, int(padded), scale, 1, 3, rsplit, stream),
                "feature map")
            return (res,)
        want = (feature_map.rbf_feature_map_plain(xk, pr, True, padded),)
        out.append((label, k2, want))
    return lib, out


def timing(name):
    """Runs in a variant's copy: each launch alone, twice 20 calls; the
    base variants also check and hash the outputs, the timeline variant
    reads its clock64 sums."""
    import ctypes
    sys.path.insert(0, str(Path.cwd()))
    import torch
    import chip_smoke as cs
    lib, launches = cases()
    rows, notes = [], []
    for label, fn, want in launches:
        rows.append(label + " " + "/".join(
            f"{cs.time_ms(torch, fn, reps=20):.4f}" for _ in range(2)))
        if name in ("base", "parent"):
            got = fn()
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            top = max(float(b.abs().max()) for b in want)
            sha = hashlib.sha256(b"".join(
                a.cpu().numpy().tobytes() for a in got)).hexdigest()[:12]
            notes.append(f"{label} err {err:.3e} (max|ref| {top:.3e}) "
                         f"sha {sha}")
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


def build_all(dirs):
    procs = {n: subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--build", n],
        cwd=d) for n, d in dirs.items()}
    return {n: p.wait() == 0 for n, p in procs.items()}


def time_in(name, d):
    try:
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--time", name], cwd=d, check=False, timeout=300)
    except subprocess.TimeoutExpired:
        print("VARIANT", name, "timed out", flush=True)


def main(argv):
    if len(argv) > 1 and argv[0] == "--time":
        timing(argv[1])
        return
    if len(argv) > 1 and argv[0] == "--build":
        build_variant(argv[1])
        return
    if argv and argv[0] == "--turns":
        dirs = {"parent": make(Path(argv[1]).resolve(), "parent", []),
                "base": make(ROOT, "base", [])}
        built = build_all(dirs)
        for n in ("parent", "base", "base", "parent"):
            if built[n]:
                time_in(n, dirs[n])
            else:
                print("VARIANT", n, "build failed", flush=True)
        return
    if argv and argv[0] == "--parent":
        src, table = Path(argv[1]).resolve(), PARENT_VARIANTS
        names = argv[2:] or list(table)
    else:
        src, table = ROOT, VARIANTS
        names = argv or list(table)
    dirs = {n: make(src, n, table[n]) for n in names}
    built = build_all(dirs)
    for n, d in dirs.items():
        if built[n]:
            time_in(n, d)
        else:
            print("VARIANT", n, "build failed", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
