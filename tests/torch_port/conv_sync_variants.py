"""Split and time K3/K4's synchronous bodies (fp32 FMAs at "highest",
float64 DMMA) on the card.

Each variant is a copy of the package under build/variants/<name> whose
sources take one named set of patches (below), built from the conv
sources alone (``conv_ws_variants.make``); all builds run side by side,
then each variant times, in a process of its own, the launch alone
(``conv.parts_launcher`` / ``maxpool_launcher``, CUDA events, 2 x 20
calls after a warm-up) of K3 at "highest" in the "exact" sincos and in
float64 at F 4096, 1024 and 128, and of K4 at F 1024 in both, at the
motif chunk (chip_smoke.py's corpus and models), and prints one line a
format:

    VARIANT <name> <fma32|f64> K3 F4096 <ms>/<ms> | ... | K4 F1024 ...

From the root of a checkout on the card:

    python tests/torch_port/conv_sync_variants.py [name ...]
    python tests/torch_port/conv_sync_variants.py --parent DIR [name ...]
    python tests/torch_port/conv_sync_variants.py --rates

``--parent DIR`` (a tree of the commit before the synchronous kernel of
csrc/conv_sync.cuh, e.g. ``git archive c2118a7 | tar -x -C
build/parent``) splits that tree's bodies (the implicit GEMM of conv.cuh
on the ring of tf32_gemm.cuh; PARENT_VARIANTS): the launch as it is,
then with the fold, the products or the copies compiled out, and a
clock64 timeline (thread 0 of every block: the share of its cycles in
the copy wait and barrier, the copies' issue, the fold and the
products).  Every variant prints the registers, spills and shared
memory ptxas reports for the conv kernels of its formats (``-Xptxas
-v``) and the resident blocks an SM takes from them.

The variants of the synchronous kernel (VARIANTS): base; nofold,
noproducts, nocopies (each compiled out, the split); f64_m8n8k4 (float64
on m8n8k4, the parent's DMMA shape); f64_lines1 (float64 steps of one
line, 8 stages); ahead (S - 1 steps in flight, a stage refilled one step
after its read); unroll4, unroll32 (the fp32 depth loop's unrolling).

``--rates`` builds and runs tests/torch_port/dmma_rate.cu (the DMMA
shapes and the FFMA thread tile) and times torch.matmul in float64 and
in float32 (TF32 off) at the conv's dense GEMM shape, 65,536 x 576 by
576 x 4096 (a yardstick of the card, not of K3).
"""
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import conv_ws_variants as wsv  # noqa: E402

ROOT = Path.cwd()
CONV = "xgpr_tpu_torch/ops/cuda/csrc/conv.cuh"
GEMM = "xgpr_tpu_torch/ops/cuda/csrc/tf32_gemm.cuh"
FMA_TU = "xgpr_tpu_torch/ops/cuda/csrc/conv_fma.cu"
F64_TU = "xgpr_tpu_torch/ops/cuda/csrc/conv_f64.cu"
SYNC = "xgpr_tpu_torch/ops/cuda/csrc/conv_sync.cuh"
SOURCES = ["conv.cu", "conv_fma.cu", "conv_f64.cu"]

# The parent's implicit GEMM (conv.cuh's conv_window_kernel on
# tf32_gemm.cuh's gemm_loop).
_PARENT_FOLD = """    const int j0 = gi * WG;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (j0 + h < nk_s) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            epi.fold(0, j, e, acc[4 * j + 2 * h + e]);
      }
"""
# The accumulators stay live without the fold: one sum a group.
_SINK = """    T sink = T(0);
#pragma unroll
    for (int i = 0; i < 64; ++i) sink += acc[i];
    if (sink == T(-1.25e-30)) epi.fold(0, 0, 0, sink + T(gi));
"""
_PARENT_PRODUCTS = """  if constexpr (FMT == FMT_F64) {
    dmma_products(a, b, acc, overwrite);
  } else if constexpr (FMT == FMT_FMA32) {
    fma_products(a, b, acc, overwrite);
  } else {"""
_PARENT_COPY = """    const size_t at = off * B::ELEM;
    cp_async16(dst, static_cast<const char*>(hi) + at, ok);
    if constexpr (B::PLANES == 2)
      cp_async16(dst + A_BYTES, static_cast<const char*>(lo) + at, ok);
"""
_PARENT_RING = "  unsigned char* smem = ring_base(smem_raw);\n"
_ZERO_RING = """  unsigned char* smem = ring_base(smem_raw);
  for (int i = threadIdx.x; i < STAGES * Body<FMT>::STAGE / 16; i += GT)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
"""
_PARENT_LOOP = """  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
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
"""
_TIMED_LOOP = """  long long tl[4] = {0, 0, 0, 0};
  for (int step = 0; step < nsteps; ++step) {
    const long long c0 = clock64();
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    __syncthreads();
    const long long c1 = clock64();
    if (step + 2 < nsteps) load(step + 2);
    cp_async_commit();
    if constexpr (!Body<FMT>::SYNC) {
      wgmma_wait_all();
      fence_acc(acc);
    }
    const long long c2 = clock64();
    if ((step + 1) % spg == 0) done(step / spg);  // the group is complete
    tl_fence(acc);
    const long long c3 = clock64();
    if (step + 1 < nsteps) issue(step + 1, (step + 1) % spg == 0);
    tl_fence(acc);
    const long long c4 = clock64();
    tl[0] += c1 - c0;
    tl[1] += c2 - c1;
    tl[2] += c3 - c2;
    tl[3] += c4 - c3;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      atomicAdd(&xgpr_tl[i], (unsigned long long)tl[i]);
    atomicAdd(&xgpr_tl[4], 1ull);
  }
"""
_TL_DECL = """namespace xgpr {

// clock64 sums of thread 0 of every block: wait + barrier, copy issue,
// fold, products; blocks.
static __device__ unsigned long long xgpr_tl[5];
__device__ __forceinline__ void tl_fence(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void tl_fence(double* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+d"(d[i])::"memory");
}
"""


def _reader(tag):
    return f"""
extern "C" int xgpr_timeline_{tag}(unsigned long long* host) {{
  cudaError_t err = cudaMemcpyFromSymbol(host, xgpr::xgpr_tl,
                                         sizeof(xgpr::xgpr_tl));
  const unsigned long long zero[5] = {{0, 0, 0, 0, 0}};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(xgpr::xgpr_tl, zero, sizeof(zero));
  return (int)err;
}}
"""


PARENT_VARIANTS = {
    "parent": [],
    "parent_nofold": [(CONV, _PARENT_FOLD, _SINK)],
    "parent_noproducts": [(GEMM, _PARENT_PRODUCTS,
                           "  if constexpr (Body<FMT>::SYNC) {\n"
                           "    (void)a; (void)b; (void)overwrite;\n"
                           "  } else {")],
    "parent_nocopies": [(CONV, _PARENT_COPY,
                         "    (void)dst; (void)hi; (void)lo; (void)off; "
                         "(void)ok;\n"),
                        (CONV, _PARENT_RING, _ZERO_RING)],
    "parent_timeline": [(GEMM, "namespace xgpr {\n", _TL_DECL),
                        (GEMM, _PARENT_LOOP, _TIMED_LOOP),
                        (FMA_TU, "}  // namespace xgpr\n",
                         "}  // namespace xgpr\n" + _reader("fma")),
                        (F64_TU, "}  // namespace xgpr\n",
                         "}  // namespace xgpr\n" + _reader("f64"))],
}

# Variants of the synchronous kernel (csrc/conv_sync.cuh).
_FOLD = "      tile.fold(epi, acc, nk, j0);\n"
_SYNC_SINK = """      T sink = T(0);
#pragma unroll
      for (int i = 0; i < Tile::ACC; ++i) sink += acc[i];
      if (sink == T(-1.25e-30)) epi.fold(0, 0, 0, sink + T(j0));
"""
_PRODUCTS = "    tile.products(smem + st * Tile::STAGE, acc);\n"
_LOAD = "    tile.load(p, next, smem + st * Tile::STAGE);\n"
_RING = "  unsigned char* smem = ring_base(smem_raw);\n"
_SYNC_ZERO = """  unsigned char* smem = ring_base(smem_raw);
  for (int i = threadIdx.x; i < S * Tile::STAGE / 16; i += THREADS)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
"""
# The fp32 register tile's depth loop (fma_gemm.cuh: fma_step).
FMA_H = "xgpr_tpu_torch/ops/cuda/csrc/fma_gemm.cuh"
_FMA_LOOP = "#pragma unroll 8\n  for (int k = 0; k < KS; ++k) fma_channel("
VARIANTS = {
    "base": [],
    "nofold": [(SYNC, _FOLD, _SYNC_SINK)],
    "noproducts": [(SYNC, _PRODUCTS, "    (void)acc;\n")],
    "nocopies": [(SYNC, _LOAD, ""), (SYNC, _RING, _SYNC_ZERO)],
    # float64 on m8n8k4 (half the FP64 rate): four products a chunk,
    # each window its own 8 x 8 tile.
    "f64_m8n8k4": [(SYNC, """            dmma16x8x8(&acc[4 * (4 * m + n)], a[m][0].x, a[m][1].x,
                       a[m][0].y, a[m][1].y, b[n].x, b[n].y);
""", """            {
              double* cc = &acc[4 * (4 * m + n)];
              dmma(cc[0], cc[1], a[m][0].x, b[n].x);
              dmma(cc[2], cc[3], a[m][1].x, b[n].x);
              dmma(cc[0], cc[1], a[m][0].y, b[n].y);
              dmma(cc[2], cc[3], a[m][1].y, b[n].y);
            }
""")],
    # float64 steps of one 128-byte line, 8 stages.
    "f64_lines1": [(SYNC, """  static constexpr int LINES = 2;
  static constexpr int KS = 16 * LINES;
  static constexpr int STAGES = 4;
""", """  static constexpr int LINES = 1;
  static constexpr int KS = 16 * LINES;
  static constexpr int STAGES = 8;
""")],
    # S - 1 steps in flight ahead of the products, not S - 2: a stage is
    # refilled once every warp has released the step before.
    "ahead": [(SYNC, "  while (q < S - 2 && q < nsteps) issue();\n",
               "  while (q < S - 1 && q < nsteps) issue();\n")],
    # The fp32 products' depth loop unrolled by 4 or 32, not 8.
    "unroll4": [(FMA_H, _FMA_LOOP,
                 "#pragma unroll 4\n  for (int k = 0; k < KS; ++k) fma_channel(")],
    "unroll32": [(FMA_H, _FMA_LOOP,
                  "#pragma unroll\n  for (int k = 0; k < KS; ++k) fma_channel(")],
}


def ptxas_report(log):
    """(kernel, registers, spill bytes, static smem) of the conv kernels
    of the synchronous formats in an nvcc -Xptxas -v log."""
    rows, name, spills = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), None
            continue
        # ptxas prints a function's spills before its registers.
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and ("conv" in name):
            rows.append([name, int(m.group(1)), spills])
    return rows


def resident_blocks(regs, threads):
    """Blocks of ``threads`` an H100 SM holds by their registers (64K,
    allocated per warp in units of 256; at most 64 warps)."""
    per_warp = -(-regs * 32 // 256) * 256
    warps = threads // 32
    return min((65536 // per_warp) // warps, 64 // warps)


def build_variant(name):
    """Runs in a variant's copy: the build, with ptxas's report of the
    conv kernels."""
    sys.path.insert(0, str(Path.cwd()))
    from xgpr_tpu_torch.ops.cuda import build
    build.build(["-Xptxas", "-v"])
    for kernel, regs, spills in ptxas_report(build.BUILD_LOG):
        print(f"PTXAS {name} {kernel[:100]} registers {regs}, spill "
              f"stores/loads {spills} bytes; blocks of 256 threads an SM "
              f"by registers {resident_blocks(regs, 256)}", flush=True)


def timing(name):
    """Runs in a variant's copy: the launch alone at the motif chunk, each
    format; the timeline variant also reads its clock64 sums."""
    import ctypes
    sys.path.insert(0, str(Path.cwd()))
    import numpy as np
    import torch
    import chip_smoke as cs
    from xgpr_tpu_torch.kernels import Conv1dRBF, Conv1dTwoLayer
    from xgpr_tpu_torch.ops.conv import conv_row_scale
    from xgpr_tpu_torch.ops.cuda import build, conv
    lib = build.library()
    x_np, _, l_np = cs.motif_corpus(cs.CHUNK)
    dev, w = "cuda", cs.MOTIF_W
    xdim = (cs.CHUNK, cs.MOTIF_L, cs.MOTIF_D)
    x32 = torch.as_tensor(x_np, device=dev)
    lens = torch.as_tensor(l_np, device=dev)
    sigma = float(np.exp(cs.MOTIF_HPARAMS[1]))
    p4 = Conv1dTwoLayer(xdim, cs.K4_RFFS, cs.SEED, device=dev,
                        kernel_spec_parms={"conv_width": w,
                                           "init_rffs": cs.INIT_RFFS}
                        )._dense_projs()[0]
    p3s = [Conv1dRBF(xdim, rffs, cs.SEED, device=dev,
                     kernel_spec_parms={"conv_width": w})._dense_proj()
           for rffs in (cs.NUM_RFFS, cs.TUNE_RFFS, cs.VERIFY_RFFS)]
    timeline = getattr(lib, "xgpr_timeline_fma", None)

    def twice(fn):
        return "/".join(f"{cs.time_ms(torch, fn, reps=20):.4f}"
                        for _ in range(2))

    def split(tag, fn):
        reader = getattr(lib, f"xgpr_timeline_{tag}")
        buf = (ctypes.c_ulonglong * 5)()
        fn()
        torch.cuda.synchronize()
        reader(buf)
        fn()
        torch.cuda.synchronize()
        reader(buf)
        total = sum(buf[:4]) or 1
        return (f" [thread 0: {buf[4]} blocks, {total / max(buf[4], 1):.0f} "
                f"cycles a block; wait+barrier {buf[0] / total:.1%}, copy "
                f"issue {buf[1] / total:.1%}, fold {buf[2] / total:.1%}, "
                f"products {buf[3] / total:.1%}]")

    for tag, dtype in (("fma32", torch.float32), ("f64", torch.float64)):
        x = x32.to(dtype)
        precision = "highest"
        rows = []
        for p3 in p3s:
            p = p3.to(dtype)
            scale = conv_row_scale(lens, w, p.shape[1], 0, dtype, dev)
            out, launch = conv.parts_launcher(x, lens, p, sigma, w, scale,
                                              "exact", precision)
            row = f"K3 F{p.shape[1]} " + twice(launch)
            if p.shape[1] == p3s[0].shape[1]:
                want = conv.conv_parts_plain(x, lens, p, sigma, w, scale,
                                             "exact", precision)
                err = max(float((a - b).abs().max())
                          for a, b in zip(out, want))
                row += f" err {err:.2e}"
            if timeline is not None and p.shape[1] == p3s[0].shape[1]:
                row += split("fma" if tag == "fma32" else "f64", launch)
            rows.append(row)
        launch4 = conv.maxpool_launcher(x, lens, p4.to(dtype), w,
                                        precision)[1]
        rows.append("K4 F1024 " + twice(launch4))
        print("VARIANT", name, tag, " | ".join(rows), f"[{cs.card_line()}]",
              flush=True)


def rates():
    """dmma_rate.cu's rates, then torch.matmul at the conv's GEMM shape."""
    import torch
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from xgpr_tpu_torch.ops.cuda import build
    out = ROOT / "build" / "dmma_rate"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = Path(__file__).resolve().parent / "dmma_rate.cu"
    subprocess.run([build._nvcc()] + build.NVCC_FLAGS[:6] +
                   ["-o", str(out), str(src)], check=True)
    subprocess.run([str(out)], check=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = 65536, 576, 4096
    for dtype in (torch.float64, torch.float32):
        a = torch.randn(m, k, device="cuda", dtype=dtype)
        b = torch.randn(k, n, device="cuda", dtype=dtype)
        for _ in range(2):
            ms = cs.time_ms(torch, lambda: torch.matmul(a, b), reps=10)
            print(f"RATE torch.matmul {dtype} {m} x {k} @ {k} x {n} (TF32 "
                  f"off): {ms:.4f} ms, {2 * m * k * n / ms / 1e9:.2f} "
                  f"TFLOP/s [{cs.card_line()}]", flush=True)


def main(argv):
    if len(argv) > 1 and argv[0] == "--time":
        timing(argv[1])
        return
    if len(argv) > 1 and argv[0] == "--build":
        build_variant(argv[1])
        return
    if argv and argv[0] == "--rates":
        rates()
        return
    if argv and argv[0] == "--parent":
        src, table = Path(argv[1]).resolve(), PARENT_VARIANTS
        names = argv[2:] or list(table)
    else:
        src, table = ROOT, VARIANTS
        names = argv or list(table)
    dirs = {n: wsv.make(src, n, table[n], SOURCES) for n in names}
    procs = {n: subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--build", n],
        cwd=d) for n, d in dirs.items()}
    built = {n: p.wait() == 0 for n, p in procs.items()}
    for n, d in dirs.items():
        if not built[n]:
            print("VARIANT", n, "build failed", flush=True)
            continue
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--time", n], cwd=d, check=False)


if __name__ == "__main__":
    main(sys.argv[1:])
