"""Split and time K3/K4's 3xTF32 body (csrc/conv_tf32.cuh, "high" under the
"balanced" preset) on the card.

Each variant is a copy of the package under build/variants/<name> whose
sources take one named set of patches (below), built from the conv
sources alone (``conv_ws_variants.make``) with ptxas's report of the conv
kernels' registers and spills; all builds run side by side, then each
variant times, in a process of its own, at the motif chunk (chip_smoke.py's
corpus and models): K3 "hi" at F 4096, 1024 and 128 and K4 at F 1024, the
launch alone (``conv.parts_launcher`` / ``maxpool_launcher``, CUDA events,
2 x 20 calls after a warm-up) and the whole wrapper (the preparation
included), with the error at F 4096 (K3) and 1024 (K4) against the plain
versions and a SHA-256 of the outputs' bits; one line a variant:

    VARIANT <name> K3 F4096 <ms>/<ms> wrapper <ms>/<ms> err <e> sha <h> |
        ... | K4 F1024 <ms>/<ms> wrapper <ms>/<ms> err <e> sha <h>

``--time <label>`` runs that timing alone on the package of the working
directory, which may be an older tree (``parts_launcher`` is its only
need): the parent and the change in turns in one call, e.g.
``(cd build/parent && python ../../tests/torch_port/conv_tf32_variants.py
--time parent)``.

From the root of a checkout on the card:

    python tests/torch_port/conv_tf32_variants.py [name ...]
    python tests/torch_port/conv_tf32_variants.py --parent DIR [name ...]
    python tests/torch_port/conv_tf32_variants.py --rates
    python tests/torch_port/conv_tf32_variants.py --clocks

``--parent DIR`` (a tree of the commit before the pipeline, e.g. ``git
archive d08b120 | tar -x -C build/parent``) splits that tree's 3xTF32
body (the implicit GEMM of conv.cuh on the ring of tf32_gemm.cuh;
PARENT_VARIANTS): the launch as it is, then with the fold, the products or
the copies compiled out, and a clock64 timeline (thread 0 of every block:
the share of its cycles in the copy wait and barrier, the copies' issue,
the fold and the products).  ``--rates`` builds and runs
tests/torch_port/tf32_rate.cu (TF32 wgmma at m64n64k8 and m64n128k8 with
one and two warpgroups issuing; TMA boxes from L2 alone and multicast to
clusters of 2 and 4).  ``--clocks`` samples the SM clock and the power
(nvidia-smi) idle and while K3's launch at F 4096 repeats for 6 s.

The variants of the pipeline (VARIANTS): base; nofold, noproducts and
nocopies (each compiled out: the fold, the wgmma products, the TMA
copies, whose bytes the producer then counts on its barriers itself);
p3x8, p5x4 (the rings' 224 KB as 3 projT and 8 position stages, or 5
and 4, in place of 4 and 6); offset (consumer 1 starts two lines after
consumer 0, so that one warpgroup's fold may meet the other's products);
timeline (a clock64 split of the consumers' cycles and each block's
span); nostores (the outputs' stores compiled out).
"""
import hashlib
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import conv_sync_variants as csv  # noqa: E402
import conv_ws_variants as wsv  # noqa: E402

ROOT = Path.cwd()
CONV = "xgpr_tpu_torch/ops/cuda/csrc/conv.cuh"
GEMM = "xgpr_tpu_torch/ops/cuda/csrc/tf32_gemm.cuh"
# This tree's shared header (the timeline's counters).
CSRC_COMMON = "xgpr_tpu_torch/ops/cuda/csrc/gemm_common.cuh"
CONV_TU = "xgpr_tpu_torch/ops/cuda/csrc/conv.cu"
TF32 = "xgpr_tpu_torch/ops/cuda/csrc/conv_tf32.cuh"

_PARENT_PRODUCTS = """#pragma unroll
      for (int kk = 0; kk < GK / 8; ++kk) {
        wgmma_tf32(acc, al + 2 * kk, bh + 2 * kk, kk > 0 || !overwrite);
        wgmma_tf32(acc, ah + 2 * kk, bl + 2 * kk, 1);
        wgmma_tf32(acc, ah + 2 * kk, bh + 2 * kk, 1);
      }
"""
PARENT_VARIANTS = {
    "parent": [],
    "parent_nofold": [(CONV, csv._PARENT_FOLD, csv._SINK)],
    "parent_noproducts": [(GEMM, _PARENT_PRODUCTS,
                           "      (void)al; (void)bl;\n")],
    "parent_nocopies": [(CONV, csv._PARENT_COPY,
                         "    (void)dst; (void)hi; (void)lo; (void)off; "
                         "(void)ok;\n"),
                        (CONV, csv._PARENT_RING, csv._ZERO_RING)],
    "parent_timeline": [(GEMM, "namespace xgpr {\n", csv._TL_DECL),
                        (GEMM, csv._PARENT_LOOP, csv._TIMED_LOOP),
                        (CONV_TU, "using namespace xgpr::conv;\n",
                         "using namespace xgpr::conv;\n"
                         + csv._reader("tf32"))],
}

_FOLD = """        const bool builtin = epi.needs_builtin(acc[v]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (j + v < nk_h[h]) epi.fold_row(acc[v], h, builtin);
"""
# The accumulators stay live without the fold: one sum a window.
_SINK = """        float sink = 0.0f;
#pragma unroll
        for (int k = 0; k < 32; ++k) sink += acc[v][k];
        if (sink == -1.25e-30f) epi.fold_row(acc[v], 0, false);
"""
_PRODUCTS = """  if (both) {
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
"""
# No copies: the producer completes each full barrier's bytes itself
# (expect_tx, then complete_tx), so the rings keep their order, over
# stages zeroed once.
_X_COPY = ("      tma_box4(xring + st * X_BOX, &xmap, &xfull[st], CH * kk, "
           "pos, row0, 0);\n")
_X_NO_COPY = """      (void)pos; (void)kk; (void)row0;
      asm volatile("mbarrier.complete_tx.shared::cta.b64 [%0], %1;\\n" ::
                       "r"(saddr(&xfull[st])), "r"(X_BOX) : "memory");
"""
_P_COPIES = """            tma_box(dst, &hmap, &pfull[st], CH * kk, t, f0);
            tma_box(dst + P_PLANE, &lmap, &pfull[st], CH * kk, t, f0);
"""
_P_NO_COPIES = """            (void)dst;
            asm volatile("mbarrier.complete_tx.shared::cta.b64 [%0], %1;\\n"
                         :: "r"(saddr(&pfull[st])), "r"(P_BOX) : "memory");
"""
_STAGES = "constexpr int P_STAGES = 4;\nconstexpr int X_STAGES = 6;\n"
_RING_BASE = "  unsigned char* xring = pring + P_STAGES * P_BOX;\n"
_ZEROED_RINGS = _RING_BASE + (
    "  for (int i = threadIdx.x; i < (SMEM - 1024) / 16; i += THREADS)\n"
    "    reinterpret_cast<int4*>(pring)[i] = make_int4(0, 0, 0, 0);\n")
# Consumer 1 starts two lines after consumer 0, so that one warpgroup's
# fold meets the other's products.
_OFFSET = [
    (TF32, "  __shared__ __align__(8) uint64_t xfull[X_STAGES], "
           "xempty[X_STAGES];\n",
     "  __shared__ __align__(8) uint64_t xfull[X_STAGES], "
     "xempty[X_STAGES];\n  __shared__ __align__(8) uint64_t kick;\n"),
    (TF32, "    asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: "
           "\"memory\");\n",
     "    mbar_init(&kick, 4);\n"
     "    asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: "
     "\"memory\");\n"),
    (TF32, "  for (int k = 0; k < 32; ++k) acc[0][k] = acc[1][k] = 0.0f;\n",
     "  for (int k = 0; k < 32; ++k) acc[0][k] = acc[1][k] = 0.0f;\n"
     "  bool kicked = c == 1;\n  int issued = 0;\n"
     "  if (c == 1) mbar_wait(&kick, 0);\n"),
    (TF32, "                     t == 0 && kk == 0, j + 1 < top);\n",
     "                     t == 0 && kk == 0, j + 1 < top);\n"
     "          if (!kicked && ++issued == 2) {\n"
     "            __syncwarp();\n"
     "            if (lane == 0) mbar_arrive(&kick);\n"
     "            kicked = true;\n          }\n"),
    (TF32, "            if (col + e < p.f) epi.store(at + col + e, scale, h, "
           "jj, e);\n        }\n      }\n    }\n  }\n}\n",
     "            if (col + e < p.f) epi.store(at + col + e, scale, h, "
     "jj, e);\n        }\n      }\n    }\n  }\n"
     "  if (!kicked) {\n    __syncwarp();\n"
     "    if (lane == 0) mbar_arrive(&kick);\n  }\n}\n"),
]
# A clock64 timeline of the consumers (thread 0 of warpgroup 1 in every
# block): waits on full barriers, the products' issue, the wait for the
# line before and its releases, the pair's end (wait_group 0 and the
# fold); the rest of a block's cycles (tile set-up, stores) is not
# counted.
_LINE = """          mbar_wait(&pfull[ps.stage], ps.parity);
          mbar_wait(&xfull[xa.stage], xa.parity);
          mbar_wait(&xfull[xb.stage], xb.parity);
          issue_line(acc, x_desc + xa.stage * X_STEP,
                     x_desc + xb.stage * X_STEP, p_desc + ps.stage * P_STEP,
                     t == 0 && kk == 0, j + 1 < top);
          if (t > 0 || kk > 0) {  // the line before is complete: free it
"""
_TIMED_LINE = """          const long long c0 = clock64();
          mbar_wait(&pfull[ps.stage], ps.parity);
          mbar_wait(&xfull[xa.stage], xa.parity);
          mbar_wait(&xfull[xb.stage], xb.parity);
          const long long c1 = clock64();
          issue_line(acc, x_desc + xa.stage * X_STEP,
                     x_desc + xb.stage * X_STEP, p_desc + ps.stage * P_STEP,
                     t == 0 && kk == 0, j + 1 < top);
          const long long c2 = clock64();
          tl[0] += c1 - c0;
          tl[1] += c2 - c1;
          if (t > 0 || kk > 0) {  // the line before is complete: free it
"""
_STEP = "          ps.step(1, P_STAGES);\n"
_PAIR_END = "      wgmma_wait<0>();\n      fence_acc32(acc[0]);\n"
_FOLD_END = ("          if (j + v < nk_h[h]) "
             "epi.fold_row(acc[v], h, builtin);\n      }\n")
_ACC = "  float acc[2][32];\n"
_KERNEL_END = "      }\n    }\n  }\n}\n\n// xt: (2, n, l, dp)"
# Beside the split, each block's span on the same thread: its cycles and
# nanoseconds (%globaltimer) from the consumers' start to their end, the
# sums and the largest, so that cycles over nanoseconds is the clock.
_SPAN_DECL = """namespace xgpr {

// The timed thread's span in every block: sum of cycles, sum of ns,
// largest ns, blocks.
static __device__ unsigned long long xgpr_span[4];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""
_SPAN_READER = """
extern "C" int xgpr_span_tf32(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, xgpr::xgpr_span,
                                         sizeof(xgpr::xgpr_span));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(xgpr::xgpr_span, zero, sizeof(zero));
  return (int)err;
}
"""
_TIMELINE = [
    (CSRC_COMMON, "namespace xgpr {\n", csv._TL_DECL),
    (TF32, "namespace xgpr {\n", _SPAN_DECL),
    (CONV_TU, "using namespace xgpr::conv;\n",
     "using namespace xgpr::conv;\n" + csv._reader("tf32") + _SPAN_READER),
    (TF32, _ACC, "  long long tl[4] = {0, 0, 0, 0};\n"
                 "  const long long span_c = clock64();\n"
                 "  const unsigned long long span_t = global_ns();\n" + _ACC),
    (TF32, _LINE, _TIMED_LINE),
    (TF32, _STEP, "          tl[2] += clock64() - c2;\n" + _STEP),
    (TF32, _PAIR_END, "      const long long e0 = clock64();\n" + _PAIR_END),
    (TF32, _FOLD_END, _FOLD_END + "      tl[3] += clock64() - e0;\n"),
    (TF32, _KERNEL_END,
     "      }\n    }\n  }\n  if (threadIdx.x == 128) {\n"
     "    for (int i = 0; i < 4; ++i)\n"
     "      atomicAdd(&xgpr_tl[i], (unsigned long long)tl[i]);\n"
     "    atomicAdd(&xgpr_tl[4], 1ull);\n"
     "    const unsigned long long ns = global_ns() - span_t;\n"
     "    atomicAdd(&xgpr_span[0], "
     "(unsigned long long)(clock64() - span_c));\n"
     "    atomicAdd(&xgpr_span[1], ns);\n"
     "    atomicMax(&xgpr_span[2], ns);\n"
     "    atomicAdd(&xgpr_span[3], 1ull);\n"
     "  }\n}\n\n// xt: (2, n, l, dp)"),
]
VARIANTS = {
    "base": [],
    "nofold": [(TF32, _FOLD, _SINK)],
    "noproducts": [(TF32, _PRODUCTS,
                    "  (void)XL; (void)PL; (void)both; (void)overwrite;\n")],
    "nocopies": [(TF32, _X_COPY, _X_NO_COPY), (TF32, _P_COPIES, _P_NO_COPIES),
                 (TF32, _RING_BASE, _ZEROED_RINGS)],
    # The same 224 KB of rings split otherwise: 3 projT stages and 8
    # position stages, or 5 and 4.
    "p3x8": [(TF32, _STAGES, _STAGES.replace("4;", "3;").replace("6;", "8;"))],
    "p5x4": [(TF32, _STAGES, _STAGES.replace("4;", "5;").replace("6;", "4;"))],
    "offset": _OFFSET,
    "timeline": _TIMELINE,
    # The outputs' stores compiled out (kept live behind a test that
    # never holds).
    "nostores": [(TF32,
                  "          epi.store_pair(at + col, scale, h, jj);\n",
                  "          if (scale == -1.25e-30f)\n"
                  "            epi.store_pair(at + col, scale, h, jj);\n")],
}


def sha(tensors):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                   for t in tensors)).hexdigest()[:12]


def timing(name):
    """Runs in a variant's copy: the launches alone at the motif chunk,
    the wrapper at F 4096 and 128; the timeline variant also reads its
    clock64 sums."""
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
    x = torch.as_tensor(x_np, device=dev)
    lens = torch.as_tensor(l_np, device=dev)
    sigma = float(np.exp(cs.MOTIF_HPARAMS[1]))
    p4 = Conv1dTwoLayer(xdim, cs.K4_RFFS, cs.SEED, device=dev,
                        kernel_spec_parms={"conv_width": w,
                                           "init_rffs": cs.INIT_RFFS}
                        )._dense_projs()[0]
    reader = getattr(lib, "xgpr_timeline_tf32", None)

    def twice(fn):
        return "/".join(f"{cs.time_ms(torch, fn, reps=20):.4f}"
                        for _ in range(2))

    def split(fn):
        buf = (ctypes.c_ulonglong * 5)()
        for _ in range(2):  # the second launch alone
            fn()
            torch.cuda.synchronize()
            reader(buf)
        total = sum(buf[:4]) or 1
        shares = ", ".join(f"{label} {b / total:.1%}"
                           for label, b in zip(labels, buf[:4]))
        text = (f" [{who}: {buf[4]} blocks, {total / max(buf[4], 1):.0f} "
                f"cycles a block; {shares}")
        span = getattr(lib, "xgpr_span_tf32", None)
        if span is not None:
            sp = (ctypes.c_ulonglong * 4)()
            span(sp)             # the two launches above
            n = max(sp[3], 1)
            text += (f"; span {sp[0] / n:.0f} cycles, {sp[1] / n / 1e3:.1f} "
                     f"us a block (largest {sp[2] / 1e3:.1f} us), clock "
                     f"{sp[0] / max(sp[1], 1):.3f} GHz")
        return text + "]"

    if hasattr(conv, "tf32_plan"):
        who = "consumer thread 0 of warpgroup 1"
        labels = ("full-barrier waits", "products' issue",
                  "line before's wait and release", "pair end and fold")
    else:
        who = "thread 0"
        labels = ("wait+barrier", "copy issue", "fold", "products")

    rows = []
    for rffs in (cs.NUM_RFFS, cs.TUNE_RFFS, cs.VERIFY_RFFS):
        p3 = Conv1dRBF(xdim, rffs, cs.SEED, device=dev,
                       kernel_spec_parms={"conv_width": w})._dense_proj()
        f = p3.shape[1]
        scale = conv_row_scale(lens, w, f, 0, torch.float32, dev)
        out, launch = conv.parts_launcher(x, lens, p3, sigma, w, scale, "hi",
                                          "high")
        row = f"K3 F{f} " + twice(launch) + " wrapper " + twice(
            lambda: conv.conv_parts(x, lens, p3, sigma, w, scale, "hi",
                                    "high"))
        if f == cs.NUM_RFFS // 2:
            launch()
            want = conv.conv_parts_plain(x, lens, p3, sigma, w, scale, "hi",
                                         "high")
            err = max(float((a - b).abs().max()) for a, b in zip(out, want))
            row += f" err {err:.2e} sha {sha(out)}"
            if reader is not None:
                row += split(launch)
        rows.append(row)
    out4, launch4 = conv.maxpool_launcher(x, lens, p4, w, "high")
    launch4()
    want4 = conv.conv_maxpool_plain(x, lens, p4, w, "high")
    rows.append(f"K4 F{p4.shape[1]} " + twice(launch4) + " wrapper " +
                twice(lambda: conv.conv_maxpool(x, lens, p4, w, "high")) +
                f" err {float((out4 - want4).abs().max()):.2e} "
                f"sha {sha([out4])}")
    print("VARIANT", name, " | ".join(rows), f"[{cs.card_line()}]",
          flush=True)


def clocks(seconds=6.0):
    """The SM clock and the power the card draws (nvidia-smi, sampled
    every 100 ms) idle and while the launch of K3 "hi" at F 4096 repeats
    for ``seconds``; prints the medians and the launch's time from CUDA
    events over the same loop."""
    import statistics
    import time
    sys.path.insert(0, str(Path.cwd()))
    import numpy as np
    import torch
    import chip_smoke as cs
    from xgpr_tpu_torch.kernels import Conv1dRBF
    from xgpr_tpu_torch.ops.conv import conv_row_scale
    from xgpr_tpu_torch.ops.cuda import conv
    x_np, _, l_np = cs.motif_corpus(cs.CHUNK)
    dev, w = "cuda", cs.MOTIF_W
    x = torch.as_tensor(x_np, device=dev)
    lens = torch.as_tensor(l_np, device=dev)
    p3 = Conv1dRBF((cs.CHUNK, cs.MOTIF_L, cs.MOTIF_D), cs.NUM_RFFS, cs.SEED,
                   device=dev, kernel_spec_parms={"conv_width": w}
                   )._dense_proj()
    scale = conv_row_scale(lens, w, p3.shape[1], 0, torch.float32, dev)
    launch = conv.parts_launcher(x, lens, p3, float(np.exp(
        cs.MOTIF_HPARAMS[1])), w, scale, "hi", "high")[1]
    launch()
    torch.cuda.synchronize()
    query = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"]

    def sample(work):
        proc = subprocess.Popen(query, stdout=subprocess.PIPE, text=True)
        time.sleep(0.5)
        out = work()
        time.sleep(0.2)
        proc.terminate()
        rows = [line.split(",") for line in proc.communicate()[0].split(
            "\n") if line.count(",") == 1]
        mhz = [float(a) for a, _ in rows[5:-2] or rows]
        watts = [float(b) for _, b in rows[5:-2] or rows]
        return statistics.median(mhz), statistics.median(watts), out

    def loop():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        n, t0 = 0, time.perf_counter()
        start.record()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                launch()
            n += 50
            torch.cuda.synchronize()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    idle = sample(lambda: time.sleep(2.0))
    busy = sample(loop)
    print(f"CLOCKS idle: SM {idle[0]:.0f} MHz, {idle[1]:.1f} W; K3 F4096 "
          f"launch repeated {seconds:.0f} s: {busy[2]:.4f} ms a launch, SM "
          f"{busy[0]:.0f} MHz, {busy[1]:.1f} W (medians) "
          f"[{cs.card_line()}]", flush=True)


def rates():
    """tf32_rate.cu's rates."""
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from xgpr_tpu_torch.ops.cuda import build
    out = ROOT / "build" / "tf32_rate"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = Path(__file__).resolve().parent / "tf32_rate.cu"
    subprocess.run([build._nvcc()] + build.NVCC_FLAGS[:6] +
                   ["-o", str(out), str(src)], check=True)
    subprocess.run([str(out)], check=True)
    print(f"RATE card [{cs.card_line()}]", flush=True)


def main(argv):
    if len(argv) > 1 and argv[0] == "--time":
        timing(argv[1])
        return
    if len(argv) > 1 and argv[0] == "--build":
        csv.build_variant(argv[1])
        return
    if argv and argv[0] == "--rates":
        rates()
        return
    if argv and argv[0] == "--clocks":
        clocks()
        return
    if argv and argv[0] == "--parent":
        src, table = Path(argv[1]).resolve(), PARENT_VARIANTS
        names = argv[2:] or list(table)
        sources = ["conv.cu"]
    else:
        src, table = ROOT, VARIANTS
        names = argv or list(table)
        sources = ["conv.cu", "conv_bf16.cu"]
    dirs = {n: wsv.make(src, n, table[n], sources) for n in names}
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
