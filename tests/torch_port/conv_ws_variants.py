"""Time variants of K3/K4's bf16 pipeline (csrc/conv_ws.cuh) on the card.

Each variant is a copy of the package under build/variants/<name> whose
sources take one named set of patches (below), built from the conv
sources alone into the copy's own build directory; all builds run side
by side, then each variant times, in a process of its own, the launch
alone (``conv.parts_launcher`` / ``maxpool_launcher``, CUDA events, 2 x
20 calls after a warm-up) of K3 bf16 "fast" at F 4096, 1024 and 128 and
of K4 bf16 at F 1024, at the motif chunk (chip_smoke.py's corpus and
models), and prints one line:

    VARIANT <name> K3 F4096 <ms>/<ms> | K3 F1024 ... | K4 F1024 ...

From the root of a checkout on the card:

    python tests/torch_port/conv_ws_variants.py [name ...]

With ``--parent DIR`` (a tree of the commit before the pipeline, e.g.
``git archive 4c1bac6 | tar -x -C build/parent``) it splits that
tree's bf16 body instead (the implicit GEMM of conv.cuh): the wrapper,
its preparation and the launch alone, then the launch with the fold and
with the products compiled out (PARENT_VARIANTS).

The variants of the pipeline:
- base: the kernel as it is;
- nofold: the sincos (K3) or max (K4) fold compiled out;
- noproducts: the wgmma products compiled out;
- pingpong: the two consumer warpgroups issue their pairs in turn
  (a pair of mbarriers; each waits only for lines 0-1 of a pair but
  the tile's last);
- offset: consumer 1 starts once consumer 0 has issued half its first
  pair;
- fold_by_pair: the fold branches on a row's validity per frequency
  pair (2 evaluations a branch) instead of per row (16);
- release_at_end: a pair frees its positions when it completes, not
  each with the product that reads it last (resident plans only);
- threads288: a producer warp instead of a warpgroup, no setmaxnreg.
"""
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
OUT = ROOT / "build" / "variants"
WS = "xgpr_tpu_torch/ops/cuda/csrc/conv_ws.cuh"
CONV = "xgpr_tpu_torch/ops/cuda/csrc/conv.cuh"
GEMM = "xgpr_tpu_torch/ops/cuda/csrc/tf32_gemm.cuh"

_FOLD = """        const bool builtin = epi.needs_builtin(acc[v]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (j + v < nk_h[h]) epi.fold_row(acc[v], h, builtin);
"""
_PRODUCTS = """#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_bf16_n64(acc[0], d0 + 2 * kk, db + 2 * kk, kk > 0 || !overwrite);
    wgmma_bf16_n64(acc[1], d1 + 2 * kk, db + 2 * kk, kk > 0 || !overwrite);
  }
"""
_LINE_FREE = """          if (line > 0) {  // the line before is complete
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
"""
_AFTER_PAIR = """      if (free_b >= 0) release(&empty[free_b]);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
"""
_TURN_BARRIER = [
    (WS, "  __shared__ __align__(8) uint64_t proj_full;\n",
     "  __shared__ __align__(8) uint64_t proj_full, turn[2];\n"),
    (WS, "    mbar_init(&proj_full, 1);\n",
     "    mbar_init(&proj_full, 1);\n    mbar_init(&turn[0], 4);\n"
     "    mbar_init(&turn[1], 4);\n"),
]

VARIANTS = {
    "base": [],
    "nofold": [(WS, _FOLD, "        (void)v;\n")],
    "noproducts": [(WS, _PRODUCTS, "")],
    "pingpong": _TURN_BARRIER + [
        (WS, "  uint32_t q0 = 0;  // ring fills of the earlier tiles\n",
         "  uint32_t q0 = 0;  // ring fills of the earlier tiles\n"
         "  uint32_t turns = 0;\n"),
        (WS, "      const bool last = jp == pairs - 1;\n",
         "      const bool last = jp == pairs - 1;\n"
         "      if (p.resident)\n"
         "        mbar_wait(&turn[c], (turns & 1) ^ (c == 0 ? 1 : 0));\n"
         "      const bool eager = !p.resident || last;\n"
         "      const Slot first(q0 + j * kc, S);\n"
         "      bool freed = false;\n"),
        (WS, _LINE_FREE, """          if (eager) {
            if (line > 0) {
              wgmma_wait<1>();
              if (free_a >= 0) release(&empty[free_a]);
              if (free_b >= 0) release(&empty[free_b]);
            }
            if (p.resident) {
              free_a = t <= 1 || last ? a.stage : -1;
              free_b = t == w - 1 && (w == 1 || last) ? b.stage : -1;
            } else {
              free_a = a.stage;
            }
          } else if (line == 2 * kc) {
            wgmma_wait<1>();
            Slot f = first;
            for (int k = 0; k < 2 * kc; ++k) {
              release(&empty[f.stage]);
              f.step(1, S);
            }
            freed = true;
          }
          if (p.resident) b.step(1, S);
"""),
        (WS, "      wgmma_wait<0>();\n      fence_acc32(acc[0]);\n",
         "      if (p.resident) {\n        __syncwarp();\n"
         "        if (lane == 0) mbar_arrive(&turn[c ^ 1]);\n"
         "        ++turns;\n      }\n"
         "      wgmma_wait<0>();\n      fence_acc32(acc[0]);\n"),
        (WS, _AFTER_PAIR, """      if (free_b >= 0) release(&empty[free_b]);
      if (!eager && !freed) {
        Slot f = first;
        for (int k = 0; k < 2 * kc; ++k) {
          release(&empty[f.stage]);
          f.step(1, S);
        }
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
"""),
    ],
    "offset": [
        (WS, "  __shared__ __align__(8) uint64_t proj_full;\n",
         "  __shared__ __align__(8) uint64_t proj_full, kick;\n"),
        (WS, "    mbar_init(&proj_full, 1);\n",
         "    mbar_init(&proj_full, 1);\n    mbar_init(&kick, 4);\n"),
        (WS, "  int top = count > 0 ? p.top[b0] : 0;\n",
         "  int top = count > 0 ? p.top[b0] : 0;\n"
         "  bool kicked = c == 1;\n  int issued = 0;\n"
         "  if (c == 1) mbar_wait(&kick, 0);\n"),
        (WS, "          issue_pair(acc, d0, d1, db, line == 0);\n",
         "          issue_pair(acc, d0, d1, db, line == 0);\n"
         "          if (!kicked && ++issued > steps / 2) {\n"
         "            __syncwarp();\n"
         "            if (lane == 0) mbar_arrive(&kick);\n"
         "            kicked = true;\n          }\n"),
        (WS, "    top = next_top;\n  }\n}\n",
         "    top = next_top;\n  }\n  if (!kicked) {\n    __syncwarp();\n"
         "    if (lane == 0) mbar_arrive(&kick);\n  }\n}\n"),
    ],
    "fold_by_pair": [
        (CONV, "  __device__ __forceinline__ void fold_row(const float* acc, int h,\n",
         """  __device__ __forceinline__ void fold_one(const float* acc, int h,
                                           bool builtin, int j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float c, s;
      if (MODE == MODE_EXACT || builtin)
        sincos_scaled<MODE>(acc[4 * j + 2 * h + e] * a.sigma, 1.0f, &c, &s);
      else if constexpr (MODE != MODE_EXACT)
        sincos_mode_poly<MODE>(acc[4 * j + 2 * h + e] * a.sigma, 1.0f, &c,
                               &s);
      cs[h][j][e] = __fadd_rn(cs[h][j][e], c);
      sn[h][j][e] = __fadd_rn(sn[h][j][e], s);
    }
  }
  __device__ __forceinline__ void fold_row(const float* acc, int h,
"""),
        (CONV, "  __device__ __forceinline__ void fold_row(const T* acc, int h, bool) {\n",
         """  __device__ __forceinline__ void fold_one(const T* acc, int h, bool,
                                           int j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) fold(h, j, e, acc[4 * j + 2 * h + e]);
  }
  __device__ __forceinline__ void fold_row(const T* acc, int h, bool) {
"""),
        (WS, _FOLD, """        const bool builtin = epi.needs_builtin(acc[v]);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (j + v < nk_h[h]) epi.fold_one(acc[v], h, builtin, jj);
"""),
    ],
    "release_at_end": [
        (WS, _LINE_FREE, """          if (!p.resident && line > 0) {
            wgmma_wait<1>();
            if (free_a >= 0) release(&empty[free_a]);
          }
          if (p.resident)
            b.step(1, S);
          else
            free_a = a.stage;
"""),
        (WS, _AFTER_PAIR, """      if (free_b >= 0) release(&empty[free_b]);
      if (p.resident) {
        Slot f(q0 + j * kc, S);
        for (int k = 0; k < (last ? w + 1 : 2) * kc; ++k) {
          release(&empty[f.stage]);
          f.step(1, S);
        }
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
"""),
    ],
    "threads288": [
        (WS, "constexpr int THREADS = 384;",
         "constexpr int THREADS = 288;"),
        (WS, "  if (threadIdx.x < 128) {  // the producer\n"
             "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 40;\\n\");\n"
             "    if (threadIdx.x != 0) return;",
         "  if (threadIdx.x >= 256) {  // the producer\n"
         "    if (threadIdx.x != 256) return;"),
        (WS, "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 232;\\n\");\n"
             "  const int c = threadIdx.x / 128 - 1;",
         "  const int c = threadIdx.x / 128;"),
    ],
}

# The parent's implicit-GEMM bf16 body (conv.cuh on tf32_gemm.cuh).
_PARENT_FOLD = """    const int j0 = gi * WG;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (j0 + h < nk_s) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) epi.fold(j, e, acc[4 * j + 2 * h + e]);
      }
"""
_PARENT_PRODUCTS = """#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16(acc, ah + 2 * kk, bh + 2 * kk, kk > 0 || !overwrite);
"""
PARENT_VARIANTS = {
    "parent": [],
    "parent_nofold": [(CONV, _PARENT_FOLD, "    (void)gi;\n")],
    "parent_noproducts": [(GEMM, _PARENT_PRODUCTS, "")],
}


def make(src, name, patches, sources):
    """A copy of tree `src`'s package and chip_smoke.py with `patches`
    applied, building only `sources` (the loader skips the C entry points
    the others hold)."""
    dst = OUT / name
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    shutil.copytree(src / "xgpr_tpu_torch", dst / "xgpr_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    shutil.copy(src / "chip_smoke.py", dst / "chip_smoke.py")
    for path, old, new in patches:
        text = (dst / path).read_text()
        if old not in text:
            raise SystemExit(f"{name}: patch target not found in {path}")
        (dst / path).write_text(text.replace(old, new, 1))
    build = dst / "xgpr_tpu_torch/ops/cuda/build.py"
    text = build.read_text()
    for old, new in (
            ('for src in sorted(CSRC.glob("*.cu")):',
             f"for src in [CSRC / s for s in {sources!r}]:"),
            ("            fn = getattr(lib, name)\n",
             "            fn = getattr(lib, name, None)\n"
             "            if fn is None:\n                continue\n")):
        if old not in text:
            raise SystemExit(f"{name}: build.py has changed")
        text = text.replace(old, new)
    build.write_text(text)
    return dst


def timing(name, parent):
    """Runs in a variant's copy: the launch alone at the motif chunk."""
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
    k4 = Conv1dTwoLayer(xdim, cs.K4_RFFS, cs.SEED, device=dev,
                        kernel_spec_parms={"conv_width": w,
                                           "init_rffs": cs.INIT_RFFS})
    p4 = k4._dense_projs()[0]

    def twice(fn):
        return "/".join(f"{cs.time_ms(torch, fn, reps=20):.4f}"
                        for _ in range(2))

    rows = []
    for rffs in ((cs.NUM_RFFS,) if parent else
                 (cs.NUM_RFFS, cs.TUNE_RFFS, cs.VERIFY_RFFS)):
        p3 = Conv1dRBF(xdim, rffs, cs.SEED, device=dev,
                       kernel_spec_parms={"conv_width": w})._dense_proj()
        scale = conv_row_scale(lens, w, p3.shape[1], 0, torch.float32, dev)
        if parent:
            launch3 = parent_launch(torch, conv, lib, x, lens, p3, w, scale,
                                    sigma)
            rows.append("K3 F4096 wrapper " + twice(
                lambda: conv.conv_parts(x, lens, p3, sigma, w, scale,
                                        "fast", "default")))
            rows.append("preparation " + twice(
                lambda: conv._kernel_operands("conv_parts", "K3", x, lens,
                                              p3, w, "default", scale)))
        else:
            launch3 = conv.parts_launcher(x, lens, p3, sigma, w, scale,
                                          "fast", "default")[1]
        rows.append(f"K3 F{p3.shape[1]} " + twice(launch3))
    launch4 = parent_launch(torch, conv, lib, x, lens, p4, w) if parent \
        else conv.maxpool_launcher(x, lens, p4, w, "default")[1]
    rows.append("K4 F1024 " + twice(launch4))
    print("VARIANT", name, " | ".join(rows), f"[{cs.card_line()}]",
          flush=True)


def parent_launch(torch, conv, lib, x, lens, proj, w, scale=None,
                  sigma=None):
    """The older tree's C call alone, its operands prepared once."""
    from xgpr_tpu_torch.ops.cuda.feature_map import (BODY_FLAGS,
                                                     kernel_sincos_flag)
    k3 = scale is not None
    ops = conv._kernel_operands("conv_parts" if k3 else "conv_maxpool",
                                "K3" if k3 else "K4", x, lens, proj, w,
                                "default", *((scale,) if k3 else ()))
    _, _, xh, _, order, nk, hi, _ = ops[:8]
    n, l, dp = xh.shape
    f = proj.shape[1]
    out = [torch.empty((n, f), device=x.device) for _ in range(2 if k3
                                                             else 1)]
    stream = torch.cuda.current_stream().cuda_stream
    body = BODY_FLAGS["bf16"]
    if k3:
        return lambda: lib.xgpr_conv_parts(
            xh.data_ptr(), None, order.data_ptr(), nk.data_ptr(),
            hi.data_ptr(), None, ops[8].data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), n, l, dp, w, f, sigma,
            kernel_sincos_flag("fast"), body, stream)
    return lambda: lib.xgpr_conv_maxpool(
        xh.data_ptr(), None, order.data_ptr(), nk.data_ptr(), hi.data_ptr(),
        None, out[0].data_ptr(), n, l, dp, w, f, body, stream)


def main(argv):
    if len(argv) > 1 and argv[0] == "--time":
        timing(argv[1], argv[1].startswith("parent"))
        return
    if argv and argv[0] == "--parent":
        src, table = Path(argv[1]).resolve(), PARENT_VARIANTS
        names = argv[2:] or list(table)
        sources = ["conv.cu", "conv_bf16.cu", "conv_fma.cu", "conv_f64.cu"]
    else:
        src, table = ROOT, VARIANTS
        names = argv or list(table)
        sources = ["conv_bf16.cu"]
    dirs = {n: make(src, n, table[n], sources) for n in names}
    procs = {n: subprocess.Popen(
        [sys.executable, "-c",
         "from xgpr_tpu_torch.ops.cuda import build; build.build()"],
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
