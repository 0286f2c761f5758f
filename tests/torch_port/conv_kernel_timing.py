"""Time the conv kernels K3 and K4 alone on the card, at the motif slice's
shapes (one 8192-row chunk of chip_smoke.py's motif corpus, L 16, D 64,
w 9; K3 with Conv1dRBF's 8192-RFF projection, K4 with Conv1dTwoLayer's
1024-feature first layer), in each body asked for, and print one line a
body:

    VARIANT <label> <body> K3 <mode> wrapper <ms>/<ms> launch <ms>/<ms>
        err <max abs err> sha <hash> | K4 ...

Two timings of 20 calls each (CUDA events, after a warm-up) of the whole
wrapper and of the kernel's launch alone (its operands prepared once,
``conv.parts_launcher`` / ``maxpool_launcher``; "n/a" for a version of
the package without them), the max error against the plain versions, and
the first 12 hex digits of the SHA-256 of the kernel's output bytes: two
versions that compute the same bits print the same hash.  The bodies are
the precisions "high" (3xTF32), "default" (bf16, K3 in the "fast" sincos
mode of the "max" preset), "highest" (fp32 FMAs) and "float64" (float64
operands); K3 runs "hi" in the others.  Run it from the root of a
checkout or of a copy of one; to compare versions of the kernels on one
card, run each copy in turn in one command (parent, change, change,
parent):

    python tests/torch_port/conv_kernel_timing.py <label> [body ...]
"""
import hashlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from xgpr_tpu_torch.kernels import Conv1dRBF, Conv1dTwoLayer  # noqa: E402
from xgpr_tpu_torch.ops.conv import conv_row_scale  # noqa: E402
from xgpr_tpu_torch.ops.cuda import build, conv  # noqa: E402

BODIES = {"high": ("high", "hi"), "default": ("default", "fast"),
          "highest": ("highest", "hi"), "float64": ("high", "exact")}


def times(fn):
    return "/".join(f"{cs.time_ms(torch, fn, reps=20):.4f}"
                    for _ in range(2))


def body_line(label, body, x, lens, p3, p4, scale, sigma, w):
    precision, mode = BODIES[body]
    if body == "float64":
        x, p3, p4, scale = x.double(), p3.double(), p4.double(), \
            scale.double()
    runs = (
        ("K3", lambda: conv.conv_parts(x, lens, p3, sigma, w, scale, mode,
                                       precision),
         lambda: conv.conv_parts_plain(x, lens, p3, sigma, w, scale, mode,
                                       precision),
         lambda: conv.parts_launcher(x, lens, p3, sigma, w, scale, mode,
                                     precision)[1]),
        ("K4", lambda: (conv.conv_maxpool(x, lens, p4, w, precision),),
         lambda: (conv.conv_maxpool_plain(x, lens, p4, w, precision),),
         lambda: conv.maxpool_launcher(x, lens, p4, w, precision)[1]))
    out = []
    for name, fn, plain, launcher in runs:
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        sha = hashlib.sha256(b"".join(a.cpu().numpy().tobytes()
                                      for a in got)).hexdigest()[:12]
        launch = times(launcher()) if hasattr(conv, "parts_launcher") \
            else "n/a"
        out.append(f"{name}{' ' + mode if name == 'K3' else ''} wrapper "
                   f"{times(fn)} launch {launch} ms err {err:.2e} "
                   f"sha {sha}")
    print("VARIANT", label, body, " | ".join(out), f"[{cs.card_line()}]",
          flush=True)


def main(label, bodies):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    build.library()
    x_np, _, l_np = cs.motif_corpus(cs.CHUNK)
    dev = "cuda"
    xdim = (cs.CHUNK, cs.MOTIF_L, cs.MOTIF_D)
    w = cs.MOTIF_W
    k3 = Conv1dRBF(xdim, cs.NUM_RFFS, cs.SEED, device=dev,
                   kernel_spec_parms={"conv_width": w})
    k4 = Conv1dTwoLayer(xdim, cs.K4_RFFS, cs.SEED, device=dev,
                        kernel_spec_parms={"conv_width": w,
                                           "init_rffs": cs.INIT_RFFS})
    p3, p4 = k3._dense_proj(), k4._dense_projs()[0]
    x = torch.as_tensor(x_np, device=dev)
    lens = torch.as_tensor(l_np, device=dev)
    scale = conv_row_scale(lens, w, p3.shape[1], 0, torch.float32, dev)
    sigma = float(np.exp(cs.MOTIF_HPARAMS[1]))
    for body in bodies:
        body_line(label, body, x, lens, p3, p4, scale, sigma, w)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "this",
         sys.argv[2:] or list(BODIES))
