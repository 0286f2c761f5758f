"""Time the conv kernels K3 and K4 alone on the card, at the motif slice's
shapes (one 8192-row chunk of chip_smoke.py's motif corpus, L 16, D 64,
w 9; K3 with Conv1dRBF's 8192-RFF projection, K4 with Conv1dTwoLayer's
1024-feature first layer), and print one line:

    VARIANT <label> K3 <ms>/<ms> ms err <max abs err> sha <hash> | K4 ...

Two timings of 20 calls each (CUDA events, after a warm-up), the max
error against the plain versions, and the first 12 hex digits of the
SHA-256 of the kernel's output bytes: two versions that compute the same
bits print the same hash.  Run it from the root of a checkout or
of a copy of one; to compare versions of the kernels on one card, run
each copy in turn in one command (parent, change, change, parent):

    python tests/torch_port/conv_kernel_timing.py <label>
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


def main(label):
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
    out = []
    for name, fn, plain in (
            ("K3", lambda: conv.conv_parts(x, lens, p3, sigma, w, scale),
             lambda: conv.conv_parts_plain(x, lens, p3, sigma, w, scale)),
            ("K4", lambda: (conv.conv_maxpool(x, lens, p4, w),),
             lambda: (conv.conv_maxpool_plain(x, lens, p4, w),))):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        sha = hashlib.sha256(b"".join(a.cpu().numpy().tobytes()
                                      for a in got)).hexdigest()[:12]
        times = [cs.time_ms(torch, fn, reps=20) for _ in range(2)]
        out.append(f"{name} {times[0]:.4f}/{times[1]:.4f} ms err {err:.2e} "
                   f"sha {sha}")
    print("VARIANT", label, " | ".join(out), f"[{cs.card_line()}]",
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "this")
