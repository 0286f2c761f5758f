"""Check and time the float64 and "highest" kernel bodies on the card
(chip_smoke.py's G1: K1 at K 1 and 26, K2 at D 84 and D 1024, K3 at F
4096, 1024 and 128, K4 at F 1024, each against its plain version) and
print one line per case:

    ROW <label> (<kernel>, <shape key>) ms <t> plain <t> bound <t> err <e>

With --k1-modes it also times float32 K1 at slice A's chunk (K 1) in each
sincos mode, three readings each, and float64 K1 at K 1 and 26.  Run it
from the root of a checkout or of a copy of one (it imports the package
and chip_smoke.py from the working directory); to compare two versions on
one card, run it from each copy in turn in one command:

    python tests/torch_port/float64_kernel_timing.py <label> [--k1-modes]
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def k1_modes(card):
    from xgpr_tpu_torch.kernels import RBF
    from xgpr_tpu_torch.ops.cuda import ztzv
    rng = np.random.default_rng(7)
    sigma = float(np.exp(cs.HPARAMS[1]))
    for dtype in (torch.float32, torch.float64):
        kern = RBF((cs.CHUNK, cs.N_FEATURES), cs.NUM_RFFS, cs.SEED,
                   device="cuda", double_precision=dtype == torch.float64)
        proj = kern._dense_proj()

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device="cuda")
        x = t(rng.standard_normal((cs.CHUNK, cs.N_FEATURES)))
        m = t((rng.random(cs.CHUNK) > 0.25).astype(np.float32))
        double = dtype == torch.float64
        modes = ("exact",) if double else ("hi", "fast", "poly", "hi", "poly")
        for k in (1, 26) if double else (1,):
            vc = t(rng.standard_normal((proj.shape[1], k)))
            vs = t(rng.standard_normal((proj.shape[1], k)))
            for mode in modes:
                ms = [cs.time_ms(torch, lambda: ztzv.ztzv_parts(
                    x, m, proj, sigma, vc, vs, True, mode, "high"))
                    for _ in range(3)]
                print(f"K1 {dtype} K={k} {mode}: "
                      + " ".join(f"{v:.4f}" for v in ms) + f" ms [{card}]",
                      flush=True)


def main(argv):
    label = argv[0] if argv else "this"
    card = cs.card_line()
    print(f"=== {label} {card}", flush=True)
    t0 = time.perf_counter()
    cs.phase_build()
    corpus = cs.motif_corpus(cs.N_TRAIN + cs.N_TEST)
    timed = cs.phase_g_kernels(torch, card, corpus)
    for key, res in sorted(timed.items(), key=str):
        print(f"ROW {label} {key} ms {res['ms']:.4f} plain "
              f"{res['plain_ms']:.4f} bound {res['bound']['ms']:.4f} err "
              f"{res['max_abs_err']:.3e}", flush=True)
    if "--k1-modes" in argv:
        k1_modes(card)
    print(f"=== {label} done in {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
