"""Time the dense kernels K1 and K2 alone on the card, at the main paths'
shapes, and print one line:

    VARIANT <label> K2 <ms>/<ms> ms err <e> | K2 D1024 ... | K1 ... | K1 K26 ...

K2 at slice A's chunk (8192 x 84 rows, RBF's 4096-frequency projection,
padded 128) and at Conv1dTwoLayer's second layer (8192 x 1024 nonnegative
rows, its 2048-frequency projection, padded 1024), and at slice A's chunk
at "highest" in "exact" (the "reference" preset; where the version's
rbf_feature_map takes a precision); K1 at slice A's chunk for K = 1, 5
and 26 at "high", for K = 1 and 26 at "default" in "fast" (the "max"
preset) and for K = 26 at "highest" in "exact".  Two timings of 20 calls
each (CUDA events, after a warm-up) and the max error against the plain
versions.  Run it from the
root of a checkout or of a copy of one (it imports the package and
chip_smoke.py from the working directory); to compare versions of the
kernels on one card, run it from each copy in turn in one command
(parent, change, change, parent):

    python tests/torch_port/dense_kernel_timing.py <label> [--profile]

With --profile it also prints, for each case, the device time of each
CUDA kernel the wrapper launches (torch.profiler over 10 calls).
"""
import inspect
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from xgpr_tpu_torch.kernels import RBF, Conv1dTwoLayer  # noqa: E402
from xgpr_tpu_torch.ops.cuda import build, feature_map, ztzv  # noqa: E402


def profile_table(fn, label):
    """Device milliseconds per call of each kernel fn launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    for e in sorted(prof.key_averages(),
                    key=lambda e: -getattr(e, "self_device_time_total", 0)):
        t = getattr(e, "self_device_time_total", 0)
        if t > 0:
            print(f"PROFILE {label}: {t / 1e4:.4f} ms/call "
                  f"{e.count // 10} launches/call {e.key[:80]}", flush=True)


def k1_case(name, x, m, proj, sigma, v, mode, precision):
    return (name,
            lambda: ztzv.ztzv_parts(x, m, proj, sigma, *v, True, mode,
                                    precision),
            lambda: ztzv.ztzv_parts_plain(x, m, proj, sigma, *v, True, mode,
                                          precision))


def k2_highest(x, proj, padded):
    """K2 at "highest" in "exact", where rbf_feature_map takes a
    precision."""
    if "precision" not in inspect.signature(
            feature_map.rbf_feature_map).parameters:
        return ()
    return [("K2 highest",
             lambda: (feature_map.rbf_feature_map(x, proj, True, padded,
                                                  "exact", "highest"),),
             lambda: (feature_map.rbf_feature_map_plain(x, proj, True,
                                                        padded, "exact"),))]


def main(label, profile=False):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    build.library()
    dev = "cuda"
    rng = np.random.default_rng(7)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    rbf = RBF((cs.CHUNK, cs.N_FEATURES), cs.NUM_RFFS, cs.SEED, device=dev)
    two = Conv1dTwoLayer((cs.CHUNK, cs.MOTIF_L, cs.MOTIF_D), cs.K4_RFFS,
                         cs.SEED, device=dev,
                         kernel_spec_parms={"conv_width": cs.MOTIF_W,
                                            "init_rffs": cs.INIT_RFFS})
    p1, p2 = rbf._dense_proj(), two._dense_projs()[1]
    x1 = t(rng.standard_normal((cs.CHUNK, p1.shape[0])) * 0.5)
    x2 = t(rng.random((cs.CHUNK, p2.shape[0])) * 0.1)
    xr = t(rng.standard_normal((cs.CHUNK, p1.shape[0])))
    m = t((rng.random(cs.CHUNK) > 0.25).astype(np.float32))
    v1, v5, v26 = ([t(rng.standard_normal((p1.shape[1], k)))
                    for _ in range(2)] for k in (1, 5, 26))
    sigma = float(np.exp(cs.HPARAMS[1]))
    pad1, pad2 = rbf.padded_dims, two._feature_padded
    out = []
    for name, fn, plain in (
            ("K2", lambda: (feature_map.rbf_feature_map(x1, p1, True, pad1),),
             lambda: (feature_map.rbf_feature_map_plain(x1, p1, True,
                                                        pad1),)),
            ("K2 D1024",
             lambda: (feature_map.rbf_feature_map(x2, p2, True, pad2),),
             lambda: (feature_map.rbf_feature_map_plain(x2, p2, True,
                                                        pad2),)),
            *k2_highest(x1, p1, pad1),
            *(k1_case(name, xr, m, p1, sigma, v, mode, precision)
              for name, v, mode, precision in (
                  ("K1", v1, None, None), ("K1 K5", v5, None, None),
                  ("K1 K26", v26, None, None),
                  ("K1 bf16", v1, "fast", "default"),
                  ("K1 bf16 K26", v26, "fast", "default"),
                  ("K1 highest K26", v26, "exact", "highest")))):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        times = [cs.time_ms(torch, fn, reps=20) for _ in range(2)]
        if profile:
            profile_table(fn, f"{label} {name}")
        out.append(f"{name} {times[0]:.4f}/{times[1]:.4f} ms err {err:.2e}")
    print("VARIANT", label, " | ".join(out), f"[{cs.card_line()}]",
          flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--profile"]
    main(args[0] if args else "this", "--profile" in sys.argv[1:])
