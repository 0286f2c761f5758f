"""K1's reuse path (csrc/ztzv_reuse.cuh) against the 3xTF32 passes it
replaces (csrc/dense_wgmma.cuh), on the card, at RBF's chunk (8192 x 84
rows, F 4096, chip_smoke.py's shapes) and K right-hand sides.

For each K, in turns (passes, reuse, reuse, passes): the launch alone
(``ztzv.launcher``; CUDA events, 20 calls after a warm-up) with
``ztzv.REUSE_MIN_K`` set past K (the passes) or at K (the reuse path),
the projections a call makes (``PROJECTIONS``),
each output's error against the plain version and, over the plain fp32
version's error, against a float64 witness (precision_error.py's
measure), and whether two calls give the same bits.  One line a K:

    REUSE K=<k> passes <ms>/<ms> reuse <ms>/<ms> projections <a>/<b>
        err <e> ratio <r> bitwise <bool> [card, power limit]

``--ptxas`` first builds the library with ``-Xptxas -v`` and prints the
registers, stack and spills of the reuse path's kernels; ``--profile``
then prints, for each K, each kernel's device time a call on the reuse
path (torch.profiler over 20 calls):

    KERNELS K=<k> <kernel> <us> | ...

From the root of a checkout on the card:

    python tests/torch_port/ztzv_reuse_timing.py [--ptxas] [--profile] [K ...]
"""
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

KS = (1, 5, 8, 9, 16, 17, 26, 32, 64)


def ptxas():
    from xgpr_tpu_torch.ops.cuda import build
    build.build(["-Xptxas", "-v"])
    name = None
    for line in build.BUILD_LOG.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            name = hit.group(1)
        elif name and ("stream_kernel" in name or "features_kernel" in name
                       or "pack_vt" in name):
            if "registers" in line or "spill" in line:
                print("PTXAS", name[:60], line.strip(), flush=True)


def kernels(torch, launch, calls=20):
    """(kernel name, device us a call) of ``launch``, longest first."""
    from torch.profiler import ProfilerActivity, profile
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            launch()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / calls)
            for e in prof.key_averages() if e.device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def main(argv):
    if "--ptxas" in argv:
        ptxas()
    profile = "--profile" in argv
    argv = [a for a in argv if not a.startswith("--")]
    import numpy as np
    import torch
    import chip_smoke as cs
    from xgpr_tpu_torch.ops.cuda import ztzv
    ks = [int(a) for a in argv] or list(KS)
    rng = np.random.default_rng(11)
    dev = "cuda"

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)
    n, d, f = cs.CHUNK, cs.N_FEATURES, cs.NUM_RFFS // 2
    x64 = rng.standard_normal((n, d))
    m64 = (rng.random(n) > 0.25).astype(np.float64)
    p64 = rng.standard_normal((d, f)) * 0.3
    sigma = 0.05
    x, m, proj = t(x64), t(m64), t(p64)
    default_k = ztzv.REUSE_MIN_K
    for k in ks:
        vc64, vs64 = (rng.standard_normal((f, k)) for _ in "cs")
        vc, vs = t(vc64), t(vs64)
        args = (x, m, proj, sigma, vc, vs, True, "hi", "high")

        def run(reuse):
            ztzv.REUSE_MIN_K = k if reuse else 1 << 30
            before = ztzv.PROJECTIONS.total()
            launch = ztzv.launcher(*args)
            out = launch()
            torch.cuda.synchronize()
            made = ztzv.PROJECTIONS.total() - before
            ms = cs.time_ms(torch, launch, reps=20)
            again = launch()
            torch.cuda.synchronize()
            ztzv.REUSE_MIN_K = default_k
            return ms, made, out, again
        times = {False: [], True: []}
        outs = {}
        for reuse in (False, True, True, False):
            ms, made, out, again = run(reuse)
            times[reuse].append(ms)
            outs[reuse] = (made, out, again)
        plain = ztzv.ztzv_parts_plain(*args)
        witness = ztzv.ztzv_parts_plain(
            t(x64, torch.float64), t(m64, torch.float64),
            t(p64, torch.float64), sigma, t(vc64, torch.float64),
            t(vs64, torch.float64), True, "exact")
        top = max(float(w.abs().max()) for w in witness)

        def err(got, ref):
            return max(float((a.double() - b.double()).abs().max())
                       for a, b in zip(got, ref))
        base = err(plain, witness)
        cols = []
        for reuse in (False, True):
            made, out, again = outs[reuse]
            same = all(torch.equal(a, b) for a, b in zip(out, again))
            cols.append(f"{'reuse' if reuse else 'passes'} "
                        f"{times[reuse][0]:.4f}/{times[reuse][1]:.4f} "
                        f"projections {made} err {err(out, plain):.3e} "
                        f"ratio {err(out, witness) / base:.3f} "
                        f"bitwise {same}")
        print(f"REUSE K={k} " + " | ".join(cols) + f" (max|ref| {top:.3e}) "
              f"[{cs.card_line()}]", flush=True)
        if profile:
            ztzv.REUSE_MIN_K = k
            rows = kernels(torch, ztzv.launcher(*args))
            ztzv.REUSE_MIN_K = default_k
            print(f"KERNELS K={k} " + " | ".join(
                f"{name[:48]} {us:.1f}" for name, us in rows), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
