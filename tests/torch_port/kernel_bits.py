"""Whether two versions of the kernels give the same bits on the card.

    python tests/torch_port/kernel_bits.py save OUT.pt
    python tests/torch_port/kernel_bits.py compare A.pt B.pt

``save`` runs, on fixed random inputs, K1 (slice A's chunk, 8192 x 84
rows, F 4096, K 1, 5 and 26), K2 (the same rows, padded 128), K3 (8192
rows, L 16, D 64, w 9, F 4096) and K4 (F 1024) in every body: with every
knob at its default (3xTF32; K1, K2 and K3 in each sincos mode), at
"default" (bf16 for K1 in each sincos mode, K3 and K4; K3 in "fast"), at
"highest" (K1 3xTF32; K2, K3 and K4 fp32 FMAs; K2 and K3 in each sincos
mode) and in float64 (float64 operands: the DMMA bodies); then K1's bf16
body and K2's fp32 FMA body at other depths and layouts (K1 at D 200 and
1024 with F 4100, K 1 and 26; K2 at D 200 with F 4100 in blocks of 128,
a ragged last block, and at D 1024, F 2048 in blocks of 1024), and writes
their outputs; run it from the root of each version (it imports the
package from the working directory).  ``compare`` prints, for each output, whether the
two files hold the same bits and the largest difference, and exits with 1
when one differs, except that a float64 output may differ within F64_RTOL
= 1e-11 of max(1, max|a|) (another order of the DMMA sums), which it
prints as such.
"""
import sys
from pathlib import Path

import numpy as np
import torch

F64_RTOL = 1e-11
MODES = ("hi", "exact", "fast", "poly")


def outputs():
    sys.path.insert(0, str(Path.cwd()))
    from xgpr_tpu_torch.ops.cuda import conv, feature_map, ztzv
    dev = "cuda"
    rng = np.random.default_rng(3)

    def t(shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32, device=dev)

    x, proj = t((8192, 84)), t((84, 4096), 0.3)
    m = torch.as_tensor((rng.random(8192) > 0.25).astype(np.float32),
                        device=dev)
    v = {k: (t((4096, k)), t((4096, k))) for k in (1, 5, 26)}
    xs = t((8192, 16, 64), 0.5)
    lengths = torch.as_tensor(rng.integers(9, 17, size=8192).astype(np.int32),
                              device=dev)
    p3, p4 = t((576, 4096), 0.1), t((576, 1024), 0.1)
    scale = torch.as_tensor(rng.random(8192) + 0.5, dtype=torch.float32,
                            device=dev)
    out = {}

    def body(tag, cast, precision, k3_modes, dense_modes, k1_modes=(None,)):
        xb, pb, mb, xsb, p3b, p4b, sb = (cast(a) for a in (
            x, proj, m, xs, p3, p4, scale))
        for mode in dense_modes:
            out[f"K2 {tag} {mode}"] = feature_map.rbf_feature_map(
                xb * 0.05, pb, True, 128, mode, precision)
        for k, (vc, vs) in v.items():
            for mode in k1_modes:
                key = f"K={k} {tag}" + ("" if mode is None else f" {mode}")
                out[f"K1 oc {key}"], out[f"K1 os {key}"] = ztzv.ztzv_parts(
                    xb, mb, pb, 0.05, cast(vc), cast(vs), True, mode,
                    precision)
        for mode in k3_modes:
            out[f"K3 c {tag} {mode}"], out[f"K3 s {tag} {mode}"] = \
                conv.conv_parts(xsb, lengths, p3b, 0.7, 9, sb, mode,
                                precision)
        out[f"K4 {tag}"] = conv.conv_maxpool(xsb, lengths, p4b, 9,
                                             precision)

    same = lambda a: a  # noqa: E731
    body("high", same, None, MODES, MODES, (None,) + MODES[1:])
    body("default", same, "default", ("fast",), (), MODES)
    body("highest", same, "highest", MODES, MODES)
    body("float64", lambda a: a.double(), None, ("exact",), ("exact",))
    # K1's bf16 and K2's fp32 FMA bodies past D 84: streamed lines, a
    # ragged last step, a ragged last layout block.
    for d, f in ((200, 4100), (1024, 2048)):
        xd, pd = t((2000, d), 0.2), t((d, f), 0.3)
        md = m[:2000]
        for k in (1, 26):
            vd = (t((f, k)), t((f, k)))
            out[f"K1 oc D{d} K={k} default"], out[f"K1 os D{d} K={k} default"] \
                = ztzv.ztzv_parts(xd, md, pd, 0.05, vd[0], vd[1], True,
                                  "fast", "default")
        padded = 128 if d == 200 else 1024
        for mode in ("hi", "exact"):
            out[f"K2 D{d} highest {mode}"] = feature_map.rbf_feature_map(
                xd * 0.05, pd, True, padded, mode, "highest")
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main(argv):
    if argv[0] == "save":
        torch.save(outputs(), argv[1])
        return 0
    a, b = torch.load(argv[1]), torch.load(argv[2])
    ok = True
    for key in a:
        if key not in b:
            print(f"BITS {key}: only in {argv[1]}", flush=True)
            continue
        diff = float((a[key] - b[key]).abs().max())
        if torch.equal(a[key], b[key]):
            verdict = "same"
        elif a[key].dtype == torch.float64 and \
                diff <= F64_RTOL * max(1.0, float(a[key].abs().max())):
            verdict = "differ, within F64_RTOL"
        else:
            verdict = "differ"
            ok = False
        print(f"BITS {key}: {verdict} (max abs diff {diff:.3e})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
