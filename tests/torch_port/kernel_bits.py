"""Whether two versions of the kernels give the same bits on the card.

    python tests/torch_port/kernel_bits.py save OUT.pt
    python tests/torch_port/kernel_bits.py compare A.pt B.pt

``save`` runs K1 (slice A's chunk, 8192 x 84 rows, F 4096, K 1 and 26), K2
(the same rows, padded 128), K3 (8192 rows, L 16, D 64, w 9, F 4096) and
K4 (F 1024) on fixed random inputs with every knob at its default, and
writes their outputs; run it from the root of each version (it imports
the package from the working directory).  ``compare`` prints, for each
output, whether the two files hold the same bits, and exits with 1 when
one differs.
"""
import sys
from pathlib import Path

import numpy as np
import torch


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
    out = {"K2": feature_map.rbf_feature_map(x * 0.05, proj, True, 128)}
    for k in (1, 26):
        vc, vs = t((4096, k)), t((4096, k))
        out[f"K1 oc K={k}"], out[f"K1 os K={k}"] = ztzv.ztzv_parts(
            x, m, proj, 0.05, vc, vs, True)
    xs = t((8192, 16, 64), 0.5)
    lengths = torch.as_tensor(rng.integers(9, 17, size=8192).astype(np.int32),
                              device=dev)
    p3, p4 = t((576, 4096), 0.1), t((576, 1024), 0.1)
    out["K3 c"], out["K3 s"] = conv.conv_parts(xs, lengths, p3, 0.7, 9)
    out["K4"] = conv.conv_maxpool(xs, lengths, p4, 9)
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main(argv):
    if argv[0] == "save":
        torch.save(outputs(), argv[1])
        return 0
    a, b = torch.load(argv[1]), torch.load(argv[2])
    same = True
    for key in a:
        eq = torch.equal(a[key], b[key])
        same &= eq
        print(f"BITS {key}: {'same' if eq else 'differ'} (max abs diff "
              f"{float((a[key] - b[key]).abs().max()):.3e})", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
