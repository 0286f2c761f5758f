"""The kernels' error against a float64 witness on the card, by precision.

For K1 (slice A's chunk: 8192 x 84 rows, RBF's 4096-frequency projection,
K 1 and 26), K2 (the same rows, sigma-scaled, and projection), K3 (8192
motif rows, L 16, D 64, w 9, F 4096)
and K4 (the same rows, Conv1dTwoLayer's first layer, F 1024), in the
"exact" sincos mode of the "reference" preset, prints one line per case:

    PRECISION <kernel> <precision> kernel <e> plain_fp32 <e> ratio <r>

with each error the max absolute difference from the witness (the plain
version of the same precision in float64 on the card) over max|witness|,
for the kernel and for the plain version in float32.  A body is
fp32-grade where ``ratio`` stays within 2: "high" runs 3xTF32 everywhere,
"highest" 3xTF32 for K1 and fp32 FMAs on the CUDA cores for K2, K3 and
K4, "default" one bf16 pass for K1, K3 and K4 and 3xTF32 for K2.
With ``--tf32-inputs`` x and the projections are first rounded to TF32,
so that the 3xTF32 body's split is exact and its products' only error
is their accumulation on the tensor cores.  Run it from the root of a
checkout (it imports the package and chip_smoke.py from the working
directory):

    python tests/torch_port/precision_error.py [--tf32-inputs] [precision...]

The precisions default to "high", "highest" and "default".
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from xgpr_tpu_torch.kernels import RBF, Conv1dRBF, Conv1dTwoLayer  # noqa
from xgpr_tpu_torch.ops.conv import conv_row_scale  # noqa: E402
from xgpr_tpu_torch.ops.cuda import (build, conv, feature_map,  # noqa
                                     ztzv)
from xgpr_tpu_torch.ops.cuda.operands import split_tf32  # noqa: E402


def rel(got, want):
    top = max(float(w.abs().max()) for w in want)
    err = max(float((g.double() - w).abs().max()) for g, w in zip(got, want))
    return err / top


def cases(precision, tf32_inputs=False):
    """(name, kernel call, plain call on float32 or float64 operands)."""
    dev = "cuda"
    rng = np.random.default_rng(7)

    def inp(a):
        return split_tf32(a)[0].contiguous() if tf32_inputs else a
    rbf = RBF((cs.CHUNK, cs.N_FEATURES), cs.NUM_RFFS, cs.SEED, device=dev)
    p1 = inp(rbf._dense_proj())
    x1 = inp(torch.as_tensor(rng.standard_normal((cs.CHUNK, cs.N_FEATURES)),
                             dtype=torch.float32, device=dev))
    m = torch.as_tensor((rng.random(cs.CHUNK) > 0.25).astype(np.float32),
                        device=dev)
    sig1 = float(np.exp(cs.HPARAMS[1]))
    x2 = inp(x1 * sig1)
    out = [("K2", lambda: (feature_map.rbf_feature_map(
                x2, p1, True, rbf.padded_dims, "exact", precision),),
            lambda dt: (feature_map.rbf_feature_map_plain(
                x2.to(dt), p1.to(dt), True, rbf.padded_dims, "exact"),))]
    for k in (1, 26):
        vc, vs = (torch.as_tensor(rng.standard_normal((cs.NUM_RFFS // 2, k)),
                                  dtype=torch.float32, device=dev)
                  for _ in range(2))
        ops = (x1, m, p1, vc, vs)
        out.append((f"K1 K={k}",
                    lambda o=ops: ztzv.ztzv_parts(
                        o[0], o[1], o[2], sig1, o[3], o[4], True, "exact",
                        precision),
                    lambda dt, o=ops: ztzv.ztzv_parts_plain(
                        *(a.to(dt) for a in o[:3]), sig1,
                        *(a.to(dt) for a in o[3:]), True, "exact",
                        precision)))
    x_np, _, l_np = cs.motif_corpus(cs.CHUNK)
    xdim = (cs.CHUNK, cs.MOTIF_L, cs.MOTIF_D)
    k3 = Conv1dRBF(xdim, cs.NUM_RFFS, cs.SEED, device=dev,
                   kernel_spec_parms={"conv_width": cs.MOTIF_W})
    k4 = Conv1dTwoLayer(xdim, cs.K4_RFFS, cs.SEED, device=dev,
                        kernel_spec_parms={"conv_width": cs.MOTIF_W,
                                           "init_rffs": cs.INIT_RFFS})
    x3 = inp(torch.as_tensor(x_np, device=dev))
    l3 = torch.as_tensor(l_np, dtype=torch.int32, device=dev)
    p3, p4 = inp(k3._dense_proj()), inp(k4._dense_projs()[0])
    sig3 = float(np.exp(cs.MOTIF_HPARAMS[1]))
    rs = conv_row_scale(l3, cs.MOTIF_W, p3.shape[1], 0, torch.float32, dev)
    w = cs.MOTIF_W
    out.append(("K3", lambda: conv.conv_parts(x3, l3, p3, sig3, w, rs,
                                              "exact", precision),
                lambda dt: conv.conv_parts_plain(
                    x3.to(dt), l3, p3.to(dt), sig3, w, rs.to(dt), "exact",
                    precision)))
    out.append(("K4", lambda: (conv.conv_maxpool(x3, l3, p4, w, precision),),
                lambda dt: (conv.conv_maxpool_plain(x3.to(dt), l3, p4.to(dt),
                                                    w, precision),)))
    return out


def main(precisions, tf32_inputs=False):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    build.library()
    card = cs.card_line()
    tag = " tf32-inputs" if tf32_inputs else ""
    for precision in precisions:
        for name, kernel, plain in cases(precision, tf32_inputs):
            witness = plain(torch.float64)
            e_kernel = rel(kernel(), witness)
            e_plain = rel(plain(torch.float32), witness)
            torch.cuda.synchronize()
            print(f"PRECISION{tag} {name} {precision} kernel {e_kernel:.3e} "
                  f"plain_fp32 {e_plain:.3e} ratio "
                  f"{e_kernel / max(e_plain, 1e-300):.3f} [{card}]",
                  flush=True)
            del witness
            torch.cuda.empty_cache()


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--tf32-inputs"]
    main(args or ["high", "highest", "default"],
         "--tf32-inputs" in sys.argv[1:])
