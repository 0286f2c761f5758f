"""Where the float32 error of the exact NMLL gradient enters, and how rough
the float32 NMLL is in sigma, through the port.

    python -m tests.torch_port.gradient_noise [rows] [rffs] [dl ds]
        [--device cuda]

RBF on chip_smoke.py's tabular data, 8192-row chunks, at chip_smoke's
pinned hyperparameters plus (dl, ds) in log space (default 0.5 0.5), on
the CPU unless --device says otherwise.  The gradient's chunk terms are
computed four ways: features (the kernel's plain-torch gradient fn) in
float32 or float64, and each chunk's products in float32 or float64; the
sums over chunks are float64 throughout, as in the engine.  Each line
prints the NMLL and the analytic gradient with their relative gaps to the
all-float64 one, after a check of the float32 matmul itself (a chunk
Gram product against float64).  Then central differences at steps 1e-3
and 1e-2: of the NMLL from float64 products with float64 or float32
features, and of the float32 exact_nmll (float32 features, on the card
from the K2 kernel, and float32 chunk products).
"""
import sys
import time

import numpy as np
import torch

import chip_smoke
from xgpr_tpu_torch import GPRegression, build_regression_dataset, config
from xgpr_tpu_torch.scoring.gradient import exact_nmll_reg_grad


def gradient(model, data, point, products):
    """(NMLL, gradient) from the model's gradient fn with each chunk's
    products in ``products``, summed over chunks in float64."""
    model.kernel.set_hyperparams(point, logspace=True)
    engine = model._engine(data)
    fn = model.kernel.pure_gradient_fn()
    params = model.kernel.gradient_params()
    f64 = dict(dtype=torch.float64, device=engine.device)
    m = model.num_rffs
    ztz, zty, yty = (torch.zeros(m, m, **f64), torch.zeros(m, **f64),
                     torch.zeros((), **f64))
    dz_ty, inner = torch.zeros(m, 1, **f64), torch.zeros(m, m, 1, **f64)
    n = 0.0
    for xb, yb, lb, mb, _ in engine._batches():
        z, dz = fn(params, xb, lb)
        mb, yb = mb.to(products), yb.to(products)
        z = z.to(products) * mb[:, None]
        dz = dz[:, :, 0].to(products) * mb[:, None]
        ym = yb * mb
        ztz += (z.T @ z).double()
        zty += (z.T @ ym).double()
        yty += (ym @ ym).double()
        dz_ty[:, 0] += (dz.T @ ym).double()
        inner[:, :, 0] += (dz.T @ z).double()
        n += float(mb.sum())
    inner = inner + inner.transpose(0, 1)
    hparams = model.kernel.get_hyperparams(logspace=False)
    score, grad, _ = exact_nmll_reg_grad(ztz, zty, float(yty), hparams, n,
                                         dz_ty, inner)
    return score, grad


def central_difference(fn, point, step):
    num = np.zeros(2)
    for i in range(2):
        e = np.zeros(2)
        e[i] = step
        num[i] = (fn(point + e) - fn(point - e)) / (2 * step)
    return num


def main(argv):
    device = "cpu"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    rows = int(argv[0]) if argv else 65_536
    rffs = int(argv[1]) if len(argv) > 1 else 2048
    offset = np.array([float(a) for a in argv[2:4]] or [0.5, 0.5])
    point = chip_smoke.HPARAMS + offset
    (x, y), _ = chip_smoke.tabular_data(rows, 10, chip_smoke.N_FEATURES,
                                        seed=chip_smoke.SEED)
    data = build_regression_dataset(x, y, chunk_size=8192)
    models = {}
    for dtype in (torch.float64, torch.float32):
        with config.working_dtype(dtype):
            models[dtype] = GPRegression(num_rffs=rffs, kernel_choice="RBF",
                                         device=device, verbose=False)
            models[dtype].set_hyperparams(point, data)
    z = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (8192, rffs)) / np.sqrt(rffs), device=device)
    gram = z.T @ z
    err = float(((z.float().T @ z.float()).double() - gram).abs().max()
                / gram.abs().max())
    print(f"rows {rows}, rffs {rffs}, point {point}, device {device}; "
          f"a float32 (8192, {rffs}) Gram product is within {err:.3e} of "
          f"float64 (of its largest entry)", flush=True)
    ref = None
    for feats, prods in ((torch.float64, torch.float64),
                         (torch.float32, torch.float32),
                         (torch.float32, torch.float64),
                         (torch.float64, torch.float32)):
        t0 = time.perf_counter()
        score, grad = gradient(models[feats], data, point, prods)
        secs = time.perf_counter() - t0
        ref = ref or (score, grad)
        print(f"features {feats}, products {prods}: NMLL {score:.6f} "
              f"(gap {abs(score - ref[0]) / abs(ref[0]):.3e}), gradient "
              f"{grad} (gap {np.abs(grad - ref[1]) / np.abs(ref[1])}), "
              f"{secs:.2f}s", flush=True)
    for feats in (torch.float64, torch.float32):
        for step in (1e-3, 1e-2):
            num = central_difference(
                lambda h: gradient(models[feats], data, h,
                                   torch.float64)[0], point, step)
            print(f"NMLL from {feats} features and float64 products, central "
                  f"difference at {step:g}: {num} "
                  f"(gap {np.abs(num - ref[1]) / np.abs(ref[1])})",
                  flush=True)
    m32 = models[torch.float32]
    for step in (1e-3, 1e-2):
        num = central_difference(lambda h: m32.exact_nmll(h, data), point,
                                 step)
        print(f"float32 exact_nmll, central difference at {step:g}: {num} "
              f"(gap {np.abs(num - ref[1]) / np.abs(ref[1])})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
