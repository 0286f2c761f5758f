#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xgpr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA device, nvcc and nothing
built beforehand.  Phases (any failure raises and the exit code is not 0):

1. Print the card's name and power limit, the torch and CUDA versions;
   build the kernels from ops/cuda/csrc and print the build time.
2. Each kernel against its plain PyTorch version on the card, in fp32:
   the feature map (K2) at the slice's shape and at a ragged one, and the
   fused CG matvec (K1) at the slice's shape for K = 1 and 26 and at a
   ragged one with masked rows.  Prints each max error and each kernel's
   time beside the plain version's.
3. The slice at a real size: 262,144 x 84 training rows, 8192 RFFs, RBF,
   fit(mode="cg") with the autoselected Nystrom preconditioner, then
   predict(get_var=True) on 16,384 rows.  Checks CG convergence, finite
   predictions, var >= 0, held-out Spearman > 0.62, that both kernels ran
   during fit and the feature map during predict, and that predictions
   recomputed through the plain feature map agree.

The line before the last is one JSON object describing the kernels; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout, it exits with code 1 and prints no result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Pinned hyperparameters of the JAX suite's tabular fixture
# (tests/fitting_tests/test_regression_fits.py), log-space (lambda, sigma).
HPARAMS = np.array([-1.7908995, -3.9549678])
SPEARMAN_FLOOR = 0.62
N_TRAIN, N_TEST, N_FEATURES, SEED = 262_144, 16_384, 84, 123
CHUNK, NUM_RFFS, VARIANCE_RFFS = 8192, 8192, 512

# Tolerances, fp32 on both sides with a different summation order:
# features are O(1/sqrt(F)) in magnitude and match to ~1e-5 absolute;
# the matvec sums R * F products, so it is held to 1e-4 of max |ref|.
FEATURE_ATOL = 1e-5
ZTZV_RTOL = 1e-4
PREDICT_RTOL = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError("check failed: " + msg)


def tabular_data(n_train, n_test, n_features, noise=0.1, seed=123):
    """The JAX suite's synthetic tabular generator
    (tests/utils/synthetic.py:tabular_data), copied so that this script
    needs nothing from the test tree."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    x = rng.standard_normal((n, n_features))
    w1 = rng.standard_normal(n_features) / np.sqrt(n_features)
    w2 = rng.standard_normal(n_features) / np.sqrt(n_features)
    w3 = rng.standard_normal(n_features) / np.sqrt(n_features)
    y = (np.sin(2.0 * x @ w1) + (x @ w2) * np.cos(x @ w3)
         + 0.5 * np.tanh(x @ w1 * (x @ w2)))
    y = y + noise * rng.standard_normal(n)
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: " + out.stderr)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=10):
    """Mean milliseconds per call on the card (CUDA events, warmed up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_build():
    from xgpr_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f}s "
          f"(nvcc {build.BUILD_SECONDS if build.BUILD_SECONDS else 0:.2f}s)",
          flush=True)


def phase_kernels(torch, card):
    """K1 and K2 against their plain versions on the card."""
    from xgpr_tpu_torch.kernels import RBF
    from xgpr_tpu_torch.ops.cuda import feature_map, ztzv
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    kernel = RBF((CHUNK, N_FEATURES), NUM_RFFS, SEED, device="cuda")
    proj = kernel._dense_proj()                       # (84, 4096), fp32

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    results = {}
    # --- K2: slice shape (padded 128, 32 blocks) and a ragged case -----
    k2_err, k2_ms, k2_plain_ms = 0.0, None, None
    cases = [(CHUNK, proj, kernel.padded_dims, True, "slice")]
    for intercept in (False, True):
        cases.append((257, t(rng.standard_normal((10, 200)) * 0.7), 16,
                      intercept, f"ragged intercept={intercept}"))
    for n, pr, padded, intercept, label in cases:
        x = t(rng.standard_normal((n, pr.shape[0])) * 0.5)
        got = feature_map.rbf_feature_map(x, pr, intercept, padded)
        want = feature_map.rbf_feature_map_plain(x, pr, intercept, padded)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"K2 feature map {label}: N={n} D={pr.shape[0]} "
              f"F={pr.shape[1]} padded={padded} max_abs_err={err:.3e} "
              f"(tol {FEATURE_ATOL:g})", flush=True)
        check(err < FEATURE_ATOL, f"K2 {label} disagrees ({err})")
        k2_err = max(k2_err, err)
        if label == "slice":
            k2_ms = time_ms(torch, lambda: feature_map.rbf_feature_map(
                x, pr, intercept, padded))
            k2_plain_ms = time_ms(
                torch, lambda: feature_map.rbf_feature_map_plain(
                    x, pr, intercept, padded))
            print(f"K2 time at slice shape: kernel {k2_ms:.4f} ms, plain "
                  f"{k2_plain_ms:.4f} ms [{card}]", flush=True)
    results["k2"] = (k2_err, k2_ms, k2_plain_ms)

    # --- K1: slice shape for K = 1, 26 and a ragged masked case --------
    k1_err, k1_ms, k1_plain_ms = 0.0, None, None
    sigma = float(np.exp(HPARAMS[1]))
    k1_cases = [(CHUNK, proj, 1, sigma, "slice K=1"),
                (CHUNK, proj, 26, sigma, "slice K=26"),
                (2000, t(rng.standard_normal((N_FEATURES, 500)) * 0.3), 3,
                 0.7, "ragged")]
    for n, pr, k, sig, label in k1_cases:
        x = t(rng.standard_normal((n, pr.shape[0])))
        m = t((rng.random(n) > 0.25).astype(np.float32))
        vc = t(rng.standard_normal((pr.shape[1], k)))
        vs = t(rng.standard_normal((pr.shape[1], k)))
        for intercept in (True, False):
            oc, os_ = ztzv.ztzv_parts(x, m, pr, sig, vc, vs, intercept)
            rc, rs = ztzv.ztzv_parts_plain(x, m, pr, sig, vc, vs, intercept)
            torch.cuda.synchronize()
            scale = max(1.0, float(rc.abs().max()), float(rs.abs().max()))
            err = max(float((oc - rc).abs().max()),
                      float((os_ - rs).abs().max()))
            print(f"K1 ztzv {label} intercept={intercept}: R={n} "
                  f"D={pr.shape[0]} F={pr.shape[1]} K={k} "
                  f"max_abs_err={err:.3e} max|ref|={scale:.3e} "
                  f"(tol {ZTZV_RTOL:g} * max|ref|)", flush=True)
            check(err < ZTZV_RTOL * scale, f"K1 {label} disagrees ({err})")
            k1_err = max(k1_err, err)
        if label == "slice K=1":
            k1_ms = time_ms(torch, lambda: ztzv.ztzv_parts(
                x, m, pr, sig, vc, vs, True))
            k1_plain_ms = time_ms(torch, lambda: ztzv.ztzv_parts_plain(
                x, m, pr, sig, vc, vs, True))
            print(f"K1 time at slice shape (K=1): kernel {k1_ms:.4f} ms, "
                  f"plain {k1_plain_ms:.4f} ms [{card}]", flush=True)
    results["k1"] = (k1_err, k1_ms, k1_plain_ms)
    return results


def phase_slice(torch, card):
    """fit(mode="cg") + predict(get_var=True) at a real size on the card."""
    from scipy.stats import spearmanr
    from xgpr_tpu_torch import GPRegression, build_regression_dataset
    from xgpr_tpu_torch.ops.cuda import feature_map, ztzv

    t0 = time.perf_counter()
    (trx, tr_y), (tex, te_y) = tabular_data(N_TRAIN, N_TEST, N_FEATURES,
                                            seed=SEED)
    dset = build_regression_dataset(trx, tr_y, chunk_size=CHUNK)
    print(f"data: {N_TRAIN} x {N_FEATURES} train, {N_TEST} test, made in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    model = GPRegression(num_rffs=NUM_RFFS, variance_rffs=VARIANCE_RFFS,
                         kernel_choice="RBF", device="cuda", verbose=False)
    model.set_hyperparams(HPARAMS, dset)

    feature_map.LAUNCHES = 0
    ztzv.LAUNCHES = 0
    t0 = time.perf_counter()
    n_iter, losses = model.fit(dset, mode="cg", run_diagnostics=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k2_fit, k1_fit = feature_map.LAUNCHES, ztzv.LAUNCHES
    print(f"fit: {fit_s:.3f}s, CG iterations {n_iter}, final relative "
          f"residual {losses[-1]:.3e}; launches during fit: "
          f"K1 {k1_fit}, K2 {k2_fit}", flush=True)
    check(n_iter < 500 and losses[-1] < 1e-6, "CG did not converge")
    check(k1_fit > 0, "K1 was not launched during fit")
    check(k2_fit > 0, "K2 was not launched during fit")

    feature_map.LAUNCHES = 0
    ztzv.LAUNCHES = 0
    t0 = time.perf_counter()
    preds, var = model.predict(tex, get_var=True)
    predict_s = time.perf_counter() - t0
    k2_predict = feature_map.LAUNCHES
    print(f"predict: {predict_s:.3f}s for {N_TEST} rows; K2 launches "
          f"{k2_predict}", flush=True)
    check(k2_predict > 0, "K2 was not launched during predict")
    check(preds.shape == (N_TEST,) and var.shape == (N_TEST,),
          "prediction shapes")
    check(bool(np.all(np.isfinite(preds)) and np.all(np.isfinite(var))),
          "non-finite predictions")
    check(bool(np.all(var >= 0)), "negative variance")
    rho = float(spearmanr(preds, te_y)[0])
    print(f"held-out Spearman {rho:.4f} (floor {SPEARMAN_FLOOR})",
          flush=True)
    check(rho > SPEARMAN_FLOOR, "Spearman below the floor")

    # Recompute 4096 predictions through the plain feature map on the card.
    kern = model.kernel
    params = kern.feature_params()
    x = kern._cast_input(tex[:4096])
    z = feature_map.rbf_feature_map_plain(x * params["sigma"],
                                          params["proj"], kern.fit_intercept,
                                          kern.padded_dims)
    z[:, 0] = 1.0
    ref = (z @ model.weights).cpu().numpy().astype(np.float64)
    ref = ref * model.trainy_std + model.trainy_mean
    err = float(np.abs(ref - preds[:4096]).max())
    bound = PREDICT_RTOL * float(np.abs(ref).max())
    print(f"predict vs plain feature map: max_abs_err {err:.3e} "
          f"(tol {bound:.3e})", flush=True)
    check(err < bound, "predictions disagree with the plain feature map")

    times = dict(model.fit_phase_times)
    times["predict"] = predict_s
    for name, sec in times.items():
        print(f"phase {name}: {sec:.4f}s [{card}]", flush=True)
    print(f"mean per-CG-iteration time: {times['cg'] / n_iter * 1e3:.3f} ms "
          f"(cg phase / iterations) [{card}]", flush=True)
    return k1_fit, k2_fit + k2_predict


def main():
    if not (ROOT / "xgpr_tpu_torch" / "ops" / "cuda" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(xgpr_tpu_torch/ not found beside it).", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible; this smoke run needs one.",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    phase_build()
    res = phase_kernels(torch, card)
    k1_launches, k2_launches = phase_slice(torch, card)
    kernels = [
        {"name": "rbf_feature_map", "route": "cuda",
         "source": "xgpr_tpu_torch/ops/cuda/csrc/feature_map.cu",
         "replaces": "xgpr_tpu/ops/pallas/sorf_pallas.py:96",
         "launches": k2_launches, "max_abs_err": res["k2"][0],
         "ms": res["k2"][1], "plain_ms": res["k2"][2]},
        {"name": "ztzv_parts", "route": "cuda",
         "source": "xgpr_tpu_torch/ops/cuda/csrc/ztzv.cu",
         "replaces": "xgpr_tpu/ops/pallas/ztzv_pallas.py:240",
         "launches": k1_launches, "max_abs_err": res["k1"][0],
         "ms": res["k1"][1], "plain_ms": res["k1"][2]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
