#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xgpr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py              # the run below
    python3 chip_smoke.py --profile    # also profile a warm Conv1dRBF fit

Run from the root of a checkout; needs one CUDA device, nvcc and nothing
built beforehand.  Phases (any failure raises and the exit code is not 0):

1. Print the card's name and power limit, the torch and CUDA versions;
   build the kernels from ops/cuda/csrc (one nvcc per source, in
   parallel) and print the build time and ptxas's register counts.
2. K1 and K2 against their plain PyTorch versions on the card, in fp32:
   the feature map (K2) at slice A's shape and at a ragged one, and the
   fused CG matvec (K1) at slice A's shape for K = 1 and 26 and at a
   ragged one with masked rows.  Prints each max error and each kernel's
   time beside the plain version's.
3. Slice A at a real size: 262,144 x 84 training rows, 8192 RFFs, RBF,
   fit(mode="cg") with the autoselected Nystrom preconditioner, then
   predict(get_var=True) on 16,384 rows.  Checks CG convergence, finite
   predictions, var >= 0, held-out Spearman > 0.62, that both kernels ran
   during fit and the feature map during predict, and that predictions
   recomputed through the plain feature map agree.
4. The motif corpus of the 1M-row sequence north star (one-hot letters,
   L 16, D 64, an anchor-RBF target over windows of 9): 262,144 training
   rows and 16,384 held out.
5. K3 and K4 against their plain versions on the card, in fp32: at the
   sequence slice's shapes (8192-row chunks of the corpus with the
   models' own projections), a ragged case, GraphRBF's w = 1 and D = 21.
   At the slice shape, prints each kernel's time beside both bounds, the
   (row, window) slots its tiles project against the valid windows, and
   its achieved TFLOP/s on the valid-window work.
6. The sequence slice: Conv1dRBF, 8192 RFFs, fit(mode="cg") with the
   autoselected preconditioner (the model prints the rank it chose),
   predict(get_var=True).  Checks CG convergence, that K3 ran during fit
   and during predict, finite predictions, var >= 0, 4096 predictions
   against the plain K3, and held-out Spearman > 0.75.
7. The K4 path on 65,536 rows of the corpus: Conv1dTwoLayer (init_rffs
   1024, 4096 RFFs) fit by CG and predict with variance, then FastConv1d
   on 4096 rows.  Checks convergence, that K4 and K2 ran, agreement with
   the plain path, and held-out Spearman above its floor.

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
# (tests/utils/synthetic.py tabular_data; test_regression_fits.py),
# log-space (lambda, sigma).
HPARAMS = np.array([-1.7908995, -3.9549678])
SPEARMAN_FLOOR = 0.62
N_TRAIN, N_TEST, N_FEATURES, SEED = 262_144, 16_384, 84, 123
CHUNK, NUM_RFFS, VARIANCE_RFFS = 8192, 8192, 512

# The sequence slice: the 1M motif north star's model
# (scripts/million_point_tune_fit.py:224-230, NORTHSTAR_r05_motif.json),
# cut in depth to 262,144 rows, hyperparameters pinned to that run's tuned
# values.  Its held-out Spearman was 0.813 at 1M rows.
MOTIF_L, MOTIF_D, MOTIF_W = 16, 64, 9
MOTIF_HPARAMS = np.array([-1.4877232, -3.9336658])
MOTIF_SPEARMAN_FLOOR = 0.75
# The K4 path: Conv1dTwoLayer on 65,536 rows.  Hyperparameters from
# xgpr_tpu's tune_hyperparams_crude on the CPU over 4,000 rows of the same
# corpus (tests/torch_port/motif_twolayer_tune.py; PERF.md), and the floor
# that run's held-out Spearman less 0.05.
K4_ROWS, INIT_RFFS, K4_RFFS = 65_536, 1024, 4096
TWOLAYER_HPARAMS = np.array([-0.713433, -5.3507411])
TWOLAYER_SPEARMAN_FLOOR = 0.5495

# Tolerances, fp32 on both sides with a different summation order:
# features are O(1/sqrt(F)) in magnitude and match to ~1e-5 absolute;
# the matvec sums R * F products, so it is held to 1e-4 of max |ref|; the
# conv window loops sum up to nw O(1) terms of 576-term fp32 dot products,
# so they are held to 1e-4 * max(1, max |ref|).
FEATURE_ATOL = 1e-5
ZTZV_RTOL = 1e-4
CONV_RTOL = 1e-4
PREDICT_RTOL = 1e-4

# Published H100 SXM peaks (NVIDIA data sheet): dense TF32 on the tensor
# cores, fp32 on CUDA cores and HBM3 bandwidth.  The bounds count each
# input read once, each output written once, and the multiply-adds of the
# projections (2 flops each): as three TF32 products each at fp32 grade
# (3xTF32) for the tensor-core bound, as fp32 FMAs for the CUDA-core one.
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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


def motif_corpus(n_rows, seq_len=MOTIF_L, dim=MOTIF_D, width=MOTIF_W,
                 seed=SEED):
    """The motif-profile corpus of the 1M north star
    (scripts/million_point_tune_fit.py:_generate_motif), copied so that
    this script needs nothing else of the repository: one-hot letters from
    a 21-symbol alphabet plus 0.1 noise, and an anchor-RBF target over the
    valid windows.  Generated in row chunks to bound host memory; held in
    memory instead of .npy files.  Returns x (n, L, D) float32, y (n,)
    float64 and lengths (n,) int32."""
    rng = np.random.default_rng(seed)
    L, D = seq_len, dim
    nw = L - width + 1
    wd = width * D
    alphabet = min(D, 21)
    sig_t = 0.7
    n_anchor = 128

    letters = rng.integers(0, alphabet, (n_rows, L))
    lengths = rng.integers(width, L + 1, size=(n_rows,)).astype(np.int32)
    # Anchors from the corpus itself so anchor distances are typical.
    a_rows = rng.integers(0, n_rows, n_anchor)
    a_starts = rng.integers(0, nw, n_anchor)
    eye = np.eye(D, dtype=np.float32)

    x = np.empty((n_rows, L, D), dtype=np.float32)
    for lo in range(0, n_rows, 50_000):
        hi = min(lo + 50_000, n_rows)
        xb = eye[letters[lo:hi]]
        xb += 0.1 * rng.standard_normal(xb.shape).astype(np.float32)
        x[lo:hi] = xb

    anchors = np.stack([x[r, s:s + width, :].reshape(wd)
                        for r, s in zip(a_rows, a_starts)]).astype(np.float64)
    coef = rng.standard_normal(n_anchor)
    an2 = (anchors ** 2).sum(-1)

    n_valid = np.clip(lengths - width + 1, 1, nw).astype(np.float64)
    wmask = np.arange(nw)[None, :]
    y = np.empty(n_rows, dtype=np.float64)
    for lo in range(0, n_rows, 8192):
        hi = min(lo + 8192, n_rows)
        xb = x[lo:hi].astype(np.float64)
        win = np.stack([xb[:, t:t + width, :].reshape(hi - lo, wd)
                        for t in range(nw)], axis=1)
        wn2 = (win ** 2).sum(-1)
        cross = win.reshape(-1, wd) @ anchors.T
        d2 = wn2[:, :, None] \
            - 2.0 * cross.reshape(hi - lo, nw, n_anchor) \
            + an2[None, None, :]
        g = np.exp(-0.5 * sig_t * sig_t * d2) @ coef
        valid = wmask < n_valid[lo:hi, None]
        y[lo:hi] = (g * valid).sum(1) / n_valid[lo:hi]
    y = (y - y.mean()) / y.std() * 0.4
    y += 0.1 * rng.standard_normal(n_rows)
    return x, y, lengths


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: " + out.stderr)
    return out.stdout.strip().splitlines()[0]


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def time_ms(torch, fn, reps=10, dev="cuda"):
    """Mean milliseconds per call on the card (CUDA events, warmed up)."""
    fn()
    if torch.device(dev).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes, flops):
    """Least ms on the published peaks and what sets it: "ms"/"by" with
    the flops on the tensor cores (3xTF32), "cuda_core_ms"/"cuda_core_by"
    with them on CUDA cores."""
    t_bytes = nbytes / PEAK_BYTES
    out = {}
    for key, t_ops in (("", 3 * flops / PEAK_TF32_FLOPS),
                       ("cuda_core_", flops / PEAK_FP32_FLOPS)):
        out[key + "ms"] = max(t_bytes, t_ops) * 1e3
        out[key + "by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def bound_text(b):
    return (f"bound {b['ms']:.4f} ms ({b['by']}, tensor cores 3xTF32) / "
            f"{b['cuda_core_ms']:.4f} ms ({b['cuda_core_by']}, fp32 CUDA "
            f"cores)")


def counters():
    """The kernels' launch counters, as (module, attribute) by name."""
    from xgpr_tpu_torch.ops.cuda import conv, feature_map, ztzv
    return {"K1": (ztzv, "LAUNCHES"), "K2": (feature_map, "LAUNCHES"),
            "K3": (conv, "PARTS_LAUNCHES"), "K4": (conv, "MAXPOOL_LAUNCHES")}


def reset_counts():
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in counters().items()}


def phase_build():
    from xgpr_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    path = build.build(["-Xptxas", "-v"])
    build.library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f}s "
          f"(nvcc {build.BUILD_SECONDS if build.BUILD_SECONDS else 0:.2f}s)",
          flush=True)
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or \
                "entry function" in line or line.startswith("---"):
            print("ptxas: " + line.strip(), flush=True)


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
            mm_ms = time_ms(torch, lambda: torch.matmul(x, pr))
            d, f = pr.shape
            k2_bound = bound(4 * (n * d + d * f + n * 2 * f), 2 * n * d * f)
            print(f"K2 time at slice shape: kernel {k2_ms:.4f} ms, plain "
                  f"{k2_plain_ms:.4f} ms, {bound_text(k2_bound)}; "
                  f"projection matmul alone (partial yardstick) "
                  f"{mm_ms:.4f} ms [{card}]", flush=True)
    results["K2"] = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms,
                         bound=k2_bound)

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
            d, f = pr.shape
            k1_bound = bound(4 * (n * d + n + d * f + 4 * f * k),
                             2 * n * d * f + 8 * n * f * k)
            print(f"K1 time at slice shape (K=1): kernel {k1_ms:.4f} ms, "
                  f"plain {k1_plain_ms:.4f} ms, {bound_text(k1_bound)} "
                  f"[{card}]", flush=True)
    results["K1"] = dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
                         bound=k1_bound)
    return results


def phase_slice(torch, card):
    """Slice A: fit(mode="cg") + predict(get_var=True) at a real size."""
    from scipy.stats import spearmanr
    from xgpr_tpu_torch import GPRegression, build_regression_dataset
    from xgpr_tpu_torch.ops.cuda import feature_map

    t0 = time.perf_counter()
    (trx, tr_y), (tex, te_y) = tabular_data(N_TRAIN, N_TEST, N_FEATURES,
                                            seed=SEED)
    dset = build_regression_dataset(trx, tr_y, chunk_size=CHUNK)
    print(f"data: {N_TRAIN} x {N_FEATURES} train, {N_TEST} test, made in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    model = GPRegression(num_rffs=NUM_RFFS, variance_rffs=VARIANCE_RFFS,
                         kernel_choice="RBF", device="cuda", verbose=False)
    model.set_hyperparams(HPARAMS, dset)

    reset_counts()
    t0 = time.perf_counter()
    n_iter, losses = model.fit(dset, mode="cg", run_diagnostics=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = read_counts()
    print(f"fit: {fit_s:.3f}s, CG iterations {n_iter}, final relative "
          f"residual {losses[-1]:.3e}; launches during fit: {fit_counts}",
          flush=True)
    check(n_iter < 500 and losses[-1] < 1e-6, "CG did not converge")
    check(fit_counts["K1"] > 0, "K1 was not launched during fit")
    check(fit_counts["K2"] > 0, "K2 was not launched during fit")

    reset_counts()
    t0 = time.perf_counter()
    preds, var = model.predict(tex, get_var=True)
    predict_s = time.perf_counter() - t0
    predict_counts = read_counts()
    print(f"predict: {predict_s:.3f}s for {N_TEST} rows; launches "
          f"{predict_counts}", flush=True)
    check(predict_counts["K2"] > 0, "K2 was not launched during predict")
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
    check_predictions(model, z, preds[:4096], "the plain feature map")
    report_times(model, n_iter, predict_s, card, "slice A")
    return {"K1": fit_counts["K1"],
            "K2": fit_counts["K2"] + predict_counts["K2"]}


def check_predictions(model, z, preds, what):
    ref = (z @ model.weights).cpu().numpy().astype(np.float64)
    ref = ref * model.trainy_std + model.trainy_mean
    err = float(np.abs(ref - preds).max())
    tol = PREDICT_RTOL * float(np.abs(ref).max())
    print(f"predict vs {what}: max_abs_err {err:.3e} (tol {tol:.3e})",
          flush=True)
    check(err < tol, f"predictions disagree with {what}")


def report_times(model, n_iter, predict_s, card, label):
    times = dict(model.fit_phase_times)
    times["predict"] = predict_s
    for name, sec in times.items():
        print(f"{label} phase {name}: {sec:.4f}s [{card}]", flush=True)
    print(f"{label} mean per-CG-iteration time: "
          f"{times.get('cg', 0.0) / max(n_iter, 1) * 1e3:.3f} ms "
          f"(cg phase / iterations) [{card}]", flush=True)


def phase_conv_kernels(torch, card, corpus, dev="cuda", chunk=CHUNK,
                       num_rffs=NUM_RFFS, init_rffs=INIT_RFFS):
    """K3 and K4 against their plain versions, at the sequence slice's
    shapes (chunks of the corpus, the models' own projections), a ragged
    case and w = 1."""
    from xgpr_tpu_torch.kernels import Conv1dRBF, Conv1dTwoLayer
    from xgpr_tpu_torch.ops.conv import conv_row_scale
    from xgpr_tpu_torch.ops.cuda import conv
    rng = np.random.default_rng(11)
    x_np, _, l_np = corpus
    xdim = (chunk, MOTIF_L, MOTIF_D)
    k3 = Conv1dRBF(xdim, num_rffs, SEED, device=dev,
                   kernel_spec_parms={"conv_width": MOTIF_W})
    k4 = Conv1dTwoLayer(xdim, K4_RFFS, SEED, device=dev,
                        kernel_spec_parms={"conv_width": MOTIF_W,
                                           "init_rffs": init_rffs})
    proj3, proj4 = k3._dense_proj(), k4._dense_projs()[0]
    sigma = float(np.exp(MOTIF_HPARAMS[1]))

    def t(a, dtype=k3.dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    def ragged(n, l, d, width, f):
        x = t(rng.standard_normal((n, l, d)) * 0.5)
        lens = t(rng.integers(width, l + 1, size=n), torch.int32)
        return x, lens, t(rng.standard_normal((width * d, f)) * 0.3)

    x_slice, l_slice = t(x_np[:chunk]), t(l_np[:chunk], torch.int32)
    row_scale = conv_row_scale(l_slice, MOTIF_W, proj3.shape[1], 0,
                               k3.dtype, dev)
    nk_sum = int(np.clip(l_np[:chunk] - MOTIF_W + 1, 0, None).sum())
    cases = {
        "K3": [("slice", x_slice, l_slice, proj3, MOTIF_W, row_scale),
               ("ragged", *ragged(1000, 9, 16, 5, 200), 5, None),
               ("w=1", *ragged(300, 12, 21, 1, 256), 1, None),
               ("D=21", *ragged(700, 14, 21, 6, 300), 6, None)],
        "K4": [("slice", x_slice, l_slice, proj4, MOTIF_W, None),
               ("ragged", *ragged(1000, 9, 16, 5, 200), 5, None),
               ("w=1", *ragged(300, 12, 21, 1, 256), 1, None),
               ("D=21", *ragged(700, 14, 21, 6, 300), 6, None)],
    }
    runs = {"K3": (lambda x, l, p, w, rs: conv.conv_parts(x, l, p, sigma, w,
                                                          rs),
                   lambda x, l, p, w, rs: conv.conv_parts_plain(x, l, p,
                                                                sigma, w,
                                                                rs)),
            "K4": (lambda x, l, p, w, rs: (conv.conv_maxpool(x, l, p, w),),
                   lambda x, l, p, w, rs: (conv.conv_maxpool_plain(x, l, p,
                                                                   w),))}
    results = {}
    for name, kcases in cases.items():
        kernel_fn, plain_fn = runs[name]
        worst = 0.0
        for label, x, lens, proj, width, rs in kcases:
            got = kernel_fn(x, lens, proj, width, rs)
            want = plain_fn(x, lens, proj, width, rs)
            sync(torch, dev)
            scale = max(1.0, max(float(w.abs().max()) for w in want))
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            print(f"{name} {label}: N={x.shape[0]} L={x.shape[1]} "
                  f"D={x.shape[2]} w={width} F={proj.shape[1]} "
                  f"max_abs_err={err:.3e} max|ref|={scale:.3e} "
                  f"(tol {CONV_RTOL:g} * max(1, max|ref|))", flush=True)
            check(err < CONV_RTOL * scale, f"{name} {label} disagrees ({err})")
            worst = max(worst, err)
        _, x, lens, proj, width, rs = kcases[0]
        ms = time_ms(torch, lambda: kernel_fn(x, lens, proj, width, rs),
                     dev=dev)
        plain_ms = time_ms(torch, lambda: plain_fn(x, lens, proj, width, rs),
                           reps=3, dev=dev)
        slab = conv.window_slab(x, width)
        mm_ms = time_ms(torch, lambda: torch.matmul(slab, proj), dev=dev)
        n, l, d = x.shape
        f = proj.shape[1]
        out_cols = 2 * f if name == "K3" else f
        flops = 2 * width * d * f * nk_sum
        kb = bound(4 * (n * l * d + n + width * d * f + n * out_cols)
                   + (4 * n if name == "K3" else 0), flops)
        slots, valid = conv.window_slots(lens, width, l - width + 1)
        print(f"{name} time at slice shape: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, {bound_text(kb)}; {nk_sum} valid "
              f"windows, {flops / 1e9:.1f} GFLOP; projection matmul alone "
              f"(partial yardstick, no mask/sincos/sum) {mm_ms:.4f} ms "
              f"[{card}]", flush=True)
        print(f"{name} at slice shape: {slots} window slots projected for "
              f"{valid} valid windows ({slots / valid:.3f} : 1); achieved "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s on the "
              f"valid-window work ({flops * 1e3 / ms / PEAK_FP32_FLOPS:.1%} "
              f"of the fp32 CUDA-core peak; the tensor cores run "
              f"{3 * flops * slots / valid / (ms * 1e-3) / 1e12:.1f} TFLOP/s "
              f"of TF32 products on the projected slots, "
              f"{3 * flops * slots / valid * 1e3 / ms / PEAK_TF32_FLOPS:.1%} "
              f"of peak) [{card}]", flush=True)
        results[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                             bound=kb)
    return results


def phase_conv_slice(torch, card, corpus, n_train=N_TRAIN, n_test=N_TEST,
                     dev="cuda", chunk=CHUNK, num_rffs=NUM_RFFS,
                     variance_rffs=VARIANCE_RFFS, profile=False):
    """The sequence slice: Conv1dRBF fit(mode="cg") + predict."""
    from scipy.stats import spearmanr
    from xgpr_tpu_torch import GPRegression, build_regression_dataset
    from xgpr_tpu_torch.ops.conv import conv_row_scale
    from xgpr_tpu_torch.ops.cuda.conv import conv_parts_plain
    from xgpr_tpu_torch.ops.layout import assemble_cos_sin

    x, y, lens = corpus
    trx, tr_y, tr_l = x[:n_train], y[:n_train], lens[:n_train]
    tex, te_y, te_l = (a[n_train:n_train + n_test] for a in (x, y, lens))
    dset = build_regression_dataset(trx, tr_y, tr_l, chunk_size=chunk)
    # verbose: the fit prints the preconditioner rank the autoselect chose.
    model = GPRegression(num_rffs=num_rffs, variance_rffs=variance_rffs,
                         kernel_choice="Conv1dRBF",
                         kernel_settings={"conv_width": MOTIF_W},
                         device=dev, verbose=True)
    model.set_hyperparams(MOTIF_HPARAMS, dset)

    reset_counts()
    t0 = time.perf_counter()
    n_iter, losses = model.fit(dset, mode="cg", run_diagnostics=True)
    sync(torch, dev)
    fit_s = time.perf_counter() - t0
    fit_counts = read_counts()
    print(f"Conv1dRBF fit: {fit_s:.3f}s, CG iterations {n_iter}, final "
          f"relative residual {losses[-1]:.3e}; launches during fit: "
          f"{fit_counts}", flush=True)
    check(n_iter < 500 and losses[-1] < 1e-6, "Conv1dRBF CG did not converge")
    model.verbose = False

    reset_counts()
    t0 = time.perf_counter()
    preds, var = model.predict(tex, te_l, get_var=True)
    predict_s = time.perf_counter() - t0
    predict_counts = read_counts()
    print(f"Conv1dRBF predict: {predict_s:.3f}s for {n_test} rows; "
          f"launches {predict_counts}", flush=True)
    if torch.device(dev).type == "cuda":
        check(fit_counts["K3"] > 0, "K3 was not launched during fit")
        check(predict_counts["K3"] > 0, "K3 was not launched during predict")
    check(preds.shape == (n_test,) and var.shape == (n_test,),
          "prediction shapes")
    check(bool(np.all(np.isfinite(preds)) and np.all(np.isfinite(var))),
          "non-finite predictions")
    check(bool(np.all(var >= 0)), "negative variance")
    rho = float(spearmanr(preds, te_y)[0])
    print(f"Conv1dRBF held-out Spearman {rho:.4f} (floor "
          f"{MOTIF_SPEARMAN_FLOOR})", flush=True)

    # Recompute 4096 predictions through the plain K3 on the card.
    kern = model.kernel
    params = kern.feature_params()
    xs, ls = kern._cast_input(tex[:4096]), kern._cast_lengths(te_l[:4096])
    scale = conv_row_scale(ls, kern.conv_width, kern.num_freqs,
                           kern.scaling_type, kern.dtype, kern.device)
    c, s = conv_parts_plain(xs, ls, params["proj"], params["sigma"],
                            kern.conv_width, scale)
    c[:, 0] = 1.0
    check_predictions(model, assemble_cos_sin(c, s, kern.padded_dims),
                      preds[:4096], "the plain K3")
    report_times(model, n_iter, predict_s, card, "Conv1dRBF")
    if profile:
        profile_fit(torch, model, dset, card)
    check(rho > MOTIF_SPEARMAN_FLOOR, "Conv1dRBF Spearman below the floor")
    return {"K3": fit_counts["K3"] + predict_counts["K3"]}


def phase_k4_path(torch, card, corpus, n_train=K4_ROWS, n_test=N_TEST,
                  dev="cuda", chunk=CHUNK, num_rffs=K4_RFFS,
                  init_rffs=INIT_RFFS):
    """Conv1dTwoLayer fit(mode="cg") + predict, then FastConv1d."""
    from scipy.stats import spearmanr
    from xgpr_tpu_torch import (FastConv1d, GPRegression,
                                build_regression_dataset)
    from xgpr_tpu_torch.ops.cuda.conv import conv_maxpool_plain
    from xgpr_tpu_torch.ops.cuda.feature_map import rbf_feature_map_plain

    x, y, lens = corpus
    trx, tr_y, tr_l = x[:n_train], y[:n_train], lens[:n_train]
    tex, te_y, te_l = (a[-n_test:] for a in (x, y, lens))
    dset = build_regression_dataset(trx, tr_y, tr_l, chunk_size=chunk)
    model = GPRegression(num_rffs=num_rffs, variance_rffs=VARIANCE_RFFS // 2,
                         kernel_choice="Conv1dTwoLayer",
                         kernel_settings={"conv_width": MOTIF_W,
                                          "init_rffs": init_rffs},
                         device=dev, verbose=False)
    model.set_hyperparams(TWOLAYER_HPARAMS, dset)

    reset_counts()
    t0 = time.perf_counter()
    n_iter, losses = model.fit(dset, mode="cg", run_diagnostics=True)
    sync(torch, dev)
    fit_s = time.perf_counter() - t0
    preds, var = model.predict(tex, te_l, get_var=True)
    sync(torch, dev)
    fv = FastConv1d(seq_width=MOTIF_D, device=dev, num_features=init_rffs)
    fast = fv.predict(tex[:4096], te_l[:4096])
    counts = read_counts()
    print(f"Conv1dTwoLayer fit: {fit_s:.3f}s, CG iterations {n_iter}, "
          f"final relative residual {losses[-1]:.3e}; launches over fit, "
          f"predict and FastConv1d: {counts}", flush=True)
    check(n_iter < 500 and losses[-1] < 1e-6,
          "Conv1dTwoLayer CG did not converge")
    if torch.device(dev).type == "cuda":
        check(counts["K4"] > 0, "K4 was not launched on the K4 path")
        check(counts["K2"] > 0, "K2 was not launched on the K4 path")
    check(bool(np.all(np.isfinite(preds)) and np.all(var >= 0)),
          "Conv1dTwoLayer predictions not finite or var < 0")
    rho = float(spearmanr(preds, te_y)[0])
    print(f"Conv1dTwoLayer held-out Spearman {rho:.4f} (floor "
          f"{TWOLAYER_SPEARMAN_FLOOR})", flush=True)

    kern = model.kernel
    params = kern.feature_params()
    xs, ls = kern._cast_input(tex[:4096]), kern._cast_lengths(te_l[:4096])
    prof = conv_maxpool_plain(xs, ls, params["proj1"], kern.conv_width)
    z = rbf_feature_map_plain(prof * params["sigma"], params["proj2"],
                              kern.fit_intercept, kern._feature_padded)
    z[:, 0] = 1.0
    check_predictions(model, z, preds[:4096], "the plain K4 + K2 path")
    ref = conv_maxpool_plain(xs, ls, fv.conv_kernel._dense_proj(),
                             MOTIF_W).cpu().numpy()
    err = float(np.abs(fast - ref).max())
    tol = CONV_RTOL * max(1.0, float(np.abs(ref).max()))
    print(f"FastConv1d vs the plain K4: max_abs_err {err:.3e} (tol "
          f"{tol:.3e})", flush=True)
    check(err < tol, "FastConv1d disagrees with the plain K4")
    check(rho > TWOLAYER_SPEARMAN_FLOOR,
          "Conv1dTwoLayer Spearman below the floor")
    print(f"Conv1dTwoLayer fit phases: {dict(model.fit_phase_times)} "
          f"[{card}]", flush=True)
    return {"K4": counts["K4"]}


def profile_fit(torch, model, dset, card):
    """A warm refit timed alone, then under torch.profiler: device time
    by kernel name and the card's idle share.  The trace goes to
    build/profile/ of the checkout."""
    from torch.profiler import ProfilerActivity, profile
    model.fit(dset, mode="cg")            # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(dset, mode="cg")
    torch.cuda.synchronize()
    print(f"profile: warm Conv1dRBF fit without the profiler "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms wall [{card}]",
          flush=True)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.fit(dset, mode="cg")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        rows.append((e.key, t / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"profile: warm Conv1dRBF fit {wall * 1e3:.1f} ms wall, "
          f"{busy:.1f} ms device kernel time over {len(rows)} kernel "
          f"names, idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f} "
          f"[{card}]", flush=True)
    for key, ms, count in rows[:15]:
        print(f"profile: {ms:10.2f} ms  {count:6d} calls  {key[:90]}",
              flush=True)
    out = ROOT / "build" / "profile"
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "conv_fit_trace.json.gz"))


def kernel_line(name, route, source, replaces, launches, res):
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound"]["ms"],
            "bound_by": res["bound"]["by"],
            "cuda_core_bound_ms": res["bound"]["cuda_core_ms"],
            "cuda_core_bound_by": res["bound"]["cuda_core_by"],
            "library_ms": None}


def main(argv):
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
    t_start = time.perf_counter()
    phase_build()
    res = phase_kernels(torch, card)
    launches = phase_slice(torch, card)
    t0 = time.perf_counter()
    corpus = motif_corpus(N_TRAIN + N_TEST)
    print(f"motif corpus: {N_TRAIN} + {N_TEST} rows x {MOTIF_L} x "
          f"{MOTIF_D}, made in {time.perf_counter() - t0:.2f}s", flush=True)
    res.update(phase_conv_kernels(torch, card, corpus))
    launches.update(phase_conv_slice(torch, card, corpus,
                                     profile="--profile" in argv))
    launches.update(phase_k4_path(torch, card, corpus))
    print(f"total {time.perf_counter() - t_start:.1f}s [{card}]", flush=True)
    src = "xgpr_tpu_torch/ops/cuda/csrc/"
    pallas = "xgpr_tpu/ops/pallas/"
    kernels = [
        kernel_line("rbf_feature_map", "cuda", src + "feature_map.cu",
                    pallas + "sorf_pallas.py:96", launches["K2"], res["K2"]),
        kernel_line("ztzv_parts", "cuda", src + "ztzv.cu",
                    pallas + "ztzv_pallas.py:240", launches["K1"], res["K1"]),
        kernel_line("conv_parts", "cuda", src + "conv.cu",
                    pallas + "conv_pallas.py:302", launches["K3"], res["K3"]),
        kernel_line("conv_maxpool", "cuda", src + "conv.cu",
                    pallas + "conv_pallas.py:216", launches["K4"], res["K4"]),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
