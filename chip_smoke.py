#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xgpr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py              # the run below
    python3 chip_smoke.py --profile    # also profile a warm Conv1dRBF fit
    python3 chip_smoke.py --design-mat-timing LABEL   # only time design_mat

``--design-mat-timing`` builds the kernels and times Engine.design_mat
alone (``design_mat_timing``) on the package beside the script; to
compare two versions on one card, copy this script into the root of each
version and run each copy in turn in one command.

Run from the root of a checkout; needs one CUDA device, nvcc and nothing
built beforehand.  Phases (any failure raises and the exit code is not 0):

1. Print the card's name and power limit, the torch and CUDA versions;
   build the kernels from ops/cuda/csrc (one nvcc per source, in
   parallel) and print the build time and ptxas's register counts.
2. K1 and K2 against their plain PyTorch versions on the card, in fp32:
   the feature map (K2) at slice A's shape, at the tuning width (F 1024),
   at the K4 path's second layer (D 1024, F 2048, padded 1024) and at a
   ragged one, and the fused CG matvec (K1) at slice A's shape for K = 1
   and 26 and at a ragged one with masked rows; two K1 calls on the same
   inputs must be bitwise equal.  Prints each max error and, at every
   shape the main path launches, each kernel's time beside the plain
   version's.
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
   models' own projections; K3 at the tuning width's F 1024 and the
   verify width's F 128 too), a
   ragged case, GraphRBF's w = 1 and D = 21.  At each slice shape, prints
   the kernel's time beside both bounds, the (row, window) slots its
   tiles project against the valid windows, and its achieved TFLOP/s on
   the valid-window work.
6. The sequence slice: Conv1dRBF, 8192 RFFs, fit(mode="cg") with the
   autoselected preconditioner (the model prints the rank it chose),
   predict(get_var=True).  Checks CG convergence, that K3 ran during fit
   and during predict, finite predictions, var >= 0, 4096 predictions
   against the plain K3, and held-out Spearman > 0.75.
7. The K4 path on 65,536 rows of the corpus: Conv1dTwoLayer (init_rffs
   1024, 4096 RFFs) fit by CG and predict with variance, then FastConv1d
   on 4096 rows.  Checks convergence, that K4 and K2 ran, agreement with
   the plain path, and held-out Spearman above its floor.
8. Slice B, tuning (``phase_tuning``):
   a. RBF on phase 3's data at 8192 RFFs and the pinned hyperparameters:
      exact_nmll, then approximate_nmll with default settings (the
      amortized srht_2 preconditioner, 25 probes: K1 at K = 26), within
      1% of exact; prints the SLQ CG iterations, the rank, each call's
      time and K1's launches by K.
   b. RBF at 2048 RFFs, at a point away from the pinned one:
      exact_nmll_gradient within 0.5% of a float64 witness on the card,
      the witness within 0.5% of a central difference of its own NMLL;
      then tune_hyperparams(L-BFGS-B, exact, max_iter 5) from the same
      point; the score must not rise.
   c. Conv1dRBF: tune_hyperparams_crude on the first 65,536 rows of the
      corpus at 2048 RFFs, a refit at 8192 RFFs on 262,144 rows with the
      tuned hyperparameters (held-out Spearman > 0.75), and
      approximate_nmll within 1% of exact_nmll there.
   No evaluation may return the penalty score, and K1 (at K = 26), K2
   and K3 must each have run during the phase.
9. The streamed engine (``phase_streamed``): phase 6's fit and predict
   again with the dataset streamed through the prefetcher (pinned
   staging buffers, a copy stream, events).  Its CG iterations must be
   within one of phase 6's and its predictions within PREDICT_RTOL x
   max|pred| of phase 6's; prints one CG iteration's data pass split
   into host assembly, copy and compute.
10. The referee (``phase_referee``): at the 1M north star's verify width
   (256 RFFs: K3 at F 128) and rank 64 on phase 6's rows, the Gram from
   K3's float32 features with float64 chunk products, through
   GramEngine: its SLQ within 1e-3 of the exact NMLL of the same Gram,
   and approximate_nmll (same probes and seed) within 1e-6 of it.

The launch counters count by shape.  The line before the last is one JSON
object describing the kernels: one row per path (slice A, Conv1dRBF,
streamed Conv1dRBF, the referee, the K4 path, tuning), kernel and launch
shape less its row count, with the
launches at that shape (by row count) and the times and bound measured
at it; a launch at a shape phases 2 and 5 did not check and time fails
the run.  The last line is {"ok": true, "device": {...}}.
Without a CUDA device, or outside a checkout, it exits with code 1 and
prints no result.
"""
import json
import subprocess
import sys
import time
from collections import Counter
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

# Slice B, tuning.  Tuning runs at 2048 RFFs as the 1M motif north star
# did (NORTHSTAR_r05_motif.json tune_rffs), the crude tune on 65,536 rows;
# SLQ is held within 1% of the exact NMLL, the JAX suite's gate
# (tests/approximate_nmll_tests/test_slq_nmll.py).  The gradient is held
# at GRAD_POINT, in log space, to the JAX suite's 0.5% against a float64
# witness on the card (the same analytic gradient with float64 features),
# and the witness to 0.5% against a central difference at GRAD_STEP of its
# own NMLL.  Central differences of the float32 exact_nmll are printed
# beside them, not gated: its float32 chunk products make it rough in
# sigma at this size (PERF.md, slice B).  L-BFGS-B starts at GRAD_POINT.
TUNE_RFFS, TUNE_ROWS, BAYES_ITER = 2048, 65_536, 30
NMLL_RTOL = 0.01
GRAD_POINT = HPARAMS + np.array([0.5, 0.5])
GRAD_STEP, GRAD_RTOL = 1e-3, 0.005

# The referee (phase 10): the 1M north star's verify width, 256 RFFs (K3
# at F 128, one TILE_FREQS tile) and rank 64, on the sequence slice's
# rows.  GramEngine's SLQ is held to the north star's 1e-3 of the exact
# NMLL of the same Gram; the engine's SLQ to 1e-6 relative of
# GramEngine's (same features, probes and preconditioner seed; the
# engine's matvec products are float32 on the card, the Gram's float64).
VERIFY_RFFS, VERIFY_RANK = 256, 64
REFEREE_SLQ_RTOL, ENGINE_VS_GRAM_RTOL = 1e-3, 1e-6

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
    """The kernels' launch counters by name: Counters keyed by the launch's
    shape, whose first entry is the row count (K1 (R, D, F, K), K2
    (N, D, F), K3 and K4 (N, L, D, w, F))."""
    from xgpr_tpu_torch.ops.cuda import conv, feature_map, ztzv
    return {"K1": ztzv.LAUNCHES, "K2": feature_map.LAUNCHES,
            "K3": conv.PARTS_LAUNCHES, "K4": conv.MAXPOOL_LAUNCHES}


def reset_counts():
    for counter in counters().values():
        counter.clear()


def read_counts():
    """A copy of every counter."""
    return {k: Counter(c) for k, c in counters().items()}


def counts_since(before):
    now = read_counts()
    return {k: now[k] - before[k] for k in now}


def totals(counts):
    return {k: c.total() for k, c in counts.items()}


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


def timed_entry(name, key, err, ms, plain_ms, kb, shape):
    """One timed kernel case, keyed by (kernel, launch shape without its
    row count) as the kernels line matches the launches to it."""
    return {(name, key): dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound=kb, shape=shape)}


def phase_kernels(torch, card):
    """K1 and K2 against their plain versions on the card, timed at every
    shape the main path launches them at."""
    from xgpr_tpu_torch.kernels import RBF, Conv1dTwoLayer
    from xgpr_tpu_torch.ops.cuda import feature_map, ztzv
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    kernel = RBF((CHUNK, N_FEATURES), NUM_RFFS, SEED, device="cuda")
    proj = kernel._dense_proj()                       # (84, 4096), fp32
    tune = RBF((CHUNK, N_FEATURES), TUNE_RFFS, SEED, device="cuda")
    two = Conv1dTwoLayer((CHUNK, MOTIF_L, MOTIF_D), K4_RFFS, SEED,
                         device="cuda",
                         kernel_spec_parms={"conv_width": MOTIF_W,
                                            "init_rffs": INIT_RFFS})
    proj2 = two._dense_projs()[1]                     # (1024, 2048), fp32

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    results = {}
    # --- K2: slice A's shape (padded 128, 32 blocks), the tuning width's
    # (F 1024), ragged cases, and the K4 path's second layer (D 1024,
    # F 2048, padded 1024) on nonnegative rows like its sigma-scaled
    # maxpool profiles ------------------------------------------------
    x_tab = t(rng.standard_normal((CHUNK, N_FEATURES)) * 0.5)
    cases = [(x_tab, proj, kernel.padded_dims, True, "slice"),
             (x_tab, tune._dense_proj(), tune.padded_dims, True,
              f"tuning ({TUNE_RFFS} RFFs)"),
             (t(rng.random((CHUNK, proj2.shape[0])) * 0.1), proj2,
              two._feature_padded, True, "K4 path")]
    for intercept in (False, True):
        cases.append((t(rng.standard_normal((257, 10)) * 0.5),
                      t(rng.standard_normal((10, 200)) * 0.7), 16,
                      intercept, f"ragged intercept={intercept}"))
    for x, pr, padded, intercept, label in cases:
        n = x.shape[0]
        got = feature_map.rbf_feature_map(x, pr, intercept, padded)
        want = feature_map.rbf_feature_map_plain(x, pr, intercept, padded)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"K2 feature map {label}: N={n} D={pr.shape[0]} "
              f"F={pr.shape[1]} padded={padded} max_abs_err={err:.3e} "
              f"(tol {FEATURE_ATOL:g})", flush=True)
        check(err < FEATURE_ATOL, f"K2 {label} disagrees ({err})")
        if label.startswith("ragged"):
            continue
        ms = time_ms(torch, lambda: feature_map.rbf_feature_map(
            x, pr, intercept, padded))
        plain_ms = time_ms(torch, lambda: feature_map.rbf_feature_map_plain(
            x, pr, intercept, padded))
        mm_ms = time_ms(torch, lambda: torch.matmul(x, pr))
        d, f = pr.shape
        kb = bound(4 * (n * d + d * f + n * 2 * f), 2 * n * d * f)
        print(f"K2 time at {label} shape: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, {bound_text(kb)}; projection matmul "
              f"alone (partial yardstick) {mm_ms:.4f} ms [{card}]",
              flush=True)
        results.update(timed_entry(
            "K2", (d, f), err, ms, plain_ms, kb,
            f"N {n}, D {d}, F {f}, padded {padded}"))

    # --- K1: slice shape for K = 1, 26 and a ragged masked case --------
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
        k1_err = 0.0
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
        if label == "ragged":
            continue
        if k == 1:
            again = ztzv.ztzv_parts(x, m, pr, sig, vc, vs, False)
            torch.cuda.synchronize()
            same = torch.equal(again[0], oc) and torch.equal(again[1], os_)
            print(f"K1 determinism at slice shape (K=1): two calls "
                  f"bitwise equal: {same}", flush=True)
            check(same, "two K1 calls on the same inputs differ")
        d, f = pr.shape
        ms = time_ms(torch, lambda: ztzv.ztzv_parts(
            x, m, pr, sig, vc, vs, True))
        plain_ms = time_ms(torch, lambda: ztzv.ztzv_parts_plain(
            x, m, pr, sig, vc, vs, True))
        kb = bound(4 * (n * d + n + d * f + 4 * f * k),
                   2 * n * d * f + 8 * n * f * k)
        print(f"K1 time at slice shape (K={k}): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, {bound_text(kb)} [{card}]",
              flush=True)
        results.update(timed_entry("K1", (d, f, k), k1_err, ms, plain_ms, kb,
                                   f"R {n}, D {d}, F {f}, K {k}"))
    return results


def phase_slice(torch, card, tab):
    """Slice A: fit(mode="cg") + predict(get_var=True) at a real size, on
    ``tab`` = (train dataset, test x, test y)."""
    from scipy.stats import spearmanr
    from xgpr_tpu_torch import GPRegression
    from xgpr_tpu_torch.ops.cuda import feature_map

    dset, tex, te_y = tab
    model = GPRegression(num_rffs=NUM_RFFS, variance_rffs=VARIANCE_RFFS,
                         kernel_choice="RBF", device="cuda", verbose=False)
    model.set_hyperparams(HPARAMS, dset)

    reset_counts()
    t0 = time.perf_counter()
    n_iter, losses = model.fit(dset, mode="cg", run_diagnostics=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = read_counts()
    fit_n = totals(fit_counts)
    print(f"fit: {fit_s:.3f}s, CG iterations {n_iter}, final relative "
          f"residual {losses[-1]:.3e}; launches during fit: {fit_n}",
          flush=True)
    check(n_iter < 500 and losses[-1] < 1e-6, "CG did not converge")
    check(fit_n["K1"] > 0, "K1 was not launched during fit")
    check(fit_n["K2"] > 0, "K2 was not launched during fit")

    reset_counts()
    t0 = time.perf_counter()
    preds, var = model.predict(tex, get_var=True)
    predict_s = time.perf_counter() - t0
    predict_counts = read_counts()
    print(f"predict: {predict_s:.3f}s for {N_TEST} rows; launches "
          f"{totals(predict_counts)}", flush=True)
    check(predict_counts["K2"].total() > 0,
          "K2 was not launched during predict")
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
    return {k: fit_counts[k] + predict_counts[k] for k in fit_counts}


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
                       num_rffs=NUM_RFFS, init_rffs=INIT_RFFS,
                       tune_rffs=TUNE_RFFS, verify_rffs=VERIFY_RFFS):
    """K3 and K4 against their plain versions, at the shapes the main path
    launches them at (chunks of the corpus, the models' own projections:
    the sequence slice's, and K3 at the tuning and verify widths too), a
    ragged case and w = 1; each main-path shape is timed."""
    from xgpr_tpu_torch.kernels import Conv1dRBF, Conv1dTwoLayer
    from xgpr_tpu_torch.ops.conv import conv_row_scale
    from xgpr_tpu_torch.ops.cuda import conv
    rng = np.random.default_rng(11)
    x_np, _, l_np = corpus
    xdim = (chunk, MOTIF_L, MOTIF_D)
    spec = {"conv_width": MOTIF_W}
    k3 = Conv1dRBF(xdim, num_rffs, SEED, device=dev, kernel_spec_parms=spec)
    k3_tune = Conv1dRBF(xdim, tune_rffs, SEED, device=dev,
                        kernel_spec_parms=spec)
    k3_verify = Conv1dRBF(xdim, verify_rffs, SEED, device=dev,
                          kernel_spec_parms=spec)
    k4 = Conv1dTwoLayer(xdim, K4_RFFS, SEED, device=dev,
                        kernel_spec_parms={"conv_width": MOTIF_W,
                                           "init_rffs": init_rffs})
    proj3, proj4 = k3._dense_proj(), k4._dense_projs()[0]
    proj3_tune = k3_tune._dense_proj()
    proj3_verify = k3_verify._dense_proj()
    sigma = float(np.exp(MOTIF_HPARAMS[1]))

    def t(a, dtype=k3.dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    def ragged(n, l, d, width, f):
        x = t(rng.standard_normal((n, l, d)) * 0.5)
        lens = t(rng.integers(width, l + 1, size=n), torch.int32)
        return x, lens, t(rng.standard_normal((width * d, f)) * 0.3)

    def row_scale(pr):
        return conv_row_scale(l_slice, MOTIF_W, pr.shape[1], 0, k3.dtype,
                              dev)

    x_slice, l_slice = t(x_np[:chunk]), t(l_np[:chunk], torch.int32)
    nk_sum = int(np.clip(l_np[:chunk] - MOTIF_W + 1, 0, None).sum())
    others = [("ragged", *ragged(1000, 9, 16, 5, 200), 5, None),
              ("w=1", *ragged(300, 12, 21, 1, 256), 1, None),
              ("D=21", *ragged(700, 14, 21, 6, 300), 6, None)]
    # Cases whose label does not start with "slice" are checked, not timed.
    cases = {
        "K3": [("slice", x_slice, l_slice, proj3, MOTIF_W, row_scale(proj3)),
               (f"slice, tuning ({tune_rffs} RFFs)", x_slice, l_slice,
                proj3_tune, MOTIF_W, row_scale(proj3_tune)),
               (f"slice, verify ({verify_rffs} RFFs)", x_slice, l_slice,
                proj3_verify, MOTIF_W, row_scale(proj3_verify))] + others,
        "K4": [("slice", x_slice, l_slice, proj4, MOTIF_W, None)] + others,
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
        for label, x, lens, proj, width, rs in kcases:
            got = kernel_fn(x, lens, proj, width, rs)
            want = plain_fn(x, lens, proj, width, rs)
            sync(torch, dev)
            scale = max(1.0, max(float(w.abs().max()) for w in want))
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            n, l, d = x.shape
            f = proj.shape[1]
            print(f"{name} {label}: N={n} L={l} D={d} w={width} F={f} "
                  f"max_abs_err={err:.3e} max|ref|={scale:.3e} "
                  f"(tol {CONV_RTOL:g} * max(1, max|ref|))", flush=True)
            check(err < CONV_RTOL * scale, f"{name} {label} disagrees ({err})")
            if not label.startswith("slice"):
                continue
            ms = time_ms(torch, lambda: kernel_fn(x, lens, proj, width, rs),
                         dev=dev)
            plain_ms = time_ms(torch, lambda: plain_fn(x, lens, proj, width,
                                                       rs), reps=3, dev=dev)
            slab = conv.window_slab(x, width)
            mm_ms = time_ms(torch, lambda: torch.matmul(slab, proj), dev=dev)
            out_cols = 2 * f if name == "K3" else f
            flops = 2 * width * d * f * nk_sum
            kb = bound(4 * (n * l * d + n + width * d * f + n * out_cols)
                       + (4 * n if name == "K3" else 0), flops)
            slots, valid = conv.window_slots(lens, width, l - width + 1)
            print(f"{name} time at {label} shape: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, {bound_text(kb)}; {nk_sum} valid "
                  f"windows, {flops / 1e9:.1f} GFLOP; projection matmul "
                  f"alone (partial yardstick, no mask/sincos/sum) "
                  f"{mm_ms:.4f} ms [{card}]", flush=True)
            tc_flops = 3 * flops * slots / valid
            print(f"{name} at {label} shape: {slots} window slots projected "
                  f"for {valid} valid windows ({slots / valid:.3f} : 1); "
                  f"achieved {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s on the "
                  f"valid-window work "
                  f"({flops * 1e3 / ms / PEAK_FP32_FLOPS:.1%} of the fp32 "
                  f"CUDA-core peak; the tensor cores run "
                  f"{tc_flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s of TF32 "
                  f"products on the projected slots, "
                  f"{tc_flops * 1e3 / ms / PEAK_TF32_FLOPS:.1%} of peak) "
                  f"[{card}]", flush=True)
            results.update(timed_entry(
                name, (l, d, width, f), err, ms, plain_ms, kb,
                f"N {n}, L {l}, D {d}, w {width}, F {f}"))
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
          f"{totals(fit_counts)}", flush=True)
    check(n_iter < 500 and losses[-1] < 1e-6, "Conv1dRBF CG did not converge")
    model.verbose = False

    reset_counts()
    t0 = time.perf_counter()
    preds, var = model.predict(tex, te_l, get_var=True)
    predict_s = time.perf_counter() - t0
    predict_counts = read_counts()
    print(f"Conv1dRBF predict: {predict_s:.3f}s for {n_test} rows; "
          f"launches {totals(predict_counts)}", flush=True)
    if torch.device(dev).type == "cuda":
        check(fit_counts["K3"].total() > 0, "K3 was not launched during fit")
        check(predict_counts["K3"].total() > 0,
              "K3 was not launched during predict")
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
    return ({k: fit_counts[k] + predict_counts[k] for k in fit_counts},
            n_iter, preds)


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
          f"predict and FastConv1d: {totals(counts)}", flush=True)
    check(n_iter < 500 and losses[-1] < 1e-6,
          "Conv1dTwoLayer CG did not converge")
    if torch.device(dev).type == "cuda":
        check(counts["K4"].total() > 0, "K4 was not launched on the K4 path")
        check(counts["K2"].total() > 0, "K2 was not launched on the K4 path")
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
    return counts


def phase_streamed(torch, card, corpus, stacked, n_train=N_TRAIN,
                   n_test=N_TEST, dev="cuda", chunk=CHUNK,
                   num_rffs=NUM_RFFS, variance_rffs=VARIANCE_RFFS):
    """The sequence slice's fit and predict again, with the dataset
    streamed (on the card through the prefetcher: pinned staging, a copy
    stream, events), against the stacked fit's (CG iterations,
    predictions) in ``stacked``; then one CG iteration's data pass split
    into host assembly, copy and compute."""
    from xgpr_tpu_torch import GPRegression, build_regression_dataset, config
    from xgpr_tpu_torch.fitting.engine import Engine
    from xgpr_tpu_torch.parallel.streaming import iteration_split
    n_stacked, preds_stacked = stacked
    x, y, lens = corpus
    dset = build_regression_dataset(x[:n_train], y[:n_train], lens[:n_train],
                                    chunk_size=chunk)
    tex, te_l = x[n_train:n_train + n_test], lens[n_train:n_train + n_test]
    model = GPRegression(num_rffs=num_rffs, variance_rffs=variance_rffs,
                         kernel_choice="Conv1dRBF",
                         kernel_settings={"conv_width": MOTIF_W},
                         device=dev, verbose=False)
    model.set_hyperparams(MOTIF_HPARAMS, dset)
    limit = config.stacked_element_limit()
    config.set_stacked_limit(1)
    try:
        reset_counts()
        t0 = time.perf_counter()
        n_iter, losses = model.fit(dset, mode="cg", run_diagnostics=True)
        sync(torch, dev)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        preds = model.predict(tex, te_l)
        predict_s = time.perf_counter() - t0
        counts = read_counts()
        engine = model._engine(dset)
    finally:
        config.set_stacked_limit(limit)
    on_card = torch.device(dev).type == "cuda"
    check(engine.mode == "streaming" and
          (engine.prefetcher is not None) == on_card,
          "the fit did not run on the prefetching streamed engine")
    err = float(np.abs(preds - preds_stacked).max())
    tol = PREDICT_RTOL * float(np.abs(preds_stacked).max())
    print(f"streamed Conv1dRBF fit: {fit_s:.3f}s, CG iterations {n_iter} "
          f"(stacked {n_stacked}), final relative residual {losses[-1]:.3e}; "
          f"predictions vs the stacked fit's max_abs_err {err:.3e} (tol "
          f"{tol:.3e}); launches {counts_text(counts)} [{card}]",
          flush=True)
    report_times(model, n_iter, predict_s, card, "streamed Conv1dRBF")
    check(abs(n_iter - n_stacked) <= 1, "the streamed fit's CG iterations "
                                        "differ from the stacked fit's")
    check(err < tol, "streamed predictions disagree with the stacked fit's")
    if on_card:
        check(counts["K3"].total() > 0, "K3 was not launched during the "
                                        "streamed fit")
        vec = np.random.default_rng(5).standard_normal(model.num_rffs)
        split = iteration_split(engine, Engine(model.kernel, dset,
                                               mode="stacked"), vec)
        print(f"streamed CG iteration's data pass ({split['chunks']} chunks "
              f"of {chunk} rows): {split['streamed_s'] * 1e3:.1f} ms "
              f"streamed; host assembly (padded_batches and the pinned "
              f"fill) {split['host_s'] * 1e3:.1f} ms, copies "
              f"{split['copy_s'] * 1e3:.1f} ms ({split['copy_gb_per_s']:.1f} "
              f"GB/s), compute (the stacked pass) "
              f"{split['compute_s'] * 1e3:.1f} ms [{card}]", flush=True)
    return counts


def phase_referee(torch, card, corpus, n_train=N_TRAIN, dev="cuda",
                  chunk=CHUNK, verify_rffs=VERIFY_RFFS,
                  verify_rank=VERIFY_RANK):
    """GramEngine as the referee at the 1M north star's verify width on the
    sequence slice's rows, pinned hyperparameters: the Gram from K3's
    float32 features with float64 chunk products; its exact NMLL, its SLQ
    NMLL, and approximate_nmll (the streaming engine's SLQ) with the same
    rank, probes and seed."""
    from xgpr_tpu_torch import GPRegression, build_regression_dataset
    from xgpr_tpu_torch.constants import DEFAULT_NMLL_PARAMS as NMLL
    from xgpr_tpu_torch.fitting.gram_engine import GramEngine
    from xgpr_tpu_torch.models.regression import exact_nmll_from_design
    from xgpr_tpu_torch.preconditioners.nystrom import NystromPreconditioner
    from xgpr_tpu_torch.scoring.slq import slq_nmll_from_engine
    x, y, lens = corpus
    dset = build_regression_dataset(x[:n_train], y[:n_train], lens[:n_train],
                                    chunk_size=chunk)
    model = GPRegression(num_rffs=verify_rffs, kernel_choice="Conv1dRBF",
                         kernel_settings={"conv_width": MOTIF_W},
                         device=dev, verbose=False)
    model.set_hyperparams(MOTIF_HPARAMS, dset)
    reset_counts()
    t0 = time.perf_counter()
    design = model._engine(dset).design_mat()
    gram = GramEngine(*design, model.kernel, n_train)
    sync(torch, dev)
    gram_s = time.perf_counter() - t0
    lam = model.kernel.get_lambda()
    exact = exact_nmll_from_design(*design, lam, n_train)
    t0 = time.perf_counter()
    precond = NystromPreconditioner(gram, verify_rank, False,
                                    model.random_seed, "srht_2")
    slq_gram = slq_nmll_from_engine(gram, precond, model.random_seed,
                                    NMLL["nsamples"], NMLL["nmll_iter"],
                                    NMLL["nmll_tol"])
    gram_slq_s = time.perf_counter() - t0
    (slq_engine, engine_s, _) = nmll_call(
        torch, dev, model.approximate_nmll, MOTIF_HPARAMS, dset,
        {"max_rank": verify_rank, "preconditioner_mode": "srht_2"})
    counts = read_counts()
    gap = rel_gap(slq_gram, exact)
    engine_gap = rel_gap(slq_engine, slq_gram)
    print(f"referee at {verify_rffs} RFFs, rank {verify_rank}, {n_train} "
          f"rows: Gram (float64 chunk products) {gram_s:.3f}s, exact NMLL "
          f"{exact:.6f}; GramEngine SLQ {slq_gram:.6f} in {gram_slq_s:.3f}s "
          f"(gap to exact {gap:.3e}, gate {REFEREE_SLQ_RTOL}; achieved ratio "
          f"{precond.achieved_ratio:.6g}); approximate_nmll {slq_engine:.6f} "
          f"in {engine_s:.3f}s (gap to GramEngine's {engine_gap:.3e}, gate "
          f"{ENGINE_VS_GRAM_RTOL}); launches {counts_text(counts)} [{card}]",
          flush=True)
    check(gap < REFEREE_SLQ_RTOL, "GramEngine's SLQ is not within 1e-3 of "
                                  "the exact NMLL")
    check(engine_gap < ENGINE_VS_GRAM_RTOL, "the engine's SLQ is not within "
                                            "1e-6 of GramEngine's")
    if torch.device(dev).type == "cuda":
        check(counts["K3"].total() > 0, "K3 was not launched by the referee")
    return counts


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


def nmll_call(torch, dev, fn, *args):
    """(result, seconds, launches) of one NMLL evaluation; the penalty
    score fails the run."""
    from xgpr_tpu_torch.constants import DEFAULT_SCORE_IF_PROBLEM
    before = read_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    sync(torch, dev)
    secs = time.perf_counter() - t0
    score = out[0] if isinstance(out, tuple) else out
    check(score != DEFAULT_SCORE_IF_PROBLEM and np.isfinite(score),
          f"{fn.__name__} returned the penalty score ({score})")
    return out, secs, counts_since(before)


def rel_gap(a, b):
    return abs(a - b) / abs(b)


def k1_by_k(counts):
    """K1's launches by their number of right-hand sides."""
    out = Counter()
    for shape, n in counts["K1"].items():
        out[shape[3]] += n
    return out


def phase_rbf_nmll(torch, card, dset, dev="cuda", num_rffs=NUM_RFFS):
    """exact_nmll and approximate_nmll (default settings) on slice A's
    data at the pinned hyperparameters; then the approximate NMLL's two
    parts timed apart: the amortized preconditioner (the cached rank) and
    the SLQ solve.  Returns the split's launches apart: it calls the
    model's internals, not an entry point."""
    from xgpr_tpu_torch import GPRegression, constants
    from xgpr_tpu_torch.scoring.slq import slq_nmll_from_engine
    model = GPRegression(num_rffs=num_rffs, kernel_choice="RBF", device=dev,
                         verbose=False)
    model.set_hyperparams(HPARAMS, dset)
    exact, exact_s, exact_counts = nmll_call(torch, dev, model.exact_nmll,
                                             HPARAMS, dset)
    approx, approx_s, counts = nmll_call(torch, dev, model.approximate_nmll,
                                         HPARAMS, dset)
    by_k = k1_by_k(counts)
    rank = model._nmll_rank_cache[1]
    gap = rel_gap(approx, exact)
    print(f"RBF NMLL at {num_rffs} RFFs: exact {exact:.6f} in {exact_s:.3f}s "
          f"(launches {counts_text(exact_counts)}), approximate "
          f"{approx:.6f} in {approx_s:.3f}s (launches {counts_text(counts)}),"
          f" relative gap {gap:.3e} (gate {NMLL_RTOL}); "
          f"preconditioner rank {rank} (srht_2); K1 launches by K during "
          f"approximate_nmll {dict(by_k)} [{card}]", flush=True)
    check(gap < NMLL_RTOL, "RBF approximate NMLL is not within 1% of exact")

    before = read_counts()
    t0 = time.perf_counter()
    precond = model._amortized_nmll_preconditioner(dset)
    sync(torch, dev)
    pre_s = time.perf_counter() - t0
    settings = constants.DEFAULT_NMLL_PARAMS
    engine = model._engine(dset)
    t0 = time.perf_counter()
    slq = slq_nmll_from_engine(engine, precond, model.random_seed,
                               settings["nsamples"], settings["nmll_iter"],
                               settings["nmll_tol"])
    sync(torch, dev)
    slq_s = time.perf_counter() - t0
    split = counts_since(before)
    # The stacked engine launches K1 once per chunk per CG iteration.
    k = settings["nsamples"] + 1
    n_chunks = dset.get_n_batches()
    on_card = torch.device(dev).type == "cuda"
    iters = k1_by_k(split)[k] / n_chunks if on_card else None
    it_text = "not counted (no K1 on the CPU)" if iters is None else (
        f"{iters:g} ({iters * n_chunks:g} K1 launches at K={k} over "
        f"{n_chunks} chunks), {slq_s / iters * 1e3:.2f} ms per iteration")
    print(f"RBF approximate NMLL split: preconditioner at the cached rank "
          f"{precond.get_rank()} {pre_s:.3f}s, SLQ solve {slq_s:.3f}s "
          f"(NMLL {slq:.6f}); SLQ CG iterations {it_text} [{card}]",
          flush=True)
    if on_card:
        check(by_k[k] > 0, f"K1 was not launched at K={k} during "
                           "approximate_nmll")
    return {"k26": by_k[k], "approx_s": approx_s, "slq_s": slq_s,
            "split": split}


def central_difference(fn, point, step):
    """Central differences of fn at point, one coordinate at a time."""
    num = np.zeros_like(point)
    for i in range(point.shape[0]):
        e = np.zeros_like(point)
        e[i] = step
        num[i] = (fn(point + e) - fn(point - e)) / (2 * step)
    return num


def rel_err(got, want):
    return np.abs(got - want) / np.abs(want)


def phase_rbf_gradient(torch, card, dset, dev="cuda", num_rffs=TUNE_RFFS):
    """exact_nmll_gradient at GRAD_POINT against its float64 witness, and
    the witness against central differences of its own NMLL; then an
    L-BFGS-B tune from GRAD_POINT."""
    from xgpr_tpu_torch import GPRegression, config
    from xgpr_tpu_torch.constants import DEFAULT_SCORE_IF_PROBLEM
    model = GPRegression(num_rffs=num_rffs, kernel_choice="RBF", device=dev,
                         verbose=False)
    model.set_hyperparams(GRAD_POINT, dset)
    (score, grad), grad_s, _ = nmll_call(
        torch, dev, model.exact_nmll_gradient, GRAD_POINT, dset)
    # The witness: the same analytic gradient on the same rows with float64
    # features and chunk products.  The gradient fns are plain torch, so
    # no kernel runs in it; the NMLL it returns is the exact NMLL.
    with config.working_dtype(torch.float64):
        wit = GPRegression(num_rffs=num_rffs, kernel_choice="RBF",
                           device=dev, verbose=False)
        wit.set_hyperparams(GRAD_POINT, dset)
        (score64, grad64), wit_s, _ = nmll_call(
            torch, dev, wit.exact_nmll_gradient, GRAD_POINT, dset)
        num64 = central_difference(
            lambda h: nmll_call(torch, dev, wit.exact_nmll_gradient, h,
                                dset)[0][0], GRAD_POINT, GRAD_STEP)
        check(wit.kernel.dtype == torch.float64, "the witness is not float64")
    del wit
    num32 = {step: central_difference(
        lambda h: nmll_call(torch, dev, model.exact_nmll, h, dset)[0],
        GRAD_POINT, step) for step in (GRAD_STEP, 10 * GRAD_STEP)}
    err32, err64 = rel_err(grad, grad64), rel_err(grad64, num64)
    noise = "; ".join(f"at step {step:g} {num} ({rel_err(grad, num)} off "
                      f"the analytic)" for step, num in num32.items())
    print(f"RBF gradient at {num_rffs} RFFs on {dset.get_ndatapoints()} "
          f"rows, log hyperparameters {GRAD_POINT}: float32 features (the "
          f"card's path) NMLL {score:.6f}, analytic {grad} in {grad_s:.3f}s; "
          f"float64 witness NMLL {score64:.6f}, analytic {grad64} in "
          f"{wit_s:.3f}s, central difference of its NMLL at step "
          f"{GRAD_STEP:g} {num64}; relative error float32 vs witness "
          f"{err32}, witness vs central difference {err64} (gate "
          f"{GRAD_RTOL} each) [{card}]", flush=True)
    print(f"RBF gradient: central differences of the float32 exact_nmll "
          f"(not gated; its float32 chunk products make it rough in "
          f"sigma): {noise} [{card}]", flush=True)
    check(np.all(err32 < GRAD_RTOL), "the analytic gradient disagrees with "
                                     "its float64 witness")
    check(np.all(err64 < GRAD_RTOL), "the float64 analytic gradient "
                                     "disagrees with the central difference")

    evals = []
    cost = model.exact_nmll_gradient

    def recorded(h, d):
        out = cost(h, d)
        evals.append(out[0])
        return out
    model.exact_nmll_gradient = recorded
    t0 = time.perf_counter()
    tuned, n_feval, best = model.tune_hyperparams(
        dset, tuning_method="L-BFGS-B", nmll_method="exact", max_iter=5,
        starting_hyperparams=GRAD_POINT)
    sync(torch, dev)
    tune_s = time.perf_counter() - t0
    print(f"L-BFGS-B (exact NMLL, max_iter 5) from {GRAD_POINT}: score "
          f"{score:.6f} -> {best:.6f} at {tuned}, {n_feval} evaluations in "
          f"{tune_s:.3f}s ({tune_s / max(n_feval, 1):.3f}s each) [{card}]",
          flush=True)
    check(DEFAULT_SCORE_IF_PROBLEM not in evals,
          "an L-BFGS-B evaluation returned the penalty score")
    check(best <= score, "L-BFGS-B raised the score")


def phase_conv_tune(torch, card, corpus, dev="cuda", tune_rows=TUNE_ROWS,
                    n_train=N_TRAIN, n_test=N_TEST, chunk=CHUNK,
                    tune_rffs=TUNE_RFFS, num_rffs=NUM_RFFS,
                    variance_rffs=VARIANCE_RFFS, bayes_iter=BAYES_ITER,
                    spearman_floor=MOTIF_SPEARMAN_FLOOR):
    """Conv1dRBF: crude tune on a row subsample, refit with the tuned
    hyperparameters, and the approximate NMLL against the exact there."""
    from scipy.stats import spearmanr
    from xgpr_tpu_torch import GPRegression, build_regression_dataset
    from xgpr_tpu_torch.constants import DEFAULT_SCORE_IF_PROBLEM
    from xgpr_tpu_torch.scoring import surrogate_tuner
    x, y, lens = corpus
    settings = {"conv_width": MOTIF_W}
    tune_set = build_regression_dataset(x[:tune_rows], y[:tune_rows],
                                        lens[:tune_rows], chunk_size=chunk)
    model = GPRegression(num_rffs=tune_rffs, kernel_choice="Conv1dRBF",
                         kernel_settings=settings, device=dev, verbose=False)
    scores = []
    search = surrogate_tuner.shared_hparam_search

    def recorded(*args, **kw):
        out = search(*args, **kw)
        scores.append(out[0])
        return out
    surrogate_tuner.shared_hparam_search = recorded
    t0 = time.perf_counter()
    try:
        tuned, n_feval, best = model.tune_hyperparams_crude(
            tune_set, max_bayes_iter=bayes_iter)
    finally:
        surrogate_tuner.shared_hparam_search = search
    sync(torch, dev)
    tune_s = time.perf_counter() - t0
    print(f"Conv1dRBF crude tune on {tune_rows} rows at {tune_rffs} RFFs "
          f"(max_bayes_iter {bayes_iter}): {tuned} (the 1M north star's "
          f"{MOTIF_HPARAMS}), score {best}, n_feval {n_feval}, "
          f"{tune_s:.3f}s ({tune_s / max(n_feval, 1):.3f}s per evaluation) "
          f"[{card}]", flush=True)
    check(len(scores) == n_feval and all(
        s < 0.1 * DEFAULT_SCORE_IF_PROBLEM for s in scores),
          "a crude-tune evaluation returned the penalty score")
    del model, tune_set

    train = build_regression_dataset(x[:n_train], y[:n_train],
                                     lens[:n_train], chunk_size=chunk)
    tex, te_y, te_l = (a[n_train:n_train + n_test] for a in (x, y, lens))
    model = GPRegression(num_rffs=num_rffs, variance_rffs=variance_rffs,
                         kernel_choice="Conv1dRBF", kernel_settings=settings,
                         device=dev, verbose=False)
    model.set_hyperparams(tuned, train)
    t0 = time.perf_counter()
    n_iter, losses = model.fit(train, mode="cg", run_diagnostics=True)
    preds = model.predict(tex, te_l)
    sync(torch, dev)
    fit_s = time.perf_counter() - t0
    rho = float(spearmanr(preds, te_y)[0])
    print(f"Conv1dRBF refit at {num_rffs} RFFs on {n_train} rows with the "
          f"tuned hyperparameters: fit + predict {fit_s:.3f}s, CG "
          f"iterations {n_iter}, held-out Spearman {rho:.4f} (floor "
          f"{spearman_floor}) [{card}]", flush=True)
    check(n_iter < 500 and losses[-1] < 1e-6, "the refit's CG did not "
                                               "converge")
    check(rho > spearman_floor, "Spearman after tuning is below the floor")

    exact, exact_s, _ = nmll_call(torch, dev, model.exact_nmll, tuned, train)
    approx, approx_s, _ = nmll_call(torch, dev, model.approximate_nmll, tuned,
                                    train)
    gap = rel_gap(approx, exact)
    print(f"Conv1dRBF NMLL at the tuned point, {num_rffs} RFFs: exact "
          f"{exact:.6f} in {exact_s:.3f}s, approximate {approx:.6f} in "
          f"{approx_s:.3f}s (rank {model._nmll_rank_cache[1]}), relative gap "
          f"{gap:.3e} (gate {NMLL_RTOL}) [{card}]", flush=True)
    check(gap < NMLL_RTOL, "Conv1dRBF approximate NMLL is not within 1% of "
                           "exact")


def counts_text(counts):
    return ", ".join(f"{k} {v}" for k, v in sorted(totals(counts).items()))


def time_gradient_maps(torch, card, tab, corpus, dev="cuda", chunk=CHUNK,
                       num_rffs=TUNE_RFFS):
    """The gradient feature maps (plain torch on every device) on one
    chunk at the tuning width: RBF's dense one on slice A's test rows
    and Conv1dRBF's on the motif corpus."""
    from xgpr_tpu_torch.kernels import RBF, Conv1dRBF
    x_tab = tab[1][:chunk]
    x_seq, _, l_seq = (a[:chunk] for a in corpus)
    for name, kern, x, lens in (
            ("RBF", RBF((chunk, N_FEATURES), num_rffs, SEED, device=dev),
             x_tab, None),
            ("Conv1dRBF", Conv1dRBF((chunk, MOTIF_L, MOTIF_D), num_rffs,
                                    SEED, device=dev,
                                    kernel_spec_parms={"conv_width":
                                                       MOTIF_W}),
             x_seq, l_seq)):
        kern.set_hyperparams(HPARAMS if lens is None else MOTIF_HPARAMS)
        fn, params = kern.pure_gradient_fn(), kern.gradient_params()
        xt, lt = kern._cast_input(x), kern._cast_lengths(lens)
        ms = time_ms(torch, lambda: fn(params, xt, lt), reps=5, dev=dev)
        feats = kern.pure_feature_fn()
        fms = time_ms(torch, lambda: feats(kern.feature_params(), xt, lt),
                      reps=5, dev=dev)
        print(f"{name} gradient feature map (plain torch) at {chunk} rows, "
              f"{num_rffs} RFFs: {ms:.4f} ms a chunk; the feature fn "
              f"alone (its kernel) {fms:.4f} ms [{card}]", flush=True)


def phase_tuning(torch, card, tab, corpus, dev="cuda"):
    """Slice B: the NMLLs, the gradient and the two tuners; fails unless
    K1 ran at K = 26 and K2 and K3 ran.  Returns the phase's launches."""
    t0 = time.perf_counter()
    time_gradient_maps(torch, card, tab, corpus, dev)
    reset_counts()      # the timing launches above are not the path's
    rbf = phase_rbf_nmll(torch, card, tab[0], dev)
    phase_rbf_gradient(torch, card, tab[0], dev)
    phase_conv_tune(torch, card, corpus, dev)
    counts = {k: c - rbf["split"][k] for k, c in read_counts().items()}
    print(f"tuning phase: {time.perf_counter() - t0:.1f}s; launches through "
          f"the entry points {counts_text(counts)} (and "
          f"{counts_text(rbf['split'])} in the timed split), K1 at K=26 "
          f"{rbf['k26']}; the SLQ solve {rbf['slq_s']:.3f}s of an "
          f"approximate_nmll call's {rbf['approx_s']:.3f}s [{card}]",
          flush=True)
    if torch.device(dev).type == "cuda":
        for name in ("K1", "K2", "K3"):
            check(counts[name].total() > 0,
                  f"{name} was not launched during the tuning phase")
    return counts


SRC, PALLAS = "xgpr_tpu_torch/ops/cuda/csrc/", "xgpr_tpu/ops/pallas/"
KERNELS = {
    "K1": ("ztzv_parts", SRC + "ztzv.cu", PALLAS + "ztzv_pallas.py:240"),
    "K2": ("rbf_feature_map", SRC + "feature_map.cu",
           PALLAS + "sorf_pallas.py:96"),
    "K3": ("conv_parts", SRC + "conv.cu", PALLAS + "conv_pallas.py:302"),
    "K4": ("conv_maxpool", SRC + "conv.cu", PALLAS + "conv_pallas.py:216"),
}


def kernel_rows(path, counts, timed):
    """The kernels line's rows for one path: one per kernel and launch
    shape less its row count, with the launches and the times at that
    shape.  A launch at a shape that was not checked against the plain
    version and timed fails the run."""
    rows = []
    for name in sorted(counts):
        by_shape = {}
        for shape, n in counts[name].items():
            by_shape.setdefault(shape[1:], Counter())[shape[0]] += n
        for key, by_rows in sorted(by_shape.items()):
            res = timed.get((name, key))
            check(res is not None, f"{name} ran on the {path} path at "
                                   f"{key} (its shape less the rows), where "
                                   "it was not held against its plain version")
            fn, source, replaces = KERNELS[name]
            rows.append({
                "name": fn, "route": "cuda", "source": source,
                "replaces": replaces, "path": path,
                "launches": by_rows.total(),
                "launches_by_rows": {str(r): c
                                     for r, c in sorted(by_rows.items())},
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound"]["ms"],
                "bound_by": res["bound"]["by"],
                "cuda_core_bound_ms": res["bound"]["cuda_core_ms"],
                "cuda_core_bound_by": res["bound"]["cuda_core_by"],
                "library_ms": None, "shape": res["shape"]})
    return rows


def design_mat_timing(torch, card, label, reps=3):
    """Engine.design_mat's time on the card at two shapes: slice A's
    262,144 x 84 rows at 8192 RFFs (8192-row chunks, K2 features) and
    100,000 motif rows at 2048 RFFs (16,384-row chunks, K3 features), the
    1M run's tune shape; the mean of ``reps`` warm calls each, and
    exact_nmll's time and value at the pinned point.  Prints one line
    beginning ``VARIANT <label>``."""
    from xgpr_tpu_torch import GPRegression, build_regression_dataset

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / reps

    (x, y), _ = tabular_data(N_TRAIN, 10, N_FEATURES, seed=SEED)
    rbf = GPRegression(num_rffs=NUM_RFFS, kernel_choice="RBF",
                       device="cuda", verbose=False)
    dset = build_regression_dataset(x, y, chunk_size=CHUNK)
    rbf.set_hyperparams(HPARAMS, dset)
    _, rbf_s = timed(rbf._engine(dset).design_mat)
    rbf_exact, rbf_exact_s = timed(lambda: rbf.exact_nmll(HPARAMS, dset))
    del rbf, dset

    xs, ys, ls = motif_corpus(100_000)
    conv = GPRegression(num_rffs=TUNE_RFFS, kernel_choice="Conv1dRBF",
                        kernel_settings={"conv_width": MOTIF_W},
                        device="cuda", verbose=False)
    cset = build_regression_dataset(xs, ys, ls, chunk_size=16384)
    conv.set_hyperparams(MOTIF_HPARAMS, cset)
    _, conv_s = timed(conv._engine(cset).design_mat)
    conv_exact, conv_exact_s = timed(
        lambda: conv.exact_nmll(MOTIF_HPARAMS, cset))
    print(f"VARIANT {label} RBF 262144x84 8192 RFFs design_mat "
          f"{rbf_s:.4f} s, exact_nmll {rbf_exact_s:.4f} s ({rbf_exact!r}) | "
          f"Conv1dRBF 100000 motif rows 2048 RFFs design_mat {conv_s:.4f} s,"
          f" exact_nmll {conv_exact_s:.4f} s ({conv_exact!r}) [{card}]",
          flush=True)


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
    if "--design-mat-timing" in argv:
        i = argv.index("--design-mat-timing")
        design_mat_timing(torch, card, argv[i + 1] if i + 1 < len(argv)
                          else "this")
        return 0
    timed = phase_kernels(torch, card)
    t0 = time.perf_counter()
    (trx, tr_y), (tex, te_y) = tabular_data(N_TRAIN, N_TEST, N_FEATURES,
                                            seed=SEED)
    from xgpr_tpu_torch import build_regression_dataset
    tab = (build_regression_dataset(trx, tr_y, chunk_size=CHUNK), tex, te_y)
    print(f"data: {N_TRAIN} x {N_FEATURES} train, {N_TEST} test, made in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    paths = [("slice A fit + predict", phase_slice(torch, card, tab))]
    t0 = time.perf_counter()
    corpus = motif_corpus(N_TRAIN + N_TEST)
    print(f"motif corpus: {N_TRAIN} + {N_TEST} rows x {MOTIF_L} x "
          f"{MOTIF_D}, made in {time.perf_counter() - t0:.2f}s", flush=True)
    timed.update(phase_conv_kernels(torch, card, corpus))
    conv_counts, n_iter, preds = phase_conv_slice(
        torch, card, corpus, profile="--profile" in argv)
    paths.append(("Conv1dRBF fit + predict", conv_counts))
    paths.append(("K4 path", phase_k4_path(torch, card, corpus)))
    paths.append(("tuning", phase_tuning(torch, card, tab, corpus)))
    paths.append(("streamed Conv1dRBF fit + predict",
                  phase_streamed(torch, card, corpus, (n_iter, preds))))
    paths.append(("referee", phase_referee(torch, card, corpus)))
    print(f"total {time.perf_counter() - t_start:.1f}s [{card}]", flush=True)
    kernels = [row for path, counts in paths
               for row in kernel_rows(path, counts, timed)]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
