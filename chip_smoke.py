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
   version's.  Then the same in the sincos modes "fast" and "poly", each
   kernel against the plain version of the same mode, with a guard case
   (arguments past POLY_ARG_LIMIT, which take the builtin); then K1 in its
   one-pass bf16 body ("default" feature precision, in "fast": what the
   "max" preset launches) and K1 at "highest" (its 3xTF32 body) with K2,
   in "exact" (the "reference" preset), each against the plain version of
   the same mode and precision.
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
   the valid-window work.  K3 again in "fast" and "poly", with a guard
   case, and K3 (in "fast") and K4 in their bf16 body ("default"); each
   "default" time is printed beside the 3xTF32 body's.
6. The sequence slice: Conv1dRBF, 8192 RFFs, fit(mode="cg") with the
   autoselected preconditioner (the model prints the rank it chose),
   predict(get_var=True).  Checks CG convergence, that K3 ran during fit
   and during predict, finite predictions, var >= 0, 4096 predictions
   against the plain K3, and held-out Spearman > 0.75.
   6b. The paths under each sincos mode (``phase_mode_paths``): with
   ``set_sincos_mode("fast")``, then "poly", slice A refit and predicted
   (K1, K2) and phase 6's held-out rows predicted again (K3); CG
   converged, predictions within 1e-4 x max|pred| of the same mode's
   plain path and within 1e-3 x max|pred| of the "hi" run's, Spearman
   above the slice's floor, every launch in the mode.  Prints each
   mode's kernel times beside "hi"'s.
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
11. The classifiers (``phase_rbf_classifier``, ``phase_conv_classifier``):
   GPClassification fit (autoselected preconditioner, softmax NCG) and
   predict, at 8192 RFFs: RBF on 262,144 + 16,384 rows x 84 features of
   the JAX suite's classification generator (5 classes; K2), Conv1dRBF on
   65,536 motif rows with the target cut at its quartiles (4 classes;
   K3).  Gates: the objective never rises, probability rows sum to 1 and
   4096 of them agree with the plain feature map's within 1e-5, K2 / K3
   ran during fit and predict, the engine stayed on the card, held-out
   accuracy at or above the floor.  Prints one NCG iteration's two data
   passes timed apart.
12. The speed presets (``phase_presets``, run after phase 7).  Under
   ``set_speed_preset("max")`` (bf16 bodies of K1, K3 and K4, bf16
   feature materialisation, "fast" sincos): slice A (phase 3's fit and
   predict), the Conv1dRBF slice (phase 6's) and the K4 path (phase 7's),
   each to MAX_TOL with its own gates, and one RBF approximate_nmll
   against its exact_nmll (K1 at K 26).  Under "reference" ("highest",
   which runs the 3xTF32 body, and "exact" sincos): slice A refit and
   predicted.  Gates: held-out Spearman
   within 0.02 of the "balanced" run's, the exact NMLL within 1e-3 of
   "balanced"'s, SLQ within 1% of exact, every K1/K3/K4 launch at the
   preset's precision and every K1-K3 launch in its sincos mode.  Prints
   each fit's CG recurrence residual beside its true residual (float64,
   from the design matrix), its time and iterations beside "balanced"'s,
   and the Conv1dRBF chunk contraction's time with bf16 operands (a
   library call) beside fp32.  Restores "balanced".

The launch counters count by shape and, for K1-K3, sincos mode, and for
K1, K3 and K4 feature precision.  The line before the last is one JSON
object describing the kernels: one row per path (slice A, Conv1dRBF,
both under "fast" and "poly", streamed Conv1dRBF, the referee, the K4
path, the presets' paths, tuning, the two classifiers), kernel and
launch shape less its row count, with the launches at that shape (by row
count) and the times and bound measured at it; a launch at a shape, mode
or precision that phases 2 and 5 did not check and time fails the run.
The last line is {"ok": true, "device": {...}}.
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

# The classifiers (slice D1).  RBF: the JAX suite's classification
# generator (tests/utils/synthetic.py:classification_data) at slice A's
# shape, 262,144 + 16,384 rows x 84 features, 5 classes.  Conv1dRBF: the
# motif corpus, its target cut at its quartiles into 4 classes, 65,536
# training rows and the 16,384 held-out ones.  8192 RFFs, chunk 8192, the
# autoselected preconditioner.  The hyperparameters: RBF from a CPU grid
# on 16,384 rows at 1024 RFFs; Conv1dRBF the regression slice's tuned
# sigma with the RBF classifier's lambda.  Each accuracy floor is the
# held-out accuracy of a float64 CPU fit of both packages on the first
# 16,384 training rows of the same data at 1024 RFFs (RBF 0.960999,
# Conv1dRBF 0.512695, the same in both), less 0.01
# (tests/torch_port/classifier_floors.py; PERF.md).
CLASS_HPARAMS = np.log(np.array([0.3, 0.03]))
CLASS_N_CLASSES = 5
CLASS_ACC_FLOOR = 0.9509
CONV_CLASS_ROWS = 65_536
CONV_CLASS_HPARAMS = np.array([np.log(0.3), MOTIF_HPARAMS[1]])
CONV_CLASS_ACC_FLOOR = 0.5026
# Probability rows sum to 1, and agree with the plain feature map's, to:
PROB_ATOL = 1e-5

# Tolerances, fp32 on both sides with a different summation order:
# features are O(1/sqrt(F)) in magnitude and match to ~1e-5 absolute;
# the matvec sums R * F products, so it is held to 1e-4 of max |ref|; the
# conv window loops sum up to nw O(1) terms of 576-term fp32 dot products,
# so they are held to 1e-4 * max(1, max |ref|).
FEATURE_ATOL = 1e-5
ZTZV_RTOL = 1e-4
# K1's bf16 body ("default") rounds c, s and the summed zv to bf16 as its
# plain version does, but sums in another fp32 order, so a value near a
# bf16 rounding boundary can round apart: a step of up to
# 2^-7 * scale * |zv| in that row's terms (1.4e-4 of max|ref| at 2000 rows
# and 500 frequencies, less at the slice's shape).  Held to 1e-3 of
# max|ref|: room for a few such steps.
K1_DEFAULT_RTOL = 1e-3
CONV_RTOL = 1e-4
PREDICT_RTOL = 1e-4
# The sincos modes beside "hi" that K1, K2 and K3 are instantiated for,
# and the bound on a mode's predictions against the "hi" run's, relative to
# max|pred|.
SINCOS_MODES = ("fast", "poly")
MODE_RTOL = 1e-3

# Published H100 SXM peaks (NVIDIA data sheet): dense TF32 and bf16 on the
# tensor cores, fp32 on CUDA cores and HBM3 bandwidth.  The bounds count
# each input read once, each output written once, and the multiply-adds of
# the projections (2 flops each) on the tensor cores in the body of the
# launch's feature precision (PRODUCTS: 3xTF32 for "high" and "highest",
# one bf16 product for "default"), and as fp32 FMAs for the CUDA-core
# bound.
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PRODUCTS = {"high": (3, PEAK_TF32_FLOPS), "highest": (3, PEAK_TF32_FLOPS),
            "default": (1, PEAK_BF16_FLOPS)}
BODY = {"high": "3xTF32", "highest": "3xTF32", "default": "bf16"}

# The speed presets (phase 12, ``phase_presets``).  Under "max" the fits
# run K1, K3 and K4 in their one-pass bf16 body with bf16 feature
# materialisation and "fast" sincos; under "reference" K1 at "highest"
# (the 3xTF32 body) with the builtin sincos.  Gates (xgpr_tpu's own for
# "max", tests/numerics_tests/test_fast_features.py): held-out Spearman
# within PRESET_RHO of the "balanced" run's, exact NMLL within PRESET_NMLL_RTOL
# of it, predictions within PREDICT_RTOL x max|pred| of the same preset's
# plain path, SLQ within NMLL_RTOL of exact, every launch of K1, K3 and K4
# at the preset's precision.  CG runs to MAX_TOL under "max".
PRESET_RHO, PRESET_NMLL_RTOL = 0.02, 1e-3
MAX_TOL = 1e-6


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


def classification_data(n_train, n_test, n_features, n_classes, seed=123):
    """The JAX suite's synthetic classification generator
    (tests/utils/synthetic.py:classification_data), copied so that this
    script needs nothing from the test tree: classes from the argmax of
    noisy, mildly nonlinear logits around random centres."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    x = rng.standard_normal((n, n_features))
    centers = rng.standard_normal((n_classes, n_features)) * 1.5
    logits = x @ centers.T + 0.5 * np.sin(x[:, :1]) * \
        rng.standard_normal((1, n_classes))
    y = np.argmax(logits + 0.3 * rng.standard_normal((n, n_classes)),
                  axis=1).astype(np.int64)
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])


def quartile_classes(y):
    """A regression target cut at its quartiles into 4 classes."""
    return np.digitize(y, np.quantile(y, [0.25, 0.5, 0.75])).astype(np.int64)


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


def bound(nbytes, flops, precision="high"):
    """Least ms on the published peaks and what sets it: "ms"/"by" with
    the flops on the tensor cores in the body of ``precision``,
    "cuda_core_ms"/"cuda_core_by" with them on CUDA cores."""
    t_bytes = nbytes / PEAK_BYTES
    products, peak = PRODUCTS[precision]
    out = {"body": BODY[precision]}
    for key, t_ops in (("", products * flops / peak),
                       ("cuda_core_", flops / PEAK_FP32_FLOPS)):
        out[key + "ms"] = max(t_bytes, t_ops) * 1e3
        out[key + "by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def bound_text(b):
    return (f"bound {b['ms']:.4f} ms ({b['by']}, tensor cores "
            f"{b['body']}) / {b['cuda_core_ms']:.4f} ms "
            f"({b['cuda_core_by']}, fp32 CUDA cores)")


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


def guard_dense(torch, rng, t, n, d, f):
    """(x, proj) whose row 0 takes arguments past POLY_ARG_LIMIT: one
    nonzero, 5e4, against a proj rounded to TF32, so that each argument is
    one exact product in the kernel's 3xTF32 sum and in the plain fp32
    product alike (and sigma must be 1)."""
    from xgpr_tpu_torch.ops.cuda.operands import split_tf32
    x = t(rng.standard_normal((n, d)) * 0.5)
    x[0] = 0.0
    x[0, 0] = 5e4
    proj = split_tf32(t(rng.standard_normal((d, f)) * 0.5))[0].contiguous()
    return x, proj


def phase_kernels(torch, card, mode="hi", precision="high", k2=True):
    """K1 in sincos ``mode`` and feature ``precision``, and K2 (unless not
    ``k2``; it has no precision variant) in ``mode``, against their plain
    versions in the same mode and precision on the card, timed at every
    shape the main path launches them at; the ragged cases and a guard
    case (arguments past POLY_ARG_LIMIT) are checked, not timed."""
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
    cases.append((*guard_dense(torch, rng, t, 300, 16, 256), 16, True,
                  "ragged guard"))
    for x, pr, padded, intercept, label in cases if k2 else ():
        n = x.shape[0]
        got = feature_map.rbf_feature_map(x, pr, intercept, padded, mode)
        want = feature_map.rbf_feature_map_plain(x, pr, intercept, padded,
                                                 mode)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"K2 feature map ({mode}) {label}: N={n} D={pr.shape[0]} "
              f"F={pr.shape[1]} padded={padded} max_abs_err={err:.3e} "
              f"(tol {FEATURE_ATOL:g})", flush=True)
        check(err < FEATURE_ATOL, f"K2 ({mode}) {label} disagrees ({err})")
        if label.startswith("ragged"):
            continue
        ms = time_ms(torch, lambda: feature_map.rbf_feature_map(
            x, pr, intercept, padded, mode))
        plain_ms = time_ms(torch, lambda: feature_map.rbf_feature_map_plain(
            x, pr, intercept, padded, mode))
        mm_ms = time_ms(torch, lambda: torch.matmul(x, pr))
        d, f = pr.shape
        kb = bound(4 * (n * d + d * f + n * 2 * f), 2 * n * d * f)
        print(f"K2 ({mode}) time at {label} shape: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, {bound_text(kb)}; projection matmul "
              f"alone (partial yardstick) {mm_ms:.4f} ms [{card}]",
              flush=True)
        results.update(timed_entry(
            "K2", (d, f, mode), err, ms, plain_ms, kb,
            f"N {n}, D {d}, F {f}, padded {padded}, sincos {mode}"))

    # --- K1: slice shape for K = 1, 26 and a ragged masked case --------
    sigma = float(np.exp(HPARAMS[1]))
    xg, pg = guard_dense(torch, rng, t, 1000, 16, 300)
    k1_cases = [(CHUNK, proj, 1, sigma, "slice K=1", None),
                (CHUNK, proj, 26, sigma, "slice K=26", None),
                (2000, t(rng.standard_normal((N_FEATURES, 500)) * 0.3), 3,
                 0.7, "ragged", None),
                (xg.shape[0], pg, 2, 1.0, "ragged guard", xg)]
    tag = f"{mode}, {precision}"
    rtol = K1_DEFAULT_RTOL if precision == "default" else ZTZV_RTOL
    for n, pr, k, sig, label, xfix in k1_cases:
        x = t(rng.standard_normal((n, pr.shape[0]))) if xfix is None \
            else xfix
        m = t((rng.random(n) > 0.25).astype(np.float32))
        vc = t(rng.standard_normal((pr.shape[1], k)))
        vs = t(rng.standard_normal((pr.shape[1], k)))
        k1_err = 0.0
        for intercept in (True, False):
            oc, os_ = ztzv.ztzv_parts(x, m, pr, sig, vc, vs, intercept, mode,
                                      precision)
            rc, rs = ztzv.ztzv_parts_plain(x, m, pr, sig, vc, vs, intercept,
                                           mode, precision)
            torch.cuda.synchronize()
            scale = max(1.0, float(rc.abs().max()), float(rs.abs().max()))
            err = max(float((oc - rc).abs().max()),
                      float((os_ - rs).abs().max()))
            print(f"K1 ztzv ({tag}) {label} intercept={intercept}: R={n} "
                  f"D={pr.shape[0]} F={pr.shape[1]} K={k} "
                  f"max_abs_err={err:.3e} max|ref|={scale:.3e} "
                  f"(tol {rtol:g} * max|ref|)", flush=True)
            check(err < rtol * scale, f"K1 ({tag}) {label} disagrees ({err})")
            k1_err = max(k1_err, err)
        if label.startswith("ragged"):
            continue
        if k == 1:
            again = ztzv.ztzv_parts(x, m, pr, sig, vc, vs, False, mode,
                                    precision)
            torch.cuda.synchronize()
            same = torch.equal(again[0], oc) and torch.equal(again[1], os_)
            print(f"K1 ({tag}) determinism at slice shape (K=1): two calls "
                  f"bitwise equal: {same}", flush=True)
            check(same, "two K1 calls on the same inputs differ")
        d, f = pr.shape
        ms = time_ms(torch, lambda: ztzv.ztzv_parts(
            x, m, pr, sig, vc, vs, True, mode, precision))
        plain_ms = time_ms(torch, lambda: ztzv.ztzv_parts_plain(
            x, m, pr, sig, vc, vs, True, mode, precision))
        kb = bound(4 * (n * d + n + d * f + 4 * f * k),
                   2 * n * d * f + 8 * n * f * k, precision)
        print(f"K1 ({tag}) time at slice shape (K={k}): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, {bound_text(kb)} [{card}]",
              flush=True)
        results.update(timed_entry("K1", (d, f, k, mode, precision), k1_err,
                                   ms, plain_ms, kb, f"R {n}, D {d}, F {f}, "
                                   f"K {k}, sincos {mode}, {precision}"))
    return results


def phase_slice(torch, card, tab, dev="cuda", num_rffs=NUM_RFFS,
                variance_rffs=VARIANCE_RFFS, tol=1e-6, label="slice A"):
    """Slice A: fit(mode="cg", tol) + predict(get_var=True) at a real size,
    on ``tab`` = (train dataset, test x, test y).  Returns the launches,
    the predictions and the fit's record (model, fit_s, n_iter, residual,
    rho)."""
    from scipy.stats import spearmanr
    from xgpr_tpu_torch import GPRegression
    from xgpr_tpu_torch.ops.cuda import feature_map

    dset, tex, te_y = tab
    on_card = torch.device(dev).type == "cuda"
    model = GPRegression(num_rffs=num_rffs, variance_rffs=variance_rffs,
                         kernel_choice="RBF", device=dev, verbose=False)
    model.set_hyperparams(HPARAMS, dset)

    reset_counts()
    t0 = time.perf_counter()
    n_iter, losses = model.fit(dset, mode="cg", tol=tol,
                               run_diagnostics=True)
    sync(torch, dev)
    fit_s = time.perf_counter() - t0
    fit_counts = read_counts()
    fit_n = totals(fit_counts)
    print(f"{label} fit: {fit_s:.3f}s, CG iterations {n_iter}, final "
          f"relative residual {losses[-1]:.3e} (tol {tol:g}); launches "
          f"during fit: {fit_n}", flush=True)
    check(n_iter < 500 and losses[-1] < tol, f"{label}: CG did not converge")
    if on_card:
        check(fit_n["K1"] > 0, "K1 was not launched during fit")
        check(fit_n["K2"] > 0, "K2 was not launched during fit")

    reset_counts()
    t0 = time.perf_counter()
    preds, var = model.predict(tex, get_var=True)
    predict_s = time.perf_counter() - t0
    predict_counts = read_counts()
    n_test = len(tex)
    print(f"{label} predict: {predict_s:.3f}s for {n_test} rows; launches "
          f"{totals(predict_counts)}", flush=True)
    if on_card:
        check(predict_counts["K2"].total() > 0,
              "K2 was not launched during predict")
    check(preds.shape == (n_test,) and var.shape == (n_test,),
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
    report_times(model, n_iter, predict_s, card, label)
    return ({k: fit_counts[k] + predict_counts[k] for k in fit_counts}, preds,
            {"model": model, "fit_s": fit_s, "n_iter": n_iter,
             "residual": float(losses[-1]), "rho": rho})


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
                       tune_rffs=TUNE_RFFS, verify_rffs=VERIFY_RFFS,
                       mode="hi", precision="high", with_k4=True):
    """K3 (in sincos ``mode``) and, with ``with_k4``, K4, both at feature
    ``precision``, against their plain versions at the same mode and
    precision, at the shapes the main path launches them at (chunks of the
    corpus, the models' own projections: the sequence slice's, and K3 at
    the tuning and verify widths too), a ragged case, w = 1 and, for K3, a
    guard case (arguments past POLY_ARG_LIMIT); each main-path shape is
    timed.  K4 has no sincos."""
    from xgpr_tpu_torch.kernels import Conv1dRBF, Conv1dTwoLayer
    from xgpr_tpu_torch.ops.conv import conv_row_scale
    from xgpr_tpu_torch.ops.cuda import conv
    from xgpr_tpu_torch.ops.cuda.operands import split_tf32
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
    # The guard: row 0 has one nonzero, 5e4, and proj is rounded to TF32,
    # so each of its window projections is one exact product (times
    # sigma 1) in the kernel and the plain version alike, many past
    # POLY_ARG_LIMIT.
    xg, lg, pg = ragged(400, 12, 8, 4, 256)
    xg[0] = 0.0
    xg[0, 5, 3] = 5e4
    lg[0] = 12
    guard = ("guard", xg, lg, split_tf32(pg)[0].contiguous(), 4, None)
    # Cases whose label does not start with "slice" are checked, not timed.
    cases = {
        "K3": [("slice", x_slice, l_slice, proj3, MOTIF_W, row_scale(proj3)),
               (f"slice, tuning ({tune_rffs} RFFs)", x_slice, l_slice,
                proj3_tune, MOTIF_W, row_scale(proj3_tune)),
               (f"slice, verify ({verify_rffs} RFFs)", x_slice, l_slice,
                proj3_verify, MOTIF_W, row_scale(proj3_verify))] + others
        + [guard],
        "K4": [("slice", x_slice, l_slice, proj4, MOTIF_W, None)] + others,
    }
    if not with_k4:
        del cases["K4"]

    def sig(label):
        return 1.0 if label == "guard" else sigma
    runs = {"K3": (lambda x, l, p, w, rs, sg: conv.conv_parts(
                       x, l, p, sg, w, rs, mode, precision),
                   lambda x, l, p, w, rs, sg: conv.conv_parts_plain(
                       x, l, p, sg, w, rs, mode, precision)),
            "K4": (lambda x, l, p, w, rs, sg: (conv.conv_maxpool(
                       x, l, p, w, precision),),
                   lambda x, l, p, w, rs, sg: (conv.conv_maxpool_plain(
                       x, l, p, w, precision),))}
    results = {}
    for name, kcases in cases.items():
        kernel_fn, plain_fn = runs[name]
        for label, x, lens, proj, width, rs in kcases:
            got = kernel_fn(x, lens, proj, width, rs, sig(label))
            want = plain_fn(x, lens, proj, width, rs, sig(label))
            sync(torch, dev)
            scale = max(1.0, max(float(w.abs().max()) for w in want))
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            n, l, d = x.shape
            f = proj.shape[1]
            tag = f"{name} ({precision})" if name == "K4" else \
                f"{name} ({mode}, {precision})"
            print(f"{tag} {label}: N={n} L={l} D={d} w={width} F={f} "
                  f"max_abs_err={err:.3e} max|ref|={scale:.3e} "
                  f"(tol {CONV_RTOL:g} * max(1, max|ref|))", flush=True)
            check(err < CONV_RTOL * scale, f"{tag} {label} disagrees ({err})")
            if not label.startswith("slice"):
                continue
            ms = time_ms(torch, lambda: kernel_fn(x, lens, proj, width, rs,
                                                  sigma), dev=dev)
            plain_ms = time_ms(torch, lambda: plain_fn(x, lens, proj, width,
                                                       rs, sigma), reps=3,
                               dev=dev)
            slab = conv.window_slab(x, width)
            mm_ms = time_ms(torch, lambda: torch.matmul(slab, proj), dev=dev)
            out_cols = 2 * f if name == "K3" else f
            flops = 2 * width * d * f * nk_sum
            kb = bound(4 * (n * l * d + n + width * d * f + n * out_cols)
                       + (4 * n if name == "K3" else 0), flops, precision)
            slots, valid = conv.window_slots(lens, width, l - width + 1)
            print(f"{tag} time at {label} shape: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, {bound_text(kb)}; {nk_sum} valid "
                  f"windows, {flops / 1e9:.1f} GFLOP; projection matmul "
                  f"alone (partial yardstick, no mask/sincos/sum) "
                  f"{mm_ms:.4f} ms [{card}]", flush=True)
            products, peak = PRODUCTS[precision]
            tc_flops = products * flops * slots / valid
            print(f"{tag} at {label} shape: {slots} window slots projected "
                  f"for {valid} valid windows ({slots / valid:.3f} : 1); "
                  f"achieved {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s on the "
                  f"valid-window work "
                  f"({flops * 1e3 / ms / PEAK_FP32_FLOPS:.1%} of the fp32 "
                  f"CUDA-core peak; the tensor cores run "
                  f"{tc_flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s of "
                  f"{BODY[precision]} products on the projected slots, "
                  f"{tc_flops * 1e3 / ms / peak:.1%} of peak) "
                  f"[{card}]", flush=True)
            key = (l, d, width, f)
            shape = f"N {n}, L {l}, D {d}, w {width}, F {f}"
            if name == "K3":
                key, shape = key + (mode,), shape + f", sincos {mode}"
            key, shape = key + (precision,), shape + f", {precision}"
            results.update(timed_entry(name, key, err, ms, plain_ms, kb,
                                       shape))
    return results


def phase_conv_slice(torch, card, corpus, n_train=N_TRAIN, n_test=N_TEST,
                     dev="cuda", chunk=CHUNK, num_rffs=NUM_RFFS,
                     variance_rffs=VARIANCE_RFFS, profile=False, tol=1e-6,
                     label="Conv1dRBF"):
    """The sequence slice: Conv1dRBF fit(mode="cg", tol) + predict.
    Returns the launches, the CG iterations, the predictions, the model and
    the fit's record (fit_s, n_iter, residual, rho, dset)."""
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
    n_iter, losses = model.fit(dset, mode="cg", tol=tol, run_diagnostics=True)
    sync(torch, dev)
    fit_s = time.perf_counter() - t0
    fit_counts = read_counts()
    print(f"{label} fit: {fit_s:.3f}s, CG iterations {n_iter}, final "
          f"relative residual {losses[-1]:.3e} (tol {tol:g}); launches "
          f"during fit: {totals(fit_counts)}", flush=True)
    check(n_iter < 500 and losses[-1] < tol, f"{label} CG did not converge")
    model.verbose = False

    reset_counts()
    t0 = time.perf_counter()
    preds, var = model.predict(tex, te_l, get_var=True)
    predict_s = time.perf_counter() - t0
    predict_counts = read_counts()
    print(f"{label} predict: {predict_s:.3f}s for {n_test} rows; "
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
    print(f"{label} held-out Spearman {rho:.4f} (floor "
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
    report_times(model, n_iter, predict_s, card, label)
    if profile:
        profile_fit(torch, model, dset, card)
    check(rho > MOTIF_SPEARMAN_FLOOR, f"{label} Spearman below the floor")
    return ({k: fit_counts[k] + predict_counts[k] for k in fit_counts},
            n_iter, preds, model,
            {"fit_s": fit_s, "n_iter": n_iter, "residual": float(losses[-1]),
             "rho": rho, "dset": dset})


def phase_k4_path(torch, card, corpus, n_train=K4_ROWS, n_test=N_TEST,
                  dev="cuda", chunk=CHUNK, num_rffs=K4_RFFS,
                  init_rffs=INIT_RFFS, tol=1e-6, label="Conv1dTwoLayer"):
    """Conv1dTwoLayer fit(mode="cg", tol) + predict, then FastConv1d.
    Returns the launches and the fit's record (model, fit_s, n_iter,
    residual, rho, dset)."""
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
    n_iter, losses = model.fit(dset, mode="cg", tol=tol,
                               run_diagnostics=True)
    sync(torch, dev)
    fit_s = time.perf_counter() - t0
    preds, var = model.predict(tex, te_l, get_var=True)
    sync(torch, dev)
    fv = FastConv1d(seq_width=MOTIF_D, device=dev, num_features=init_rffs)
    fast = fv.predict(tex[:4096], te_l[:4096])
    counts = read_counts()
    print(f"{label} fit: {fit_s:.3f}s, CG iterations {n_iter}, "
          f"final relative residual {losses[-1]:.3e} (tol {tol:g}); "
          f"launches over fit, predict and FastConv1d: {totals(counts)}",
          flush=True)
    check(n_iter < 500 and losses[-1] < tol, f"{label} CG did not converge")
    if torch.device(dev).type == "cuda":
        check(counts["K4"].total() > 0, "K4 was not launched on the K4 path")
        check(counts["K2"].total() > 0, "K2 was not launched on the K4 path")
    check(bool(np.all(np.isfinite(preds)) and np.all(var >= 0)),
          "Conv1dTwoLayer predictions not finite or var < 0")
    rho = float(spearmanr(preds, te_y)[0])
    print(f"{label} held-out Spearman {rho:.4f} (floor "
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
    check(rho > TWOLAYER_SPEARMAN_FLOOR, f"{label} Spearman below the floor")
    print(f"{label} fit phases: {dict(model.fit_phase_times)} "
          f"[{card}]", flush=True)
    return counts, {"model": model, "fit_s": fit_s, "n_iter": n_iter,
                    "residual": float(losses[-1]), "rho": rho, "dset": dset}


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


def key_mode(name, key):
    """The sincos mode of a launch key (with or without its row count):
    K1 (.., mode, precision), K2 (.., mode), K3 (.., mode, precision);
    None for K4, which has no sincos."""
    return {"K1": key[-2], "K2": key[-1], "K3": key[-2]}.get(name)


def key_precision(name, key):
    """The feature precision of a launch key: its last entry for K1, K3
    and K4; K2 has no precision variant and runs its 3xTF32 body."""
    return "high" if name == "K2" else key[-1]


def mode_summary(timed, mode, card):
    """Each timed (kernel, shape) of ``mode`` at "high" beside the "hi"
    time at the same shape."""
    for (name, key), res in sorted(timed.items(), key=str):
        if key_mode(name, key) != mode or key_precision(name, key) != "high":
            continue
        hi_key = key[:-1] + ("hi",) if name == "K2" else \
            key[:-2] + ("hi", key[-1])
        hi = timed.get((name, hi_key))
        hi_text = "not timed" if hi is None else f"{hi['ms']:.4f} ms"
        faster = "" if hi is None else (
            f"; {mode} {'faster' if res['ms'] < hi['ms'] else 'not faster'}"
            f" than hi")
        print(f"{name} {res['shape']}: {res['ms']:.4f} ms against hi "
              f"{hi_text}{faster}; bound {res['bound']['ms']:.4f} ms "
              f"({res['bound']['by']}) [{card}]", flush=True)


def precision_summary(timed, precision, card):
    """Each timed (kernel, shape) at ``precision`` beside the 3xTF32
    ("high") body's time and bound at the same shape and mode."""
    for (name, key), res in sorted(timed.items(), key=str):
        if name == "K2" or key[-1] != precision:
            continue
        high = timed.get((name, key[:-1] + ("high",)))
        high_text = "not timed" if high is None else (
            f"{high['ms']:.4f} ms (bound {high['bound']['ms']:.4f} ms, "
            f"plain {high['plain_ms']:.4f} ms)")
        print(f"{name} {res['shape']} ({res['bound']['body']}): "
              f"{res['ms']:.4f} ms, bound {res['bound']['ms']:.4f} ms "
              f"({res['bound']['by']}), plain {res['plain_ms']:.4f} ms; "
              f"3xTF32 body {high_text} [{card}]", flush=True)


def phase_mode_paths(torch, card, tab, corpus, hi_preds, conv_model,
                     conv_preds, mode, n_train=N_TRAIN, n_test=N_TEST,
                     dev="cuda", num_rffs=NUM_RFFS,
                     variance_rffs=VARIANCE_RFFS):
    """Slice A refit and predicted, and the Conv1dRBF model's held-out rows
    predicted again, with the sincos mode set to ``mode`` (K1, K2 and K3
    run its instantiation); restores the mode.  Gates: CG converged;
    predictions within PREDICT_RTOL * max|pred| of the same mode's plain
    path and within MODE_RTOL * max|pred| of the "hi" run's; Spearman
    above the slice's floor.  Returns the launches of each of the two
    paths."""
    from scipy.stats import spearmanr
    from xgpr_tpu_torch import GPRegression, config
    from xgpr_tpu_torch.ops.conv import conv_row_scale
    from xgpr_tpu_torch.ops.cuda.conv import conv_parts_plain
    from xgpr_tpu_torch.ops.cuda.feature_map import rbf_feature_map_plain
    from xgpr_tpu_torch.ops.layout import assemble_cos_sin
    dset, tex, te_y = tab
    saved = config.sincos_mode()
    config.set_sincos_mode(mode)
    try:
        model = GPRegression(num_rffs=num_rffs, variance_rffs=variance_rffs,
                             kernel_choice="RBF", device=dev, verbose=False)
        model.set_hyperparams(HPARAMS, dset)
        reset_counts()
        t0 = time.perf_counter()
        n_iter, losses = model.fit(dset, mode="cg", suppress_var=True,
                                   run_diagnostics=True)
        preds = model.predict(tex)
        sync(torch, dev)
        rbf_s = time.perf_counter() - t0
        rbf_counts = read_counts()
        kern = model.kernel
        params = kern.feature_params()
        z = rbf_feature_map_plain(kern._cast_input(tex[:4096]) *
                                  params["sigma"], params["proj"],
                                  kern.fit_intercept, kern.padded_dims, mode)
        z[:, 0] = 1.0
        plain = (z @ model.weights).cpu().numpy().astype(np.float64) * \
            model.trainy_std + model.trainy_mean
        del model

        tex_c, te_yc, te_lc = (a[n_train:n_train + n_test] for a in corpus)
        reset_counts()
        t0 = time.perf_counter()
        conv_mode = conv_model.predict(tex_c, te_lc)
        sync(torch, dev)
        conv_s = time.perf_counter() - t0
        conv_counts = read_counts()
        kern = conv_model.kernel
        params = kern.feature_params()
        xs, ls = kern._cast_input(tex_c[:4096]), kern._cast_lengths(
            te_lc[:4096])
        scale = conv_row_scale(ls, kern.conv_width, kern.num_freqs,
                               kern.scaling_type, kern.dtype, kern.device)
        c, s_ = conv_parts_plain(xs, ls, params["proj"], params["sigma"],
                                 kern.conv_width, scale, mode)
        c[:, 0] = 1.0
        zc = assemble_cos_sin(c, s_, kern.padded_dims)
        conv_plain = (zc @ conv_model.weights).cpu().numpy().astype(
            np.float64) * conv_model.trainy_std + conv_model.trainy_mean
    finally:
        config.set_sincos_mode(saved)
    rho = float(spearmanr(preds, te_y)[0])
    rho_c = float(spearmanr(conv_mode, te_yc)[0])
    rows = []
    for label, got, plain_ref, hi, r, floor in (
            ("slice A refit + predict", preds, plain, hi_preds, rho,
             SPEARMAN_FLOOR),
            ("Conv1dRBF predict", conv_mode, conv_plain, conv_preds, rho_c,
             MOTIF_SPEARMAN_FLOOR)):
        top = float(np.abs(hi).max())
        err_plain = float(np.abs(got[:4096] - plain_ref).max())
        err_hi = float(np.abs(got - hi).max())
        rows.append((label, err_plain, err_hi, top, r, floor))
        print(f"{label} with sincos {mode}: vs the same mode's plain path "
              f"max_abs_err {err_plain:.3e} (tol {PREDICT_RTOL:g} x "
              f"{top:.3e}); vs hi {err_hi:.3e} (tol {MODE_RTOL:g} x "
              f"max|pred|); held-out Spearman {r:.4f} (floor {floor}) "
              f"[{card}]", flush=True)
    print(f"slice A with sincos {mode}: fit + predict {rbf_s:.3f}s, CG "
          f"iterations {n_iter}, final relative residual {losses[-1]:.3e}, "
          f"launches {counts_text(rbf_counts)}; Conv1dRBF predict of "
          f"{n_test} rows {conv_s:.3f}s, launches {counts_text(conv_counts)} "
          f"[{card}]", flush=True)
    check(n_iter < 500 and losses[-1] < 1e-6,
          f"CG did not converge with sincos {mode}")
    for name, counts in (("K1", rbf_counts), ("K2", rbf_counts),
                         ("K3", conv_counts)):
        if torch.device(dev).type == "cuda":
            check(counts[name].total() > 0,
                  f"{name} did not run with sincos {mode}")
        check(all(key_mode(name, key) == mode for key in counts[name]),
              f"{name} ran in another mode than {mode}")
    for label, err_plain, err_hi, top, r, floor in rows:
        check(err_plain < PREDICT_RTOL * top,
              f"{label} ({mode}) disagrees with the plain path")
        check(err_hi < MODE_RTOL * top,
              f"{label} ({mode}) is not within {MODE_RTOL} of hi's")
        check(r > floor, f"{label} ({mode}) Spearman below the floor")
    return rbf_counts, conv_counts


def true_residual(torch, model, dset):
    """||A w - b|| / ||b|| in float64 for a fitted model's weights w, with
    A = Z^T Z + lambda^2 I and b = Z^T y from the model's own features
    (Engine.design_mat: float64 chunk products, no bf16 materialisation):
    the residual of the system the inexact bf16 operator stands for."""
    ztz, zty, _ = model._engine(dset).design_mat()
    lam = float(model.kernel.get_lambda())
    w = model.weights.double().reshape(-1)
    r = ztz @ w + lam ** 2 * w - zty
    return float(torch.linalg.norm(r) / torch.linalg.norm(zty))


def contraction_times(torch, card, model, dset, reps=10):
    """One chunk's (cos, sin) contraction on the Conv1dRBF path (K = 1) as
    the engine runs it under bf16 feature materialisation (bf16 operands,
    torch.mm with fp32 output) and in fp32; ms each on the card."""
    from xgpr_tpu_torch.ops.contract import parts_contract_bf16
    engine = model._engine(dset)
    xb, _, lb, mb, _ = next(engine._batches(with_y=False))
    c, s = model.kernel.pure_feature_parts_fn()(engine._params(), xb, lb)
    c, s = c * mb[:, None], s * mb[:, None]
    rng = np.random.default_rng(9)
    v_c, v_s = (torch.as_tensor(rng.standard_normal((c.shape[1], 1)),
                                dtype=c.dtype, device=c.device)
                for _ in range(2))

    def fp32():
        zv = c @ v_c + s @ v_s
        return c.T @ zv, s.T @ zv
    bf_ms = time_ms(torch, lambda: parts_contract_bf16(c, s, v_c, v_s),
                    reps=reps, dev=c.device)
    fp_ms = time_ms(torch, fp32, reps=reps, dev=c.device)
    n, f = c.shape
    t_bytes = 2 * n * f * 4 / PEAK_BYTES * 1e3
    print(f"Conv1dRBF chunk contraction (R {n}, F {f}, K 1; the engine's "
          f"parts_contract, library calls): bf16 operands with fp32 output "
          f"(torch.mm out_dtype) {bf_ms:.4f} ms, fp32 {fp_ms:.4f} ms; "
          f"reading the fp32 parts once takes {t_bytes:.4f} ms at 3.35 TB/s "
          f"[{card}]", flush=True)
    return bf_ms, fp_ms


def preset_launches(counts, mode, precision, what):
    """Every K1/K3/K4 launch at ``precision`` and every K1/K2/K3 launch in
    sincos ``mode``."""
    for name, counter in counts.items():
        for key in counter:
            if name != "K2":
                check(key_precision(name, key) == precision,
                      f"{name} ran at {key_precision(name, key)} during "
                      f"{what}, not {precision}")
            if name != "K4":
                check(key_mode(name, key) == mode,
                      f"{name} ran in sincos {key_mode(name, key)} during "
                      f"{what}, not {mode}")


def phase_presets(torch, card, tab, corpus, balanced, dev="cuda",
                  num_rffs=NUM_RFFS):
    """The speed presets on the main paths (``set_speed_preset``).  Under
    "max": slice A fit by CG and predict with variance, the Conv1dRBF
    sequence slice fit and predict, the K4 path, and one RBF
    approximate_nmll (K1 at K 26) against its exact_nmll; under
    "reference": slice A refit and predict.  ``balanced`` holds the
    "balanced" runs' records of the same paths.  Gates as PRESET_RHO's
    comment says; prints each fit's recurrence residual beside its true
    residual in float64, and each preset's fit time and CG iterations
    beside "balanced"'s.  Restores "balanced".  Returns the paths'
    launches."""
    from xgpr_tpu_torch import GPRegression, config
    from xgpr_tpu_torch.constants import DEFAULT_NMLL_PARAMS
    dset = tab[0]
    on_card = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    rbf = GPRegression(num_rffs=num_rffs, kernel_choice="RBF", device=dev,
                       verbose=False)
    rbf.set_hyperparams(HPARAMS, dset)
    exact_bal = nmll_call(torch, dev, rbf.exact_nmll, HPARAMS, dset)[0]
    paths, records = [], []
    try:
        config.set_speed_preset("max")
        counts, _, rec = phase_slice(torch, card, tab, dev=dev, tol=MAX_TOL,
                                     label='slice A ("max")')
        rec["true_residual"] = true_residual(torch, rec.pop("model"), dset)
        paths.append(('slice A fit + predict ("max")', counts))
        records.append(("max", "slice A", rec))

        counts, _, _, model, rec = phase_conv_slice(
            torch, card, corpus, dev=dev, tol=MAX_TOL,
            label='Conv1dRBF ("max")')
        rec["true_residual"] = true_residual(torch, model, rec["dset"])
        contraction_times(torch, card, model, rec.pop("dset"))
        del model
        paths.append(('Conv1dRBF fit + predict ("max")', counts))
        records.append(("max", "Conv1dRBF", rec))

        counts, rec = phase_k4_path(torch, card, corpus, dev=dev,
                                    tol=MAX_TOL,
                                    label='Conv1dTwoLayer ("max")')
        rec["true_residual"] = true_residual(torch, rec.pop("model"),
                                             rec.pop("dset"))
        paths.append(('K4 path ("max")', counts))
        records.append(("max", "K4 path", rec))

        before = read_counts()
        exact, exact_s, _ = nmll_call(torch, dev, rbf.exact_nmll, HPARAMS,
                                      dset)
        approx, approx_s, nmll_counts = nmll_call(
            torch, dev, rbf.approximate_nmll, HPARAMS, dset)
        k26 = k1_by_k(nmll_counts)[DEFAULT_NMLL_PARAMS["nsamples"] + 1]
        paths.append(('RBF NMLL ("max")', counts_since(before)))
        gap, drift = rel_gap(approx, exact), rel_gap(exact, exact_bal)
        print(f'RBF NMLL at {num_rffs} RFFs under "max": exact {exact:.6f} '
              f"in {exact_s:.3f}s (balanced {exact_bal:.6f}, relative "
              f"{drift:.3e}, gate {PRESET_NMLL_RTOL}), approximate "
              f"{approx:.6f} in {approx_s:.3f}s, relative gap {gap:.3e} "
              f"(gate {NMLL_RTOL}); K1 launches at K=26 {k26} [{card}]",
              flush=True)
        check(gap < NMLL_RTOL, 'RBF approximate NMLL under "max" is not '
                               "within 1% of exact")
        check(drift < PRESET_NMLL_RTOL, 'RBF exact NMLL under "max" is not '
                                        'within 1e-3 of "balanced"\'s')
        check(k26 > 0 or not on_card,
              'K1 was not launched at K=26 under "max"')
        for path, counts in paths:
            preset_launches(counts, "fast", "default", path)

        config.set_speed_preset("reference")
        counts, _, rec = phase_slice(torch, card, tab, dev=dev,
                                     label='slice A ("reference")')
        rec["true_residual"] = true_residual(torch, rec.pop("model"), dset)
        preset_launches(counts, "exact", "highest", "slice A (reference)")
        check(counts["K1"].total() > 0 or not on_card,
              'K1 was not launched under "reference"')
        paths.append(('slice A fit + predict ("reference")', counts))
        records.append(("reference", "slice A", rec))
    finally:
        config.set_speed_preset("balanced")
    for preset, path, rec in records:
        bal = balanced[path]
        print(f"{path} under \"{preset}\": fit {rec['fit_s']:.3f}s, CG "
              f"iterations {rec['n_iter']}, recurrence residual "
              f"{rec['residual']:.3e}, true residual (float64) "
              f"{rec['true_residual']:.3e}, held-out Spearman "
              f"{rec['rho']:.4f}; balanced: fit {bal['fit_s']:.3f}s, CG "
              f"iterations {bal['n_iter']}, Spearman {bal['rho']:.4f} "
              f"(gate |d| < {PRESET_RHO}) [{card}]", flush=True)
        check(abs(rec["rho"] - bal["rho"]) < PRESET_RHO,
              f"{path} under {preset}: Spearman moved from balanced's")
    print(f"presets phase: {time.perf_counter() - t_phase:.1f}s [{card}]",
          flush=True)
    return paths


def class_gates(torch, card, label, model, hist, probs, te_y, plain_probs,
                fit_counts, predict_counts, kernel, floor, dev):
    """The classifiers' gates: the objective never rises, probability rows
    sum to 1 and agree with the plain feature map's within PROB_ATOL, the
    held-out accuracy is at or above ``floor``; on the card, ``kernel``
    ran during fit and predict and the engine, the kernel and the weights
    stayed there."""
    rise = float(np.max(np.diff(hist))) if len(hist) > 1 else 0.0
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    plain_err = float(np.abs(probs[:plain_probs.shape[0]] -
                             plain_probs).max())
    acc = float((np.argmax(probs, axis=1) == te_y).mean())
    engine = next(iter(model._engines.values()))
    print(f"{label}: objective {hist[0]:.6f} -> {hist[-1]:.6f} over "
          f"{len(hist) - 1} iterations (largest rise {rise:.3e}); "
          f"probability rows sum to 1 within {row_err:.3e}; vs the plain "
          f"feature map on {plain_probs.shape[0]} rows {plain_err:.3e} (tol "
          f"{PROB_ATOL:g}); held-out accuracy {acc:.4f} (floor {floor}); "
          f"{kernel} launches fit {fit_counts[kernel].total()}, predict "
          f"{predict_counts[kernel].total()}; engine {engine.mode} on "
          f"{engine.device} [{card}]", flush=True)
    check(rise <= 0.0, f"{label}: the objective rose")
    check(row_err < PROB_ATOL, f"{label}: probability rows do not sum to 1")
    check(plain_err < PROB_ATOL,
          f"{label}: probabilities disagree with the plain feature map")
    if torch.device(dev).type == "cuda":
        check(fit_counts[kernel].total() > 0,
              f"{label}: {kernel} did not run during fit")
        check(predict_counts[kernel].total() > 0,
              f"{label}: {kernel} did not run during predict")
        check(engine.device.type == "cuda" and model.kernel.device.type ==
              "cuda" and model.weights.device.type == "cuda",
              f"{label}: the fit did not stay on the card")
    check(acc >= floor, f"{label}: accuracy below the floor")


def softmax_np(logits):
    logits = logits - logits.max(axis=1, keepdims=True)
    e = np.exp(logits)
    return e / e.sum(axis=1, keepdims=True)


def classifier_passes(torch, model, dset, card, label, reps=3):
    """One NCG iteration's two data passes timed apart on the fitted
    model's engine (after the counted run)."""
    from xgpr_tpu_torch.fitting.softmax_solver import _STEP_GRID
    engine = model._engine(dset)
    lam = model.kernel.get_lambda()
    w = model.weights
    grad_ms = time_ms(torch, lambda: engine.classification_loss_grad(w, lam),
                      reps=reps)
    ls_ms = time_ms(torch, lambda: engine.softmax_linesearch(
        w, -w, _STEP_GRID, lam), reps=reps)
    print(f"{label}: loss-gradient pass {grad_ms:.3f} ms, step-grid pass "
          f"({_STEP_GRID.shape[0]} steps) {ls_ms:.3f} ms, "
          f"{dset.get_n_batches()} chunks [{card}]", flush=True)


def phase_rbf_classifier(torch, card, dev="cuda", n_train=N_TRAIN,
                         n_test=N_TEST, num_rffs=NUM_RFFS, chunk=CHUNK,
                         floor=CLASS_ACC_FLOOR):
    """GPClassification with RBF at slice A's width: fit (autoselected
    preconditioner, NCG) and predict on the classification generator's
    held-out rows; class_gates."""
    from xgpr_tpu_torch import GPClassification, build_classification_dataset
    from xgpr_tpu_torch.ops.cuda.feature_map import rbf_feature_map_plain
    t0 = time.perf_counter()
    (trx, tr_y), (tex, te_y) = classification_data(
        n_train, n_test, N_FEATURES, CLASS_N_CLASSES, seed=SEED)
    dset = build_classification_dataset(trx, tr_y, chunk_size=chunk)
    print(f"RBF classifier data: {n_train} + {n_test} rows x {N_FEATURES}, "
          f"{CLASS_N_CLASSES} classes, made in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    model = GPClassification(num_rffs=num_rffs, kernel_choice="RBF",
                             device=dev, verbose=True)
    model.set_hyperparams(CLASS_HPARAMS, dset)
    reset_counts()
    t0 = time.perf_counter()
    n_iter, hist = model.fit(dset, run_diagnostics=True)
    sync(torch, dev)
    fit_s = time.perf_counter() - t0
    fit_counts = read_counts()
    model.verbose = False
    reset_counts()
    t0 = time.perf_counter()
    probs = model.predict(tex)
    predict_s = time.perf_counter() - t0
    predict_counts = read_counts()
    print(f"RBF classifier fit: {fit_s:.3f}s, {n_iter} NCG iterations; "
          f"predict {predict_s:.3f}s for {n_test} rows; launches fit "
          f"{counts_text(fit_counts)}, predict {counts_text(predict_counts)} "
          f"[{card}]", flush=True)
    kern = model.kernel
    params = kern.feature_params()
    z = rbf_feature_map_plain(kern._cast_input(tex[:4096]) * params["sigma"],
                              params["proj"], kern.fit_intercept,
                              kern.padded_dims)
    z[:, 0] = 1.0
    plain = softmax_np((z @ model.weights.to(z.dtype)).double().cpu()
                       .numpy())
    class_gates(torch, card, "RBF classifier", model, hist, probs, te_y,
                plain, fit_counts, predict_counts, "K2", floor, dev)
    if torch.device(dev).type == "cuda":
        classifier_passes(torch, model, dset, card, "RBF classifier")
    return {k: fit_counts[k] + predict_counts[k] for k in fit_counts}


def phase_conv_classifier(torch, card, corpus, dev="cuda",
                          n_train=CONV_CLASS_ROWS, n_held=N_TRAIN,
                          n_test=N_TEST, num_rffs=NUM_RFFS, chunk=CHUNK,
                          floor=CONV_CLASS_ACC_FLOOR):
    """GPClassification with Conv1dRBF on the motif corpus's first
    ``n_train`` rows, its target cut at its quartiles: fit and predict the
    held-out rows (from ``n_held``); class_gates."""
    from xgpr_tpu_torch import GPClassification, build_classification_dataset
    from xgpr_tpu_torch.ops.conv import conv_row_scale
    from xgpr_tpu_torch.ops.cuda.conv import conv_parts_plain
    from xgpr_tpu_torch.ops.layout import assemble_cos_sin
    x, y, lens = corpus
    cls = quartile_classes(y)
    tex, te_y, te_l = (a[n_held:n_held + n_test] for a in (x, cls, lens))
    dset = build_classification_dataset(x[:n_train], cls[:n_train],
                                        lens[:n_train], chunk_size=chunk)
    model = GPClassification(num_rffs=num_rffs, kernel_choice="Conv1dRBF",
                             kernel_settings={"conv_width": MOTIF_W},
                             device=dev, verbose=True)
    model.set_hyperparams(CONV_CLASS_HPARAMS, dset)
    reset_counts()
    t0 = time.perf_counter()
    n_iter, hist = model.fit(dset, run_diagnostics=True)
    sync(torch, dev)
    fit_s = time.perf_counter() - t0
    fit_counts = read_counts()
    model.verbose = False
    reset_counts()
    t0 = time.perf_counter()
    probs = model.predict(tex, te_l)
    predict_s = time.perf_counter() - t0
    predict_counts = read_counts()
    print(f"Conv1dRBF classifier on {n_train} rows: fit {fit_s:.3f}s, "
          f"{n_iter} NCG iterations; predict {predict_s:.3f}s for {n_test} "
          f"rows; launches fit {counts_text(fit_counts)}, predict "
          f"{counts_text(predict_counts)} [{card}]", flush=True)
    kern = model.kernel
    params = kern.feature_params()
    xs, ls = kern._cast_input(tex[:4096]), kern._cast_lengths(te_l[:4096])
    scale = conv_row_scale(ls, kern.conv_width, kern.num_freqs,
                           kern.scaling_type, kern.dtype, kern.device)
    c, s = conv_parts_plain(xs, ls, params["proj"], params["sigma"],
                            kern.conv_width, scale)
    c[:, 0] = 1.0
    z = assemble_cos_sin(c, s, kern.padded_dims)
    plain = softmax_np((z @ model.weights.to(z.dtype)).double().cpu()
                       .numpy())
    class_gates(torch, card, "Conv1dRBF classifier", model, hist, probs,
                te_y, plain, fit_counts, predict_counts, "K3", floor, dev)
    if torch.device(dev).type == "cuda":
        classifier_passes(torch, model, dset, card, "Conv1dRBF classifier")
    return {k: fit_counts[k] + predict_counts[k] for k in fit_counts}


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
                "library_ms": None, "shape": res["shape"],
                "sincos": key_mode(name, key),
                "precision": key_precision(name, key)})
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
    for mode in SINCOS_MODES:
        timed.update(phase_kernels(torch, card, mode))
    # The precisions where the presets launch them: K1 "default" in "fast"
    # ("max"), K1 "highest" and K2 in "exact" ("reference").
    timed.update(phase_kernels(torch, card, "fast", "default", k2=False))
    timed.update(phase_kernels(torch, card, "exact", "highest"))
    t0 = time.perf_counter()
    (trx, tr_y), (tex, te_y) = tabular_data(N_TRAIN, N_TEST, N_FEATURES,
                                            seed=SEED)
    from xgpr_tpu_torch import build_regression_dataset
    tab = (build_regression_dataset(trx, tr_y, chunk_size=CHUNK), tex, te_y)
    print(f"data: {N_TRAIN} x {N_FEATURES} train, {N_TEST} test, made in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    slice_counts, slice_preds, slice_rec = phase_slice(torch, card, tab)
    del slice_rec["model"]
    paths = [("slice A fit + predict", slice_counts)]
    t0 = time.perf_counter()
    corpus = motif_corpus(N_TRAIN + N_TEST)
    print(f"motif corpus: {N_TRAIN} + {N_TEST} rows x {MOTIF_L} x "
          f"{MOTIF_D}, made in {time.perf_counter() - t0:.2f}s", flush=True)
    timed.update(phase_conv_kernels(torch, card, corpus))
    for mode in SINCOS_MODES:
        timed.update(phase_conv_kernels(torch, card, corpus, mode=mode,
                                        with_k4=False))
    timed.update(phase_conv_kernels(torch, card, corpus, mode="fast",
                                    precision="default"))
    precision_summary(timed, "default", card)
    conv_counts, n_iter, preds, conv_model, conv_rec = phase_conv_slice(
        torch, card, corpus, profile="--profile" in argv)
    del conv_rec["dset"]
    paths.append(("Conv1dRBF fit + predict", conv_counts))
    for mode in SINCOS_MODES:
        rbf_counts, mode_counts = phase_mode_paths(
            torch, card, tab, corpus, slice_preds, conv_model, preds, mode)
        paths.append((f"slice A fit + predict ({mode})", rbf_counts))
        paths.append((f"Conv1dRBF predict ({mode})", mode_counts))
        mode_summary(timed, mode, card)
    del conv_model
    k4_counts, k4_rec = phase_k4_path(torch, card, corpus)
    del k4_rec["model"], k4_rec["dset"]
    paths.append(("K4 path", k4_counts))
    paths += phase_presets(torch, card, tab, corpus,
                           {"slice A": slice_rec, "Conv1dRBF": conv_rec,
                            "K4 path": k4_rec})
    paths.append(("tuning", phase_tuning(torch, card, tab, corpus)))
    paths.append(("streamed Conv1dRBF fit + predict",
                  phase_streamed(torch, card, corpus, (n_iter, preds))))
    paths.append(("referee", phase_referee(torch, card, corpus)))
    del tab
    paths.append(("RBF classifier fit + predict",
                  phase_rbf_classifier(torch, card)))
    paths.append(("Conv1dRBF classifier fit + predict",
                  phase_conv_classifier(torch, card, corpus)))
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
