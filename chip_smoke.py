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
   at the auxiliary tools' k-means width (F 2048),
   at the K4 path's second layer (D 1024, F 2048, padded 1024) and at a
   ragged one, and the fused CG matvec (K1) at slice A's shape for K = 1
   and 26 and at a ragged one with masked rows; two K1 calls on the same
   inputs must be bitwise equal at each timed K.  Prints each max error
   and, at every shape the main path launches, each kernel's time beside
   the plain version's.  Then the same in the sincos modes "fast" and "poly", each
   kernel against the plain version of the same mode, with a guard case
   (arguments past POLY_ARG_LIMIT, which take the builtin); then K1 in its
   one-pass bf16 body ("default" feature precision, in "fast": what the
   "max" preset launches) and K1 and K2 at "highest" (K1's 3xTF32 body,
   K2's fp32 FMAs on the CUDA cores), in "exact" (the "reference"
   preset), each against the plain version of the same mode and
   precision.
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
      time, K1's launches by K and their share of the SLQ call at phase
      2's times (``k1_share``).
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
   against its exact_nmll (K1 at K 26, with its share of the call).
   Under "reference" ("highest": K1's 3xTF32 body, K2's fp32 FMAs; and
   "exact" sincos): slice A refit and predicted.  Gates: held-out Spearman
   within 0.02 of the "balanced" run's, the exact NMLL within 1e-3 of
   "balanced"'s, SLQ within 1% of exact, every K1-K4 launch at the
   preset's precision (K2 at "high" under "max": its 3xTF32 body) and
   every K1-K3 launch in its sincos mode.  Prints
   each fit's CG recurrence residual beside its true residual (float64,
   from the design matrix), its time and iterations beside "balanced"'s,
   and the Conv1dRBF chunk contraction's time with bf16 operands (a
   library call) beside fp32.  Restores "balanced".
13. Slice D2 (``phase_surface``, after the classifiers):
   a. Linear on slice A's rows (85 features, Nystrom variance of rank 64):
      a crude tune of lambda, the exact fit, a CG fit (its weights within
      1e-6 x max|w| of the exact fit's) and predict with variance, against
      the port's float64 fit on the CPU (predictions within 1e-4 x
      max|pred|, Spearman at least the CPU fit's less 0.005).  No kernel
      runs on this path; the kernels line names it under
      "paths_without_kernels".
   b. MiniARD on slice A's rows, split at column 42: a crude tune at 2048
      RFFs on 65,536 rows, exact_nmll_gradient against a float64 witness
      (0.5%) and the witness against its central difference (0.5%), a CG
      fit at 8192 RFFs with the tuned point, predict with variance, and
      the same predict again under ``diagnostics.trace`` (the same
      results; the trace must name K2's kernel); K2 ran in fit and
      predict, 4096 predictions agree with the plain feature
      map, Spearman > 0.62; MiniARD at slice A's sigma in both groups
      gives slice A's RBF features bitwise.
   c. export_predict_fn on slice A's RBF model (with variance), the
      Conv1dRBF model and the RBF classifier: within 1e-6 x max|pred| of
      predict, the same bits after the state went through numpy.
   d. KernelFGen at 8192 RFFs on RBF (slice A's held-out rows) and
      Conv1dRBF (the corpus's), bitwise ``transform_x`` and within 1e-5 of
      the plain feature maps; KernelPCA at 8192 RFFs, 16 components, on
      slice A's training rows (orthonormal components, non-increasing
      variances, the transformed rows' variance within 1e-3); KernelKMeans
      at 4096 RFFs on 262,144 rows of 8 blobs (purity > 0.9, labels_ equal
      predict).

14. Slice E, the scale-out layer (``phase_scale_out``, after phase 13):
   a. E0: ``torch.compile(fn, fullgraph=True)`` of phase 13c's three
      exported fns (K2 and K3 are custom operators), each within 1e-6 x
      max|pred| of predict; prints the first call's (compile) and a warm
      call's time.
   b. E1, in a child process at world size 1 over NCCL: slice A fit by CG
      (autoselected preconditioner), predict with variance and one
      approximate_nmll, on the single Engine and then under
      ``set_engine_mode("sharded")`` on the ShardedEngine: the engines
      route, and weights, predictions, iterations and the NMLL are
      bitwise equal.
   c. E2, two gloo ranks spawned on the one card (a free port, a join
      timeout), each with its own rows and y standardised over all of
      them: (a) slice A split 131,072 / 131,072 at 8192 RFFs, fit and
      predict; (b) the same rows at 32768 RFFs, config's M-sharding
      threshold, the M-sharded fit against ``set_m_sharding("off")``'s
      replicated one and SLQ's CG coefficients (K 5) under both; (c) the
      Conv1dRBF on the corpus's first 65,536 rows split 5 chunks against
      3, through the StreamingShardedEngine; (d) the RBF classifier on
      the classification rows' first 65,536.  Every fit takes an explicit
      rank-1024 srht_2 preconditioner; gates: CG converged, iterations
      within one of the one-process fit's (E1's, or this process's for (c)
      and (d); the replicated fit for (b)), weights within 1e-6 x max|w|,
      both ranks the same bits, slice A's Spearman floor and the
      classifier's accuracy floor; (c)'s Spearman equal to the
      one-process fit's (the depth is cut below the slice's floor's).
   The ranks load the parent's kernel build and hand their records and
   launch counts back through build/scale_out/; each phase prints its
   time, its collectives and their seconds (synchronised).  Phase 2
   checks and times K1 (K 1 and 5) and K2 at E2(b)'s 32768 RFFs (F 16384)
   too, in "hi".
15. Slice G, float64 on the card and the "reference" preset on the
   sequence path (``phase_g_kernels``, ``phase_g``; G_CONV_ROWS' comment
   has the gates):
   a. G1: K1 (K 1 and 26), K2 (D 84 / F 4096, D 1024 / F 2048), K3 (F
      4096, 1024, 128) and K4 (F 1024) in float64, each against its plain
      float64 version (F64_RTOL) and timed; K3 and K4 at "highest" (the
      fp32 CUDA-core body) against the plain fp32 versions, timed; every
      kernel on non-contiguous operands bitwise its contiguous result, in
      float64 and float32; mixed dtypes refused.
   b. G2: slice A in float64 (``double_precision_fht``): fit, predict
      with variance, against the same model computed through the plain
      versions on the card (``plain_kernels``) and the float32 fit; an
      SLQ NMLL (K1 at K 26) against the exact one on all its rows.
   c. G4 then G3: Conv1dRBF on 65,536 motif rows under "balanced" and
      "reference" (K3 on its fp32 CUDA-core body), then in float64 against
      its plain-version twin; FastConv1d (K4) in float64 on 4096 rows.

The launch counters count by shape and, for K1-K3, sincos mode, and
precision: the feature precision that ran for float32 launches (K2's
"high" under "default" too), "float64" for float64 ones, which also count
their sincos as "exact" (the builtin, in every mode).  The line before
the last is one JSON object describing the kernels: one row per path
(slice A, Conv1dRBF, both under "fast" and "poly", streamed Conv1dRBF,
the referee, the K4 path, the presets' paths, tuning, the two
classifiers, MiniARD, the exports, KernelFGen, KernelPCA, KernelKMeans,
the compiled exports, slice E's rank paths, their launches summed over
the ranks, and slice G's paths), kernel and launch shape less its row
count, with the launches at that shape (by row count), the source of the
launch's body and the times and bound measured at it; a launch at a
shape, mode or precision that phases 2, 5 and 15 did not check and time
fails the run; and "paths_without_kernels", the paths that launch none
(Linear).
The last line is {"ok": true, "device": {...}}.
Without a CUDA device, or outside a checkout, it exits with code 1 and
prints no result.
"""
import contextlib
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

# Slice D2 (``phase_surface``).  Linear on slice A's rows: 85 features
# (84 and the intercept), a Nystrom variance of rank LINEAR_VARIANCE_RFFS;
# CG to LINEAR_CG_TOL (so that the weights' gap is the float32 matvec's,
# not the solver's), its weights within LINEAR_CG_RTOL x max|w| of the
# exact fit's (float64 products of the same features), predictions
# within PREDICT_RTOL x max|pred| of the port's float64 CPU fit, held-out
# Spearman at least the CPU fit's less LINEAR_RHO_DROP.  MiniARD on slice
# A's rows, split at column ARD_SPLIT (two groups of 42; xgpr_tpu's own
# test splits at 40): a crude tune at TUNE_RFFS on the first TUNE_ROWS
# rows, the gradient at ARD_GRAD_POINT (slice B's GRAD_POINT with sigma in
# both groups) against a float64 witness, a CG fit at NUM_RFFS with the
# tuned point, held-out Spearman above slice A's floor.  The exports within
# EXPORT_RTOL x max|pred| of predict.  KernelFGen at NUM_RFFS on RBF and
# Conv1dRBF, within FEATURE_ATOL of the plain feature maps; KernelPCA at
# PCA_RFFS on slice A's training rows (PCA_COMPONENTS components:
# orthonormal to PCA_ORTHO_TOL, variances non-increasing and >= -1e-8, the
# transformed rows' variance within PCA_VAR_RTOL of each); KernelKMeans at
# KMEANS_RFFS on a blob corpus (KMEANS_CENTRES centres in 84 dimensions,
# noise KMEANS_NOISE, sigma KMEANS_SIGMA), purity above KMEANS_PURITY,
# xgpr_tpu's own gate (tests/auxiliary_tests/test_clustering.py).
LINEAR_VARIANCE_RFFS = 64
LINEAR_CG_TOL, LINEAR_CG_RTOL, LINEAR_RHO_DROP = 1e-8, 1e-6, 0.005
ARD_SPLIT = 42
ARD_GRAD_POINT = np.array([GRAD_POINT[0], GRAD_POINT[1], GRAD_POINT[1]])
EXPORT_RTOL = 1e-6
PCA_RFFS, PCA_COMPONENTS = 8192, 16
PCA_ORTHO_TOL, PCA_VAR_RTOL = 1e-8, 1e-3
KMEANS_RFFS, KMEANS_CENTRES, KMEANS_NOISE = 4096, 8, 0.05
KMEANS_SIGMA, KMEANS_PURITY = 0.1, 0.9

# Tolerances, fp32 on both sides with a different summation order:
# features are O(1/sqrt(F)) in magnitude and match to ~1e-5 absolute;
# the matvec sums R * F products, so it is held to 1e-4 of max |ref|; the
# conv window loops sum up to nw O(1) terms of 576-term fp32 dot products,
# so they are held to 1e-4 * max(1, max |ref|).
FEATURE_ATOL = 1e-5
ZTZV_RTOL = 1e-4
# The float64 bodies against their plain float64 versions: the same
# arithmetic in float64 summed in another order, held to F64_RTOL of
# max(1, max|ref|) (phase G).
F64_RTOL = 1e-11
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

# Published H100 SXM peaks (NVIDIA data sheet): dense TF32, bf16 and FP64
# on the tensor cores, fp32 and FP64 on the CUDA cores, and HBM3
# bandwidth.  The bounds count each input read once, each output written
# once, and the multiply-adds of the projections (2 flops each) in the
# launch's body (feature_map.py ``kernel_body``; PRODUCTS: three TF32
# products for 3xTF32, one bf16 product, one fp32 FMA on the CUDA cores,
# or one FP64 DMMA product on the tensor cores, the card's FP64 peak), and
# as fp32 FMAs (FP64 for float64) on the CUDA cores for the CUDA-core
# bound.
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP64_FLOPS = 67e12
PEAK_FP32_CORE_FLOPS = 67e12
PEAK_FP64_CORE_FLOPS = 34e12
PEAK_BYTES = 3.35e12
PRODUCTS = {"tf32x3": (3, PEAK_TF32_FLOPS), "bf16": (1, PEAK_BF16_FLOPS),
            "fma32": (1, PEAK_FP32_CORE_FLOPS), "f64": (1, PEAK_FP64_FLOPS)}
BODY = {"tf32x3": "3xTF32", "bf16": "bf16", "fma32": "fp32 FMA",
        "f64": "FP64 DMMA"}

# The speed presets (phase 12, ``phase_presets``).  Under "max" the fits
# run K1, K3 and K4 in their one-pass bf16 body with bf16 feature
# materialisation and "fast" sincos; under "reference" K1 and K2 at
# "highest" (K1's 3xTF32 body, K2's fp32 FMAs) with the builtin sincos.
# Gates (xgpr_tpu's own for "max",
# tests/numerics_tests/test_fast_features.py): held-out Spearman within
# PRESET_RHO of the "balanced" run's, exact NMLL within PRESET_NMLL_RTOL of
# it, predictions within PREDICT_RTOL x max|pred| of the same preset's
# plain path, SLQ within NMLL_RTOL of exact, every launch of K1-K4 at the
# preset's precision (K2 at "high" under "max").  CG runs to MAX_TOL under
# "max".
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


def bound(nbytes, flops, body="tf32x3"):
    """Least ms on the published peaks and what sets it: "ms"/"by" with
    the flops in ``body`` (tensor cores or CUDA cores, PRODUCTS),
    "cuda_core_ms"/"cuda_core_by" with them as CUDA-core FMAs (FP64 for
    the float64 body, fp32 otherwise)."""
    t_bytes = nbytes / PEAK_BYTES
    products, peak = PRODUCTS[body]
    core_peak = PEAK_FP64_CORE_FLOPS if body == "f64" \
        else PEAK_FP32_CORE_FLOPS
    out = {"body": BODY[body]}
    for key, t_ops in (("", products * flops / peak),
                       ("cuda_core_", flops / core_peak)):
        out[key + "ms"] = max(t_bytes, t_ops) * 1e3
        out[key + "by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def bound_text(b):
    return (f"bound {b['ms']:.4f} ms ({b['by']}, {b['body']}) / "
            f"{b['cuda_core_ms']:.4f} ms ({b['cuda_core_by']}, CUDA-core "
            f"FMAs)")


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
    product alike (and sigma must be 1).  In float64 every body forms it
    as one float64 product, so proj is not rounded."""
    from xgpr_tpu_torch.ops.cuda.operands import split_tf32
    x = t(rng.standard_normal((n, d)) * 0.5)
    x[0] = 0.0
    x[0, 0] = 5e4
    proj = t(rng.standard_normal((d, f)) * 0.5)
    if proj.dtype == torch.float32:
        proj = split_tf32(proj)[0].contiguous()
    return x, proj


def phase_kernels(torch, card, mode="hi", precision="high", k2=True,
                  double=False):
    """K1 and K2 (unless not ``k2``) in sincos ``mode`` and feature
    ``precision`` (K2 runs 3xTF32 at "high" and "default", fp32 FMAs at
    "highest"), against their plain versions in the same mode and
    precision on the card, timed at every shape the main path launches
    them at; the ragged cases and a guard case (arguments past
    POLY_ARG_LIMIT) are checked, not timed.  Two K1 calls on the same
    inputs must give the same bits at every timed K.  With
    ``double`` the same in float64 (the float64 bodies, whatever mode and
    precision: keyed "exact", "float64") at phase G's shapes, to
    F64_RTOL."""
    from xgpr_tpu_torch.kernels import RBF, Conv1dTwoLayer
    from xgpr_tpu_torch.ops.cuda import feature_map, ztzv
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    dtype = torch.float64 if double else torch.float32
    esize = 8 if double else 4
    kernel = RBF((CHUNK, N_FEATURES), NUM_RFFS, SEED, device="cuda",
                 double_precision=double)
    proj = kernel._dense_proj()                       # (84, 4096)
    # E2(b)'s M-sharded width (phase_scale_out), launched in "hi" only.
    wide = RBF((CHUNK, N_FEATURES), MSHARD_RFFS, SEED, device="cuda") \
        if (mode, precision, double) == ("hi", "high", False) else None
    two = Conv1dTwoLayer((CHUNK, MOTIF_L, MOTIF_D), K4_RFFS, SEED,
                         device="cuda", double_precision=double,
                         kernel_spec_parms={"conv_width": MOTIF_W,
                                            "init_rffs": INIT_RFFS})
    proj2 = two._dense_projs()[1]                     # (1024, 2048)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    results = {}
    # --- K2: slice A's shape (padded 128, 32 blocks), the tuning width's
    # (F 1024), the auxiliary tools' (F 2048), ragged cases, and the K4
    # path's second layer (D 1024,
    # F 2048, padded 1024) on nonnegative rows like its sigma-scaled
    # maxpool profiles; in float64 slice A's and the K4 path's --------
    x_tab = t(rng.standard_normal((CHUNK, N_FEATURES)) * 0.5)
    cases = [(x_tab, proj, kernel.padded_dims, True, "slice"),
             (t(rng.random((CHUNK, proj2.shape[0])) * 0.1), proj2,
              two._feature_padded, True, "K4 path")]
    if not double:
        tune = RBF((CHUNK, N_FEATURES), TUNE_RFFS, SEED, device="cuda")
        aux = RBF((CHUNK, N_FEATURES), KMEANS_RFFS, SEED, device="cuda")
        cases[1:1] = [(x_tab, tune._dense_proj(), tune.padded_dims, True,
                       f"tuning ({TUNE_RFFS} RFFs)"),
                      (x_tab, aux._dense_proj(), aux.padded_dims, False,
                       f"auxiliary ({KMEANS_RFFS} RFFs)")]
    if wide is not None:
        cases.append((x_tab, wide._dense_proj(), wide.padded_dims, True,
                      f"M-sharded ({MSHARD_RFFS} RFFs)"))
    for intercept in (False, True):
        cases.append((t(rng.standard_normal((257, 10)) * 0.5),
                      t(rng.standard_normal((10, 200)) * 0.7), 16,
                      intercept, f"ragged intercept={intercept}"))
    cases.append((*guard_dense(torch, rng, t, 300, 16, 256), 16, True,
                  "ragged guard"))
    k2_body = feature_map.kernel_body("K2", dtype, precision)
    k2_tags = feature_map.launch_tags(
        dtype, mode, "highest" if k2_body == "fma32" else "high")
    k2_tag = ", ".join(k2_tags)
    for x, pr, padded, intercept, label in cases if k2 else ():
        n = x.shape[0]
        got = feature_map.rbf_feature_map(x, pr, intercept, padded, mode,
                                          precision)
        want = feature_map.rbf_feature_map_plain(x, pr, intercept, padded,
                                                 mode)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = F64_RTOL * max(1.0, float(want.abs().max())) if double \
            else FEATURE_ATOL
        print(f"K2 feature map ({k2_tag}) {label}: N={n} D={pr.shape[0]} "
              f"F={pr.shape[1]} padded={padded} max_abs_err={err:.3e} "
              f"(tol {tol:g})", flush=True)
        check(err < tol, f"K2 ({k2_tag}) {label} disagrees ({err})")
        if label.startswith("ragged"):
            continue
        ms = time_ms(torch, lambda: feature_map.rbf_feature_map(
            x, pr, intercept, padded, mode, precision))
        plain_ms = time_ms(torch, lambda: feature_map.rbf_feature_map_plain(
            x, pr, intercept, padded, mode))
        mm_ms = time_ms(torch, lambda: torch.matmul(x, pr))
        d, f = pr.shape
        kb = bound(esize * (n * d + d * f + n * 2 * f), 2 * n * d * f,
                   k2_body)
        print(f"K2 ({k2_tag}) time at {label} shape: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, {bound_text(kb)}; projection "
              f"matmul alone (partial yardstick) {mm_ms:.4f} ms [{card}]",
              flush=True)
        results.update(timed_entry(
            "K2", (d, f) + k2_tags, err, ms, plain_ms, kb,
            f"N {n}, D {d}, F {f}, padded {padded}, sincos {k2_tags[0]}, "
            f"{k2_tags[1]}"))

    # --- K1: slice shape for K = 1, 26 and a ragged masked case --------
    sigma = float(np.exp(HPARAMS[1]))
    xg, pg = guard_dense(torch, rng, t, 1000, 16, 300)
    k1_cases = [(CHUNK, proj, 1, sigma, "slice K=1", None),
                (CHUNK, proj, 26, sigma, "slice K=26", None),
                (2000, t(rng.standard_normal((N_FEATURES, 500)) * 0.3), 3,
                 0.7, "ragged", None),
                (xg.shape[0], pg, 2, 1.0, "ragged guard", xg)]
    if wide is not None:
        k1_cases += [(CHUNK, wide._dense_proj(), k, sigma,
                      f"M-sharded K={k}", None) for k in (1, SLQ_PROBES + 1)]
    tags = feature_map.launch_tags(dtype, mode, precision)
    body = feature_map.kernel_body("K1", dtype, precision)
    tag = ", ".join(tags)
    rtol = F64_RTOL if double else \
        K1_DEFAULT_RTOL if precision == "default" else ZTZV_RTOL
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
        again = ztzv.ztzv_parts(x, m, pr, sig, vc, vs, False, mode,
                                precision)
        torch.cuda.synchronize()
        same = torch.equal(again[0], oc) and torch.equal(again[1], os_)
        print(f"K1 ({tag}) determinism at {label}: two calls "
              f"bitwise equal: {same}", flush=True)
        check(same, f"two K1 calls on the same inputs differ at {label}")
        d, f = pr.shape
        ms = time_ms(torch, lambda: ztzv.ztzv_parts(
            x, m, pr, sig, vc, vs, True, mode, precision))
        plain_ms = time_ms(torch, lambda: ztzv.ztzv_parts_plain(
            x, m, pr, sig, vc, vs, True, mode, precision))
        kb = bound(esize * (n * d + n + d * f + 4 * f * k),
                   2 * n * d * f + 8 * n * f * k, body)
        print(f"K1 ({tag}) time at {label}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, {bound_text(kb)} [{card}]",
              flush=True)
        results.update(timed_entry("K1", (d, f, k) + tags, k1_err,
                                   ms, plain_ms, kb, f"R {n}, D {d}, F {f}, "
                                   f"K {k}, sincos {tags[0]}, {tags[1]}"))
    return results


def phase_slice(torch, card, tab, dev="cuda", num_rffs=NUM_RFFS,
                variance_rffs=VARIANCE_RFFS, tol=1e-6, label="slice A",
                double=False, kernels=True):
    """Slice A: fit(mode="cg", tol) + predict(get_var=True) at a real size,
    on ``tab`` = (train dataset, test x, test y), in float64 with
    ``double`` (``double_precision_fht``); on the card K1 and K2 must run
    unless not ``kernels`` (inside ``plain_kernels``).  Returns the
    launches, the predictions and the fit's record (model, fit_s, n_iter,
    residual, rho)."""
    from scipy.stats import spearmanr
    from xgpr_tpu_torch import GPRegression
    from xgpr_tpu_torch.ops.cuda import feature_map

    dset, tex, te_y = tab
    on_card = torch.device(dev).type == "cuda"
    model = GPRegression(num_rffs=num_rffs, variance_rffs=variance_rffs,
                         kernel_choice="RBF", device=dev, verbose=False,
                         double_precision_fht=double)
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
    if on_card and kernels:
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
    if on_card and kernels:
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
    """Predictions against the plain features' own, formed as predict
    forms them (float64 products with the weights)."""
    ref = (z.double() @ model.weights.double()).cpu().numpy()
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
                       mode="hi", precision="high", with_k4=True,
                       double=False):
    """K3 (in sincos ``mode``) and, with ``with_k4``, K4, both at feature
    ``precision``, against their plain versions at the same mode and
    precision, at the shapes the main path launches them at (chunks of the
    corpus, the models' own projections: the sequence slice's, and K3 at
    the tuning and verify widths too), a ragged case, w = 1 and, for K3, a
    guard case (arguments past POLY_ARG_LIMIT); each main-path shape is
    timed.  K4 has no sincos.  With ``double`` the same in float64 (the
    float64 bodies, keyed "exact", "float64"), to F64_RTOL."""
    from xgpr_tpu_torch.kernels import Conv1dRBF, Conv1dTwoLayer
    from xgpr_tpu_torch.ops.conv import conv_row_scale
    from xgpr_tpu_torch.ops.cuda import conv, feature_map
    from xgpr_tpu_torch.ops.cuda.operands import split_tf32
    rng = np.random.default_rng(11)
    x_np, _, l_np = corpus
    xdim = (chunk, MOTIF_L, MOTIF_D)
    spec = {"conv_width": MOTIF_W}
    k3 = Conv1dRBF(xdim, num_rffs, SEED, device=dev, double_precision=double,
                   kernel_spec_parms=spec)
    k3_tune = Conv1dRBF(xdim, tune_rffs, SEED, device=dev,
                        double_precision=double, kernel_spec_parms=spec)
    k3_verify = Conv1dRBF(xdim, verify_rffs, SEED, device=dev,
                          double_precision=double, kernel_spec_parms=spec)
    k4 = Conv1dTwoLayer(xdim, K4_RFFS, SEED, device=dev,
                        double_precision=double,
                        kernel_spec_parms={"conv_width": MOTIF_W,
                                           "init_rffs": init_rffs})
    esize = 8 if double else 4
    rtol = F64_RTOL if double else CONV_RTOL
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
    # D=128: the bf16 body's projT tile (128 x 9 x 128) does not stay in
    # shared memory, so it streams (conv.ws_plan).
    others = [("ragged", *ragged(1000, 9, 16, 5, 200), 5, None),
              ("w=1", *ragged(300, 12, 21, 1, 256), 1, None),
              ("D=21", *ragged(700, 14, 21, 6, 300), 6, None),
              ("D=128", *ragged(300, 16, 128, 9, 256), 9, None)]
    # The guard: row 0 has one nonzero, 5e4, and proj is rounded to TF32,
    # so each of its window projections is one exact product (times
    # sigma 1) in the kernel and the plain version alike, many past
    # POLY_ARG_LIMIT.
    xg, lg, pg = ragged(400, 12, 8, 4, 256)
    xg[0] = 0.0
    xg[0, 5, 3] = 5e4
    lg[0] = 12
    if not double:
        pg = split_tf32(pg)[0].contiguous()
    guard = ("guard", xg, lg, pg, 4, None)
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
            tags = feature_map.launch_tags(x.dtype, mode, precision)
            if name == "K4":
                tags = tags[1:]
            body = feature_map.kernel_body(name, x.dtype, precision)
            tag = f"{name} ({', '.join(tags)})"
            print(f"{tag} {label}: N={n} L={l} D={d} w={width} F={f} "
                  f"max_abs_err={err:.3e} max|ref|={scale:.3e} "
                  f"(tol {rtol:g} * max(1, max|ref|))", flush=True)
            check(err < rtol * scale, f"{tag} {label} disagrees ({err})")
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
            kb = bound(esize * (n * l * d + width * d * f + n * out_cols
                                + (n if name == "K3" else 0)) + 4 * n,
                       flops, body)
            slots, valid = conv.window_slots(lens, width, l - width + 1)
            print(f"{tag} time at {label} shape: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, {bound_text(kb)}; {nk_sum} valid "
                  f"windows, {flops / 1e9:.1f} GFLOP; projection matmul "
                  f"alone (partial yardstick, no mask/sincos/sum) "
                  f"{mm_ms:.4f} ms [{card}]", flush=True)
            products, peak = PRODUCTS[body]
            core_peak = PEAK_FP64_CORE_FLOPS if double \
                else PEAK_FP32_CORE_FLOPS
            tc_flops = products * flops * slots / valid
            print(f"{tag} at {label} shape: {slots} window slots projected "
                  f"for {valid} valid windows ({slots / valid:.3f} : 1); "
                  f"achieved {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s on the "
                  f"valid-window work "
                  f"({flops * 1e3 / ms / core_peak:.1%} of the "
                  f"{'FP64' if double else 'fp32'} CUDA-core peak; the "
                  f"{BODY[body]} body runs "
                  f"{tc_flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s of "
                  f"products on the projected slots, "
                  f"{tc_flops * 1e3 / ms / peak:.1%} of its peak) "
                  f"[{card}]", flush=True)
            shape = (f"N {n}, L {l}, D {d}, w {width}, F {f}"
                     + (f", sincos {tags[0]}" if name == "K3" else "")
                     + f", {tags[-1]}")
            results.update(timed_entry(name, (l, d, width, f) + tags, err,
                                       ms, plain_ms, kb, shape))
    return results


def phase_conv_slice(torch, card, corpus, n_train=N_TRAIN, n_test=N_TEST,
                     dev="cuda", chunk=CHUNK, num_rffs=NUM_RFFS,
                     variance_rffs=VARIANCE_RFFS, profile=False, tol=1e-6,
                     label="Conv1dRBF", double=False, kernels=True,
                     floor=MOTIF_SPEARMAN_FLOOR):
    """The sequence slice: Conv1dRBF fit(mode="cg", tol) + predict, in
    float64 with ``double`` (``double_precision_fht``); on the card K3
    must run unless not ``kernels`` (inside ``plain_kernels``), and the
    held-out Spearman must pass ``floor``.  Returns the launches, the CG
    iterations, the predictions, the model and the fit's record (fit_s,
    n_iter, residual, rho, dset)."""
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
                         device=dev, verbose=True,
                         double_precision_fht=double)
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
    if torch.device(dev).type == "cuda" and kernels:
        check(fit_counts["K3"].total() > 0, "K3 was not launched during fit")
        check(predict_counts["K3"].total() > 0,
              "K3 was not launched during predict")
    check(preds.shape == (n_test,) and var.shape == (n_test,),
          "prediction shapes")
    check(bool(np.all(np.isfinite(preds)) and np.all(np.isfinite(var))),
          "non-finite predictions")
    check(bool(np.all(var >= 0)), "negative variance")
    rho = float(spearmanr(preds, te_y)[0])
    print(f"{label} held-out Spearman {rho:.4f} (floor {floor})",
          flush=True)

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
    check(rho > floor, f"{label} Spearman below the floor")
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


def k1_share(timed, counts, k, call_s):
    """What K1's launches at K ``k`` in ``counts`` take of a call of
    ``call_s`` seconds, at the times phase 2 measured at their shapes
    (``timed``)."""
    n, secs = 0, 0.0
    for shape, c in counts["K1"].items():
        if shape[3] != k:
            continue
        res = (timed or {}).get(("K1", shape[1:]))
        if res is None:
            return f"K1 at K {k}: {c} launches at {shape[1:]}, not timed"
        n, secs = n + c, secs + c * res["ms"] / 1e3
    if n == 0:
        return f"K1 at K {k}: no launches"
    return (f"K1 at K {k}: {n} launches x {secs / n * 1e3:.4f} ms = "
            f"{secs:.3f}s, {100 * secs / call_s:.1f}% of the call's "
            f"{call_s:.3f}s")


def phase_rbf_nmll(torch, card, dset, dev="cuda", num_rffs=NUM_RFFS,
                   timed=None):
    """exact_nmll and approximate_nmll (default settings) on slice A's
    data at the pinned hyperparameters, with K1's share of the SLQ call
    (``k1_share``); then the approximate NMLL's two parts timed apart: the
    amortized preconditioner (the cached rank) and the SLQ solve.  Returns
    the split's launches apart: it calls the model's internals, not an
    entry point."""
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
    probes = constants.DEFAULT_NMLL_PARAMS["nsamples"]
    rank = model._nmll_rank_cache[1]
    gap = rel_gap(approx, exact)
    print(f"RBF NMLL at {num_rffs} RFFs: exact {exact:.6f} in {exact_s:.3f}s "
          f"(launches {counts_text(exact_counts)}), approximate "
          f"{approx:.6f} in {approx_s:.3f}s (launches {counts_text(counts)}),"
          f" relative gap {gap:.3e} (gate {NMLL_RTOL}); "
          f"preconditioner rank {rank} (srht_2); K1 launches by K during "
          f"approximate_nmll {dict(by_k)}; "
          f"{k1_share(timed, counts, probes + 1, approx_s)} [{card}]",
          flush=True)
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
    K1, K2 and K3 end in (.., mode, precision); None for K4, which has no
    sincos."""
    return None if name == "K4" else key[-2]


def key_precision(name, key):
    """The precision entry of a launch key, its last: the feature
    precision that ran for float32 launches (K2's "high" under "default"
    too), "float64" for float64 launches."""
    return key[-1]


def mode_summary(timed, mode, card):
    """Each timed (kernel, shape) of ``mode`` at "high" beside the "hi"
    time at the same shape."""
    for (name, key), res in sorted(timed.items(), key=str):
        if key_mode(name, key) != mode or key_precision(name, key) != "high":
            continue
        hi_key = key[:-2] + ("hi", key[-1])
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
    ("high") body's time and bound at the same shape and mode, or in "hi"
    where that mode was not timed at "high"."""
    for (name, key), res in sorted(timed.items(), key=str):
        if key[-1] != precision:
            continue
        high = timed.get((name, key[:-1] + ("high",)))
        if high is None and name != "K4":
            high = timed.get((name, key[:-2] + ("hi", "high")))
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
        plain = (z.double() @ model.weights.double()).cpu().numpy() * \
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
        conv_plain = (zc.double() @ conv_model.weights.double()).cpu() \
            .numpy() * conv_model.trainy_std + conv_model.trainy_mean
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
    """Every K1/K3/K4 launch at ``precision`` (K2 at "highest" under
    "highest", else at "high", its 3xTF32 body) and every K1/K2/K3 launch
    in sincos ``mode``."""
    for name, counter in counts.items():
        want = precision if name != "K2" or precision == "highest" \
            else "high"
        for key in counter:
            check(key_precision(name, key) == want,
                  f"{name} ran at {key_precision(name, key)} during "
                  f"{what}, not {want}")
            if name != "K4":
                check(key_mode(name, key) == mode,
                      f"{name} ran in sincos {key_mode(name, key)} during "
                      f"{what}, not {mode}")


def phase_presets(torch, card, tab, corpus, balanced, dev="cuda",
                  num_rffs=NUM_RFFS, timed=None):
    """The speed presets on the main paths (``set_speed_preset``).  Under
    "max": slice A fit by CG and predict with variance, the Conv1dRBF
    sequence slice fit and predict, the K4 path, and one RBF
    approximate_nmll (K1 at K 26) against its exact_nmll; under
    "reference": slice A refit and predict.  ``balanced`` holds the
    "balanced" runs' records of the same paths.  Gates as PRESET_RHO's
    comment says; prints each fit's recurrence residual beside its true
    residual in float64, and each preset's fit time and CG iterations
    beside "balanced"'s, and K1's share of the "max" SLQ call
    (``k1_share``, from ``timed``).  Restores "balanced".  Returns the
    paths' launches."""
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
              f"(gate {NMLL_RTOL}); "
              f"{k1_share(timed, nmll_counts, 26, approx_s)} [{card}]",
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
    held-out rows; class_gates.  Returns the launches, the model and the
    held-out rows."""
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
    plain = softmax_np((z.double() @ model.weights).cpu().numpy())
    class_gates(torch, card, "RBF classifier", model, hist, probs, te_y,
                plain, fit_counts, predict_counts, "K2", floor, dev)
    if torch.device(dev).type == "cuda":
        classifier_passes(torch, model, dset, card, "RBF classifier")
    return {k: fit_counts[k] + predict_counts[k] for k in fit_counts}, \
        model, tex


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
    plain = softmax_np((z.double() @ model.weights).cpu().numpy())
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


def phase_tuning(torch, card, tab, corpus, dev="cuda", timed=None):
    """Slice B: the NMLLs, the gradient and the two tuners; fails unless
    K1 ran at K = 26 and K2 and K3 ran.  ``timed``: phase 2's kernel times,
    for K1's share of the SLQ call.  Returns the phase's launches."""
    t0 = time.perf_counter()
    time_gradient_maps(torch, card, tab, corpus, dev)
    reset_counts()      # the timing launches above are not the path's
    rbf = phase_rbf_nmll(torch, card, tab[0], dev, timed=timed)
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


def blob_corpus(n_rows, n_features=N_FEATURES, n_centres=KMEANS_CENTRES,
                noise=KMEANS_NOISE, seed=SEED):
    """Blobs for the k-means gate: ``n_centres`` standard-normal centres,
    each row one of them (drawn uniformly) plus ``noise`` times a standard
    normal.  Returns x (n, n_features) float64 and the true labels."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((n_centres, n_features))
    labels = rng.integers(0, n_centres, n_rows)
    return centres[labels] + noise * rng.standard_normal(
        (n_rows, n_features)), labels


def spearman(a, b):
    from scipy.stats import spearmanr
    return float(spearmanr(a, b)[0])


def phase_linear(torch, card, tab, dev="cuda",
                 variance_rffs=LINEAR_VARIANCE_RFFS):
    """The Linear kernel on slice A's rows: a crude tune of lambda, the
    exact fit, the CG fit and predict with its Nystrom variance, against
    the port's own float64 fit on the CPU.  Returns the path's launches
    (none: Linear has no projection, so no kernel)."""
    from xgpr_tpu_torch import GPRegression
    dset, tex, te_y = tab
    model = GPRegression(num_rffs=2, variance_rffs=variance_rffs,
                         kernel_choice="Linear", device=dev, verbose=False)
    reset_counts()
    t0 = time.perf_counter()
    hparams, _, score = model.tune_hyperparams_crude(dset)
    model.fit(dset, mode="exact")
    exact_w = model.weights.double()
    n_iter, losses = model.fit(dset, mode="cg", tol=LINEAR_CG_TOL,
                               run_diagnostics=True)
    preds, var = model.predict(tex, get_var=True)
    sync(torch, dev)
    secs = time.perf_counter() - t0
    counts = read_counts()
    cpu = GPRegression(num_rffs=2, variance_rffs=variance_rffs,
                       kernel_choice="Linear", device="cpu", verbose=False)
    cpu.set_hyperparams(hparams, dset)
    cpu.fit(dset, mode="exact")
    cpu_preds = cpu.predict(tex)
    w_err = float((model.weights.double() - exact_w).abs().max())
    w_tol = LINEAR_CG_RTOL * float(exact_w.abs().max())
    p_err = float(np.abs(preds - cpu_preds).max())
    p_tol = PREDICT_RTOL * float(np.abs(cpu_preds).max())
    rho, rho_cpu = spearman(preds, te_y), spearman(cpu_preds, te_y)
    print(f"Linear ({model.num_rffs} features, Nystrom variance rank "
          f"{model.var.get_rank()}): crude tune log lambda {hparams} (score "
          f"{score}), exact fit, CG fit ({n_iter} iterations, residual "
          f"{losses[-1]:.3e}) and predict in {secs:.3f}s; CG vs exact "
          f"weights max_abs_err {w_err:.3e} (tol {w_tol:.3e}); predictions "
          f"vs the float64 CPU fit {p_err:.3e} (tol {p_tol:.3e}); held-out "
          f"Spearman {rho:.4f} (CPU {rho_cpu:.4f}, floor CPU - "
          f"{LINEAR_RHO_DROP}); launches {counts_text(counts)} [{card}]",
          flush=True)
    check(not model.exact_var_calculation, "Linear kept no Nystrom variance")
    check(n_iter < 500 and losses[-1] < LINEAR_CG_TOL,
          "Linear CG did not converge")
    check(w_err < w_tol, "Linear CG weights disagree with the exact fit's")
    check(p_err < p_tol, "Linear predictions disagree with the CPU fit's")
    check(bool(np.all(np.isfinite(var)) and np.all(var >= 0)),
          "Linear variances not finite or negative")
    check(rho >= rho_cpu - LINEAR_RHO_DROP, "Linear Spearman below the CPU "
                                            "fit's")
    check(sum(totals(counts).values()) == 0, "the Linear path launched a "
                                             "kernel")
    return counts


def plain_rbf_features(torch, kern, x, params):
    """The plain K2 features of an RBF or MiniARD kernel's rows, intercept
    applied."""
    from xgpr_tpu_torch.ops.cuda.feature_map import rbf_feature_map_plain
    scale = params["ard_weights"] if "ard_weights" in params \
        else params["sigma"]
    z = rbf_feature_map_plain(x * scale, params["proj"], kern.fit_intercept,
                              kern.padded_dims)
    if kern.fit_intercept:
        z[:, 0] = 1.0
    return z


def phase_mini_ard(torch, card, tab, trx, tr_y, dev="cuda",
                   tune_rows=TUNE_ROWS, tune_rffs=TUNE_RFFS,
                   num_rffs=NUM_RFFS, variance_rffs=VARIANCE_RFFS,
                   chunk=CHUNK, bayes_iter=BAYES_ITER,
                   spearman_floor=SPEARMAN_FLOOR, trace_dir=None):
    """MiniARD on slice A's rows (two groups, split at ARD_SPLIT): a crude
    tune on the first ``tune_rows`` rows, exact_nmll_gradient against a
    float64 witness, a CG fit at ``num_rffs`` with the tuned point and
    predict(get_var=True), then the same predict traced into
    ``trace_dir`` (the same results; the trace must name K2's kernel on
    the card).  Then a MiniARD whose
    lengthscales both equal slice A's sigma against slice A's RBF
    features, bitwise.  Returns the path's launches."""
    from xgpr_tpu_torch import GPRegression, build_regression_dataset, config
    from xgpr_tpu_torch.kernels import RBF, MiniARD
    from xgpr_tpu_torch.utils import diagnostics
    dset, tex, te_y = tab
    on_card = torch.device(dev).type == "cuda"
    settings = {"split_points": [ARD_SPLIT]}
    tune_set = build_regression_dataset(trx[:tune_rows], tr_y[:tune_rows],
                                        chunk_size=chunk)
    reset_counts()
    t0 = time.perf_counter()
    tuner = GPRegression(num_rffs=tune_rffs, kernel_choice="MiniARD",
                         kernel_settings=settings, device=dev, verbose=False)
    tuned, n_feval, best = tuner.tune_hyperparams_crude(
        tune_set, max_bayes_iter=bayes_iter)
    sync(torch, dev)
    tune_s = time.perf_counter() - t0
    del tuner, tune_set

    t0 = time.perf_counter()
    grad_model = GPRegression(num_rffs=tune_rffs, kernel_choice="MiniARD",
                              kernel_settings=settings, device=dev,
                              verbose=False)
    grad_model.set_hyperparams(ARD_GRAD_POINT, dset)
    (score, grad), grad_s, _ = nmll_call(
        torch, dev, grad_model.exact_nmll_gradient, ARD_GRAD_POINT, dset)
    del grad_model
    with config.working_dtype(torch.float64):
        wit = GPRegression(num_rffs=tune_rffs, kernel_choice="MiniARD",
                           kernel_settings=settings, device=dev,
                           verbose=False)
        wit.set_hyperparams(ARD_GRAD_POINT, dset)
        (score64, grad64), _, _ = nmll_call(
            torch, dev, wit.exact_nmll_gradient, ARD_GRAD_POINT, dset)
        num64 = central_difference(
            lambda h: nmll_call(torch, dev, wit.exact_nmll_gradient, h,
                                dset)[0][0], ARD_GRAD_POINT, GRAD_STEP)
        check(wit.kernel.dtype == torch.float64, "the witness is not float64")
    del wit
    sync(torch, dev)
    gradient_s = time.perf_counter() - t0
    err32, err64 = rel_err(grad, grad64), rel_err(grad64, num64)

    model = GPRegression(num_rffs=num_rffs, variance_rffs=variance_rffs,
                         kernel_choice="MiniARD", kernel_settings=settings,
                         device=dev, verbose=False)
    model.set_hyperparams(tuned, dset)
    t0 = time.perf_counter()
    n_iter, losses = model.fit(dset, mode="cg", run_diagnostics=True)
    sync(torch, dev)
    fit_s = time.perf_counter() - t0
    fit_counts = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    preds, var = model.predict(tex, get_var=True)
    sync(torch, dev)
    predict_s = time.perf_counter() - t0
    trace_path, traced_s = None, None
    if trace_dir is not None:
        t0 = time.perf_counter()
        with diagnostics.trace(str(trace_dir)):
            traced = model.predict(tex, get_var=True)
        traced_s = time.perf_counter() - t0
        trace_path = Path(trace_dir) / "trace.json"
        check(all(np.array_equal(a, b) for a, b in zip(traced,
                                                         (preds, var))),
              "the traced MiniARD predict differs from the untraced one")
    predict_counts = read_counts()
    rho = spearman(preds, te_y)
    kern = model.kernel
    params = kern.feature_params()
    z = plain_rbf_features(torch, kern, kern._cast_input(tex[:4096]), params)
    print(f"MiniARD (split at {ARD_SPLIT}): crude tune on {tune_rows} rows "
          f"at {tune_rffs} RFFs -> {tuned} (score {best}, {n_feval} "
          f"evaluations) in {tune_s:.3f}s; gradient at {ARD_GRAD_POINT} on "
          f"{dset.get_ndatapoints()} rows: float32 features NMLL "
          f"{score:.6f}, analytic {grad}; float64 witness NMLL "
          f"{score64:.6f}, analytic {grad64}, central difference {num64}; "
          f"relative error float32 vs witness {err32}, witness vs central "
          f"difference {err64} (gate {GRAD_RTOL} each), {gradient_s:.3f}s "
          f"with the witness; fit at {num_rffs} RFFs {fit_s:.3f}s, CG "
          f"iterations {n_iter}, residual {losses[-1]:.3e}; predict "
          f"{predict_s:.3f}s for {len(tex)} rows, again under "
          f"diagnostics.trace {traced_s}s; held-out Spearman {rho:.4f} (floor "
          f"{spearman_floor}); launches fit {counts_text(fit_counts)}, "
          f"predict {counts_text(predict_counts)} [{card}]", flush=True)
    check(np.all(err32 < GRAD_RTOL), "the MiniARD gradient disagrees with "
                                     "its float64 witness")
    check(np.all(err64 < GRAD_RTOL), "the MiniARD float64 gradient "
                                     "disagrees with the central difference")
    check(n_iter < 500 and losses[-1] < 1e-6, "MiniARD CG did not converge")
    check(bool(np.all(np.isfinite(preds)) and np.all(np.isfinite(var))
               and np.all(var >= 0)), "MiniARD predictions not finite or "
                                      "var < 0")
    check_predictions(model, z, preds[:4096], "the plain feature map "
                                              "(MiniARD)")
    check(rho > spearman_floor, "MiniARD Spearman below the floor")
    if on_card:
        check(fit_counts["K2"].total() > 0, "K2 did not run in the MiniARD "
                                            "fit")
        check(predict_counts["K2"].total() > 0, "K2 did not run in the "
                                                "MiniARD predict")
    if trace_path is not None:
        text = trace_path.read_text() if trace_path.exists() else ""
        named = "feature_map_kernel" in text
        print(f"MiniARD predict trace {trace_path} "
              f"({len(text)} bytes): names K2's feature_map_kernel: {named}",
              flush=True)
        check(trace_path.exists(), "the trace file was not written")
        check(named or not on_card, "the trace does not name K2's kernel")
    del model
    counts = {k: fit_counts[k] + predict_counts[k] for k in fit_counts}

    # Equal lengthscales give slice A's RBF features bit for bit (these
    # launches compare two kernels and are not the path's).
    x = torch.as_tensor(tex[:chunk], dtype=config.fp_dtype(dev),
                        device=dev)
    rbf = RBF((chunk, N_FEATURES), num_rffs, SEED, device=dev)
    rbf.set_hyperparams(HPARAMS)
    ard = MiniARD((chunk, N_FEATURES), num_rffs, SEED, device=dev,
                  kernel_spec_parms=settings)
    ard.set_hyperparams(np.array([HPARAMS[0], HPARAMS[1], HPARAMS[1]]))
    same = torch.equal(ard.transform_x(x), rbf.transform_x(x))
    print(f"MiniARD with both lengthscales at slice A's sigma vs slice A's "
          f"RBF features on {chunk} held-out rows: bitwise equal {same}",
          flush=True)
    check(same, "MiniARD at equal lengthscales differs from RBF")
    return counts


def state_roundtrip(torch, state, dev):
    """An exported state through numpy and back onto ``dev``."""
    if isinstance(state, dict):
        return {k: state_roundtrip(torch, v, dev) for k, v in state.items()}
    if torch.is_tensor(state):
        return torch.as_tensor(state.cpu().numpy(), device=dev)
    return state


def export_cases(torch, rbf_model, tex, conv_model, conv_test, classifier,
                 class_tex, dev="cuda"):
    """(label, fn, state, args, predict's outputs) of export_predict_fn on
    models earlier phases fitted: slice A's RBF with variance, the
    Conv1dRBF slice's (mean), the RBF classifier's."""
    dtype = rbf_model.kernel.dtype
    cases = []
    fn, state = rbf_model.export_predict_fn(get_var=True)
    cases.append(("RBF (mean, variance)", fn, state,
                  (torch.as_tensor(tex, dtype=dtype, device=dev),),
                  rbf_model.predict(tex, get_var=True)))
    xc, lc = conv_test
    fn, state = conv_model.export_predict_fn()
    cases.append(("Conv1dRBF (mean)", fn, state,
                  (torch.as_tensor(xc, dtype=dtype, device=dev),
                   torch.as_tensor(lc, dtype=torch.int32, device=dev)),
                  (conv_model.predict(xc, lc),)))
    fn, state = classifier.export_predict_fn()
    cases.append(("RBF classifier (probabilities)", fn, state,
                  (torch.as_tensor(class_tex, dtype=dtype, device=dev),),
                  (classifier.predict(class_tex),)))
    return cases


def phase_export(torch, card, cases, dev="cuda"):
    """Each exported fn (``export_cases``) against the model's predict on
    the held-out rows (within EXPORT_RTOL x max|pred|), and the same bits
    from a state that went through numpy.  Returns the launches of the
    exported fns."""
    reset_counts()
    results = []
    for label, fn, state, args, refs in cases:
        t0 = time.perf_counter()
        out = fn(state, *args)
        sync(torch, dev)
        secs = time.perf_counter() - t0
        out = out if isinstance(out, tuple) else (out,)
        again = fn(state_roundtrip(torch, state, dev), *args)
        again = again if isinstance(again, tuple) else (again,)
        same = all(torch.equal(a, b) for a, b in zip(again, out))
        errs = [(float(np.abs(o.cpu().numpy() - r).max()),
                 EXPORT_RTOL * float(np.abs(r).max()))
                for o, r in zip(out, refs)]
        results.append((label, errs, same))
        print(f"export_predict_fn {label}: {secs:.3f}s for {args[0].shape[0]} "
              f"rows; vs predict max_abs_err / tol "
              f"{[f'{e:.3e} / {t:.3e}' for e, t in errs]}; same bits after "
              f"the state went through numpy: {same} [{card}]", flush=True)
    counts = read_counts()
    print(f"export_predict_fn launches {counts_text(counts)}", flush=True)
    for label, errs, same in results:
        check(all(e < t for e, t in errs),
              f"the exported {label} fn disagrees with predict")
        check(same, f"the exported {label} fn changed after a numpy round "
                    "trip")
    if torch.device(dev).type == "cuda":
        check(counts["K2"].total() > 0 and counts["K3"].total() > 0,
              "the exported fns did not launch K2 and K3")
    return counts


def phase_aux(torch, card, tex, trx, corpus_test, dev="cuda",
              num_rffs=NUM_RFFS, pca_rffs=PCA_RFFS, kmeans_rffs=KMEANS_RFFS,
              kmeans_rows=N_TRAIN, chunk=CHUNK):
    """KernelFGen on RBF (slice A's held-out rows) and on Conv1dRBF (the
    motif corpus's held-out rows), KernelPCA on slice A's training rows,
    KernelKMeans on the blob corpus.  Returns the launches of each tool."""
    from xgpr_tpu_torch import KernelFGen, KernelKMeans, KernelPCA
    from xgpr_tpu_torch.ops.conv import conv_row_scale
    from xgpr_tpu_torch.ops.cuda.conv import conv_parts_plain
    from xgpr_tpu_torch.ops.layout import assemble_cos_sin
    on_card = torch.device(dev).type == "cuda"
    paths = []
    xc, lc = corpus_test
    for label, kernel_choice, x, lens, hparams, settings, nfeat in (
            ("RBF", "RBF", tex, None, HPARAMS[1:], None, N_FEATURES),
            ("Conv1dRBF", "Conv1dRBF", xc, lc, MOTIF_HPARAMS[1:],
             {"conv_width": MOTIF_W}, MOTIF_D)):
        fgen = KernelFGen(num_rffs=num_rffs, hyperparams=hparams,
                          num_features=nfeat, kernel_choice=kernel_choice,
                          kernel_settings=settings, device=dev,
                          verbose=False)
        reset_counts()
        t0 = time.perf_counter()
        feats = fgen.predict(x, lens, chunk_size=chunk)
        secs = time.perf_counter() - t0
        counts = read_counts()
        kern = fgen.kernel
        direct = np.vstack([kern.transform_x(
            x[i:i + chunk], None if lens is None else lens[i:i + chunk])
            .cpu().numpy() for i in range(0, x.shape[0], chunk)])
        params = kern.feature_params()
        xs = kern._cast_input(x[:chunk])
        if lens is None:
            ref = plain_rbf_features(torch, kern, xs, params)
        else:
            ls = kern._cast_lengths(lens[:chunk])
            scale = conv_row_scale(ls, kern.conv_width, kern.num_freqs,
                                   kern.scaling_type, kern.dtype,
                                   kern.device)
            c, s_ = conv_parts_plain(xs, ls, params["proj"],
                                     params["sigma"], kern.conv_width, scale)
            ref = assemble_cos_sin(c, s_, kern.padded_dims)
        ref = ref.cpu().numpy()
        err = float(np.abs(feats[:chunk] - ref).max())
        same = bool(np.array_equal(feats, direct))
        print(f"KernelFGen {label} at {num_rffs} RFFs: {feats.shape} in "
              f"{secs:.3f}s; equal to kernel.transform_x bitwise: {same}; vs "
              f"the plain feature map on {chunk} rows max_abs_err {err:.3e} "
              f"(tol {FEATURE_ATOL:g}); launches {counts_text(counts)} "
              f"[{card}]", flush=True)
        check(feats.shape == (x.shape[0], num_rffs), "KernelFGen shape")
        check(same, f"KernelFGen {label} differs from transform_x")
        check(err < FEATURE_ATOL, f"KernelFGen {label} disagrees with the "
                                  "plain feature map")
        check(not kern.fit_intercept, "KernelFGen kept an intercept")
        if on_card:
            check(counts["K3" if lens is not None else "K2"].total() > 0,
                  f"KernelFGen {label} launched no kernel")
        paths.append((f"KernelFGen {label}", counts))

    pca = KernelPCA(n_components=PCA_COMPONENTS, num_rffs=pca_rffs,
                    hyperparams=HPARAMS[1:], num_features=N_FEATURES,
                    device=dev, verbose=False)
    reset_counts()
    t0 = time.perf_counter()
    pca.fit(trx, chunk_size=chunk)
    sync(torch, dev)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proj = pca.transform(trx, chunk_size=chunk)
    transform_s = time.perf_counter() - t0
    counts = read_counts()
    comp = pca.components_
    ortho = float((comp @ comp.T - torch.eye(
        comp.shape[0], dtype=comp.dtype, device=comp.device)).abs().max())
    ev = pca.explained_variance_.cpu().numpy()
    var_err = np.abs(proj.var(axis=0) - ev) / np.abs(ev)
    print(f"KernelPCA at {pca_rffs} RFFs, {PCA_COMPONENTS} components on "
          f"{trx.shape[0]} rows: fit {fit_s:.3f}s (features, float64 "
          f"covariance, eigh of {pca_rffs}^2 in float64), transform "
          f"{transform_s:.3f}s; explained variance {ev[:4]} ... {ev[-1]:.4e}; "
          f"|C C^T - I| {ortho:.3e} (tol {PCA_ORTHO_TOL:g}); transformed "
          f"rows' variance vs explained variance, largest relative gap "
          f"{var_err.max():.3e} (tol {PCA_VAR_RTOL:g}); launches "
          f"{counts_text(counts)} [{card}]", flush=True)
    check(ortho < PCA_ORTHO_TOL, "KernelPCA components are not orthonormal")
    check(bool(np.all(np.diff(ev) <= 0) and np.all(ev >= -1e-8)),
          "KernelPCA explained variances not non-increasing and >= 0")
    check(bool(np.all(var_err < PCA_VAR_RTOL)),
          "KernelPCA transformed variance disagrees with explained_variance_")
    paths.append(("KernelPCA fit + transform", counts))
    del pca, proj

    xb, yb = blob_corpus(kmeans_rows)
    km = KernelKMeans(n_clusters=KMEANS_CENTRES, num_rffs=kmeans_rffs,
                      hyperparams=np.array([np.log(KMEANS_SIGMA)]),
                      num_features=N_FEATURES, device=dev, verbose=False)
    reset_counts()
    t0 = time.perf_counter()
    km.fit(xb, chunk_size=chunk)
    sync(torch, dev)
    fit_s = time.perf_counter() - t0
    labels = km.predict(xb, chunk_size=chunk)
    counts = read_counts()
    purity = sum(np.unique(labels[yb == k], return_counts=True)[1].max()
                 for k in range(KMEANS_CENTRES)) / xb.shape[0]
    agree = bool(np.array_equal(km.labels_, labels))
    print(f"KernelKMeans at {kmeans_rffs} RFFs, {KMEANS_CENTRES} clusters on "
          f"{xb.shape[0]} blob rows: fit {fit_s:.3f}s; purity {purity:.4f} "
          f"(floor {KMEANS_PURITY}); labels_ equal predict(x): {agree}; "
          f"launches {counts_text(counts)} [{card}]", flush=True)
    check(purity > KMEANS_PURITY, "KernelKMeans purity below the floor")
    check(agree, "KernelKMeans labels_ differ from predict(x)")
    paths.append(("KernelKMeans fit + predict", counts))
    if on_card:
        for path, counts in paths[2:]:
            check(counts["K2"].total() > 0, f"{path} launched no K2")
    return paths


def phase_surface(torch, card, tab, trx, tr_y, corpus, fitted, dev="cuda",
                  n_train=N_TRAIN, n_test=N_TEST, ard=None, aux=None):
    """Slice D2: the Linear kernel, MiniARD, the exports and the auxiliary
    tools (``fitted``: slice A's RBF model, the Conv1dRBF model and the
    RBF classifier with its held-out rows; the corpus's held-out rows
    start at ``n_train``).  ``ard`` and ``aux`` override the sizes of
    phase_mini_ard and phase_aux (a CPU rehearsal).  Returns the paths'
    launches and the names of the paths that launch no kernel."""
    t0 = time.perf_counter()
    tex = tab[1]
    conv_test = (corpus[0][n_train:n_train + n_test],
                 corpus[2][n_train:n_train + n_test])
    fitted["cases"] = export_cases(
        torch, fitted["rbf"], tex, fitted["conv"], conv_test,
        fitted["classifier"], fitted["class_tex"], dev)
    paths = [("Linear tune + fit + predict",
              phase_linear(torch, card, tab, dev))]
    paths.append(("MiniARD tune + gradient + fit + predict", phase_mini_ard(
        torch, card, tab, trx, tr_y, dev,
        trace_dir=ROOT / "build" / "trace" / "mini_ard_predict",
        **(ard or {}))))
    paths.append(("export_predict_fn", phase_export(
        torch, card, fitted["cases"], dev)))
    paths += phase_aux(torch, card, tex, trx, conv_test, dev, **(aux or {}))
    print(f"slice D2 phase: {time.perf_counter() - t0:.1f}s [{card}]",
          flush=True)
    without = [path for path, counts in paths
               if sum(totals(counts).values()) == 0]
    return [(p, c) for p, c in paths if p not in without], without


# ----------------------------------------------------------------------
# Slice E: the scale-out engines (phase_scale_out).
SCALE_OUT_DIR = ROOT / "build" / "scale_out"
SCALE_OUT_TIMEOUT = 600          # seconds, each group of ranks
SCALE_OUT_RANK, SCALE_OUT_METHOD = 1024, "srht_2"
MSHARD_RFFS = 32768              # config's M-sharding threshold
SLQ_PROBES, SLQ_ITER = 4, 30
SCALE_OUT_ROWS = 65_536          # (c) and (d): the depth is cut
SPLIT_CHUNKS = (5, 3)            # (c): chunks on rank 0 and rank 1
SHARD_RTOL = 1e-6                # weights vs the one-process fit, x max|w|


def standardised(y):
    """y on a scale common to every rank: the multi-process contract
    builds each rank's rows with normalize_y=False."""
    return (y - y.mean()) / y.std()


def rel_max(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def counts_to_json(counts):
    return {k: [[list(shape), n] for shape, n in c.items()]
            for k, c in counts.items()}


def counts_from_json(data):
    return {k: Counter({tuple(shape): n for shape, n in pairs})
            for k, pairs in data.items()}


def collectives():
    """A copy of the collective counts and seconds (distributed.py)."""
    from xgpr_tpu_torch.parallel import distributed
    return (Counter(distributed.COLLECTIVES),
            Counter(distributed.COLLECTIVE_SECONDS))


def collectives_since(before):
    calls, secs = collectives()
    return ({k: calls[k] - before[0][k] for k in calls},
            sum(secs.values()) - sum(before[1].values()))


def phase_compiled_exports(torch, card, cases, dev="cuda"):
    """E0: ``torch.compile(fn, fullgraph=True)`` of each exported fn
    (``export_cases``) against the model's predict, within EXPORT_RTOL x
    max|pred|; prints the first call's time (the compile) and a warm
    call's.  Returns the launches of the compiled calls."""
    reset_counts()
    results = []
    for label, fn, state, args, refs in cases:
        compiled = torch.compile(fn, fullgraph=True)
        t0 = time.perf_counter()
        out = compiled(state, *args)
        sync(torch, dev)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = compiled(state, *args)
        sync(torch, dev)
        warm_s = time.perf_counter() - t0
        out = out if isinstance(out, tuple) else (out,)
        errs = [(float(np.abs(o.cpu().numpy() - r).max()),
                 EXPORT_RTOL * float(np.abs(r).max()))
                for o, r in zip(out, refs)]
        results.append((label, errs))
        print(f"E0 compiled export {label}: first call (compile) "
              f"{first_s:.3f}s, warm call {warm_s:.4f}s for "
              f"{args[0].shape[0]} rows; vs predict max_abs_err / tol "
              f"{[f'{e:.3e} / {t:.3e}' for e, t in errs]} [{card}]",
              flush=True)
    counts = read_counts()
    for label, errs in results:
        check(all(e < t for e, t in errs),
              f"the compiled {label} export disagrees with predict")
    if torch.device(dev).type == "cuda":
        check(counts["K2"].total() > 0 and counts["K3"].total() > 0,
              "the compiled exports did not launch K2 and K3")
    return counts


def scale_out_rank(rank, job, world, port, workdir, dev, sizes):
    """One rank of a scale-out job (the target of phase_scale_out's
    spawn): takes the parent's ``sizes`` (module constants a CPU
    rehearsal lowers), joins the group (NCCL at world size 1, gloo for
    ranks that share the card), loads the parent's kernel build, runs
    ``job`` and writes its record to ``workdir``."""
    sys.path.insert(0, str(ROOT))
    globals().update(sizes)
    import torch
    from xgpr_tpu_torch.ops.cuda import build
    from xgpr_tpu_torch.parallel import distributed
    if torch.device(dev).type == "cuda":
        check(build.library_path().exists(),
              "the kernels were not built before the ranks started")
    backend = "nccl" if world == 1 and torch.device(dev).type == "cuda" \
        else "gloo"
    distributed.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       local_device_ids=[0],
                                       backend=backend)
    distributed.SYNC_TIMING = True
    try:
        record = SCALE_OUT_JOBS[job](torch, rank, world, Path(workdir), dev)
    finally:
        torch.distributed.destroy_process_group()
    record["backend"] = backend
    with open(Path(workdir) / f"{job}_{rank}.json", "w") as f:
        json.dump(record, f)


def start_ranks(job, world, workdir, dev, sizes):
    """Spawn ``world`` ranks of ``job`` on a free port; returns the
    processes' context and the time they started (``join_ranks``)."""
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(scale_out_rank,
                             args=(job, world, port, str(workdir), dev,
                                   sizes),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, time.monotonic()


def stop_ranks(started):
    """Kill whatever of ``start_ranks``' processes still runs."""
    for p in started[0].processes:
        if p.is_alive():
            p.kill()
            p.join()


def join_ranks(started, job, world, workdir, timeout=SCALE_OUT_TIMEOUT):
    """Wait for ``start_ranks``' processes within ``timeout`` seconds of
    their start (every rank is killed if it is hit); returns each rank's
    record."""
    ctx, t0 = started
    deadline = t0 + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            check(time.monotonic() < deadline,
                  f"scale-out job {job} did not end within {timeout} s")
    finally:
        stop_ranks(started)
    records = []
    for rank in range(world):
        with open(Path(workdir) / f"{job}_{rank}.json") as f:
            records.append(json.load(f))
    return records


def drive(torch, dev, label, fn):
    """Run ``fn`` with the launch and collective counts set to 0 just
    before; returns (its result, its record: seconds, launches,
    collectives and their seconds, which the parent prints)."""
    reset_counts()
    before = collectives()
    sync(torch, dev)
    t0 = time.perf_counter()
    out = fn()
    sync(torch, dev)
    secs = time.perf_counter() - t0
    counts = read_counts()
    calls, coll_s = collectives_since(before)
    return out, {"label": label, "seconds": secs,
                 "counts": counts_to_json(counts), "collectives": calls,
                 "collective_s": coll_s}


def warm_up(torch, dev, label):
    """A small fit, predict and SLQ NMLL at slice A's width under the
    sharded engine, so that a fresh process's first uses (the CUDA
    libraries and their handles, the first collective) stay out of the
    timed phases; prints its time."""
    from xgpr_tpu_torch import GPRegression, build_regression_dataset, config
    t0 = time.perf_counter()
    config.set_engine_mode("sharded")
    (x, y), (tx, _) = tabular_data(2 * CHUNK, 64, N_FEATURES, seed=SEED + 1)
    data = build_regression_dataset(x, y, chunk_size=CHUNK)
    model = GPRegression(num_rffs=NUM_RFFS, variance_rffs=VARIANCE_RFFS,
                         device=dev, verbose=False)
    model.set_hyperparams(HPARAMS, data)
    precond, _ = model.build_preconditioner(data, max_rank=64,
                                            method=SCALE_OUT_METHOD)
    model.fit(data, preconditioner=precond)
    model.predict(tx, get_var=True)
    model.approximate_nmll(HPARAMS, data)
    sync(torch, dev)
    config.set_engine_mode("auto")
    print(f"{label} warm-up (a fresh process's first uses): "
          f"{time.perf_counter() - t0:.3f}s", flush=True)


def job_e1(torch, rank, world, workdir, dev):
    """E1 (NCCL, world size 1): slice A fit by CG (autoselected
    preconditioner), predict with variance and one approximate_nmll, on
    the single Engine and then, under set_engine_mode("sharded"), on the
    ShardedEngine; and the one-process reference fit of E2(a) (slice A
    with the explicit preconditioner E2 uses)."""
    from xgpr_tpu_torch import GPRegression, build_regression_dataset, config
    (trx, tr_y), (tex, _) = tabular_data(N_TRAIN, N_TEST, N_FEATURES,
                                         seed=SEED)
    dset = build_regression_dataset(trx, standardised(tr_y),
                                    chunk_size=CHUNK, normalize_y=False)
    warm_up(torch, dev, "E1")
    record = {"paths": []}
    for mode in ("single", "sharded"):
        config.set_engine_mode(mode)
        model = GPRegression(num_rffs=NUM_RFFS, variance_rffs=VARIANCE_RFFS,
                             kernel_choice="RBF", device=dev, verbose=False)
        model.set_hyperparams(HPARAMS, dset)

        def run():
            n_iter, losses = model.fit(dset, mode="cg", tol=1e-6,
                                       run_diagnostics=True)
            weights = model.weights.cpu().numpy()
            preds, var = model.predict(tex, get_var=True)
            return n_iter, losses[-1], weights, np.stack([preds, var]), \
                model.approximate_nmll(HPARAMS, dset)
        out, rec = drive(torch, dev, f"E1 {mode} engine: CG fit + predict "
                                     "+ approximate_nmll", run)
        rec["engine"] = type(model._engine(dset)).__name__
        np.save(workdir / f"e1_{mode}.npy", out[2])
        np.save(workdir / f"e1_{mode}_pred.npy", out[3])
        rec.update(n_iter=out[0], residual=out[1], nmll=out[4])
        record[mode] = rec
        if mode == "single":
            precond, _ = model.build_preconditioner(
                dset, max_rank=SCALE_OUT_RANK, method=SCALE_OUT_METHOD)
            n_ref = model.fit(dset, preconditioner=precond, tol=1e-6,
                              run_diagnostics=True)[0]
            np.save(workdir / "e2a_ref.npy", model.weights.cpu().numpy())
            record["e2a_ref_iter"] = n_ref
        del model
    config.set_engine_mode("auto")
    record["paths"] += [record["single"], record["sharded"]]
    return record


def split_rows(n, rank, world, cuts=None):
    cuts = cuts or [n * r // world for r in range(world + 1)]
    return slice(cuts[rank], cuts[rank + 1])


def job_e2(torch, rank, world, workdir, dev):
    """E2: two gloo ranks on one card, each with its own rows: (a) slice A
    at 8192 RFFs, (b) slice A at MSHARD_RFFS, M-sharded against the
    replicated solver (fit and SLQ's coefficients), (c) the Conv1dRBF on
    SCALE_OUT_ROWS motif rows split SPLIT_CHUNKS through the
    StreamingShardedEngine, (d) the RBF classifier on SCALE_OUT_ROWS rows.
    Every fit takes the explicit preconditioner (SCALE_OUT_RANK,
    SCALE_OUT_METHOD) of its one-process reference."""
    from xgpr_tpu_torch import (GPClassification, GPRegression,
                                build_classification_dataset,
                                build_regression_dataset, config)
    from xgpr_tpu_torch.fitting.cg import ConjugateGrad
    record = {"paths": []}
    (trx, tr_y), (tex, _) = tabular_data(N_TRAIN, N_TEST, N_FEATURES,
                                         seed=SEED)
    rows = split_rows(N_TRAIN, rank, world)
    dset = build_regression_dataset(trx[rows], standardised(tr_y)[rows],
                                    chunk_size=CHUNK, normalize_y=False)
    # The ranks start while E1 runs; the card is theirs once the parent
    # has E1's result and the references (its "go" file).
    deadline = time.monotonic() + SCALE_OUT_TIMEOUT
    while not (workdir / "e2_go").exists():
        check(time.monotonic() < deadline, "E2 was never started")
        time.sleep(0.1)
    warm_up(torch, dev, f"E2 rank {rank}")
    config.set_engine_mode("sharded")

    def fit(model, data, **kw):
        precond, _ = model.build_preconditioner(
            data, max_rank=SCALE_OUT_RANK, method=SCALE_OUT_METHOD)
        return model.fit(data, preconditioner=precond, run_diagnostics=True,
                         **kw)[0]

    # (a)
    model = GPRegression(num_rffs=NUM_RFFS, variance_rffs=VARIANCE_RFFS,
                         kernel_choice="RBF", device=dev, verbose=False)
    model.set_hyperparams(HPARAMS, dset)
    (n_iter, preds), rec = drive(torch, dev, "E2(a) slice A, 2 ranks: fit "
                                 "+ predict", lambda: (
                                     fit(model, dset, tol=1e-6),
                                     model.predict(tex, get_var=True)[0]))
    rec.update(n_iter=n_iter, engine=type(model._engine(dset)).__name__,
               rows=dset.get_ndatapoints())
    np.save(workdir / f"e2a_{rank}.npy", model.weights.cpu().numpy())
    np.save(workdir / f"e2a_pred_{rank}.npy", preds)
    record["a"] = rec
    record["paths"].append(rec)
    del model

    # (b)
    model = GPRegression(num_rffs=MSHARD_RFFS, kernel_choice="RBF",
                         device=dev, verbose=False)
    model.set_hyperparams(HPARAMS, dset)
    precond, _ = model.build_preconditioner(
        dset, max_rank=SCALE_OUT_RANK, method=SCALE_OUT_METHOD)
    engine = model._engine(dset)
    n = engine.ndatapoints
    rhs = torch.cat([precond.get_zty()[:, None] / n, torch.as_tensor(
        np.random.default_rng(1).standard_normal((MSHARD_RFFS, SLQ_PROBES)),
        dtype=torch.float64, device=dev)], dim=1)
    lam = model.kernel.get_lambda()
    out = {}
    for mode in ("auto", "off"):
        # MSHARD_RFFS is config's threshold (a rehearsal lowers both).
        config.set_m_sharding(mode, threshold=MSHARD_RFFS)
        engine = model._engine(dset)
        m_sharded = config.use_m_sharding(MSHARD_RFFS, engine.n_dev)

        def run():
            n_iter = model.fit(dset, preconditioner=precond, tol=1e-6,
                               suppress_var=True, run_diagnostics=True)[0]
            _, a, b = ConjugateGrad(engine).fit(rhs, lam, precond, SLQ_ITER,
                                                1e-6, nmll_settings=True)
            return n_iter, a.cpu().numpy(), b.cpu().numpy()
        res, rec = drive(torch, dev, f"E2(b) {MSHARD_RFFS} RFFs, 2 ranks, "
                                     f"M-sharding {mode} ({m_sharded}): fit "
                                     f"+ SLQ's CG at K {SLQ_PROBES + 1}",
                         run)
        rec.update(n_iter=res[0], m_sharded=m_sharded)
        np.save(workdir / f"e2b_{mode}_{rank}.npy",
                model.weights.cpu().numpy())
        np.save(workdir / f"e2b_{mode}_ab_{rank}.npy", np.stack(res[1:]))
        out[mode] = rec
        record["paths"].append(rec)
    config.set_m_sharding("auto", threshold=32768)
    record["b"] = out
    del model, precond, engine, dset

    # (c)
    x = np.load(workdir / "motif_x.npy", mmap_mode="r")
    y = np.load(workdir / "motif_y.npy")
    lengths = np.load(workdir / "motif_l.npy")
    cuts = [0, SPLIT_CHUNKS[0] * CHUNK, SCALE_OUT_ROWS]
    rows = split_rows(SCALE_OUT_ROWS, rank, world, cuts)
    cset = build_regression_dataset(np.array(x[rows]), y[rows],
                                    lengths[rows], chunk_size=CHUNK,
                                    normalize_y=False)
    config.set_stacked_limit(1)
    model = GPRegression(num_rffs=NUM_RFFS, variance_rffs=VARIANCE_RFFS,
                         kernel_choice="Conv1dRBF",
                         kernel_settings={"conv_width": MOTIF_W},
                         device=dev, verbose=False)
    model.set_hyperparams(MOTIF_HPARAMS, cset)
    ctex = np.load(workdir / "motif_test_x.npy")
    ctel = np.load(workdir / "motif_test_l.npy")
    (n_iter, preds), rec = drive(
        torch, dev, "E2(c) Conv1dRBF, 2 ranks streamed "
                    f"({SPLIT_CHUNKS[0]} chunks against {SPLIT_CHUNKS[1]}): "
                    "fit + predict",
        lambda: (fit(model, cset, tol=1e-6), model.predict(ctex, ctel)))
    engine = model._engine(cset)
    rec.update(n_iter=n_iter, engine=type(engine).__name__,
               local_chunks=engine.local_batches,
               global_chunks=engine.global_batches)
    np.save(workdir / f"e2c_{rank}.npy", model.weights.cpu().numpy())
    np.save(workdir / f"e2c_pred_{rank}.npy", preds)
    record["c"] = rec
    record["paths"].append(rec)
    config.set_stacked_limit(10 ** 9)
    del model, engine, cset, x

    # (d)
    (ktx, kty), (ktex, _) = classification_data(
        N_TRAIN, N_TEST, N_FEATURES, CLASS_N_CLASSES, seed=SEED)
    rows = split_rows(SCALE_OUT_ROWS, rank, world)
    kset = build_classification_dataset(ktx[rows], kty[rows],
                                        chunk_size=CHUNK)
    model = GPClassification(num_rffs=NUM_RFFS, kernel_choice="RBF",
                             device=dev, verbose=False)
    model.set_hyperparams(CLASS_HPARAMS, kset)
    (n_iter, probs), rec = drive(
        torch, dev, "E2(d) RBF classifier, 2 ranks: fit + predict",
        lambda: (fit(model, kset), model.predict(ktex)))
    rec.update(n_iter=n_iter)
    np.save(workdir / f"e2d_{rank}.npy", model.weights.cpu().numpy())
    np.save(workdir / f"e2d_pred_{rank}.npy", probs)
    record["d"] = rec
    record["paths"].append(rec)
    config.set_engine_mode("auto")
    return record


SCALE_OUT_JOBS = {"e1": job_e1, "e2": job_e2}


def single_references(torch, card, corpus, workdir, dev="cuda"):
    """The one-process fits E2(c) and E2(d) are held against, on this
    process's card with the explicit preconditioner E2 uses: the
    Conv1dRBF on the corpus's first SCALE_OUT_ROWS rows (whose arrays go
    to ``workdir`` for the ranks) and the RBF classifier on the
    classification rows' first SCALE_OUT_ROWS."""
    from xgpr_tpu_torch import (GPClassification, GPRegression,
                                build_classification_dataset,
                                build_regression_dataset)
    x, y, lengths = corpus
    n = SCALE_OUT_ROWS
    y = standardised(y[:n])
    for name, arr in (("motif_x", x[:n]), ("motif_y", y),
                      ("motif_l", lengths[:n]),
                      ("motif_test_x", x[N_TRAIN:N_TRAIN + N_TEST]),
                      ("motif_test_l", lengths[N_TRAIN:N_TRAIN + N_TEST])):
        np.save(workdir / f"{name}.npy", arr)
    refs = {}
    t0 = time.perf_counter()
    cset = build_regression_dataset(x[:n], y, lengths[:n], chunk_size=CHUNK,
                                    normalize_y=False)
    model = GPRegression(num_rffs=NUM_RFFS, variance_rffs=VARIANCE_RFFS,
                         kernel_choice="Conv1dRBF",
                         kernel_settings={"conv_width": MOTIF_W},
                         device=dev, verbose=False)
    model.set_hyperparams(MOTIF_HPARAMS, cset)
    precond, _ = model.build_preconditioner(cset, max_rank=SCALE_OUT_RANK,
                                            method=SCALE_OUT_METHOD)
    refs["c_iter"] = model.fit(cset, preconditioner=precond, tol=1e-6,
                               run_diagnostics=True)[0]
    refs["c_w"] = model.weights.cpu().numpy()
    refs["c_pred"] = model.predict(x[N_TRAIN:N_TRAIN + N_TEST],
                                   lengths[N_TRAIN:N_TRAIN + N_TEST])
    del model, precond, cset
    (ktx, kty), (ktex, kte_y) = classification_data(
        N_TRAIN, N_TEST, N_FEATURES, CLASS_N_CLASSES, seed=SEED)
    kset = build_classification_dataset(ktx[:n], kty[:n], chunk_size=CHUNK)
    model = GPClassification(num_rffs=NUM_RFFS, kernel_choice="RBF",
                             device=dev, verbose=False)
    model.set_hyperparams(CLASS_HPARAMS, kset)
    precond, _ = model.build_preconditioner(kset, max_rank=SCALE_OUT_RANK,
                                            method=SCALE_OUT_METHOD)
    refs["d_iter"] = model.fit(kset, preconditioner=precond,
                               run_diagnostics=True)[0]
    refs["d_w"] = model.weights.cpu().numpy()
    refs["d_probs"] = model.predict(ktex)
    refs["d_te_y"] = kte_y
    print(f"E2 one-process references (Conv1dRBF and RBF classifier on "
          f"{n} rows): {time.perf_counter() - t0:.2f}s, CG iterations "
          f"{refs['c_iter']}, NCG iterations {refs['d_iter']} [{card}]",
          flush=True)
    return refs


def shard_gate(label, got_w, want_w, got_iter, want_iter,
               against="the one-process fit's"):
    err = rel_max(got_w, want_w)
    print(f"{label}: iterations {got_iter} against {want_iter}; weights "
          f"{err:.3e} x max|w| from {against} (tol {SHARD_RTOL:g})",
          flush=True)
    check(abs(got_iter - want_iter) <= 1,
          f"{label}: iterations differ by more than one")
    check(err < SHARD_RTOL, f"{label}: weights differ")


def report_ranks(record, name, card):
    for rec in record["paths"]:
        print(f"{rec['label']}: {rec['seconds']:.3f}s; launches "
              f"{counts_text(counts_from_json(rec['counts']))}; collectives "
              f"{rec['collectives']} in {rec['collective_s']:.3f}s "
              f"({name}, {record['backend']}) [{card}]", flush=True)


def check_e1(e1, workdir, te_y, card, t_start):
    """E1's gates: the engines routed, the sharded run bitwise the single
    one's, CG converged, Spearman above slice A's floor.  Returns the
    sharded run's path for the kernels line."""
    report_ranks(e1, "rank 0 of 1", card)
    single, sharded = e1["single"], e1["sharded"]
    same = {
        "weights": np.array_equal(np.load(workdir / "e1_single.npy"),
                                  np.load(workdir / "e1_sharded.npy")),
        "predictions": np.array_equal(np.load(workdir / "e1_single_pred.npy"),
                                      np.load(workdir /
                                              "e1_sharded_pred.npy")),
        "iterations": single["n_iter"] == sharded["n_iter"],
        "NMLL": single["nmll"] == sharded["nmll"]}
    rho = spearman(np.load(workdir / "e1_sharded_pred.npy")[0], te_y)
    print(f"E1 ({e1['backend']}, world size 1): engine "
          f"{sharded['engine']}, CG "
          f"{sharded['n_iter']} iterations (single {single['n_iter']}), "
          f"approximate NMLL {sharded['nmll']!r} (single "
          f"{single['nmll']!r}); bitwise equal to the single engine: {same};"
          f" held-out Spearman {rho:.4f} (floor {SPEARMAN_FLOOR}); the "
          f"child, E0 beside it, {time.perf_counter() - t_start:.1f}s "
          f"[{card}]", flush=True)
    check(sharded["engine"] == "ShardedEngine" and
          single["engine"] == "Engine", "E1 did not route the engines")
    check(all(same.values()), "E1: the sharded fit is not bitwise the "
                              "single engine's")
    check(sharded["residual"] < 1e-6, "E1: CG did not converge")
    check(rho > SPEARMAN_FLOOR, "E1: Spearman below the floor")
    return ("E1 sharded fit + predict + NMLL (NCCL, world size 1)",
            counts_from_json(sharded["counts"]))


def phase_scale_out(torch, card, te_y, corpus, cases, dev="cuda",
                    sizes=None):
    """Slice E (after phase_surface): E0 the compiled exports (``cases``
    from ``export_cases``), E1 the sharded path at world size 1 over NCCL
    in a child process, bitwise against the single engine, and E2 two
    gloo ranks on the one card (job_e2), each against its one-process
    fit.  The kernels are already built: the ranks load the parent's
    build.  ``te_y`` are slice A's held-out targets.  ``sizes`` (module
    constants by name) reach the ranks as the parent's: a CPU rehearsal
    sets them in both.  Returns the paths' launches."""
    sizes = sizes or {}
    t0 = time.perf_counter()
    workdir = SCALE_OUT_DIR
    workdir.mkdir(parents=True, exist_ok=True)
    for old in workdir.iterdir():
        old.unlink()
    # E0 runs here while E1's child starts and warms up (the compiles are
    # host work), and E2's ranks start, make their rows and wait for E1.
    t1 = time.perf_counter()
    e1_ranks = start_ranks("e1", 1, workdir, dev, sizes)
    e2_ranks = start_ranks("e2", 2, workdir, dev, sizes)
    try:
        paths = [("E0 compiled exports",
                  phase_compiled_exports(torch, card, cases, dev))]
        (e1,) = join_ranks(e1_ranks, "e1", 1, workdir)
        paths.append(check_e1(e1, workdir, te_y, card, t1))
        refs = single_references(torch, card, corpus, workdir, dev)
    except BaseException:
        stop_ranks(e1_ranks)
        stop_ranks(e2_ranks)
        raise
    t1 = time.perf_counter()
    (workdir / "e2_go").touch()
    ranks = join_ranks(e2_ranks, "e2", 2, workdir)
    for rank, record in enumerate(ranks):
        report_ranks(record, f"rank {rank} of 2", card)
    print(f"E2 (gloo, 2 ranks on one card): {time.perf_counter() - t1:.1f}s "
          f"[{card}]", flush=True)
    r0 = ranks[0]

    def rank_arrays(name):
        arrays = [np.load(workdir / f"{name}_{r}.npy") for r in range(2)]
        check(np.array_equal(*arrays), f"E2: the ranks' {name} differ")
        return arrays[0]
    check(r0["a"]["engine"] == "ShardedEngine" and
          r0["a"]["rows"] == N_TRAIN // 2, "E2(a) did not shard its rows")
    shard_gate("E2(a) slice A", rank_arrays("e2a"),
               np.load(workdir / "e2a_ref.npy"), r0["a"]["n_iter"],
               e1["e2a_ref_iter"])
    rho = spearman(rank_arrays("e2a_pred"), te_y)
    print(f"E2(a) held-out Spearman {rho:.4f} (floor {SPEARMAN_FLOOR})",
          flush=True)
    check(rho > SPEARMAN_FLOOR, "E2(a): Spearman below the floor")
    b = r0["b"]
    check(b["auto"]["m_sharded"] and not b["off"]["m_sharded"],
          f"E2(b): M-sharding did not switch on at {MSHARD_RFFS} RFFs")
    shard_gate(f"E2(b) M-sharded against replicated at {MSHARD_RFFS} RFFs",
               rank_arrays("e2b_auto"), rank_arrays("e2b_off"),
               b["auto"]["n_iter"], b["off"]["n_iter"],
               "the replicated fit's")
    ab_m, ab_r = rank_arrays("e2b_auto_ab"), rank_arrays("e2b_off_ab")
    check(ab_m.shape == ab_r.shape, "E2(b): SLQ ran different lengths")
    err = rel_max(ab_m, ab_r)
    print(f"E2(b) SLQ's alphas and betas ({ab_m.shape[1]} iterations x "
          f"{SLQ_PROBES} probes): M-sharded {err:.3e} x max from the "
          f"replicated (tol {SHARD_RTOL:g})", flush=True)
    check(err < SHARD_RTOL, "E2(b): SLQ's coefficients differ")
    c = r0["c"]
    check(c["engine"] == "StreamingShardedEngine" and
          [r["c"]["local_chunks"] for r in ranks] == list(SPLIT_CHUNKS) and
          c["global_chunks"] == SPLIT_CHUNKS[0],
          "E2(c) did not stream its unequal split")
    shard_gate("E2(c) Conv1dRBF streamed", rank_arrays("e2c"), refs["c_w"],
               c["n_iter"], refs["c_iter"])
    preds = rank_arrays("e2c_pred")
    rho_c = spearman(preds, corpus[1][N_TRAIN:N_TRAIN + N_TEST])
    rho_ref = spearman(refs["c_pred"], corpus[1][N_TRAIN:N_TRAIN + N_TEST])
    print(f"E2(c) held-out Spearman {rho_c:.4f} (one-process fit "
          f"{rho_ref:.4f}; the floor {MOTIF_SPEARMAN_FLOOR} is for "
          f"{N_TRAIN} rows)", flush=True)
    check(abs(rho_c - rho_ref) < 1e-4, "E2(c): Spearman moved")
    shard_gate("E2(d) RBF classifier", rank_arrays("e2d"), refs["d_w"],
               r0["d"]["n_iter"], refs["d_iter"])
    acc = float((np.argmax(rank_arrays("e2d_pred"), axis=1) ==
                 refs["d_te_y"]).mean())
    acc_ref = float((np.argmax(refs["d_probs"], axis=1) ==
                     refs["d_te_y"]).mean())
    print(f"E2(d) held-out accuracy {acc:.4f} (one-process fit "
          f"{acc_ref:.4f}, floor {CLASS_ACC_FLOOR})", flush=True)
    check(acc >= CLASS_ACC_FLOOR, "E2(d): accuracy below the floor")
    for tag, rec in (("(a)", r0["a"]), ("(b) M-sharded", b["auto"]),
                     ("(b) replicated", b["off"]), ("(c)", c),
                     ("(d)", r0["d"])):
        counts = counts_from_json(rec["counts"])
        for other in ranks[1:]:
            more = {r["label"]: r for r in other["paths"]}[rec["label"]]
            for k, v in counts_from_json(more["counts"]).items():
                counts[k] = counts[k] + v
        paths.append((f"E2{tag} 2 gloo ranks", counts))
    print(f"slice E phase: {time.perf_counter() - t0:.1f}s [{card}]",
          flush=True)
    return paths


# Phase G: float64 on the card (``double_precision_fht``: every kernel's
# float64 body) and the "reference" preset on the sequence path (K3's fp32
# CUDA-core body).  G2 fits slice A in float64 at its full size; G3 fits
# Conv1dRBF in float64 on the corpus's first G_CONV_ROWS rows (a float64
# K3 chunk costs several times a 3xTF32 one; the cut of depth), then runs
# FastConv1d in float64 on G_K4_ROWS rows; G4 fits the same Conv1dRBF rows
# under "reference" and under "balanced".  The float64 fits are held
# against the same models computed through the plain versions on the card
# (``plain_kernels``): predictions within G_PLAIN_RTOL x max|pred|, CG
# iterations within one; their held-out Spearman within G_RHO of the
# float32 fit's (phase 3's for G2, G4's "balanced" for G3); G2's SLQ NMLL
# (K1 at K 26) within NMLL_RTOL of the exact one, on G_NMLL_ROWS rows
# (all of slice A's).  G4's predictions within PREDICT_RTOL x max|pred| of
# the plain K3 (phase_conv_slice) and within MODE_RTOL x max|pred| of
# "balanced"'s, every K3/K4 launch at "highest" in "exact".  The Spearman
# floors of the full-depth slices do not apply at G_CONV_ROWS rows.
G_CONV_ROWS, G_K4_ROWS, G_NMLL_ROWS = 65_536, 4096, N_TRAIN
G_PLAIN_RTOL, G_RHO = 1e-8, 0.005


@contextlib.contextmanager
def plain_kernels():
    """Inside the block the port's kernels compute through the kernels'
    plain versions on every device: the names the kernel classes and the
    conv feature ops call at run time are pointed at the plain versions.
    It gives the same model computed without the kernels, on the card, as
    a reference; no launch is counted inside it."""
    from xgpr_tpu_torch.kernels import basic, l2_conv1d, mini_ard
    from xgpr_tpu_torch.ops import conv as conv_ops
    from xgpr_tpu_torch.ops.cuda import conv, feature_map, ztzv
    swaps = [(basic, "fused_feature_map", feature_map.rbf_feature_map_plain),
             (basic, "ztzv_parts", ztzv.ztzv_parts_plain),
             (mini_ard, "fused_feature_map",
              feature_map.rbf_feature_map_plain),
             (l2_conv1d, "fused_feature_map",
              feature_map.rbf_feature_map_plain),
             (conv_ops, "conv_parts", conv.conv_parts_plain),
             (conv_ops, "conv_maxpool", conv.conv_maxpool_plain)]
    saved = [(module, name, getattr(module, name))
             for module, name, _ in swaps]
    for module, name, fn in swaps:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def strided(torch, a):
    """a's values in a non-contiguous layout (every other element of a
    buffer twice as long in the last axis)."""
    out = torch.stack([a, torch.zeros_like(a)], dim=-1)[..., 0]
    check(not out.is_contiguous() and torch.equal(out, a),
          "the strided copy is not a non-contiguous copy")
    return out


def check_layouts(torch, card, dev="cuda"):
    """K1-K4 on non-contiguous operands against the same values laid out
    contiguously: the same bits, in float64 and in float32 ("high"; K3
    and K4 also at "highest")."""
    from xgpr_tpu_torch.ops.cuda import conv, feature_map, ztzv
    rng = np.random.default_rng(13)
    for dtype in (torch.float64, torch.float32):
        def t(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=dev)
        x, proj = t(rng.standard_normal((300, 84)) * 0.5), \
            t(rng.standard_normal((84, 256)) * 0.3)
        m = t(rng.random(300) > 0.25)
        vc, vs = (t(rng.standard_normal((256, 3))) for _ in range(2))
        xs = t(rng.standard_normal((300, 16, 64)) * 0.5)
        lens = t(rng.integers(8, 17, size=300), torch.int32)
        pc = t(rng.standard_normal((9 * 64, 256)) * 0.3)
        rs = t(rng.random(300) + 0.5)
        calls = [("K2", lambda f: (feature_map.rbf_feature_map(
                      f(x), f(proj), True, 128),)),
                 ("K1", lambda f: ztzv.ztzv_parts(
                      f(x), f(m), f(proj), 0.7, f(vc), f(vs), True))]
        for precision in ("high", "highest"):
            calls += [
                ("K3", lambda f, p=precision: conv.conv_parts(
                    f(xs), f(lens), f(pc), 0.7, 9, f(rs), None, p)),
                ("K4", lambda f, p=precision: (conv.conv_maxpool(
                    f(xs), f(lens), f(pc), 9, p),))]
        for name, call in calls:
            want = call(lambda a: a)
            got = call(lambda a: strided(torch, a))
            sync(torch, dev)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"{name} ({dtype}) on non-contiguous operands: bitwise "
                  f"equal to contiguous: {same}", flush=True)
            check(same, f"{name} ({dtype}) differs on non-contiguous "
                        "operands")
    mixed = t(rng.standard_normal((4, 84)), torch.float32)
    try:
        feature_map.rbf_feature_map(mixed, proj.double(), True, 128)
    except TypeError as err:
        print(f"mixed dtypes refused: {err}", flush=True)
    else:
        check(False, "K2 took float32 rows with a float64 projection")


def phase_g_kernels(torch, card, corpus, dev="cuda"):
    """G1: K1 (K 1 and 26), K2 (D 84 / F 4096, D 1024 / F 2048), K3
    (F 4096, 1024, 128) and K4 (F 1024) in float64 against their plain
    float64 versions, K3 and K4 at "highest" (the fp32 CUDA-core body)
    against the plain fp32 versions, each timed at the main path's
    shapes; the non-contiguous layouts.  Returns the timed cases."""
    t0 = time.perf_counter()
    timed = phase_kernels(torch, card, "exact", "highest", double=True)
    timed.update(phase_conv_kernels(torch, card, corpus, dev=dev,
                                    mode="exact", double=True))
    timed.update(phase_conv_kernels(torch, card, corpus, dev=dev,
                                    mode="exact", precision="highest"))
    check_layouts(torch, card, dev)
    print(f"G1 kernels: {time.perf_counter() - t0:.1f}s [{card}]",
          flush=True)
    return timed


def all_float64(counts, what):
    for name, counter in counts.items():
        for key in counter:
            check(key_precision(name, key) == "float64",
                  f"{name} ran at {key_precision(name, key)} during {what}, "
                  "not in float64")


def plain_gates(label, got, want, iters, rho, rho32, card):
    """The float64 run against its plain-version twin and the float32
    fit: predictions, CG iterations, held-out Spearman."""
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    print(f"{label}: predictions vs the plain versions' max_abs_err "
          f"{err:.3e} (tol {G_PLAIN_RTOL:g} x {top:.3e}); CG iterations "
          f"{iters[0]} vs {iters[1]} (gate +-1); held-out Spearman "
          f"{rho:.6f} vs float32 {rho32:.6f} (gate |d| < {G_RHO}) [{card}]",
          flush=True)
    check(err < G_PLAIN_RTOL * top,
          f"{label} disagrees with the plain versions")
    check(abs(iters[0] - iters[1]) <= 1,
          f"{label} took other CG iterations than the plain versions")
    check(abs(rho - rho32) < G_RHO,
          f"{label} Spearman moved from the float32 fit's")


def phase_g(torch, card, tab, raw, corpus, rho32, dev="cuda",
            nmll_rows=G_NMLL_ROWS, conv_rows=G_CONV_ROWS,
            k4_rows=G_K4_ROWS, n_test=N_TEST, num_rffs=NUM_RFFS,
            variance_rffs=VARIANCE_RFFS):
    """G2-G4 (see G_CONV_ROWS' comment).  ``tab`` is slice A's (dataset,
    test x, test y), ``raw`` its training (x, y), ``rho32`` the float32
    slice A fit's held-out Spearman; the corpus's held-out rows follow its
    first N_TRAIN.  Returns the paths' launches."""
    from scipy.stats import spearmanr
    from xgpr_tpu_torch import (FastConv1d, GPRegression,
                                build_regression_dataset, config)
    from xgpr_tpu_torch.constants import DEFAULT_NMLL_PARAMS
    from xgpr_tpu_torch.ops.cuda.conv import conv_maxpool_plain
    on_card = torch.device(dev).type == "cuda"
    paths = []
    t_phase = time.perf_counter()

    # --- G2: slice A in float64 -------------------------------------
    sizes = dict(num_rffs=num_rffs, variance_rffs=variance_rffs)
    counts, preds, rec = phase_slice(torch, card, tab, dev=dev, double=True,
                                     label="G2 slice A (float64)", **sizes)
    check(rec.pop("model").kernel.dtype == torch.float64,
          "G2's kernel is not float64")
    all_float64(counts, "G2")
    paths.append(("G2 slice A fit + predict (float64)", counts))
    with plain_kernels():
        pcounts, ppreds, prec = phase_slice(
            torch, card, tab, dev=dev, double=True, kernels=False,
            label="G2 slice A (float64, plain versions)", **sizes)
    check(sum(totals(pcounts).values()) == 0,
          "a kernel ran inside plain_kernels")
    plain_gates("G2 slice A (float64)", preds, ppreds,
                (rec["n_iter"], prec["n_iter"]), rec["rho"], rho32, card)

    nset = build_regression_dataset(raw[0][:nmll_rows], raw[1][:nmll_rows],
                                    chunk_size=CHUNK)
    rbf = GPRegression(num_rffs=num_rffs, kernel_choice="RBF", device=dev,
                       verbose=False, double_precision_fht=True)
    rbf.set_hyperparams(HPARAMS, nset)
    reset_counts()
    exact, exact_s, _ = nmll_call(torch, dev, rbf.exact_nmll, HPARAMS, nset)
    approx, approx_s, nmll_counts = nmll_call(
        torch, dev, rbf.approximate_nmll, HPARAMS, nset)
    counts = read_counts()
    del rbf, nset
    all_float64(counts, "G2's NMLL")
    paths.append(("G2 RBF NMLL (float64)", counts))
    k26 = k1_by_k(nmll_counts).get(DEFAULT_NMLL_PARAMS["nsamples"] + 1, 0)
    gap = rel_gap(approx, exact)
    print(f"G2 RBF NMLL in float64 at {num_rffs} RFFs on the first "
          f"{nmll_rows} rows: exact {exact:.8f} in {exact_s:.3f}s, "
          f"approximate {approx:.8f} in {approx_s:.3f}s, relative gap "
          f"{gap:.3e} (gate {NMLL_RTOL}); K1 launches at K=26 {k26} "
          f"[{card}]", flush=True)
    check(gap < NMLL_RTOL, "G2's approximate NMLL is not within 1% of exact")
    check(k26 > 0 or not on_card, "K1 was not launched at K=26 in float64")

    # --- G4 (its "balanced" run first: G3's float32 twin) -------------
    g_corpus = tuple(np.concatenate([a[:conv_rows], a[N_TRAIN:]])
                     for a in corpus)
    conv_kw = dict(n_train=conv_rows, n_test=n_test, dev=dev, floor=0.0,
                   **sizes)
    bal_counts, bal_iter, bal_preds, model, bal = phase_conv_slice(
        torch, card, g_corpus, label="G4 Conv1dRBF (balanced)", **conv_kw)
    del model, bal["dset"]
    paths.append(("G4 Conv1dRBF fit + predict (balanced)", bal_counts))
    try:
        config.set_speed_preset("reference")
        ref_counts, ref_iter, ref_preds, model, ref = phase_conv_slice(
            torch, card, g_corpus, label="G4 Conv1dRBF (reference)",
            **conv_kw)
    finally:
        config.set_speed_preset("balanced")
    del model, ref["dset"]
    preset_launches({k: ref_counts[k] for k in ("K3", "K4")}, "exact",
                    "highest", "G4 (reference)")
    check(ref_counts["K3"].total() > 0 or not on_card,
          'K3 was not launched under "reference"')
    paths.append(("G4 Conv1dRBF fit + predict (reference)", ref_counts))
    top = float(np.abs(bal_preds).max())
    err = float(np.abs(ref_preds - bal_preds).max())
    print(f"G4 Conv1dRBF on {conv_rows} rows under \"reference\": fit "
          f"{ref['fit_s']:.3f}s, CG iterations {ref_iter}, Spearman "
          f"{ref['rho']:.6f}; \"balanced\": fit {bal['fit_s']:.3f}s, CG "
          f"iterations {bal_iter}, Spearman {bal['rho']:.6f}; predictions "
          f"max_abs_err {err:.3e} (tol {MODE_RTOL:g} x {top:.3e}) [{card}]",
          flush=True)
    check(err < MODE_RTOL * top,
          'G4: "reference" is not within 1e-3 of "balanced"')

    # --- G3: Conv1dRBF in float64, then FastConv1d ---------------------
    counts, iters, preds, model, rec = phase_conv_slice(
        torch, card, g_corpus, double=True, label="G3 Conv1dRBF (float64)",
        **conv_kw)
    check(model.kernel.dtype == torch.float64, "G3's kernel is not float64")
    del model, rec["dset"]
    with plain_kernels():
        pcounts, piters, ppreds, model, prec = phase_conv_slice(
            torch, card, g_corpus, double=True, kernels=False,
            label="G3 Conv1dRBF (float64, plain versions)", **conv_kw)
    del model, prec["dset"]
    check(sum(totals(pcounts).values()) == 0,
          "a kernel ran inside plain_kernels")
    plain_gates("G3 Conv1dRBF (float64)", preds, ppreds, (iters, piters),
                rec["rho"], bal["rho"], card)

    x, _, lens = corpus
    tex, te_l = x[N_TRAIN:N_TRAIN + k4_rows], lens[N_TRAIN:N_TRAIN + k4_rows]
    reset_counts()
    with config.working_dtype(torch.float64):
        fv = FastConv1d(seq_width=MOTIF_D, device=dev, num_features=INIT_RFFS)
    fast = fv.predict(tex, te_l)
    sync(torch, dev)
    k4_counts = read_counts()
    kern = fv.conv_kernel
    ref_k4 = conv_maxpool_plain(
        torch.as_tensor(tex, dtype=torch.float64, device=dev),
        torch.as_tensor(te_l, dtype=torch.int32, device=dev),
        kern._dense_proj(), MOTIF_W).cpu().numpy()
    err = float(np.abs(fast - ref_k4).max())
    tol = F64_RTOL * max(1.0, float(np.abs(ref_k4).max()))
    print(f"G3 FastConv1d in float64 on {k4_rows} rows: vs the plain K4 "
          f"max_abs_err {err:.3e} (tol {tol:.3e}); launches "
          f"{counts_text(k4_counts)} [{card}]", flush=True)
    check(kern.dtype == torch.float64 and fast.dtype == np.float64,
          "FastConv1d did not run in float64")
    check(err < tol, "FastConv1d (float64) disagrees with the plain K4")
    check(k4_counts["K4"].total() > 0 or not on_card,
          "K4 was not launched by FastConv1d in float64")
    all_float64(k4_counts, "FastConv1d (float64)")
    paths += [("G3 Conv1dRBF fit + predict (float64)", counts),
              ("G3 FastConv1d (float64)", k4_counts)]
    print(f"phase G (G2-G4): {time.perf_counter() - t_phase:.1f}s [{card}]",
          flush=True)
    return paths


SRC, PALLAS = "xgpr_tpu_torch/ops/cuda/csrc/", "xgpr_tpu/ops/pallas/"
KERNELS = {
    "K1": ("ztzv_parts", PALLAS + "ztzv_pallas.py:240"),
    "K2": ("rbf_feature_map", PALLAS + "sorf_pallas.py:96"),
    "K3": ("conv_parts", PALLAS + "conv_pallas.py:302"),
    "K4": ("conv_maxpool", PALLAS + "conv_pallas.py:216"),
}
# The translation unit of each kernel's body, by the launch key's
# precision entry (the 3xTF32 body's file holds the C entry points).
SOURCES = {
    "K1": {"default": "ztzv_bf16.cu", "float64": "ztzv_f64.cu"},
    "K2": {"highest": "feature_map_fma.cu", "float64": "feature_map_f64.cu"},
    "K3": {"default": "conv_bf16.cu", "highest": "conv_fma.cu",
           "float64": "conv_f64.cu"},
    "K4": {"default": "conv_bf16.cu", "highest": "conv_fma.cu",
           "float64": "conv_f64.cu"},
}
ENTRY_SOURCES = {"K1": "ztzv.cu", "K2": "feature_map.cu", "K3": "conv.cu",
                 "K4": "conv.cu"}


def kernel_source(name, precision):
    return SRC + SOURCES[name].get(precision, ENTRY_SOURCES[name])


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
            fn, replaces = KERNELS[name]
            rows.append({
                "name": fn, "route": "cuda",
                "source": kernel_source(name, key_precision(name, key)),
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
    # ("max"), K1 and K2 at "highest" in "exact" ("reference").
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
    # Kept for the exports (phase_surface), without its engine's device copy
    # of the dataset.
    fitted = {"rbf": slice_rec.pop("model")}
    fitted["rbf"]._engines = {}
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
    fitted["conv"] = conv_model
    conv_model._engines = {}
    del conv_model
    k4_counts, k4_rec = phase_k4_path(torch, card, corpus)
    del k4_rec["model"], k4_rec["dset"]
    paths.append(("K4 path", k4_counts))
    paths += phase_presets(torch, card, tab, corpus,
                           {"slice A": slice_rec, "Conv1dRBF": conv_rec,
                            "K4 path": k4_rec}, timed=timed)
    paths.append(("tuning", phase_tuning(torch, card, tab, corpus,
                                         timed=timed)))
    paths.append(("streamed Conv1dRBF fit + predict",
                  phase_streamed(torch, card, corpus, (n_iter, preds))))
    paths.append(("referee", phase_referee(torch, card, corpus)))
    class_counts, fitted["classifier"], fitted["class_tex"] = \
        phase_rbf_classifier(torch, card)
    fitted["classifier"]._engines = {}
    paths.append(("RBF classifier fit + predict", class_counts))
    paths.append(("Conv1dRBF classifier fit + predict",
                  phase_conv_classifier(torch, card, corpus)))
    surface, without = phase_surface(torch, card, tab, trx, tr_y, corpus,
                                     fitted)
    paths += surface
    paths += phase_scale_out(torch, card, tab[2], corpus, fitted["cases"])
    del fitted
    timed.update(phase_g_kernels(torch, card, corpus))
    paths += phase_g(torch, card, tab, (trx, tr_y), corpus, slice_rec["rho"])
    del tab
    return finish(torch, card, t_start, paths, timed, without)


def finish(torch, card, t_start, paths, timed, without):
    """The summaries, the kernels line and the last line."""
    precision_summary(timed, "highest", card)
    precision_summary(timed, "float64", card)
    print(f"total {time.perf_counter() - t_start:.1f}s [{card}]", flush=True)
    kernels = [row for path, counts in paths
               for row in kernel_rows(path, counts, timed)]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels,
                      "paths_without_kernels": without}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
