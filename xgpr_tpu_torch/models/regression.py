"""Approximate GP regression (port of xgpr_tpu/models/regression.py):
fit, predict, exact and SLQ-approximated NMLL, the exact NMLL gradient,
and the crude and scipy.optimize tuners.

    model = GPRegression(num_rffs=8192, variance_rffs=512,
                         kernel_choice="RBF", device="cuda")
    model.tune_hyperparams_crude(dataset)  # or tune_hyperparams(...)
    model.fit(dataset, mode="cg")      # autoselected Nystrom rank + PCG
    mean, var = model.predict(x, get_var=True)

``fit`` keeps its per-phase wall times (synchronised on the card) in
``fit_phase_times``.  A Linear kernel's fit keeps a Nystrom
preconditioner of rank ``variance_rffs`` as its variance, and its predict
gives lambda^2 (1 + z P^-1 z^T) per row, as xgpr_tpu's does.
``export_predict_fn`` returns a plain function of tensors and its state
(see its docstring).

An NMLL evaluation at a degenerate hyperparameter point (a singular
design matrix or sketch, CG or SLQ breakdown) returns
``DEFAULT_SCORE_IF_PROBLEM`` so that one bad iterate cannot end a tune,
as in xgpr_tpu.  Only those numerical failures become the penalty score:
a kernel that does not build or launch, a CUDA error or a bad argument
raises, where xgpr_tpu's ``except Exception`` would absorb it.
"""
import warnings

import numpy as np
import torch
from scipy.optimize import minimize

from .baseclass import ModelBaseclass
from .. import constants
from ..fitting.cg import cg_fit
from ..fitting.exact import (calc_weights_exact, calc_variance_exact,
                             direct_weight_calc)
from ..preconditioners.nystrom import NystromPreconditioner
from ..scoring.alpha_beta import optimize_alpha_beta
from ..scoring.gradient import exact_nmll_reg_grad
from ..scoring.lb_optimizer import shared_hparam_search
from ..scoring.slq import slq_nmll_from_engine
from ..scoring.surrogate_tuner import surrogate_grid_tuning
from ..utils.diagnostics import PhaseTimes, phase_timer, span

# The failures of a degenerate hyperparameter point: the port's own
# non-positive-definite and SLQ breakdown checks, and the solvers' (torch
# and numpy) failures to converge.
NUMERICAL_FAILURES = (FloatingPointError, torch.linalg.LinAlgError,
                      np.linalg.LinAlgError)


def exact_nmll_from_design(z_trans_z, z_trans_y, y_trans_y, lambda_,
                           ndatapoints):
    """The exact NMLL from a design-matrix triple (``design_mat`` of an
    Engine or a GramEngine): the Cholesky factor of Z^T Z + lambda^2 I in
    float64 on the triple's device, then the closed form over the
    amplitude.  Raises a NUMERICAL_FAILURES error when the matrix is not
    positive definite; nan when the closed form fails."""
    chol, weights = direct_weight_calc(z_trans_z, z_trans_y, lambda_)
    nll1 = float(0.5 * (y_trans_y - z_trans_y @ weights))
    nll2 = float(torch.sum(torch.log(torch.diagonal(chol))))
    negloglik, _ = optimize_alpha_beta(lambda_, np.array([nll1, nll2]),
                                       ndatapoints, z_trans_z.shape[0])
    return negloglik


def _exact_variance(zv, var_mat, lam2):
    """lambda^2 (1 + z_v V z_v^T) for each row of the variance columns
    z_v, with V the fit's exact variance matrix."""
    pv = (var_mat @ zv.T).T
    return lam2 + lam2 * torch.sum(zv * pv, dim=1)


class GPRegression(ModelBaseclass):
    """GP regression on random Fourier features."""

    def predict(self, input_x, sequence_lengths=None, get_var=False,
                chunk_size=2000):
        """Posterior mean (and optionally variance) for new datapoints, as
        numpy arrays.  Each chunk of rows, with its slice of the sequence
        lengths for 3d input, is featurised on the model's device (the K2
        kernel, or K3/K4 for the convolution kernels, on the card).  The
        features' products with the weights and the variance matrix are
        float64: in float32 their rounding depends on the chunk's shape
        and moved the mean by up to 5e-6 of max|pred| (cancellation
        between large weights) between a 2000-row chunk and a 16,384-row
        call on an H100, so an exported fn (``export_predict_fn``) and
        predict could not agree.

        xgpr_tpu pads the sequence axis to a bucket first
        (``_bucket_sequence_axis``) only so that XLA reuses one compiled
        program; PyTorch compiles nothing per shape, and padding windows
        changes no feature, so the port does not.

        In a profiled run the call is the span ``xgpr/predict``, each
        chunk's variance ``xgpr/predict.var``, and its blocking copies
        ``xgpr/wait.lengths`` (a chunk's lengths to the device) and
        ``xgpr/wait.to_host``."""
        with span("xgpr/predict"):
            self.pre_prediction_checks(input_x, sequence_lengths, get_var)
            feature_fn = self.kernel.pure_feature_fn()
            params = self.kernel.feature_params()
            lam2 = self.kernel.get_lambda() ** 2
            weights = self.weights.double()
            if get_var and self.exact_var_calculation:
                var_idx = torch.as_tensor(
                    self.kernel.variance_column_indices(self.variance_rffs),
                    device=self.kernel.device)
                var_mat = self.var.double()
            means, variances = [], []
            for i in range(0, input_x.shape[0], chunk_size):
                slen = None
                if sequence_lengths is not None:
                    with span("xgpr/wait.lengths"):
                        slen = self.kernel._cast_lengths(
                            sequence_lengths[i:i + chunk_size])
                z = feature_fn(params, self.kernel._cast_input(
                    input_x[i:i + chunk_size]), slen).double()
                means.append(z @ weights)
                if not get_var:
                    continue
                with span("xgpr/predict.var"):
                    if self.exact_var_calculation:
                        variances.append(_exact_variance(
                            z[:, var_idx], var_mat, lam2))
                    else:
                        # The Nystrom variance (Linear): P^-1 z^T with the
                        # preconditioner's float64 factors.
                        pv = self.var.batch_matvec(z.T).T
                        variances.append(
                            lam2 + lam2 * torch.sum(z * pv, dim=1))
            with span("xgpr/wait.to_host"):
                preds = torch.cat(means).cpu().numpy()
            preds = preds * self.trainy_std + self.trainy_mean
            if not get_var:
                return preds
            with span("xgpr/wait.to_host"):
                var = torch.cat(variances).cpu().numpy()
            var[var < 0] = 0
            return preds, var * self.trainy_std ** 2

    def export_predict_fn(self, get_var=False):
        """(fn, state) for serving without the model object.

        ``fn(state, x, seq_len=None)`` maps a tensor x on the model's
        device (and int32 lengths for a convolution kernel) to the mean,
        or (mean, variance) with ``get_var``, y-denormalisation folded in.
        ``state`` is a dict of tensors (and the kernel's float
        hyperparameters) on the model's device: ``params`` from
        ``feature_params()``, the weights, y's mean and scale, and with
        ``get_var`` the variance matrix, its column indices and lambda^2,
        all float64, as predict forms its products.
        fn reads nothing else, so a state that went through numpy and back
        gives the same bits.  On the card fn reaches the K2, K3 or K4
        kernel through ``pure_feature_fn``; the kernels are custom
        operators with fake implementations and batching rules
        (ops/cuda/), so ``torch.compile(fn, fullgraph=True)`` and
        ``torch.func.vmap`` over a stacked batch of x take fn, as
        ``jax.jit`` and ``jax.vmap`` take xgpr_tpu's.  The Linear kernel's
        Nystrom variance is not exported, as in xgpr_tpu.
        """
        if self.kernel is None or self.weights is None:
            raise RuntimeError("No fitted weights present; call fit() first.")
        if get_var and (self.var is None or not self.exact_var_calculation):
            raise RuntimeError(
                "Variance export requires a fitted model with the exact "
                "variance calculation (not the Linear-kernel Nystrom "
                "path).")
        feature_fn = self.kernel.pure_feature_fn()
        dev = self.weights.device

        def scalar(value):
            return torch.tensor(value, dtype=torch.float64, device=dev)
        state = {"params": self.kernel.feature_params(),
                 "weights": self.weights.double(),
                 "y_mean": scalar(self.trainy_mean),
                 "y_std": scalar(self.trainy_std)}
        if get_var:
            state["var_mat"] = self.var.double()
            state["var_idx"] = torch.as_tensor(
                self.kernel.variance_column_indices(self.variance_rffs),
                device=dev)
            state["lam2"] = scalar(self.kernel.get_lambda() ** 2)

        def fn(state, x, seq_len=None):
            z = feature_fn(state["params"], x, seq_len).double()
            mean = (z @ state["weights"]) * state["y_std"] + state["y_mean"]
            if not get_var:
                return mean
            pred_var = _exact_variance(z[:, state["var_idx"]],
                                       state["var_mat"], state["lam2"])
            return mean, torch.clamp(pred_var, min=0.0) * state["y_std"] ** 2
        return fn, state

    # ------------------------------------------------------------------
    def exact_nmll(self, hyperparams, dataset):
        """Exact NMLL via the design matrix's Cholesky factor (float64 on
        the model's device)."""
        self._run_singlepoint_nmll_prep(dataset, exact_method=True)
        self.kernel.set_hyperparams(hyperparams, logspace=True)
        engine = self._engine(dataset)
        design = engine.design_mat()
        try:
            # The engine's count: a sharded engine's covers every rank.
            negloglik = exact_nmll_from_design(
                *design, self.kernel.get_lambda(), engine.ndatapoints)
        except NUMERICAL_FAILURES:
            negloglik = np.nan
        if np.isnan(negloglik):
            warnings.warn("Design matrix is numerically singular at "
                          f"{hyperparams}; returning the penalty score.")
            return constants.DEFAULT_SCORE_IF_PROBLEM
        if self.verbose:
            print("Evaluated NMLL.")
        return negloglik

    def exact_nmll_gradient(self, hyperparams, dataset, subsample=1.0):
        """(NMLL, its gradient in log space)."""
        self._run_singlepoint_nmll_prep(dataset, exact_method=True)
        init_hparams = self.kernel.get_hyperparams()
        self.kernel.set_hyperparams(hyperparams, logspace=True)
        hparams = self.kernel.get_hyperparams(logspace=False)
        if self.verbose:
            print("Evaluating gradient...")

        engine = self._engine(dataset)
        ztz, zty, yty, dz_ty, inner, nsamples = \
            engine.gradient_terms(subsample=subsample)
        try:
            negloglik, grad, _ = exact_nmll_reg_grad(
                ztz, zty, yty, hparams, nsamples, dz_ty, inner)
        except NUMERICAL_FAILURES:
            return (constants.DEFAULT_SCORE_IF_PROBLEM,
                    hyperparams - init_hparams)
        if np.isnan(negloglik):
            return (constants.DEFAULT_SCORE_IF_PROBLEM,
                    hyperparams - init_hparams)
        return float(negloglik), grad

    def approximate_nmll(self, hyperparams, dataset, manual_settings=None):
        """SLQ-approximated NMLL: a Nystrom preconditioner (the amortized
        autoselect unless ``manual_settings`` pins it), then one batched
        PCG over the fit column and the probes."""
        self._run_singlepoint_nmll_prep(dataset, exact_method=False)
        self.kernel.set_hyperparams(hyperparams, logspace=True)
        if self.verbose:
            print("Now building preconditioner...")
        try:
            negloglik = self._approximate_nmll_inner(dataset,
                                                     manual_settings)
        except NUMERICAL_FAILURES:
            warnings.warn("Numerical failure encountered when calculating "
                          f"approximate NMLL for {hyperparams}.")
            self._nmll_rank_cache = None
            return constants.DEFAULT_SCORE_IF_PROBLEM
        if not np.isfinite(negloglik):
            warnings.warn("Non-finite approximate NMLL encountered for "
                          f"{hyperparams}.")
            return constants.DEFAULT_SCORE_IF_PROBLEM
        if self.verbose:
            print("NMLL evaluation completed.")
        return negloglik

    def _approximate_nmll_inner(self, dataset, manual_settings=None):
        settings = dict(constants.DEFAULT_NMLL_PARAMS)
        engine = self._engine(dataset)
        if manual_settings is not None:
            for key in settings:
                if key in manual_settings:
                    settings[key] = manual_settings[key]
            if settings["max_rank"] >= self.num_rffs:
                settings["max_rank"] = self.num_rffs - 1
            preconditioner = NystromPreconditioner(
                engine, settings["max_rank"], False, self.random_seed,
                settings["preconditioner_mode"])
        else:
            preconditioner = self._amortized_nmll_preconditioner(dataset)
            engine = self._engine(dataset)

        if self.verbose:
            print("Now fitting...")
        return slq_nmll_from_engine(
            engine, preconditioner, self.random_seed,
            settings["nsamples"], settings["nmll_iter"],
            settings["nmll_tol"])

    # ------------------------------------------------------------------
    def fit(self, dataset, preconditioner=None, tol=1e-6, max_iter=500,
            mode="cg", suppress_var=False, max_rank=3000, min_rank=512,
            autoselect_target_ratio=30., always_use_srht2=False,
            run_diagnostics=False):
        """Fit by preconditioned CG (autoselecting a Nystrom preconditioner
        unless one is passed) or by Cholesky ("exact"), then compute the
        exact variance unless suppressed."""
        self._run_pre_fitting_prep(dataset)
        self.weights, self.var = None, None
        self.exact_var_calculation = True
        dev = self.kernel.device
        times = PhaseTimes()
        with phase_timer(times, "engine_build", dev):
            engine = self._engine(dataset)
        if mode == "exact":
            if self.kernel.get_num_rffs() > constants.MAX_CLOSED_FORM_RFFS:
                raise RuntimeError(
                    "Closed-form ('exact') fitting is capped at "
                    f"{constants.MAX_CLOSED_FORM_RFFS} rffs; this kernel "
                    f"produces {self.kernel.get_num_rffs()}. Use mode='cg' "
                    "or lower num_rffs.")
            with phase_timer(times, "exact_solve", dev):
                self.weights, n_iter, losses = calc_weights_exact(engine)
        elif mode == "cg":
            if preconditioner is None:
                with phase_timer(times, "preconditioner", dev):
                    preconditioner = self._autoselect_preconditioner(
                        dataset, min_rank=min_rank, max_rank=max_rank,
                        ratio_target=autoselect_target_ratio,
                        always_use_srht2=always_use_srht2)
            with phase_timer(times, "cg", dev):
                self.weights, n_iter, losses = cg_fit(
                    engine, preconditioner, tol, max_iter, self.verbose)
        else:
            raise RuntimeError(
                f"Unknown fit mode {mode!r}; valid choices are 'cg' "
                "and 'exact'.")
        if not suppress_var:
            with phase_timer(times, "variance", dev):
                if self.kernel_choice == "Linear":
                    self.var = NystromPreconditioner(
                        engine, self.variance_rffs, False, self.random_seed,
                        "srht")
                    self.exact_var_calculation = False
                else:
                    self.var = calc_variance_exact(engine,
                                                   self.variance_rffs)
        self.fit_phase_times = times
        if self.verbose:
            print("Fitting complete.")
            print(times.report())
        if run_diagnostics:
            return n_iter, losses

    # ------------------------------------------------------------------
    def tune_hyperparams_crude(self, dataset, bounds=None, random_seed=123,
                               max_bayes_iter=30, subsample=1.0):
        """Crude tuner: the exact NMLL with lambda in closed form on a
        grid, over a surrogate-guided search of the kernel's other
        hyperparameters.  Returns (hyperparams, n_feval, best_score)."""
        if subsample < 0.01 or subsample > 1:
            raise RuntimeError("subsample is a row fraction and must lie "
                               "in [0.01, 1].")
        optim_bounds = self._run_pre_nmll_prep(dataset, bounds)
        num_hparams = self.kernel.get_hyperparams().shape[0]
        engine_factory = lambda: self._engine(dataset)

        if num_hparams == 1:
            best_score, hyperparams = shared_hparam_search(
                np.array([]), self.kernel, engine_factory, optim_bounds,
                subsample=subsample)
            n_feval = 1
        elif 1 < num_hparams < 4:
            hyperparams, _, best_score, n_feval = surrogate_grid_tuning(
                self.kernel, engine_factory, optim_bounds, random_seed,
                max_bayes_iter, self.verbose, subsample=subsample)
        else:
            raise RuntimeError(
                "Crude tuning covers kernels carrying one to three "
                f"hyperparameters; this kernel has {num_hparams}.")

        self.kernel.set_hyperparams(hyperparams, logspace=True)
        return hyperparams, n_feval, best_score

    # scipy.optimize option recipes per supported tuning method; the
    # gradient flag marks methods whose cost function returns (f, grad).
    _TUNER_RECIPES = {
        "Powell": (lambda max_iter, tol:
                   {"maxfev": max_iter, "xtol": 1e-1, "ftol": tol}, False),
        "Nelder-Mead": (lambda max_iter, tol:
                        {"maxfev": max_iter, "fatol": tol}, False),
        "L-BFGS-B": (lambda max_iter, tol:
                     {"maxiter": max_iter, "ftol": tol}, True),
    }

    def _tuning_start_point(self, starting_hyperparams, optim_bounds):
        """Resolve/validate the optimizer's x0 inside the search box."""
        current = self.kernel.get_hyperparams()
        if starting_hyperparams is not None:
            x0 = np.asarray(starting_hyperparams, dtype=np.float64)
            if x0.ndim != 1 or x0.shape[0] != current.shape[0]:
                raise RuntimeError(
                    "starting_hyperparams must be a 1d array with one "
                    "entry per kernel hyperparameter "
                    f"({current.shape[0]} here).")
            return x0
        inside = np.all(current >= optim_bounds[:, 0]) and \
            np.all(current <= optim_bounds[:, 1])
        if inside:
            return current
        warnings.warn(
            "Current kernel hyperparameters sit outside the search box; "
            "restarting the optimizer from the box's midpoint instead.",
            UserWarning)
        return optim_bounds.mean(axis=1)

    def tune_hyperparams(self, dataset, bounds=None, max_iter=50,
                         tuning_method="Powell", starting_hyperparams=None,
                         tol=1e-2, n_restarts=1, nmll_method="exact",
                         manual_settings=None):
        """Tune hyperparameters by handing an NMLL cost function to
        scipy.optimize.minimize, with optional random restarts: Powell or
        Nelder-Mead on either NMLL, L-BFGS-B on the exact NMLL with its
        analytic gradient.  Returns (hyperparams, n_feval, best_score)."""
        if tuning_method not in self._TUNER_RECIPES:
            raise RuntimeError(
                f"Unknown tuning_method {tuning_method!r}; choose one of "
                f"{sorted(self._TUNER_RECIPES)}.")
        make_options, uses_gradient = self._TUNER_RECIPES[tuning_method]

        if nmll_method == "exact":
            cost_fun = self.exact_nmll_gradient if uses_gradient \
                else self.exact_nmll
            args = (dataset,)
        elif nmll_method == "approximate":
            if uses_gradient:
                raise RuntimeError(
                    "The SLQ-approximated NMLL has no gradient, so it "
                    "cannot drive L-BFGS-B; pick Powell or Nelder-Mead, "
                    "or use nmll_method='exact'.")
            cost_fun = self.approximate_nmll
            args = (dataset, manual_settings)
        else:
            raise RuntimeError(
                f"Unknown nmll_method {nmll_method!r}; choose 'exact' or "
                "'approximate'.")

        optim_bounds = self._run_pre_nmll_prep(dataset, bounds)
        x0 = self._tuning_start_point(starting_hyperparams, optim_bounds)
        restart_rng = np.random.default_rng(self.random_seed)

        best_score, hyperparams, n_feval = np.inf, None, 0
        for _ in range(n_restarts):
            res = minimize(cost_fun, x0=x0, args=args,
                           method=tuning_method,
                           options=make_options(max_iter, tol),
                           bounds=[tuple(row) for row in optim_bounds],
                           jac=True if uses_gradient else None)
            n_feval += res.nfev
            if res.fun < best_score:
                best_score, hyperparams = res.fun, res.x
            if self.verbose:
                print(f"Restart done; best NMLL so far {best_score}.")
            x0 = restart_rng.uniform(optim_bounds[:, 0],
                                     optim_bounds[:, 1])

        self.kernel.set_hyperparams(hyperparams, logspace=True)
        return hyperparams, n_feval, best_score
