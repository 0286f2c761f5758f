"""Approximate GP regression (port of ``fit`` and ``predict`` of
xgpr_tpu/models/regression.py; tuning, NMLL and the exported predict fn
wait for later slices).

    model = GPRegression(num_rffs=8192, variance_rffs=512,
                         kernel_choice="RBF", device="cuda")
    model.set_hyperparams(log_hparams, dataset)
    model.fit(dataset, mode="cg")      # autoselected Nystrom rank + PCG
    mean, var = model.predict(x, get_var=True)

``fit`` keeps its per-phase wall times (synchronised on the card) in
``fit_phase_times``.
"""
import numpy as np
import torch

from .baseclass import ModelBaseclass
from .. import constants
from ..fitting.cg import cg_fit
from ..fitting.exact import calc_weights_exact, calc_variance_exact
from ..utils.diagnostics import PhaseTimes, phase_timer


class GPRegression(ModelBaseclass):
    """GP regression on random Fourier features."""

    def predict(self, input_x, sequence_lengths=None, get_var=False,
                chunk_size=2000):
        """Posterior mean (and optionally variance) for new datapoints, as
        numpy arrays.  Each chunk of rows, with its slice of the sequence
        lengths for 3d input, is featurised on the model's device (the K2
        kernel, or K3/K4 for the convolution kernels, on the card).

        xgpr_tpu pads the sequence axis to a bucket first
        (``_bucket_sequence_axis``) only so that XLA reuses one compiled
        program; PyTorch compiles nothing per shape, and padding windows
        changes no feature, so the port does not."""
        self.pre_prediction_checks(input_x, sequence_lengths, get_var)
        feature_fn = self.kernel.pure_feature_fn()
        params = self.kernel.feature_params()
        lam2 = self.kernel.get_lambda() ** 2
        if get_var:
            var_idx = torch.as_tensor(
                self.kernel.variance_column_indices(self.variance_rffs),
                device=self.kernel.device)
        means, variances = [], []
        for i in range(0, input_x.shape[0], chunk_size):
            slen = None if sequence_lengths is None else \
                self.kernel._cast_lengths(sequence_lengths[i:i + chunk_size])
            z = feature_fn(params, self.kernel._cast_input(
                input_x[i:i + chunk_size]), slen)
            means.append(z @ self.weights)
            if get_var:
                zv = z[:, var_idx]
                pv = (self.var @ zv.T).T
                variances.append(lam2 + lam2 * torch.sum(zv * pv, dim=1))
        preds = torch.cat(means).cpu().numpy().astype(np.float64)
        preds = preds * self.trainy_std + self.trainy_mean
        if not get_var:
            return preds
        var = torch.cat(variances).cpu().numpy().astype(np.float64)
        var[var < 0] = 0
        return preds, var * self.trainy_std ** 2

    def fit(self, dataset, preconditioner=None, tol=1e-6, max_iter=500,
            mode="cg", suppress_var=False, max_rank=3000, min_rank=512,
            autoselect_target_ratio=30., always_use_srht2=False,
            run_diagnostics=False):
        """Fit by preconditioned CG (autoselecting a Nystrom preconditioner
        unless one is passed) or by Cholesky ("exact"), then compute the
        exact variance unless suppressed."""
        self._run_pre_fitting_prep(dataset)
        self.weights, self.var = None, None
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
                self.var = calc_variance_exact(engine, self.variance_rffs)
        self.fit_phase_times = times
        if self.verbose:
            print("Fitting complete.")
            print(times.report())
        if run_diagnostics:
            return n_iter, losses
