"""Approximate kernelized classification (port of
xgpr_tpu/models/classification.py): a multinomial-logistic model on random
features, fit by preconditioned nonlinear CG (fitting/softmax_solver.py)
and predicted by softmax.

    model = GPClassification(num_rffs=8192, kernel_choice="RBF",
                             device="cuda")
    model.set_hyperparams(np.log([lambda_, sigma]), dataset)
    model.fit(dataset)             # autoselected Nystrom rank + NCG
    probs = model.predict(x)       # (N, n_classes), rows sum to 1

The weights are (num_rffs, n_classes) float64 on the model's device and
``gamma`` is zeros (n_classes,), xgpr_tpu's layout, so a checkpoint
crosses between the packages (models/serialization.py).  Each chunk of
rows is featurised on the model's device (K2, or K3 for the convolution
kernels, on the card).  ``export_predict_fn`` returns the same
prediction as a plain function of tensors and its state, which
``torch.compile(fullgraph=True)`` and ``torch.func.vmap`` take.
"""
import numpy as np
import torch

from .baseclass import ModelBaseclass
from ..fitting.softmax_solver import fit_softmax_ncg


class GPClassification(ModelBaseclass):
    """Approximate kernelized multinomial-logistic classification."""

    def __init__(self, num_rffs=256, kernel_choice="RBF", device="cuda",
                 kernel_settings=None, verbose=True, random_seed=123):
        super().__init__(num_rffs, 0, kernel_choice, device=device,
                         kernel_settings=kernel_settings, verbose=verbose,
                         random_seed=random_seed)
        self.is_regression = False

    @staticmethod
    def _softmax(z, weights, gamma):
        """Class probabilities of a chunk's features: the logits and a
        stable softmax in float64.  In float32 the logits' rounding
        depends on the chunk's shape and moved probabilities by up to
        2e-5 on an H100 (see GPRegression.predict)."""
        pred = z.double() @ weights + gamma[None, :]
        pred = pred - torch.max(pred, dim=1, keepdim=True).values
        pred = torch.exp(pred)
        return pred / torch.sum(pred, dim=1, keepdim=True)

    def _predict_state(self):
        if self.kernel is None or self.weights is None or \
                self.gamma is None:
            raise RuntimeError("Call fit() before predicting.")
        return {"params": self.kernel.feature_params(),
                "weights": self.weights.double(),
                "gamma": torch.as_tensor(np.asarray(self.gamma),
                                         dtype=torch.float64,
                                         device=self.kernel.device)}

    def predict(self, input_x, sequence_lengths=None, chunk_size=2000):
        """Class probabilities (N, n_classes) as a float64 numpy array: per
        chunk the features (in the working dtype), the logits and a stable
        softmax in float64."""
        self.pre_prediction_checks(input_x, sequence_lengths, False)
        state = self._predict_state()
        feature_fn = self.kernel.pure_feature_fn()
        probs = []
        for i in range(0, input_x.shape[0], chunk_size):
            slen = None if sequence_lengths is None else \
                self.kernel._cast_lengths(sequence_lengths[i:i + chunk_size])
            z = feature_fn(state["params"], self.kernel._cast_input(
                input_x[i:i + chunk_size]), slen)
            probs.append(self._softmax(z, state["weights"], state["gamma"]))
        return torch.cat(probs).cpu().numpy()

    def export_predict_fn(self):
        """(fn, state): ``fn(state, x, seq_len=None)`` gives ``predict``'s
        probabilities for a tensor x on the model's device as a float64
        tensor; ``state`` holds ``params`` from ``feature_params()``, the
        weights and gamma.  See GPRegression.export_predict_fn."""
        state = self._predict_state()
        feature_fn = self.kernel.pure_feature_fn()
        softmax = self._softmax

        def fn(state, x, seq_len=None):
            z = feature_fn(state["params"], x, seq_len)
            return softmax(z, state["weights"], state["gamma"])
        return fn, state

    def fit(self, dataset, preconditioner=None, tol=1e-3, max_iter=500,
            max_rank=3000, min_rank=512, autoselect_target_ratio=30.,
            always_use_srht2=False, run_diagnostics=False):
        """Fit by preconditioned nonlinear CG, autoselecting a Nystrom
        preconditioner unless one is passed.  With ``run_diagnostics``
        returns (iterations, objective history)."""
        self._run_pre_fitting_prep(dataset)
        self.weights = None
        # The engine's count: a sharded engine's covers every rank's labels.
        self.n_classes = int(self._engine(dataset).n_classes)
        if self.verbose:
            print("starting fitting")
        if preconditioner is None:
            preconditioner = self._autoselect_preconditioner(
                dataset, min_rank=min_rank, max_rank=max_rank,
                ratio_target=autoselect_target_ratio,
                always_use_srht2=always_use_srht2)
        engine = self._engine(dataset)
        self.weights, n_iter, losses = fit_softmax_ncg(
            engine, self.n_classes, preconditioner, max_iter, tol,
            self.verbose)
        self.gamma = np.zeros((self.n_classes,))
        if self.verbose:
            print(f"CG iterations: {n_iter}")
            print("Fitting complete.")
        if run_diagnostics:
            return n_iter, losses
