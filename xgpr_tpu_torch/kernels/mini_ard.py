"""MiniARD kernel: one lengthscale per user-defined feature group (port of
xgpr_tpu/kernels/mini_ard.py).

- ``split_points`` in kernel_settings cut the D input columns into
  contiguous groups; hyperparams are (lambda, sigma_1 .. sigma_G), bounds
  [1e-3, 1e2] for lambda and [1e-6, 1e2] for each sigma.
- The features are the RBF features of the rows scaled column by column
  by their group's lengthscale, with RBF's radem/chi draws and RBF's dense
  projection (``dense_sorf_projection``), so a MiniARD whose lengthscales
  all equal an RBF's sigma gives that RBF's features bit for bit.  With
  the dense projection (D * F <= 32M) they are the K2 kernel
  (ops/cuda/feature_map.py) on a CUDA tensor, its plain version on a CPU
  tensor, called as RBF calls it with x * sigma; larger D * F take the
  structured FWHT path in plain torch.  K2 keeps full precision in every
  preset.
- The gradient fn (``ops/ard.py::mini_ard_grad``, features and their
  derivative by each group's lengthscale) is plain torch on every device,
  as in xgpr_tpu, where it is XLA.  There is no fused matvec: the engine
  contracts the materialised features.
"""
from math import ceil

import numpy as np
import torch

from .kernel_baseclass import KernelBaseclass
from ..config import feature_matmul_precision
from ..ops.ard import mini_ard_grad, precompute_sorf_weights
from ..ops.cuda.feature_map import rbf_feature_map as fused_feature_map
from ..ops.hadamard import next_pow2
from ..ops.sorf import rbf_feature_map, dense_threshold_ok
from ..utils import rng as state_rng


class MiniARD(KernelBaseclass):
    """Grouped-lengthscale RBF kernel."""

    def __init__(self, xdim, num_rffs, random_seed=123, device="cuda",
                 double_precision=False, kernel_spec_parms=None):
        super().__init__(xdim, num_rffs, sine_cosine_kernel=True,
                         kernel_spec_parms=kernel_spec_parms, device=device,
                         double_precision=double_precision)
        parms = kernel_spec_parms or {}
        if len(self._xdim) != 2:
            raise ValueError("MiniARD only accepts fixed-vector input.")
        if "split_points" not in parms or not isinstance(
                parms["split_points"], list):
            raise ValueError("MiniARD requires kernel_settings with a "
                             "'split_points' list.")
        self.split_pts = np.sort(np.asarray(
            [0] + list(parms["split_points"]) + [xdim[1]]))
        self._check_split_points(xdim)

        n_hparams = self.split_pts.shape[0]
        self.hyperparams = np.ones((n_hparams,))
        self.bounds = np.asarray(
            [[1e-3, 1e2]] + [[1e-6, 1e2]] * (n_hparams - 1))

        padded = next_pow2(xdim[-1])
        self.padded_dims = padded
        self.nblocks = max(1, ceil(self.num_freqs / padded))
        self._feature_padded = padded
        # Drawn as xgpr_tpu draws them (see kernels/basic.py).
        sdtype = self.state_dtype()
        self.radem_diag = torch.as_tensor(
            state_rng.radem_diagonals(random_seed, self.nblocks, padded,
                                      sdtype),
            dtype=self.dtype, device=self.device)
        self.chi_arr = torch.as_tensor(
            state_rng.chi_scaling(random_seed, padded, self.num_freqs,
                                  sdtype),
            dtype=self.dtype, device=self.device)

        self.full_ard_weights = np.zeros((xdim[-1],))
        self._group_slices = [
            (int(self.split_pts[i - 1]), int(self.split_pts[i]))
            for i in range(1, self.split_pts.shape[0])]
        self.precomputed_weights = None
        self.use_dense_projection = dense_threshold_ok(xdim[-1],
                                                       self.num_freqs)
        self.kernel_specific_set_hyperparams()

    def _check_split_points(self, xdim):
        if self.split_pts.shape[0] - 2 < 1:
            raise ValueError("MiniARD needs one or more split points to "
                             "define its feature groups.")
        if self.split_pts[0] < 0 or self.split_pts[-1] > xdim[1]:
            raise ValueError("Split points out of range.")
        if np.diff(self.split_pts).min() == 0:
            raise ValueError("Duplicate split points supplied.")

    def kernel_specific_set_hyperparams(self):
        for g, (s, e) in enumerate(self._group_slices):
            self.full_ard_weights[s:e] = self.hyperparams[g + 1]

    def _weights(self):
        """The dense (F, D) SORF weights with chi folded in, built once."""
        if self.precomputed_weights is None:
            self.precomputed_weights = precompute_sorf_weights(
                self.radem_diag, self.chi_arr, self._xdim[-1])
            self._proj = self.precomputed_weights.T.contiguous()
        return self.precomputed_weights

    def _dense_proj(self):
        """The (D, F) dense projection: RBF's ``_dense_proj`` bit for bit."""
        self._weights()
        return self._proj

    def feature_params(self):
        params = {"ard_weights": torch.as_tensor(
            self.full_ard_weights, dtype=self.dtype, device=self.device)}
        if self.use_dense_projection:
            params["proj"] = self._dense_proj()
        else:
            params["radem"] = self.radem_diag
            params["chi"] = self.chi_arr
        return params

    def kernel_specific_transform(self, input_x, sequence_length=None):
        return self.pure_feature_fn()(self.feature_params(), input_x)

    def pure_feature_fn(self):
        intercept = self.fit_intercept
        padded = self.padded_dims
        if self.use_dense_projection:
            def fn(params, x, seq_len=None):
                feats = fused_feature_map(
                    x * params["ard_weights"], params["proj"], intercept,
                    padded,
                    precision=feature_matmul_precision(x.device, x.dtype))
                if intercept:
                    feats[:, 0] = 1.0
                return feats
        else:
            def fn(params, x, seq_len=None):
                feats = rbf_feature_map(x * params["ard_weights"],
                                        params["radem"], params["chi"],
                                        intercept)
                if intercept:
                    feats[:, 0] = 1.0
                return feats
        return fn

    def gradient_params(self):
        params = self.feature_params()
        params["grad_weights"] = self._weights()
        params["sigmas"] = torch.as_tensor(self.hyperparams[1:],
                                           dtype=self.dtype,
                                           device=self.device)
        return params

    def pure_gradient_fn(self):
        intercept = self.fit_intercept
        starts = tuple(s for s, _ in self._group_slices)
        ends = tuple(e for _, e in self._group_slices)

        def fn(params, x, seq_len=None):
            z, dz = mini_ard_grad(x, params["grad_weights"], starts, ends,
                                  params["sigmas"], intercept)
            if intercept:
                z[:, 0] = 1.0
                dz[:, 0, :] = 0.0
            return z, dz
        return fn
