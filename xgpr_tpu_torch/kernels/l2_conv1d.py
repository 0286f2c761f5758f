"""Two-layer convolution kernel and the maxpool feature extractor (port of
xgpr_tpu/kernels/l2_conv1d.py).

- Conv1dTwoLayer: layer 1 is a hyperparameter-free ReLU + global-maxpool
  conv SORF map with init_rffs outputs (the K4 kernel with the dense
  projection, at the configured feature precision); layer 2 is a plain
  RBF SORF map on that profile, sigma applied between the layers (the K2
  feature-map kernel with the dense projection).  Layer 2's state comes
  from a second seed drawn from the first, as in xgpr_tpu.
- FHTMaxpoolConv1dFeatureExtractor: the same layer-1 operation on its own,
  for the FastConv1d static layer (models/static_layers.py).

Conv1dTwoLayer has no parts fn, so CG contracts its full features.  Its
gradient fn runs layer 1 as above (K4 on the card) and layer 2's features
and d features / d sigma through the structured SORF map in plain torch,
as xgpr_tpu does.  Both take ``double_precision`` as xgpr_tpu does: the
state drawn in float64 and held in float64 on any device.

In a profiled run each call of either fn opens the span
``xgpr/twolayer.l1`` around layer 1 (the tile layout and K4) and then
``xgpr/twolayer.l2`` around layer 2 (sigma's scale and K2, or the
gradient fn's plain SORF map).
"""
from math import ceil

import numpy as np
import torch

from .. import config
from .kernel_baseclass import KernelBaseclass
from ..ops.conv import conv_maxpool_features
from ..ops.cuda.feature_map import rbf_feature_map as fused_feature_map
from ..ops.hadamard import next_pow2
from ..ops.sorf import (dense_sorf_projection, dense_threshold_ok,
                        rbf_feature_map, rbf_feature_map_grad)
from ..utils import rng as state_rng
from ..utils.diagnostics import span


def _maxpool_state(seed, width, dim, num_features, dtype, device, sdtype):
    """(radem, chi) of a maxpool conv layer, drawn in ``sdtype``."""
    padded = next_pow2(width * dim)
    nblocks = max(1, ceil(num_features / padded))
    radem = state_rng.radem_diagonals(seed, nblocks, padded, sdtype)
    chi = state_rng.chi_scaling(seed, padded, num_features, sdtype)
    return (torch.as_tensor(radem, dtype=dtype, device=device),
            torch.as_tensor(chi, dtype=dtype, device=device))


class Conv1dTwoLayer(KernelBaseclass):
    """ReLU-maxpool conv features fed into an RBF SORF map."""

    def __init__(self, xdim, num_rffs, random_seed=123, device="cuda",
                 double_precision=False, kernel_spec_parms=None):
        parms = kernel_spec_parms or {}
        if "conv_width" not in parms:
            raise ValueError("conv_width must be included as a "
                             "kernel-specific parameter.")
        if "init_rffs" not in parms:
            raise ValueError("init_rffs must be included for the two layer "
                             "conv1d kernel.")
        if len(xdim) != 3:
            raise RuntimeError("Conv1dTwoLayer requires 3d input.")
        self.init_rffs = int(parms["init_rffs"])
        if self.init_rffs % 2 != 0:
            raise RuntimeError("init_rffs should be an even number.")
        super().__init__(xdim, num_rffs, sine_cosine_kernel=True,
                         kernel_spec_parms=parms, device=device,
                         double_precision=double_precision)
        sdtype = self.state_dtype()
        self.hyperparams = np.ones((2,))
        self.bounds = np.asarray([[1e-3, 5], [1e-6, 1e2]])
        self.conv_width = int(parms["conv_width"])

        seed2 = int(np.random.default_rng(random_seed).integers(0, 2**31 - 1))
        # Layer 1: maxpool conv projection with init_rffs outputs.
        self.radem_diag1, self.chi_arr1 = _maxpool_state(
            random_seed, self.conv_width, xdim[2], self.init_rffs,
            self.dtype, self.device, sdtype)
        # Layer 2: RBF on the init_rffs-dim profile.
        padded2 = next_pow2(self.init_rffs)
        self._feature_padded = padded2
        nblocks2 = max(1, ceil(self.num_freqs / padded2))
        self.radem_diag2 = torch.as_tensor(
            state_rng.radem_diagonals(seed2, nblocks2, padded2, sdtype),
            dtype=self.dtype, device=self.device)
        self.chi_arr2 = torch.as_tensor(
            state_rng.chi_scaling(seed2, padded2, self.num_freqs, sdtype),
            dtype=self.dtype, device=self.device)
        self.use_dense_projection = (
            dense_threshold_ok(self.conv_width * xdim[2], self.init_rffs)
            and dense_threshold_ok(self.init_rffs, self.num_freqs))
        self._projs = None

    def _dense_projs(self):
        """(layer-1 proj, layer-2 proj) dense matrices, built once."""
        if self._projs is None:
            self._projs = (
                dense_sorf_projection(self.radem_diag1, self.chi_arr1,
                                      self.conv_width * self._xdim[2]
                                      ).contiguous(),
                dense_sorf_projection(self.radem_diag2, self.chi_arr2,
                                      self.init_rffs).contiguous())
        return self._projs

    def _check_input(self, input_x, sequence_length):
        if sequence_length is None:
            raise ValueError("Convolution kernels cannot run without "
                             "per-row sequence lengths.")
        if input_x.shape[2] != self._xdim[2]:
            raise RuntimeError("Unexpected input shape supplied.")

    def kernel_specific_transform(self, input_x, sequence_length=None):
        self._check_input(input_x, sequence_length)
        return self.pure_feature_fn()(self.feature_params(), input_x,
                                      sequence_length)

    def kernel_specific_gradient(self, input_x, sequence_length=None):
        self._check_input(input_x, sequence_length)
        return super().kernel_specific_gradient(input_x, sequence_length)

    def pure_gradient_fn(self):
        intercept = self.fit_intercept
        width = self.conv_width

        def fn(params, x, seq_len=None):
            with span("xgpr/twolayer.l1"):
                prof = conv_maxpool_features(x, seq_len, params["radem1"],
                                             params["chi1"], width,
                                             proj=params.get("proj1"))
            with span("xgpr/twolayer.l2"):
                z, dz = rbf_feature_map_grad(prof, params["radem2"],
                                             params["chi2"], params["sigma"],
                                             intercept)
            if intercept:
                z[:, 0] = 1.0
                dz[:, 0, :] = 0.0
            return z, dz
        return fn

    def feature_params(self):
        params = {"sigma": float(self.hyperparams[1]),
                  "radem1": self.radem_diag1, "chi1": self.chi_arr1,
                  "radem2": self.radem_diag2, "chi2": self.chi_arr2}
        if self.use_dense_projection:
            params["proj1"], params["proj2"] = self._dense_projs()
        return params

    def pure_feature_fn(self):
        intercept = self.fit_intercept
        width = self.conv_width
        padded2 = self._feature_padded
        use_dense = self.use_dense_projection

        def fn(params, x, seq_len=None):
            with span("xgpr/twolayer.l1"):
                prof = conv_maxpool_features(x, seq_len, params["radem1"],
                                             params["chi1"], width,
                                             proj=params.get("proj1"))
            with span("xgpr/twolayer.l2"):
                if use_dense:
                    feats = fused_feature_map(
                        prof * params["sigma"], params["proj2"], intercept,
                        padded2, precision=config.feature_matmul_precision(
                            prof.device, prof.dtype))
                else:
                    feats = rbf_feature_map(prof * params["sigma"],
                                            params["radem2"], params["chi2"],
                                            intercept)
            if intercept:
                feats[:, 0] = 1.0
            return feats
        return fn


class FHTMaxpoolConv1dFeatureExtractor:
    """Hyperparameter-free maxpool conv extractor used by FastConv1d."""

    def __init__(self, seq_width, num_features, conv_width=9,
                 random_seed=123, device="cuda", double_precision=False):
        self.num_features = int(num_features)
        self.conv_width = int(conv_width)
        self.seq_width = int(seq_width)
        self.device = config.resolve_device(device)
        self.dtype = torch.float64 if double_precision \
            else config.fp_dtype(self.device)
        self.radem_diag, self.chi_arr = _maxpool_state(
            random_seed, self.conv_width, self.seq_width, self.num_features,
            self.dtype, self.device,
            np.float64 if double_precision else np.float32)
        self.use_dense_projection = dense_threshold_ok(
            self.conv_width * seq_width, self.num_features)
        self._proj = None

    def _dense_proj(self):
        if self._proj is None:
            self._proj = dense_sorf_projection(
                self.radem_diag, self.chi_arr,
                self.conv_width * self.seq_width).contiguous()
        return self._proj

    def transform_x(self, input_x, sequence_length):
        """(N, num_features) maxpool features of (N, L, seq_width) rows, as
        a tensor on the extractor's device."""
        x = torch.as_tensor(input_x, dtype=self.dtype, device=self.device)
        slen = torch.as_tensor(np.asarray(sequence_length),
                               dtype=torch.int32, device=self.device)
        proj = self._dense_proj() if self.use_dense_projection else None
        return conv_maxpool_features(x, slen, self.radem_diag, self.chi_arr,
                                     self.conv_width, proj=proj)
