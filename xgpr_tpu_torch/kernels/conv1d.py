"""Sequence / graph convolution SORF kernels (port of xgpr_tpu/kernels/conv1d.py).

- ConvKernelBaseclass: padded dims = next_pow2(conv_width * D), radem sized
  to ceil(F / padded) blocks, averaging in {none, sqrt, full} ->
  scaling_type 0/1/2, per-row sequence lengths mandatory.
- Conv1dRBF / Conv1dMatern / Conv1dCauchy: conv_width from
  kernel_settings; Matern and Cauchy apply the chi modifiers of their
  fixed-vector counterparts.
- GraphRBF / GraphMatern / GraphCauchy: conv_width fixed to 1.

The state is drawn on the host in float32 with numpy exactly as xgpr_tpu
draws it (utils/rng.py), so it is equal bit for bit.  With the dense
projection the masked window loop is the K3 kernel (ops/cuda/conv.py, via
ops/conv.py); row averaging and the intercept are applied on the (N, F)
parts, averaging in K3's epilogue.  The kernel guards its polynomial
sincos per element, so xgpr_tpu's Pallas shape gate, config switch and
lax.cond range guard are not needed.  Conv kernels have no fused matvec:
CG contracts the K3 parts with torch.matmul (fitting/engine.py), as
xgpr_tpu's ``matvec_parts`` does.  The gradient fn (features and
d features / d sigma, for the exact NMLL gradient) is plain torch
(ops/conv.py ``with_grad``), as in xgpr_tpu, where it is not a Pallas
kernel.
"""
from math import ceil

import numpy as np
import torch

from .kernel_baseclass import KernelBaseclass
from ..ops.conv import (conv_rbf_features, SCALING_NONE, SCALING_SQRT,
                        SCALING_FULL)
from ..ops.hadamard import next_pow2
from ..ops.sorf import dense_sorf_projection, dense_threshold_ok
from ..utils import rng as state_rng

_AVERAGING = {"none": SCALING_NONE, "sqrt": SCALING_SQRT,
              "full": SCALING_FULL}


class ConvKernelBaseclass(KernelBaseclass):
    """Shared setup for k-mer convolution SORF kernels."""

    def __init__(self, xdim, num_rffs, random_seed=123, device="cuda",
                 conv_width=9, kernel_spec_parms=None):
        super().__init__(xdim, num_rffs, sine_cosine_kernel=True,
                         kernel_spec_parms=kernel_spec_parms, device=device)
        if len(xdim) != 3:
            raise RuntimeError(
                f"Convolution kernels expect 3d (rows, seq, channels) "
                f"input; got a {len(xdim)}d shape.")
        parms = kernel_spec_parms or {}
        averaging = parms.get("averaging", "none")
        if averaging not in _AVERAGING:
            raise RuntimeError(
                "Unrecognized value for 'averaging', should be one of "
                "'none', 'sqrt', 'full'.")
        self.scaling_type = _AVERAGING[averaging]
        self.conv_width = int(conv_width)
        self.random_seed = random_seed

        padded = next_pow2(self.conv_width * xdim[2])
        nblocks = max(1, ceil(self.num_freqs / padded))
        self.padded_dims, self.nblocks = padded, nblocks
        self._feature_padded = padded
        self.radem_diag = torch.as_tensor(
            state_rng.radem_diagonals(random_seed, nblocks, padded,
                                      np.float32),
            dtype=self.dtype, device=self.device)
        self._set_chi(state_rng.chi_scaling(random_seed, padded,
                                            self.num_freqs, np.float32))
        self.use_dense_projection = dense_threshold_ok(
            self.conv_width * xdim[2], self.num_freqs)
        self.hyperparams = np.ones((2,))
        self.bounds = np.asarray([[1e-3, 5], [1e-6, 1e2]])

    def _set_chi(self, chi_np):
        self._chi_np = chi_np
        self.chi_arr = torch.as_tensor(chi_np, dtype=self.dtype,
                                       device=self.device)
        self._proj = None

    def _dense_proj(self):
        """The (w*D, F) window-major dense projection, chi folded in."""
        if self._proj is None:
            self._proj = dense_sorf_projection(
                self.radem_diag, self.chi_arr,
                self.conv_width * self._xdim[2]).contiguous()
        return self._proj

    def _require_lengths(self, input_x, sequence_length):
        if sequence_length is None:
            raise RuntimeError(
                "Convolution kernels cannot run without per-row sequence "
                "lengths.")
        if input_x.shape[2] != self._xdim[2]:
            raise RuntimeError("Unexpected input shape supplied.")
        # Reference contract: all lengths must be >= conv_width and <= the
        # sequence axis.
        slen = sequence_length.cpu().numpy() \
            if isinstance(sequence_length, torch.Tensor) \
            else np.asarray(sequence_length)
        if slen.size and (int(slen.min()) < self.conv_width or
                          int(slen.max()) > input_x.shape[1]):
            raise RuntimeError(
                "All sequence lengths must be >= conv_width and <= the "
                "size of the sequence axis.")

    def kernel_specific_transform(self, input_x, sequence_length=None):
        self._require_lengths(input_x, sequence_length)
        return self.pure_feature_fn()(self.feature_params(), input_x,
                                      sequence_length)

    def kernel_specific_gradient(self, input_x, sequence_length=None):
        self._require_lengths(input_x, sequence_length)
        return super().kernel_specific_gradient(input_x, sequence_length)

    def pure_gradient_fn(self):
        intercept = self.fit_intercept
        width = self.conv_width
        scaling = self.scaling_type

        def fn(params, x, seq_len=None):
            z, dz = conv_rbf_features(x, seq_len, params["radem"],
                                      params["chi"], params["sigma"], width,
                                      scaling, proj=params.get("proj"),
                                      with_grad=True)
            if intercept:
                z[:, 0] = 1.0
                dz[:, 0, :] = 0.0
            return z, dz
        return fn

    def feature_params(self):
        params = {"sigma": float(self.hyperparams[1]),
                  "radem": self.radem_diag, "chi": self.chi_arr}
        if self.use_dense_projection:
            params["proj"] = self._dense_proj()
        return params

    def pure_feature_parts_fn(self):
        """Layout-free (cos, sin) parts in frequency order; the intercept
        overwrite lands on the cos part's column 0 (frequency 0's cos
        column, ops/layout.py)."""
        intercept = self.fit_intercept
        width = self.conv_width
        scaling = self.scaling_type

        def fn(params, x, seq_len=None):
            c, s = conv_rbf_features(x, seq_len, params["radem"],
                                     params["chi"], params["sigma"], width,
                                     scaling, proj=params.get("proj"),
                                     parts=True)
            if intercept:
                c[:, 0] = 1.0
            return c, s
        return fn

    def pure_feature_fn(self):
        intercept = self.fit_intercept
        width = self.conv_width
        scaling = self.scaling_type

        def fn(params, x, seq_len=None):
            feats = conv_rbf_features(x, seq_len, params["radem"],
                                      params["chi"], params["sigma"], width,
                                      scaling, proj=params.get("proj"))
            if intercept:
                feats[:, 0] = 1.0
            return feats
        return fn


def _require_conv_width(parms):
    if "conv_width" not in parms:
        raise ValueError(
            "Sequence kernels need kernel_settings to supply 'conv_width' "
            "(the k-mer window length); none was given.")


def _matern_nu(name, parms):
    if "matern_nu" not in parms:
        raise ValueError(f"{name} requires 'matern_nu'.")
    nu = float(parms["matern_nu"])
    if not 0.5 <= nu <= 2.5:
        raise ValueError("matern_nu is only supported on [0.5, 2.5].")
    return nu


class Conv1dRBF(ConvKernelBaseclass):
    def __init__(self, xdim, num_rffs, random_seed=123, device="cuda",
                 kernel_spec_parms=None):
        parms = kernel_spec_parms or {}
        _require_conv_width(parms)
        super().__init__(xdim, num_rffs, random_seed, device,
                         parms["conv_width"], parms)


class Conv1dMatern(ConvKernelBaseclass):
    def __init__(self, xdim, num_rffs, random_seed=123, device="cuda",
                 kernel_spec_parms=None):
        parms = kernel_spec_parms or {}
        _require_conv_width(parms)
        super().__init__(xdim, num_rffs, random_seed, device,
                         parms["conv_width"], parms)
        self.matern_nu = _matern_nu("Conv1dMatern", parms)
        self._set_chi(self._chi_np / state_rng.matern_chi_modifier(
            random_seed, self.num_freqs, self.matern_nu, self._chi_np.dtype))


class Conv1dCauchy(ConvKernelBaseclass):
    def __init__(self, xdim, num_rffs, random_seed=123, device="cuda",
                 kernel_spec_parms=None):
        parms = kernel_spec_parms or {}
        _require_conv_width(parms)
        super().__init__(xdim, num_rffs, random_seed, device,
                         parms["conv_width"], parms)
        self._set_chi(self._chi_np * state_rng.cauchy_chi_modifier(
            random_seed, self.num_freqs, self._chi_np.dtype))


class GraphRBF(ConvKernelBaseclass):
    """Node-set kernel: conv_width fixed to 1."""

    def __init__(self, xdim, num_rffs, random_seed=123, device="cuda",
                 kernel_spec_parms=None):
        super().__init__(xdim, num_rffs, random_seed, device, 1,
                         kernel_spec_parms or {})
        self.bounds = np.asarray([[1e-3, 1e2], [1e-2, 1e2]])


class GraphMatern(ConvKernelBaseclass):
    def __init__(self, xdim, num_rffs, random_seed=123, device="cuda",
                 kernel_spec_parms=None):
        parms = kernel_spec_parms or {}
        super().__init__(xdim, num_rffs, random_seed, device, 1, parms)
        self.matern_nu = _matern_nu("GraphMatern", parms)
        self._set_chi(self._chi_np / state_rng.matern_chi_modifier(
            random_seed, self.num_freqs, self.matern_nu, self._chi_np.dtype))
        self.bounds = np.asarray([[1e-3, 1e2], [1e-2, 1e2]])


class GraphCauchy(ConvKernelBaseclass):
    def __init__(self, xdim, num_rffs, random_seed=123, device="cuda",
                 kernel_spec_parms=None):
        parms = kernel_spec_parms or {}
        super().__init__(xdim, num_rffs, random_seed, device, 1, parms)
        self._set_chi(self._chi_np * state_rng.cauchy_chi_modifier(
            random_seed, self.num_freqs, self._chi_np.dtype))
        self.bounds = np.asarray([[1e-3, 1e2], [1e-2, 1e2]])
