"""Fixed-vector kernels: the SORF kernels RBF, Matern and Cauchy, and
Linear (port of xgpr_tpu/kernels/basic.py).

The three share ``SORFKernelBaseclass`` and differ only in chi:
- SORF state: padded dim = next_pow2(D), ceil(F / padded) blocks, int8
  Rademacher diagonals and chi(df=padded) scaling, drawn on the host with
  numpy exactly as xgpr_tpu does (utils/rng.py: in float32, or in float64
  with ``double_precision``), so the state is equal bit for bit;
- Matern divides chi by sqrt(chi2(2nu)/2nu); Cauchy multiplies it by
  sqrt(Exp(1)).

With the dense projection (D * F <= 32M) the feature fn is the K2 kernel
(ops/cuda/feature_map.py) and the fused chunk matvec the K1 kernel
(ops/cuda/ztzv.py): kernels on a CUDA tensor, their plain versions on a
CPU tensor.  The kernels guard the polynomial sincos per element, so
xgpr_tpu's Pallas gate, host range check and lax.cond fallback are not
needed.  K1 runs the configured feature precision
(config.feature_matmul_precision, resolved by its wrapper at call time:
its 3xTF32 or bf16 body); K2 keeps full precision in every
preset.  Larger D * F take the structured FWHT path in plain torch.  The
gradient fn (features and d features / d sigma, for the exact NMLL
gradient) is plain torch on both paths.

Linear has identity features, with a column of ones in front when it
fits an intercept (its feature count is D + 1 or D, whatever num_rffs
the model asked for), one hyperparameter (lambda) and a gradient of
width 0.  No kernel runs for it on any device: there is no projection.
"""
from math import ceil

import numpy as np
import torch

from .kernel_baseclass import KernelBaseclass
from ..ops.cuda.feature_map import rbf_feature_map as fused_feature_map
from ..ops.cuda.ztzv import ztzv_parts
from ..ops.hadamard import next_pow2
from ..ops.sorf import (rbf_feature_map, rbf_feature_map_grad,
                        rbf_feature_map_dense_grad, dense_sorf_projection,
                        dense_threshold_ok)
from ..utils import rng as state_rng


class SORFKernelBaseclass(KernelBaseclass):
    """Shared machinery for fixed-vector sine-cosine SORF kernels."""

    def __init__(self, xdim, num_rffs, random_seed=123, device="cuda",
                 double_precision=False, kernel_spec_parms=None):
        super().__init__(xdim, num_rffs, sine_cosine_kernel=True,
                         kernel_spec_parms=kernel_spec_parms, device=device,
                         double_precision=double_precision)
        if len(xdim) != 2:
            raise ValueError(
                "This kernel operates on fixed-length vectors and needs "
                f"a 2d (rows, features) input; got a {len(xdim)}d shape.")
        self.random_seed = random_seed
        padded = next_pow2(xdim[-1])
        self.padded_dims = padded
        self.nblocks = max(1, ceil(self.num_freqs / padded))
        self._feature_padded = padded
        # Host state drawn as xgpr_tpu draws it: in float32 (its float64
        # working dtype casts these draws up) or, with double_precision,
        # in float64.
        sdtype = self.state_dtype()
        self.radem_diag = torch.as_tensor(
            state_rng.radem_diagonals(random_seed, self.nblocks, padded,
                                      sdtype),
            dtype=self.dtype, device=self.device)
        self._set_chi(state_rng.chi_scaling(random_seed, padded,
                                            self.num_freqs, sdtype))
        self.use_dense_projection = dense_threshold_ok(xdim[-1],
                                                       self.num_freqs)
        self.hyperparams = np.ones((2,))
        self.bounds = np.asarray([[1e-3, 1e1], [1e-6, 1e2]])

    def _set_chi(self, chi_np):
        self._chi_np = chi_np
        self.chi_arr = torch.as_tensor(chi_np, dtype=self.dtype,
                                       device=self.device)
        self._proj = None

    def _dense_proj(self):
        """The (D, F) dense projection with chi folded in, built once."""
        if self._proj is None:
            self._proj = dense_sorf_projection(self.radem_diag, self.chi_arr,
                                               self._xdim[-1]).contiguous()
        return self._proj

    def feature_params(self):
        params = {"sigma": float(self.hyperparams[1])}
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
                feats = fused_feature_map(x * params["sigma"],
                                          params["proj"], intercept, padded)
                if intercept:
                    feats[:, 0] = 1.0
                return feats
        else:
            def fn(params, x, seq_len=None):
                feats = rbf_feature_map(x * params["sigma"], params["radem"],
                                        params["chi"], intercept)
                if intercept:
                    feats[:, 0] = 1.0
                return feats
        return fn

    def pure_gradient_fn(self):
        intercept = self.fit_intercept
        padded = self.padded_dims
        if self.use_dense_projection:
            def grad_fn(params, x):
                return rbf_feature_map_dense_grad(
                    x, params["proj"], params["sigma"], intercept, padded)
        else:
            def grad_fn(params, x):
                return rbf_feature_map_grad(x, params["radem"],
                                            params["chi"], params["sigma"],
                                            intercept)

        def fn(params, x, seq_len=None):
            z, dz = grad_fn(params, x)
            if intercept:
                z[:, 0] = 1.0
                dz[:, 0, :] = 0.0
            return z, dz
        return fn

    def pure_feature_parts_fn(self):
        """(cos, sin) parts without the block layout: the feature map with
        one block as wide as F writes [cos | sin], and the parts are its
        two halves (views, no copy)."""
        if not self.use_dense_projection:
            return None
        intercept = self.fit_intercept
        num_freqs = self.num_freqs

        def fn(params, x, seq_len=None):
            z = fused_feature_map(x * params["sigma"], params["proj"],
                                  intercept, num_freqs)
            c, s = z[:, :num_freqs], z[:, num_freqs:]
            if intercept:
                c[:, 0] = 1.0
            return c, s
        return fn

    def pure_ztzv_parts_fn(self):
        """Fused whole-chunk matvec: the chunk's Z^T (Z v) in cos/sin
        halves without materialising Z (K1 on the card)."""
        if not self.use_dense_projection:
            return None
        intercept = self.fit_intercept

        def fn(params, x, seq_len, m, v_c, v_s):
            return ztzv_parts(x, m, params["proj"], params["sigma"], v_c,
                              v_s, intercept)
        return fn


class RBF(SORFKernelBaseclass):
    """Gaussian (RBF) kernel via SORF random Fourier features."""


class Matern(SORFKernelBaseclass):
    """Matern kernel (nu in [1/2, 5/2]) via Student-t spectral sampling."""

    def __init__(self, xdim, num_rffs, random_seed=123, device="cuda",
                 double_precision=False, kernel_spec_parms=None):
        super().__init__(xdim, num_rffs, random_seed, device,
                         double_precision, kernel_spec_parms)
        parms = kernel_spec_parms or {}
        if "matern_nu" not in parms:
            raise ValueError(
                "A Matern kernel requires matern_nu in kernel_settings.")
        self.matern_nu = float(parms["matern_nu"])
        if not 0.5 <= self.matern_nu <= 2.5:
            raise ValueError("matern_nu is only supported on [0.5, 2.5].")
        modifier = state_rng.matern_chi_modifier(
            random_seed, self.num_freqs, self.matern_nu, self._chi_np.dtype)
        self._set_chi(self._chi_np / modifier)


class Cauchy(SORFKernelBaseclass):
    """Cauchy kernel (rational-quadratic, small alpha limit)."""

    def __init__(self, xdim, num_rffs, random_seed=123, device="cuda",
                 double_precision=False, kernel_spec_parms=None):
        super().__init__(xdim, num_rffs, random_seed, device,
                         double_precision, kernel_spec_parms)
        modifier = state_rng.cauchy_chi_modifier(
            random_seed, self.num_freqs, self._chi_np.dtype)
        self._set_chi(self._chi_np * modifier)


class Linear(KernelBaseclass):
    """Linear kernel: identity features plus an optional intercept
    column."""

    def __init__(self, xdim, num_rffs, random_seed=123, device="cuda",
                 double_precision=False, kernel_spec_parms=None):
        parms = kernel_spec_parms or {}
        if len(xdim) != 2:
            raise ValueError("Linear kernels accept 2d (rows, features) "
                             "arrays only, not sequence or graph input.")
        fit_intercept = parms.get("intercept", True) is not False
        actual_rffs = xdim[1] + 1 if fit_intercept else xdim[1]
        super().__init__(xdim, actual_rffs, kernel_spec_parms=parms,
                         device=device, double_precision=double_precision)
        self.hyperparams = np.ones((1,))
        self.bounds = np.asarray([[1e-3, 1e1]])

    def kernel_specific_transform(self, input_x, sequence_length=None):
        # Column 0 is 0 here; transform_x sets it to 1 with an intercept.
        if self.fit_intercept:
            return torch.nn.functional.pad(input_x, (1, 0))
        return input_x

    def feature_params(self):
        return {}

    def pure_feature_fn(self):
        intercept = self.fit_intercept

        def fn(params, x, seq_len=None):
            if intercept:
                return torch.nn.functional.pad(x, (1, 0), value=1.0)
            return x
        return fn

    def pure_gradient_fn(self):
        feat = self.pure_feature_fn()

        def fn(params, x, seq_len=None):
            z = feat(params, x, seq_len)
            return z, z.new_zeros((z.shape[0], z.shape[1], 0))
        return fn
