"""Kernel baseclass (port of xgpr_tpu/kernels/kernel_baseclass.py).

- hyperparams stored linear, get/set in log-space;
- hyperparams[0] is the shared noise 'lambda';
- sine-cosine kernels require even num_rffs, num_freqs = num_rffs / 2;
- transform_x generates features and overwrites column 0 with 1.0 when
  fitting an intercept.

Every kernel holds its projection state on an explicit ``device`` in the
working dtype of that device (config.fp_dtype).  PyTorch runs eagerly, so
the JAX package's traced-function caches are gone: ``pure_feature_fn`` and
friends are plain functions of (params, x, seq_len=None), the signature of
xgpr_tpu's; fixed-vector kernels ignore seq_len, and the convolution
kernels (kernels/conv1d.py) need it as an int32 tensor on their device.
"""
import abc
import itertools
from abc import ABC

import numpy as np
import torch

from .. import config

_KERNEL_UIDS = itertools.count()


class KernelBaseclass(ABC):
    """Base class for all kernels."""

    def __init__(self, xdim, num_rffs, sine_cosine_kernel=False,
                 kernel_spec_parms=None, device="cuda"):
        kernel_spec_parms = kernel_spec_parms or {}
        self.device = config.resolve_device(device)
        self.dtype = config.fp_dtype(self.device)
        if num_rffs < 2:
            raise RuntimeError("Fewer than 2 random features makes no "
                               "sense; raise num_rffs.")
        if sine_cosine_kernel:
            if num_rffs % 2 != 0:
                raise RuntimeError(
                    "For sine-cosine kernels (e.g. Matern, RBF) num_rffs "
                    "must be an even number.")
            self.num_freqs = num_rffs // 2
        else:
            self.num_freqs = num_rffs
        self.num_rffs = num_rffs
        self.fit_intercept = \
            kernel_spec_parms.get("intercept", True) is not False
        self._xdim = tuple(xdim)
        self.kernel_spec_parms = kernel_spec_parms
        self.hyperparams = None
        self.bounds = None
        self._uid = next(_KERNEL_UIDS)

    def get_uid(self):
        """Process-unique, never-recycled identity for caching."""
        return self._uid

    @abc.abstractmethod
    def kernel_specific_transform(self, input_x, sequence_length=None):
        """Generate random features for pre-cast input."""

    def kernel_specific_set_hyperparams(self):
        """Hook run after hyperparameters change."""
        return

    # ------------------------------------------------------------------
    # hyperparameter plumbing
    def get_hyperparams(self, logspace=True):
        if logspace:
            return np.log(self.hyperparams)
        return self.hyperparams

    def set_hyperparams(self, hyperparams, logspace=True):
        hyperparams = np.asarray(hyperparams, dtype=np.float64)
        if logspace:
            self.hyperparams = np.exp(hyperparams)
        else:
            self.hyperparams = hyperparams.copy()
        self.kernel_specific_set_hyperparams()

    def check_hyperparams(self, hyperparams):
        hyperparams = np.asarray(hyperparams)
        if hyperparams.shape[0] != self.hyperparams.shape[0]:
            raise RuntimeError(
                f"This kernel requires {self.hyperparams.shape[0]} "
                "hyperparameters.")

    def get_lambda(self):
        """The shared noise hyperparameter."""
        return float(self.hyperparams[0])

    def get_bounds(self, logspace=True):
        if logspace:
            return np.log(self.bounds)
        return self.bounds

    def set_bounds(self, bounds, logspace=True):
        bounds = np.asarray(bounds, dtype=np.float64)
        if bounds.shape != self.bounds.shape:
            raise RuntimeError(
                "Bounds must be a (n_hyperparams, 2) array matching the "
                "kernel's hyperparameter count.")
        self.bounds = np.exp(bounds) if logspace else bounds

    def get_num_rffs(self):
        return self.num_rffs

    def get_num_freqs(self):
        return self.num_freqs

    def get_xdim(self):
        return self._xdim

    def variance_column_indices(self, variance_rffs):
        """Columns implementing 'use the first variance_rffs features':
        the cos/sin pairs of the first variance_rffs/2 frequencies."""
        from ..ops.layout import variance_column_indices
        padded = getattr(self, "_feature_padded", None)
        if padded is None:
            return np.arange(variance_rffs)
        return variance_column_indices(self.num_freqs, padded,
                                       variance_rffs)

    def feature_positions(self):
        """(cos_pos, sin_pos) canonical column of each frequency's parts."""
        from ..ops.layout import freq_positions
        padded = getattr(self, "_feature_padded", None)
        if padded is None:
            return None
        return freq_positions(self.num_freqs, padded)

    def validate_new_datapoints(self, input_x):
        """Shape-compatibility check."""
        if input_x.ndim != len(self._xdim):
            return False
        if len(self._xdim) == 3:
            if input_x.shape[2] != self._xdim[2] or input_x.shape[1] < 1:
                return False
        elif input_x.shape[1] != self._xdim[1]:
            return False
        return True

    # ------------------------------------------------------------------
    # functional API used by the engine and the solvers
    def feature_params(self):
        """The dict of state the pure feature fn consumes."""
        raise NotImplementedError

    def pure_feature_fn(self):
        """fn(params, x, seq_len=None) -> (N, num_rffs) features,
        intercept applied."""
        raise NotImplementedError

    def pure_feature_parts_fn(self):
        """fn(params, x, seq_len=None) -> (cos, sin) parts, or None if
        unsupported."""
        return None

    def pure_ztzv_parts_fn(self):
        """fn(params, x, seq_len, mask, v_c, v_s) -> (oc, os) fused chunk
        matvec, or None if the kernel has none."""
        return None

    def gradient_params(self):
        """The dict of state the pure gradient fn consumes."""
        return self.feature_params()

    def pure_gradient_fn(self):
        """fn(params, x, seq_len=None) -> (features, d features / d sigma)
        with the derivative (N, num_rffs, n_sigma), intercept applied (its
        column's derivative is 0), or None if the kernel has none."""
        return None

    def kernel_specific_gradient(self, input_x, sequence_length=None):
        """(features, d features / d sigma) of pre-cast input, through
        the pure gradient fn."""
        fn = self.pure_gradient_fn()
        if fn is None:
            raise NotImplementedError("This kernel has no gradient fn.")
        return fn(self.gradient_params(), input_x, sequence_length)

    # ------------------------------------------------------------------
    # transforms
    def _cast_input(self, input_x):
        return torch.as_tensor(input_x, dtype=self.dtype, device=self.device)

    def _cast_lengths(self, sequence_length):
        if sequence_length is None:
            return None
        return torch.as_tensor(np.asarray(sequence_length), dtype=torch.int32,
                               device=self.device)

    def transform_x(self, input_x, sequence_length=None):
        """Random features of (N, D) input, or of (N, L, D) sequences with
        their lengths, as an (N, num_rffs) tensor on the kernel's device."""
        xtrans = self.kernel_specific_transform(
            self._cast_input(input_x), self._cast_lengths(sequence_length))
        if self.fit_intercept:
            xtrans[:, 0] = 1.0
        return xtrans

    def gradient_x(self, input_x, sequence_length=None):
        """(features, d features / d sigma) of raw input, on the kernel's
        device; the intercept column is 1 and its derivative 0."""
        return self.kernel_specific_gradient(
            self._cast_input(input_x), self._cast_lengths(sequence_length))

    def gradient_x_y(self, input_x, input_y, sequence_length=None):
        xtrans, dz_dsigma = self.gradient_x(input_x, sequence_length)
        y_out = torch.as_tensor(np.asarray(input_y), dtype=self.dtype,
                                device=self.device)
        return xtrans, dz_dsigma, y_out
