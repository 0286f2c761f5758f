"""Standalone random-feature generation (port of
xgpr_tpu/models/kernel_fgen.py): ``AuxiliaryBaseclass`` builds a kernel
for tools that are not models (the intercept is always off), and
``KernelFGen`` hands its features to external pipelines.

    fgen = KernelFGen(num_rffs=8192, hyperparams=np.log([sigma]),
                      num_features=84, kernel_choice="RBF")
    z = fgen.predict(x)            # (N, 8192) float numpy array

The kernel lives on ``device`` ("cuda" by default, or "cpu" by name), so
on the card the features are the K2 kernel's (K3's for the convolution
kernels).  ``double_precision_fht`` builds it with ``double_precision``,
as xgpr_tpu does: float64 draws and features, on the card through the
kernels' float64 bodies.
"""
import numpy as np

from .. import constants
from ..kernels import ARR_3D_KERNELS, KERNEL_NAME_TO_CLASS


class AuxiliaryBaseclass:
    """Kernel construction shared by non-model tools."""

    def __init__(self, num_rffs, hyperparams, num_features,
                 kernel_choice="RBF", device="cuda", kernel_settings=None,
                 random_seed=123, verbose=True,
                 double_precision_fht=False):
        if kernel_settings is None:
            kernel_settings = dict(constants.DEFAULT_KERNEL_SPEC_PARMS)
        kernel_settings = dict(kernel_settings)
        kernel_settings["intercept"] = False
        self.verbose = verbose

        if kernel_choice not in KERNEL_NAME_TO_CLASS:
            raise RuntimeError("kernel_choice does not name a registered "
                               "kernel.")
        if kernel_choice in ARR_3D_KERNELS:
            width = kernel_settings.get("conv_width", 10)
            xdim = (1, max(width, 10), num_features)
        else:
            xdim = (1, num_features)

        self.kernel = KERNEL_NAME_TO_CLASS[kernel_choice](
            xdim, num_rffs, random_seed, device, double_precision_fht,
            kernel_spec_parms=kernel_settings)
        self.double_precision_fht = double_precision_fht
        full_hparams = self.kernel.get_hyperparams()
        if full_hparams.shape[0] > 1:
            full_hparams[1:] = hyperparams
        self.kernel.set_hyperparams(full_hparams)

    @property
    def device(self):
        return self.kernel.device

    def pre_prediction_checks(self, input_x, sequence_lengths):
        if not self.kernel.validate_new_datapoints(input_x):
            raise RuntimeError("Input array shape does not match the shape "
                               "this kernel was built for.")
        if sequence_lengths is None:
            if input_x.ndim != 2:
                raise RuntimeError("sequence_lengths is required if using "
                                   "a convolution kernel.")
        elif input_x.ndim == 2:
            raise RuntimeError("Fixed-vector kernels take no "
                               "sequence_lengths argument; pass None.")

    def _chunked_features(self, input_x, sequence_lengths, chunk_size):
        """Yield ``kernel.transform_x`` of each chunk of rows, as tensors
        on the kernel's device."""
        self.pre_prediction_checks(input_x, sequence_lengths)
        for i in range(0, input_x.shape[0], chunk_size):
            slen = None if sequence_lengths is None else \
                sequence_lengths[i:i + chunk_size]
            yield self.kernel.transform_x(input_x[i:i + chunk_size], slen)


class KernelFGen(AuxiliaryBaseclass):
    """Generate random features for external pipelines."""

    def predict(self, input_x, sequence_lengths=None, chunk_size=2000):
        """The (N, num_rffs) features of the rows as a numpy array, made
        ``chunk_size`` rows at a time on the kernel's device."""
        return np.vstack([z.cpu().numpy() for z in self._chunked_features(
            input_x, sequence_lengths, chunk_size)])
