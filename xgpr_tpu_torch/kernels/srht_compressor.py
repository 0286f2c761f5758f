"""SRHT compressor for sketching random-feature matrices (port of
xgpr_tpu/kernels/srht_compressor.py): a Rademacher diagonal, a
normalised FWHT and a truncated column permutation, drawn on the host with
the numpy code of utils/rng.py, so the state equals xgpr_tpu's bit for
bit.  The transform is ``ops/sorf.py::srht_rows``, plain torch on every
device (xgpr_tpu computes it in XLA)."""
import numpy as np
import torch

from .. import config
from ..ops.hadamard import next_pow2
from ..ops.sorf import srht_rows
from ..utils import rng as state_rng


class SRHTCompressor:
    """Compress (N, input_size) feature rows to (N, compression_size) on
    ``device``."""

    def __init__(self, compression_size, input_size, random_seed=123,
                 device="cuda"):
        if compression_size >= input_size or compression_size <= 1:
            raise RuntimeError(
                f"compression_size must lie strictly between 1 and the "
                f"input width ({input_size}); got {compression_size}.")
        self.device = config.resolve_device(device)
        self.compression_size = int(compression_size)
        self.input_size = int(input_size)
        self.padded_dims = next_pow2(input_size)
        radem, idx = state_rng.srht_state(random_seed, input_size,
                                          compression_size, np.float64)
        self._radem_np = radem
        self._idx_np = idx
        self.radem = torch.as_tensor(radem, device=self.device)
        self.sample_idx = torch.as_tensor(idx, dtype=torch.int64,
                                          device=self.device)

    def transform_x(self, features):
        """The compressed rows as a tensor on the compressor's device; a
        tensor keeps its dtype, a numpy array takes the working dtype."""
        if features.ndim != 2 or features.shape[1] != self.input_size:
            raise RuntimeError("Input with unexpected size passed to a "
                               "compressor module.")
        if not torch.is_tensor(features):
            features = torch.as_tensor(np.asarray(features),
                                       dtype=config.fp_dtype(self.device))
        features = features.to(self.device)
        return srht_rows(features, self.radem.to(features.dtype),
                         self.sample_idx)
