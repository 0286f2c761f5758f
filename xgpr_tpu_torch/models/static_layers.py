"""Static feature-extraction layers (port of xgpr_tpu/models/static_layers.py).

FastConv1d is a one-shot ReLU + global-maxpool conv random-feature
extractor whose output feeds an RBF model (a 3-layer-CNN analogue).  Its
features are the K4 kernel on the card.  ``device`` is an explicit
"cuda" (the default) or "cpu", where xgpr_tpu sets the process-wide JAX
default device instead.
"""
import numpy as np

from ..kernels.l2_conv1d import FHTMaxpoolConv1dFeatureExtractor


class FastConv1d:
    """Convolution-based feature extraction for sequences / time series."""

    def __init__(self, seq_width, device="cuda", random_seed=123,
                 conv_width=9, num_features=512):
        self.seq_width = seq_width
        self.num_features = num_features
        self.conv_kernel = FHTMaxpoolConv1dFeatureExtractor(
            seq_width, num_features, conv_width=conv_width,
            random_seed=random_seed, device=device)

    @property
    def device(self):
        return self.conv_kernel.device

    def predict(self, x_array, sequence_lengths, chunk_size=2000):
        """Extract (N, num_features) maxpool conv features as a numpy
        array, chunk by chunk."""
        if sequence_lengths.shape[0] != x_array.shape[0]:
            raise RuntimeError(
                f"sequence_lengths has {sequence_lengths.shape[0]} entries "
                f"but x_array has {x_array.shape[0]} rows; one length per "
                "row is required.")
        feats = []
        for i in range(0, x_array.shape[0], chunk_size):
            cut = min(x_array.shape[0], i + chunk_size)
            feats.append(self.conv_kernel.transform_x(
                x_array[i:cut, ...], sequence_lengths[i:cut]).cpu().numpy())
        return np.vstack(feats)
