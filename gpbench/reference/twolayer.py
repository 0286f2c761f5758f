"""Plain reference of Conv1dTwoLayer's features, worked out from a model
seed (the benchmark's copy of the equations; the tests' copy is
``tests/torch_port/plain_twolayer.py``).

Layer 1: every window of ``width`` positions of a row (L, C), flattened
position-major, projected by the dense SORF matrix of the model seed
with ``init_rffs`` outputs (``features.FeatureMap``'s "conv" draw at
2 * init_rffs random features: the same Rademacher diagonals and chi
draws the port makes), and the elementwise max over the row's valid
windows against 0.  Layer 2: the RBF features of sigma times that
profile under the state of seed2 = default_rng(seed).integers(0,
2**31 - 1) (``features.FeatureMap``'s "rbf" map on ``init_rffs`` inputs,
the intercept's column set to 1).

``precision`` "float64" is the reference; "tf32" the control: both
layers' projections take operands rounded to TF32 and sum in float32.
It has ``features``, ``variance_columns``, ``num_rffs`` and ``device``
as ``features.FeatureMap`` does, so ``solve.gram`` and ``solve.Fit`` take
it unchanged.  Nothing here imports the port.
"""
import numpy as np
import torch

from .features import FeatureMap

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Rows a layer-1 step projects: their windows' projections in float64
# (rows x windows x init_rffs) stay within 2 GB at 237 positions.
PROFILE_ROWS = 1024


def second_seed(seed):
    return int(np.random.default_rng(seed).integers(0, 2 ** 31 - 1))


class TwoLayerMap:
    """The two layers' state of one model seed and their features."""

    def __init__(self, channels, width, init_rffs, num_rffs, seed,
                 device="cpu"):
        self.width = width
        self.layer1 = FeatureMap("conv", channels, 2 * init_rffs, seed,
                                 width, False, device)
        self.layer2 = FeatureMap("rbf", init_rffs, num_rffs,
                                 second_seed(seed), 1, True, device)
        self.num_rffs = num_rffs
        self.device = self.layer2.device

    def profile(self, x, lengths, precision="float64"):
        """(N, init_rffs): max(0, max over valid windows of each window's
        projection), in blocks of PROFILE_ROWS rows."""
        out = []
        for lo in range(0, x.shape[0], PROFILE_ROWS):
            xb = x[lo:lo + PROFILE_ROWS].to(self.device)
            n, seq_len, chans = xb.shape
            nw = seq_len - self.width + 1
            win = xb.unfold(1, self.width, 1).transpose(2, 3).reshape(
                n, nw, self.width * chans)
            g = self.layer1._project(win, precision)
            nk = lengths[lo:lo + PROFILE_ROWS].to(self.device).long() \
                - self.width + 1
            valid = torch.arange(nw, device=self.device)[None, :] < \
                nk[:, None]
            g = torch.where(valid[:, :, None], g, float("-inf"))
            out.append(torch.clamp_min(g.amax(dim=1), 0.0))
        return torch.cat(out)

    def features(self, x, sigma, lengths=None, precision="float64"):
        """(N, num_rffs) features in the block layout, float64, with the
        intercept's column 0 set to 1."""
        return self.layer2.features(self.profile(x, lengths, precision),
                                    sigma, None, precision)

    def variance_columns(self, variance_rffs):
        return self.layer2.variance_columns(variance_rffs)
