"""A user's fit of a Conv1dTwoLayer model, back to back: the fit kind
(``operations/fit.py``: the configured preconditioner, CG to ``tol``,
the variance), compared with the plain two-layer reference
(``reference/twolayer.py``): the last fit's weights, and its mean and
variance on the held-out rows."""
from pathlib import Path

from gpbench.harness import spec
from gpbench.reference.twolayer import TwoLayerMap

_fit = spec.load_module("operations", "fit",
                        Path(__file__).resolve().parents[2])


class Op(_fit.Op):

    def feature_map(self, device):
        m, d = self.model_cfg, self.config["data"]
        k = m["kernel_settings"]
        return TwoLayerMap(d["dim"], k["conv_width"], k["init_rffs"],
                           m["num_rffs"], self.mseed, device)
