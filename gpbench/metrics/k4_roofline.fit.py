"""K4's roofline share in % in the traced fits: the least time of the
valid windows' projections (TF32 peak) or of the bytes, at every launch
shape, over the device time charged to ``xgpr_tpu_torch::conv_maxpool``
(``gpbench/kernels/k4.py``)."""
from gpbench.harness.readers import Roofline

_K4 = Roofline("k4", __file__)
observe, read = _K4.observe, _K4.read
