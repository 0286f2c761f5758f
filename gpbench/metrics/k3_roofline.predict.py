"""K3's roofline share in % in the traced predict batches: the least
time of the valid windows' projections (TF32 peak) or of the bytes, at
every launch shape (the mean's features and the variance's), over the
device time charged to ``xgpr_tpu_torch::conv_parts``
(``gpbench/kernels/k3.py``)."""
from gpbench.harness.readers import Roofline

_K3 = Roofline("k3", __file__)
observe, read = _K3.observe, _K3.read
