"""K1's roofline share in % in the traced fits: the least time of its
projection and contractions (TF32 peak) or of its bytes, at every launch
shape, over the device time inside the ``gpbench/k1`` range around the
kernel layer's ``ztzv_parts`` (``gpbench/kernels/k1.py``)."""
from gpbench.harness.readers import Roofline

_K1 = Roofline("k1", __file__)
observe, read = _K1.observe, _K1.read
