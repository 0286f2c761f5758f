"""Kernel registry (port of xgpr_tpu/kernels/__init__.py).  Holds the
fixed-vector RBF family; the other xgpr_tpu kernels are not ported yet."""
from .basic import RBF, Matern, Cauchy

KERNEL_NAME_TO_CLASS = {
    "RBF": RBF,
    "Matern": Matern,
    "Cauchy": Cauchy,
}
