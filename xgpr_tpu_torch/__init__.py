"""xgpr_tpu_torch: the PyTorch/CUDA port of xgpr_tpu.

Same module tree and names as the JAX package; each module's reference is
its namesake in ``xgpr_tpu``.  The models are GPRegression and
GPClassification (alias xGPClassification).  Plain tensor code is PyTorch; the feature
map, the fused CG matvec and the conv window loops are CUDA C++ kernels
for Hopper (``ops/cuda``).  This package never imports jax.
"""
__version__ = "0.1.0"

from .kernels import KERNEL_NAME_TO_CLASS

__all__ = ["KERNEL_NAME_TO_CLASS"]


def __getattr__(name):
    if name in ("GPRegression", "xGPRegression"):
        from .models.regression import GPRegression
        return GPRegression
    if name in ("GPClassification", "xGPClassification"):
        from .models.classification import GPClassification
        return GPClassification
    if name == "FastConv1d":
        from .models.static_layers import FastConv1d
        return FastConv1d
    if name in ("build_regression_dataset", "build_classification_dataset",
                "build_offline_np_dataset"):
        from .data import builders
        return getattr(builders, name)
    if name == "DatasetBaseclass":
        from .data.dataset import DatasetBaseclass
        return DatasetBaseclass
    if name == "from_numpy_state":
        from .models.convert import from_numpy_state
        return from_numpy_state
    if name in ("save_model", "load_model"):
        from .models import serialization
        return getattr(serialization, name)
    raise AttributeError(f"module 'xgpr_tpu_torch' has no attribute {name!r}")
