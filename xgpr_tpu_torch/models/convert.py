"""Carry a fitted model's state into a port model.

A checkpoint (either package's models/serialization.py) holds a JSON
``_meta`` record and the arrays hyperparams, weights and var (a
regression model) or weights and gamma (a classifier).  The projection
state (radem, chi) is not stored: it regenerates from the seed through
utils/rng.py, which is the JAX package's own numpy code, so the port's
state equals the JAX model's bit for bit.
"""
import numpy as np
import torch

from .classification import GPClassification
from .regression import GPRegression


def from_numpy_state(meta, arrays, device="cuda"):
    """A port GPRegression or GPClassification (meta ``class``) from a JAX
    model's state as numpy arrays.

    ``meta`` holds class, kernel_choice, num_rffs, variance_rffs,
    random_seed, trainy_mean, trainy_std, n_classes and xdim
    (kernel_settings and verbose optional); ``arrays`` holds hyperparams
    (log-space) and, when fitted, weights and var (regression) or weights
    and gamma (classification).  A classifier's weights stay float64, the
    solver's precision; a regression model's take the kernel's dtype.  A
    model whose variance was a Nystrom preconditioner (Linear kernels)
    has no ``var`` in its state: it loads with its weights and no
    variance, as xgpr_tpu's ``load_model`` loads it.
    """
    cls_name = meta.get("class", "GPRegression")
    if cls_name not in ("GPRegression", "GPClassification"):
        raise RuntimeError(f"Unknown model class {cls_name!r}; "
                           "GPRegression and GPClassification load.")
    common = dict(num_rffs=meta["num_rffs"],
                  kernel_choice=meta["kernel_choice"],
                  kernel_settings=meta.get("kernel_settings"),
                  verbose=meta.get("verbose", True),
                  random_seed=meta["random_seed"], device=device)
    if cls_name == "GPClassification":
        model = GPClassification(**common)
        model.n_classes = int(meta["n_classes"])
    else:
        model = GPRegression(variance_rffs=meta["variance_rffs"], **common)
    model.trainy_mean = float(meta["trainy_mean"])
    model.trainy_std = float(meta["trainy_std"])
    if meta.get("xdim") is not None and "hyperparams" in arrays:
        model.set_hyperparams(np.asarray(arrays["hyperparams"]),
                              xdim=tuple(meta["xdim"]))
    if model.is_regression:
        dtype = None if model.kernel is None else model.kernel.dtype
    else:
        dtype = torch.float64
    opts = dict(dtype=dtype, device=model.device)
    if "weights" in arrays:
        model.weights = torch.as_tensor(np.asarray(arrays["weights"]), **opts)
    if "var" in arrays:
        model.var = torch.as_tensor(np.asarray(arrays["var"]), **opts)
    if "gamma" in arrays:
        model.gamma = np.asarray(arrays["gamma"], dtype=np.float64)
    return model
