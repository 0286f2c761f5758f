"""Carry a fitted xgpr_tpu model across to the port.

The JAX package's checkpoint (xgpr_tpu/models/serialization.py:save_model)
is an .npz holding a JSON ``_meta`` record and the arrays hyperparams,
weights and var.  The projection state (radem, chi) is not stored: it
regenerates from the seed through utils/rng.py, which is the JAX package's
own numpy code, so the port's state equals the JAX model's bit for bit.
"""
import json

import numpy as np
import torch

from .regression import GPRegression


def from_numpy_state(meta, arrays, device="cuda"):
    """A port GPRegression from a JAX model's state as numpy arrays.

    ``meta`` holds kernel_choice, num_rffs, variance_rffs, random_seed,
    trainy_mean, trainy_std and xdim (kernel_settings and verbose
    optional); ``arrays`` holds hyperparams (log-space) and, when fitted,
    weights and var.
    """
    cls_name = meta.get("class", "GPRegression")
    if cls_name != "GPRegression":
        raise RuntimeError(f"Only GPRegression models can be converted; "
                           f"got {cls_name}.")
    if not meta.get("exact_var_calculation", True):
        raise RuntimeError("Models with the Nystrom (Linear-kernel) "
                           "variance cannot be converted yet.")
    model = GPRegression(num_rffs=meta["num_rffs"],
                         variance_rffs=meta["variance_rffs"],
                         kernel_choice=meta["kernel_choice"],
                         kernel_settings=meta.get("kernel_settings"),
                         verbose=meta.get("verbose", True),
                         random_seed=meta["random_seed"], device=device)
    model.trainy_mean = float(meta["trainy_mean"])
    model.trainy_std = float(meta["trainy_std"])
    if meta.get("xdim") is not None and "hyperparams" in arrays:
        model.set_hyperparams(np.asarray(arrays["hyperparams"]),
                              xdim=tuple(meta["xdim"]))
    opts = dict(dtype=None if model.kernel is None else model.kernel.dtype,
                device=model.device)
    if "weights" in arrays:
        model.weights = torch.as_tensor(np.asarray(arrays["weights"]), **opts)
    if "var" in arrays:
        model.var = torch.as_tensor(np.asarray(arrays["var"]), **opts)
    return model


def load_jax_model(path, device="cuda"):
    """Read an .npz written by xgpr_tpu's save_model into a port model."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["_meta"].tobytes()).decode())
        arrays = {k: data[k] for k in data.files if k != "_meta"}
    return from_numpy_state(meta, arrays, device)
