"""Model checkpointing (port of xgpr_tpu/models/serialization.py).

``save_model`` writes one .npz with a JSON ``_meta`` record and the arrays
hyperparams, weights and var (GPRegression) or weights and gamma
(GPClassification, with ``n_classes`` in the record), in xgpr_tpu's layout, so
a checkpoint crosses between the packages both ways.  The projection state
(radem, chi) is not stored: it regenerates from the seed through utils/rng.py,
the JAX package's own numpy code, so a model loaded in either package has the
same features.  ``load_model`` rebuilds the model of the record's ``class``
through ``models/convert.py``.
"""
import json

import numpy as np

from .convert import from_numpy_state


def save_model(model, path):
    """Serialize a fitted (or unfitted) GPRegression or GPClassification
    to an .npz file."""
    meta = {
        "class": type(model).__name__,
        "kernel_choice": model.kernel_choice,
        "num_rffs": int(model.num_rffs),
        "variance_rffs": int(model.variance_rffs),
        "kernel_settings": model.kernel_spec_parms,
        "random_seed": int(model.random_seed),
        "verbose": bool(model.verbose),
        "trainy_mean": float(model.trainy_mean),
        "trainy_std": float(model.trainy_std),
        # The port's variance is always the exact one; xgpr_tpu reads
        # these two fields back.
        "exact_var_calculation": True,
        "n_classes": int(model.n_classes),
        "xdim": list(model.kernel.get_xdim()) if model.kernel is not None
                else None,
    }
    arrays = {"_meta": np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)}
    if model.kernel is not None:
        arrays["hyperparams"] = model.kernel.get_hyperparams()
    if model.weights is not None:
        arrays["weights"] = model.weights.cpu().numpy()
    if model.var is not None:
        arrays["var"] = model.var.cpu().numpy()
    if model.gamma is not None:
        arrays["gamma"] = np.asarray(model.gamma)
    np.savez(path, **arrays)


def load_model(path, device="cuda"):
    """A port GPRegression or GPClassification, as the checkpoint's
    ``class`` says, from a checkpoint written by either package's
    save_model, on ``device``."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["_meta"].tobytes()).decode())
        arrays = {k: data[k] for k in data.files if k != "_meta"}
    return from_numpy_state(meta, arrays, device)
