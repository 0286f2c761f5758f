"""A fitted xgpr_tpu model carried into the port through its checkpoint.

``save_model`` (xgpr_tpu) writes the .npz, the port's ``load_model`` reads it.
The port regenerates radem and chi from the seed with the copied numpy
code, so they must equal the JAX kernel's arrays exactly, and float64
predictions and variance must match to 1e-10 relative (measured at
roundoff: only the summation order of the feature maps differs).
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
from xgpr_tpu.models.serialization import save_model
from xgpr_tpu_torch.models.convert import from_numpy_state
from xgpr_tpu_torch.models.serialization import load_model
from tests.utils.synthetic import tabular_data

torch.set_num_threads(1)


@pytest.mark.parametrize("kernel_choice,settings", [
    ("RBF", None), ("Matern", {"matern_nu": 2.5, "intercept": True}),
    ("Cauchy", {"intercept": False})])
def test_load_jax_model_predicts_the_same(tmp_path, kernel_choice, settings):
    (trx, tr_y), (tex, _) = tabular_data(n_train=600, n_test=50)
    dset = xgpr_tpu.build_regression_dataset(trx, tr_y, chunk_size=256)
    jm = xgpr_tpu.GPRegression(num_rffs=256, variance_rffs=32,
                               kernel_choice=kernel_choice,
                               kernel_settings=settings, verbose=False)
    jm.set_hyperparams(np.array([-1.5, -3.0]), dset)
    jm.fit(dset, mode="exact")
    path = tmp_path / "model.npz"
    save_model(jm, str(path))

    tm = load_model(str(path), device="cpu")
    assert np.array_equal(tm.kernel.radem_diag.numpy(),
                          np.asarray(jm.kernel.radem_diag))
    assert np.array_equal(tm.kernel.chi_arr.numpy(),
                          np.asarray(jm.kernel.chi_arr))
    jp, jv = jm.predict(tex, get_var=True)
    tp, tv = tm.predict(tex, get_var=True)
    np.testing.assert_allclose(tp, jp, rtol=1e-10,
                               atol=1e-10 * np.abs(jp).max())
    np.testing.assert_allclose(tv, jv, rtol=1e-10,
                               atol=1e-10 * np.abs(jv).max())


def test_from_numpy_state_rejects_other_models():
    with pytest.raises(RuntimeError):
        from_numpy_state({"class": "KernelFGen"}, {}, device="cpu")


@pytest.mark.parametrize("kernel_choice,settings,hparams", [
    ("Linear", {"intercept": False}, np.array([-0.5])),
    ("MiniARD", {"split_points": [30, 60]},
     np.array([-1.5, -3.0, -3.5, -2.5]))])
def test_load_jax_linear_and_mini_ard(tmp_path, kernel_choice, settings,
                                      hparams):
    """The Linear refusal is gone: a Linear checkpoint loads with its
    weights and no variance (xgpr_tpu does not store its Nystrom
    variance); MiniARD loads with its split points, its radem/chi equal to
    the JAX kernel's and the same predictions and variance to 1e-10."""
    (trx, tr_y), (tex, _) = tabular_data(n_train=600, n_test=50)
    dset = xgpr_tpu.build_regression_dataset(trx, tr_y, chunk_size=256)
    jm = xgpr_tpu.GPRegression(num_rffs=256, variance_rffs=32,
                               kernel_choice=kernel_choice,
                               kernel_settings=settings, verbose=False)
    jm.set_hyperparams(hparams, dset)
    jm.fit(dset, mode="exact")
    path = tmp_path / "model.npz"
    save_model(jm, str(path))
    tm = load_model(str(path), device="cpu")
    assert tm.kernel_choice == kernel_choice
    jp, tp = jm.predict(tex), tm.predict(tex)
    np.testing.assert_allclose(tp, jp, rtol=1e-10,
                               atol=1e-10 * np.abs(jp).max())
    if kernel_choice == "Linear":
        assert tm.var is None and tm.num_rffs == 84
        return
    assert np.array_equal(tm.kernel.radem_diag.numpy(),
                          np.asarray(jm.kernel.radem_diag))
    assert np.array_equal(tm.kernel.chi_arr.numpy(),
                          np.asarray(jm.kernel.chi_arr))
    jv, tv = jm.predict(tex, get_var=True)[1], tm.predict(tex,
                                                         get_var=True)[1]
    np.testing.assert_allclose(tv, jv, rtol=1e-10,
                               atol=1e-10 * np.abs(jv).max())
