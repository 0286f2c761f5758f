"""Checkpoints across the packages (models/serialization.py) and the
Nystrom preconditioner's state.

The .npz layout is xgpr_tpu's, so a checkpoint crosses both ways: a port
model saved and loaded predicts identically; an xgpr_tpu checkpoint loads
in the port, and a port checkpoint in xgpr_tpu, and each predicts the same
mean and variance in float64 to 1e-10 relative (the feature maps sum in
another order).  A preconditioner rebuilt from its ``to_state`` snapshot
applies the same operator: bitwise from the port's own snapshot, to
1e-12 from xgpr_tpu's.
"""
import json

import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from xgpr_tpu.fitting.engine import Engine as JaxEngine
from xgpr_tpu.models.serialization import load_model as jax_load
from xgpr_tpu.models.serialization import save_model as jax_save
from xgpr_tpu.preconditioners.nystrom import \
    NystromPreconditioner as JaxPrecond
from xgpr_tpu_torch.fitting.engine import Engine
from xgpr_tpu_torch.models.serialization import load_model, save_model
from xgpr_tpu_torch.preconditioners.nystrom import NystromPreconditioner
from tests.utils.synthetic import sequence_data, tabular_data

torch.set_num_threads(1)

HPARAMS = np.array([-1.5, -3.0])
CASES = [("RBF", None), ("Conv1dRBF", {"conv_width": 5})]


def _data(kernel_choice):
    if kernel_choice == "RBF":
        (trx, tr_y), (tex, _) = tabular_data(n_train=500, n_test=40,
                                             n_features=12)
        return (trx, tr_y, None), (tex, None)
    (trx, tr_y, trl), (tex, _, tel) = sequence_data(n_train=300, n_test=40)
    return (trx, tr_y, trl), (tex, tel)


def _fitted(pkg, kernel_choice, settings, **kw):
    (trx, tr_y, trl), test = _data(kernel_choice)
    dset = pkg.build_regression_dataset(trx, tr_y, trl, chunk_size=200)
    model = pkg.GPRegression(num_rffs=128, variance_rffs=16,
                             kernel_choice=kernel_choice,
                             kernel_settings=settings, verbose=False, **kw)
    model.set_hyperparams(HPARAMS, dset)
    model.fit(dset, mode="exact")
    return model, test


def _same(got, want, rtol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * np.abs(w).max())


@pytest.mark.parametrize("kernel_choice,settings", CASES)
def test_port_checkpoint_round_trip(tmp_path, kernel_choice, settings):
    model, (tex, tel) = _fitted(xgpr_tpu_torch, kernel_choice, settings,
                                device="cpu")
    path = tmp_path / "model.npz"
    save_model(model, str(path))
    loaded = load_model(str(path), device="cpu")
    assert loaded.kernel_spec_parms == model.kernel_spec_parms
    assert np.array_equal(loaded.get_hyperparams(), model.get_hyperparams())
    _same(loaded.predict(tex, tel, get_var=True),
          model.predict(tex, tel, get_var=True), 0.0)


@pytest.mark.parametrize("kernel_choice,settings", CASES)
def test_jax_checkpoint_loads_in_port(tmp_path, kernel_choice, settings):
    jm, (tex, tel) = _fitted(xgpr_tpu, kernel_choice, settings)
    path = tmp_path / "model.npz"
    jax_save(jm, str(path))
    tm = load_model(str(path), device="cpu")
    _same(tm.predict(tex, tel, get_var=True),
          jm.predict(tex, tel, get_var=True), 1e-10)


@pytest.mark.parametrize("kernel_choice,settings", CASES)
def test_port_checkpoint_loads_in_jax(tmp_path, kernel_choice, settings):
    tm, (tex, tel) = _fitted(xgpr_tpu_torch, kernel_choice, settings,
                             device="cpu")
    path = tmp_path / "model.npz"
    save_model(tm, str(path))
    jm = jax_load(str(path))
    assert type(jm).__name__ == "GPRegression"
    _same(jm.predict(tex, tel, get_var=True),
          tm.predict(tex, tel, get_var=True), 1e-10)


def test_classification_checkpoint_raises(tmp_path):
    meta = {"class": "GPClassification", "kernel_choice": "RBF",
            "num_rffs": 64, "variance_rffs": 0, "random_seed": 123,
            "trainy_mean": 0.0, "trainy_std": 1.0, "n_classes": 3,
            "xdim": [10, 4]}
    path = tmp_path / "model.npz"
    np.savez(path, _meta=np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8))
    with pytest.raises(RuntimeError, match="classification"):
        load_model(str(path), device="cpu")


def test_preconditioner_state_round_trip(tmp_path):
    """to_state -> .npz -> from_state, in the port and from xgpr_tpu."""
    (trx, tr_y, _), _ = _data("RBF")
    vec = np.random.default_rng(2).standard_normal((128, 3))
    ops = ("batch_matvec", "rev_batch_matvec", "matvec_for_sampling")
    sides = {}
    for pkg, kw in ((xgpr_tpu_torch, {"device": "cpu"}), (xgpr_tpu, {})):
        dset = pkg.build_regression_dataset(trx, tr_y, chunk_size=200)
        model = pkg.GPRegression(num_rffs=128, kernel_choice="RBF",
                                 verbose=False, **kw)
        model.set_hyperparams(HPARAMS, dset)
        sides[pkg.__name__] = model, dset
    model, dset = sides["xgpr_tpu_torch"]
    built = NystromPreconditioner(Engine(model.kernel, dset), 32, False, 123,
                                  "srht_2")
    path = tmp_path / "precond.npz"
    np.savez(path, **built.to_state())
    with np.load(path) as state:
        back = NystromPreconditioner.from_state(state, device="cpu")
    x = torch.as_tensor(vec)
    for op in ops:
        assert torch.equal(getattr(back, op)(x), getattr(built, op)(x))
    assert back.get_logdet() == built.get_logdet()
    assert back.achieved_ratio == built.achieved_ratio
    assert torch.equal(back.get_zty(), built.get_zty())

    jmodel, jdset = sides["xgpr_tpu"]
    jax_pre = JaxPrecond(JaxEngine(jmodel.kernel, jdset),
                         32, False, 123, "srht_2")
    np.savez(path, **jax_pre.to_state())
    with np.load(path) as state:
        from_jax = NystromPreconditioner.from_state(state, device="cpu")
    for op in ops:
        np.testing.assert_allclose(getattr(from_jax, op)(x).numpy(),
                                   np.asarray(getattr(jax_pre, op)(vec)),
                                   rtol=1e-12, atol=1e-12)
