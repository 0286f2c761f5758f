"""Checkpoints across the packages (models/serialization.py) and the
Nystrom preconditioner's state.

The .npz layout is xgpr_tpu's, so a checkpoint crosses both ways: a port model
saved and loaded predicts identically; an xgpr_tpu checkpoint loads in the
port, and a port checkpoint in xgpr_tpu, and each predicts the same mean and
variance (a classifier: the same probabilities) in float64 to 1e-10 relative
(the feature maps sum in another order).  A preconditioner rebuilt from its
``to_state`` snapshot applies the same operator: bitwise from the port's own
snapshot, to 1e-12 from xgpr_tpu's.
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
from tests.utils.synthetic import (classification_data, sequence_data,
                                   tabular_data)

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
    """A classifier's record now loads as a port GPClassification (the
    fitted round trips are in test_torch_classification.py); a record of a
    model class the port does not have raises."""
    meta = {"class": "GPClassification", "kernel_choice": "RBF",
            "num_rffs": 64, "variance_rffs": 0, "random_seed": 123,
            "trainy_mean": 0.0, "trainy_std": 1.0, "n_classes": 3,
            "xdim": [10, 4]}
    path = tmp_path / "model.npz"

    def save(meta):
        np.savez(path, _meta=np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8))
    save(meta)
    loaded = load_model(str(path), device="cpu")
    assert type(loaded).__name__ == "GPClassification"
    assert loaded.n_classes == 3 and loaded.weights is None
    save(dict(meta, **{"class": "KernelFGen"}))
    with pytest.raises(RuntimeError, match="KernelFGen"):
        load_model(str(path), device="cpu")


def _fitted_classifier(pkg, **kw):
    (trx, tr_y), (tex, _) = classification_data(n_train=300, n_test=40)
    dset = pkg.build_classification_dataset(trx, tr_y, chunk_size=100)
    model = pkg.GPClassification(num_rffs=128, kernel_choice="RBF",
                                 verbose=False, **kw)
    model.set_hyperparams(np.log(np.array([0.1, 0.2])), dset)
    model.fit(dset, max_iter=10)
    return model, tex


@pytest.mark.parametrize("source,target", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_classifier_checkpoint_crosses(tmp_path, source, target):
    """A fitted GPClassification saved by one package loads in the other
    (n_classes, weights (M, C), gamma) and gives the same probabilities
    in float64 to 1e-10 (bitwise within the port)."""
    pkgs = {"port": (xgpr_tpu_torch, {"device": "cpu"}, save_model,
                     lambda path: load_model(path, device="cpu")),
            "jax": (xgpr_tpu, {}, jax_save, jax_load)}
    pkg, kw, save, _ = pkgs[source]
    model, tex = _fitted_classifier(pkg, **kw)
    path = str(tmp_path / "classifier.npz")
    save(model, path)
    loaded = pkgs[target][3](path)
    assert type(loaded).__name__ == "GPClassification"
    assert loaded.n_classes == 3 and np.array_equal(
        np.asarray(loaded.gamma), np.zeros(3))
    assert tuple(loaded.weights.shape) == (128, 3)
    want, got = model.predict(tex), loaded.predict(tex)
    assert got.shape == (tex.shape[0], 3)
    _same((got,), (want,), 0.0 if source == target else 1e-10)


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


ARD_CASES = {"Linear": (None, np.array([-0.7]), 8),
             "MiniARD": ({"split_points": [5]},
                         np.array([-1.5, -3.0, -2.5]), 16)}


@pytest.mark.parametrize("kernel_choice", sorted(ARD_CASES))
@pytest.mark.parametrize("source,target", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_linear_and_mini_ard_checkpoints_cross(tmp_path, kernel_choice,
                                               source, target):
    """A fitted Linear or MiniARD model saved by one package loads in the
    other and predicts the same mean in float64 to 1e-10 (bitwise within
    the port).  MiniARD carries its split points and exact variance;
    Linear's Nystrom variance is not stored, so it loads with its weights
    and no variance, as xgpr_tpu's load_model has it."""
    settings, hparams, var_rffs = ARD_CASES[kernel_choice]
    pkgs = {"port": (xgpr_tpu_torch, {"device": "cpu"}, save_model,
                     lambda path: load_model(path, device="cpu")),
            "jax": (xgpr_tpu, {}, jax_save, jax_load)}
    pkg, kw, save, _ = pkgs[source]
    (trx, tr_y, _), (tex, _) = _data("RBF")
    dset = pkg.build_regression_dataset(trx, tr_y, chunk_size=200)
    model = pkg.GPRegression(num_rffs=128, variance_rffs=var_rffs,
                             kernel_choice=kernel_choice,
                             kernel_settings=settings, verbose=False, **kw)
    model.set_hyperparams(hparams, dset)
    model.fit(dset, mode="exact")
    path = str(tmp_path / "model.npz")
    save(model, path)
    with np.load(path) as data:
        meta = json.loads(bytes(data["_meta"].tobytes()).decode())
        assert ("var" in data.files) == (kernel_choice == "MiniARD")
    assert meta["exact_var_calculation"] == (kernel_choice == "MiniARD")
    loaded = pkgs[target][3](path)
    assert loaded.kernel_spec_parms == model.kernel_spec_parms
    assert np.array_equal(loaded.get_hyperparams(), model.get_hyperparams())
    rtol = 0.0 if source == target else 1e-10
    if kernel_choice == "Linear":
        assert loaded.var is None
        with pytest.raises(RuntimeError):
            loaded.predict(tex, get_var=True)
        _same((loaded.predict(tex),), (model.predict(tex),), rtol)
    else:
        _same(loaded.predict(tex, get_var=True),
              model.predict(tex, get_var=True), rtol)
