"""export_predict_fn: the exported function and its state against the
model's own predict, and against xgpr_tpu's exported function on the same
model state, in float64 on the CPU.

Against predict the mean is held to xgpr_tpu's own test tolerance
(tests/api_tests/test_export_predict.py: rtol 1e-9, atol 1e-11) and the
variance and probabilities to rtol 1e-8; against xgpr_tpu's exported fn
the same (the feature maps sum in another order).  A state that went
through numpy and back gives the same bits.  The Linear kernel's Nystrom
variance is refused, as in xgpr_tpu.
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from tests.utils.synthetic import (classification_data, sequence_data,
                                   tabular_data)

torch.set_num_threads(1)

HPARAMS = np.array([-1.7908995, -3.9549678])
MEAN_RTOL, MEAN_ATOL = 1e-9, 1e-11
VAR_RTOL = 1e-8


def _roundtrip(state):
    """The state through numpy and back, as a server would load it."""
    if isinstance(state, dict):
        return {k: _roundtrip(v) for k, v in state.items()}
    if torch.is_tensor(state):
        return torch.as_tensor(state.cpu().numpy())
    return state


def _fitted(pkg, kernel_choice, **kw):
    if kernel_choice == "Conv1dRBF":
        (trx, tr_y, trl), (tex, _, tel) = sequence_data(n_train=300,
                                                        n_test=60)
        settings = {"conv_width": 5}
    else:
        (trx, tr_y), (tex, _) = tabular_data(n_train=600, n_test=100,
                                             n_features=12)
        trl = tel = None
        settings = None
    dset = pkg.build_regression_dataset(trx, tr_y, trl, chunk_size=200)
    model = pkg.GPRegression(num_rffs=128, variance_rffs=8,
                             kernel_choice=kernel_choice,
                             kernel_settings=settings, verbose=False, **kw)
    model.set_hyperparams(HPARAMS if kernel_choice != "Linear"
                          else HPARAMS[:1], dset)
    model.fit(dset, mode="exact")
    return model, tex, tel


@pytest.fixture(scope="module")
def fitted():
    """Both packages' fitted models by kernel, built once per module."""
    cache = {}

    def get(kernel_choice):
        if kernel_choice not in cache:
            cache[kernel_choice] = (
                _fitted(xgpr_tpu_torch, kernel_choice, device="cpu"),
                _fitted(xgpr_tpu, kernel_choice)[0])
        return cache[kernel_choice]
    return get


@pytest.mark.parametrize("kernel_choice,get_var", [
    ("RBF", True), ("RBF", False), ("Conv1dRBF", False),
    ("Conv1dRBF", True)])
def test_regression_export_matches_predict(fitted, kernel_choice, get_var):
    (tm, tex, tel), jm = fitted(kernel_choice)
    fn, state = tm.export_predict_fn(get_var=get_var)
    x = torch.as_tensor(tex)
    slen = None if tel is None else torch.as_tensor(tel, dtype=torch.int32)
    out = fn(state, x, slen)
    ref = tm.predict(tex, tel, get_var=get_var)
    jfn, jstate = jm.export_predict_fn(get_var=get_var)
    jout = jfn(jstate, tex, tel)
    if not get_var:
        out, ref, jout = (out,), (ref,), (jout,)
    for got, want, jwant, rtol in zip(out, ref, jout,
                                      (MEAN_RTOL, VAR_RTOL)):
        got = got.numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=MEAN_ATOL)
        np.testing.assert_allclose(got, np.asarray(jwant), rtol=rtol,
                                   atol=MEAN_ATOL)
    again = fn(_roundtrip(state), x, slen)
    for a, b in zip(again if get_var else (again,), out):
        assert torch.equal(a, b)


def test_classification_export_matches_predict():
    (trx, tr_y), (tex, _) = classification_data(n_train=600, n_test=100)
    out = []
    for pkg, kw in ((xgpr_tpu, {}), (xgpr_tpu_torch, {"device": "cpu"})):
        dset = pkg.build_classification_dataset(trx, tr_y, chunk_size=150)
        model = pkg.GPClassification(num_rffs=128, kernel_choice="RBF",
                                     verbose=False, **kw)
        model.set_hyperparams(np.log(np.array([0.1, 0.2])), dset)
        model.fit(dset, min_rank=32, max_rank=64)
        out.append(model)
    jm, tm = out
    fn, state = tm.export_predict_fn()
    probs = fn(state, torch.as_tensor(tex)).numpy()
    np.testing.assert_allclose(probs, tm.predict(tex), rtol=VAR_RTOL,
                               atol=1e-12)
    jfn, jstate = jm.export_predict_fn()
    np.testing.assert_allclose(probs, np.asarray(jfn(jstate, tex, None)),
                               rtol=VAR_RTOL, atol=1e-12)
    assert torch.equal(fn(_roundtrip(state), torch.as_tensor(tex)),
                       fn(state, torch.as_tensor(tex)))


def test_linear_export_refuses_nystrom_variance(fitted):
    (tm, tex, _), jm = fitted("Linear")
    for model in (jm, tm):
        with pytest.raises(RuntimeError, match="Nystrom"):
            model.export_predict_fn(get_var=True)
    fn, state = tm.export_predict_fn()
    np.testing.assert_allclose(fn(state, torch.as_tensor(tex)).numpy(),
                               tm.predict(tex), rtol=MEAN_RTOL,
                               atol=MEAN_ATOL)


def test_export_requires_fit():
    for model in (xgpr_tpu_torch.GPRegression(num_rffs=64, device="cpu"),
                  xgpr_tpu_torch.GPClassification(num_rffs=64,
                                                  device="cpu")):
        with pytest.raises(RuntimeError):
            model.export_predict_fn()
