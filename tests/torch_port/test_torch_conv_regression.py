"""The sequence slice end to end: Conv1dRBF GPRegression fit + predict of
the port against xgpr_tpu, both in float64 on the CPU, through the public
entry points, on tests/utils/synthetic.py::sequence_data.

Same data, seed, hyperparameters, preconditioner rank and tolerance on both
sides, so the random state and every reduction are the same up to
summation order: the CG iteration count must be equal, and weights,
predictions and variance must agree to 1e-10 relative (measured ~1e-14).
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from xgpr_tpu.models.serialization import save_model
from xgpr_tpu_torch import config
from xgpr_tpu_torch.models.serialization import load_model
from tests.utils.synthetic import sequence_data, spearman

torch.set_num_threads(1)

HPARAMS = np.log(np.array([0.3, 0.05]))
SETTINGS = {"conv_width": 9, "averaging": "sqrt"}
RTOL = 1e-10


@pytest.fixture(scope="module")
def data():
    return sequence_data(n_train=300, n_test=100)


def _model(pkg, data, kernel_choice="Conv1dRBF", settings=SETTINGS,
           num_rffs=256, **kw):
    (trx, tr_y, trl), _ = data
    dset = pkg.build_regression_dataset(trx, tr_y, trl, chunk_size=128)
    model = pkg.GPRegression(num_rffs=num_rffs, variance_rffs=32,
                             kernel_choice=kernel_choice,
                             kernel_settings=settings, verbose=False, **kw)
    model.set_hyperparams(HPARAMS, dset)
    return model, dset


def _cg_fit(model, dset):
    precond, ratio = model.build_preconditioner(dset, max_rank=64)
    n_iter, _ = model.fit(dset, preconditioner=precond, mode="cg", tol=1e-8,
                          run_diagnostics=True)
    return n_iter, ratio


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _compare(jm, tm, data):
    _, (tex, _, tel) = data
    _close(tm.weights.numpy(), jm.weights)
    jp, jv = jm.predict(tex, tel, get_var=True)
    tp, tv = tm.predict(tex, tel, get_var=True, chunk_size=37)
    _close(tp, jp)
    _close(tv, jv)
    return tp, tv


@pytest.fixture(scope="module")
def jax_cg(data):
    jm, jd = _model(xgpr_tpu, data)
    return jm, _cg_fit(jm, jd)


@pytest.mark.parametrize("engine", ["stacked", "streaming"])
def test_cg_fit_predict_matches_jax(data, jax_cg, engine):
    jm, (j_iter, j_ratio) = jax_cg
    limit = config.stacked_element_limit()
    if engine == "streaming":
        config.set_stacked_limit(1)
    try:
        tm, td = _model(xgpr_tpu_torch, data, device="cpu")
        t_iter, t_ratio = _cg_fit(tm, td)
        assert tm._engine(td).mode == engine
    finally:
        config.set_stacked_limit(limit)
    assert t_iter == j_iter and t_iter > 3
    np.testing.assert_allclose(t_ratio, j_ratio, rtol=RTOL)
    tp, tv = _compare(jm, tm, data)
    assert spearman(tp, data[1][1]) > 0.45 and np.all(tv >= 0)


@pytest.mark.parametrize("kernel_choice,settings", [
    ("Conv1dRBF", SETTINGS), ("GraphRBF", {"averaging": "full"})])
def test_exact_fit_matches_jax(data, kernel_choice, settings):
    jm, jd = _model(xgpr_tpu, data, kernel_choice=kernel_choice,
                    settings=settings)
    tm, td = _model(xgpr_tpu_torch, data, kernel_choice=kernel_choice,
                    settings=settings, device="cpu")
    jm.fit(jd, mode="exact")
    tm.fit(td, mode="exact")
    _compare(jm, tm, data)


def test_preconditioner_sees_the_lengths(data):
    """The Nystrom sketch and the autoselect's ratio check reach the conv
    features through the engine with each chunk's lengths: both match
    xgpr_tpu, and both move when the lengths do."""
    (trx, tr_y, trl), _ = data
    jm, jd = _model(xgpr_tpu, data, num_rffs=128)
    tm, td = _model(xgpr_tpu_torch, data, num_rffs=128, device="cpu")
    want = jm._check_rank_ratio(jd, sample_frac=0.5, max_rank=40)
    got = tm._check_rank_ratio(td, sample_frac=0.5, max_rank=40)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    cut = xgpr_tpu_torch.build_regression_dataset(
        trx, tr_y, np.full_like(trl, 9), chunk_size=128)
    assert abs(tm._check_rank_ratio(cut, sample_frac=0.5, max_rank=40)
               - got) > 1e-6 * abs(got)


def test_prediction_length_contract(data):
    _, (tex, _, tel) = data
    tm, td = _model(xgpr_tpu_torch, data, device="cpu")
    tm.fit(td, mode="exact")
    with pytest.raises(RuntimeError, match="sequence_lengths is required"):
        tm.predict(tex)
    short = tel.copy()
    short[3] = 8                           # below conv_width 9
    with pytest.raises(RuntimeError, match="conv_width"):
        tm.predict(tex, short)
    with pytest.raises(RuntimeError):
        tm.predict(tex, tel[:-1])
    rm, rd = _model(xgpr_tpu_torch, ((tex[:, 0], data[1][1], None), None),
                    kernel_choice="RBF", settings=None, device="cpu")
    rm.fit(rd, mode="exact")
    with pytest.raises(RuntimeError, match="Fixed-vector"):
        rm.predict(tex[:, 0], tel)


@pytest.mark.parametrize("kernel_choice,settings", [
    ("Conv1dRBF", {"conv_width": 5, "averaging": "full"}),
    ("Conv1dTwoLayer", {"conv_width": 5, "init_rffs": 32})])
def test_load_jax_conv_model(tmp_path, data, kernel_choice, settings):
    """A fitted xgpr_tpu sequence model carried across by its checkpoint:
    kernel_settings, a 3-long xdim, and the same predictions."""
    _, (tex, _, tel) = data
    jm, jd = _model(xgpr_tpu, data, kernel_choice=kernel_choice,
                    settings=settings, num_rffs=128)
    jm.fit(jd, mode="exact")
    path = tmp_path / "model.npz"
    save_model(jm, str(path))
    tm = load_model(str(path), device="cpu")
    assert tm.kernel.get_xdim() == jm.kernel.get_xdim() and \
        len(tm.kernel.get_xdim()) == 3
    assert tm.kernel_spec_parms == settings
    jp, jv = jm.predict(tex, tel, get_var=True)
    tp, tv = tm.predict(tex, tel, get_var=True)
    _close(tp, jp)
    _close(tv, jv)
