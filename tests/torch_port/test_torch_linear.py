"""The Linear kernel and its Nystrom variance: the port against xgpr_tpu,
both in float64 on the CPU, same data, seed and hyperparameters.

Features (identity with a leading intercept column), the exact and CG fits
(weights, predictions and the lambda^2 (1 + z P^-1 z^T) variance), the
exact NMLL and its gradient (width 0 in the kernel's derivative) and the
crude tune of lambda agree to 1e-8 relative (measured at roundoff: the
preconditioner's SVDs and the solvers sum in another order).
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from xgpr_tpu.kernels import Linear as JaxLinear
from xgpr_tpu_torch.kernels import Linear
from tests.utils.synthetic import spearman, tabular_data

torch.set_num_threads(1)

RTOL = 1e-8
HPARAMS = np.log(np.array([0.5]))


@pytest.fixture(scope="module")
def data():
    return tabular_data(n_train=600, n_test=120, n_features=12)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _models(data, variance_rffs=8, settings=None):
    (trx, tr_y), _ = data
    out = []
    for pkg, kw in ((xgpr_tpu, {}), (xgpr_tpu_torch, {"device": "cpu"})):
        dset = pkg.build_regression_dataset(trx, tr_y, chunk_size=250)
        model = pkg.GPRegression(num_rffs=64, variance_rffs=variance_rffs,
                                 kernel_choice="Linear",
                                 kernel_settings=settings, verbose=False,
                                 **kw)
        model.set_hyperparams(HPARAMS, dset)
        out.append((model, dset))
    return out


@pytest.mark.parametrize("intercept", [True, False])
def test_linear_features_match_jax(data, intercept):
    x = data[0][0][:50]
    parms = {"intercept": intercept}
    jk = JaxLinear(x.shape, 64, kernel_spec_parms=parms)
    tk = Linear(x.shape, 64, device="cpu", kernel_spec_parms=parms)
    assert tk.get_num_rffs() == jk.get_num_rffs() == 12 + intercept
    assert np.array_equal(tk.get_bounds(), jk.get_bounds())
    np.testing.assert_array_equal(tk.transform_x(x).numpy(),
                                  np.asarray(jk.transform_x(x)))
    # Before the intercept overwrite, column 0 is 0; the pure fn writes 1.
    raw = tk.kernel_specific_transform(torch.as_tensor(x))
    if intercept:
        assert torch.all(raw[:, 0] == 0)
    z = tk.pure_feature_fn()(tk.feature_params(), torch.as_tensor(x))
    jz = jk.pure_feature_fn()(jk.feature_params(), x)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    z2, dz = tk.pure_gradient_fn()(tk.gradient_params(), torch.as_tensor(x))
    assert torch.equal(z2, z) and dz.shape == (50, 12 + intercept, 0)


@pytest.mark.parametrize("mode", ["exact", "cg"])
def test_linear_fit_predict_matches_jax(data, mode):
    (jm, jd), (tm, td) = _models(data)
    jout = jm.fit(jd, mode=mode, tol=1e-10, run_diagnostics=True)
    tout = tm.fit(td, mode=mode, tol=1e-10, run_diagnostics=True)
    assert jout[0] == tout[0]
    assert not jm.exact_var_calculation and not tm.exact_var_calculation
    assert tm.var.get_rank() == 8
    _close(tm.weights.numpy(), np.asarray(jm.weights))
    tex, te_y = data[1]
    jp, jv = jm.predict(tex, get_var=True)
    tp, tv = tm.predict(tex, get_var=True)
    _close(tp, jp)
    _close(tv, jv)
    _close(tm.predict(tex), jp)
    assert np.all(tv >= 0) and spearman(tp, te_y) > 0.3


def test_linear_cg_weights_match_exact(data):
    (_, _), (tm, td) = _models(data)
    tm.fit(td, mode="exact")
    exact = tm.weights.clone()
    tm.fit(td, mode="cg", tol=1e-10)
    _close(tm.weights.numpy(), exact.numpy())


def test_linear_nmll_and_gradient_match_jax(data):
    (jm, jd), (tm, td) = _models(data)
    for h in (HPARAMS, HPARAMS + 0.7):
        _close(tm.exact_nmll(h, td), jm.exact_nmll(h, jd))
        (js, jg), (ts, tg) = (jm.exact_nmll_gradient(h, jd),
                              tm.exact_nmll_gradient(h, td))
        _close(ts, js)
        _close(tg, jg)


def test_linear_crude_tune_matches_jax(data):
    (jm, jd), (tm, td) = _models(data)
    jh, jn, js = jm.tune_hyperparams_crude(jd)
    th, tn, ts = tm.tune_hyperparams_crude(td)
    assert jn == tn == 1
    _close(th, jh)
    _close(ts, js)


@pytest.mark.parametrize("kernel_choice,fits", [("Linear", True),
                                                ("RBF", False)])
def test_variance_rffs_past_num_rffs(data, kernel_choice, fits):
    """Linear sets its own feature count (13 here), so a variance rank
    above the num_rffs the model asked for builds; RBF refuses it.  Once
    built, Linear's variance_rffs may be set past its feature count, as in
    xgpr_tpu, and the fit then refuses it."""
    (trx, tr_y), _ = data
    for pkg, kw in ((xgpr_tpu, {}), (xgpr_tpu_torch, {"device": "cpu"})):
        dset = pkg.build_regression_dataset(trx, tr_y, chunk_size=250)
        model = pkg.GPRegression(num_rffs=4, variance_rffs=8,
                                 kernel_choice=kernel_choice, verbose=False,
                                 **kw)
        if not fits:
            with pytest.raises(RuntimeError, match="variance_rffs"):
                model.set_hyperparams(np.zeros(2), dset)
            continue
        model.set_hyperparams(HPARAMS, dset)
        assert model.num_rffs == 13
        model.variance_rffs = 20
        with pytest.raises(RuntimeError, match="variance_rffs"):
            model.fit(dset, mode="exact")


def test_linear_refuses_sequences():
    with pytest.raises(ValueError):
        Linear((10, 5, 3), 16, device="cpu")
