"""MiniARD: the port against xgpr_tpu, both in float64 on the CPU, same
data, seed, split points and hyperparameters.

- Features (the dense projection's path, which K2 takes on the card, and
  the structured FWHT path) and ``mini_ard_grad`` agree to 1e-10 of the
  largest value (roundoff: the projections sum in another order).
- The exact NMLL, its gradient and a fitted model's predictions agree to
  1e-8 relative.
- With every lengthscale equal to an RBF's sigma, the features equal the
  RBF's bit for bit (same radem/chi draws, same projection, same call).
- Bad split points raise the same errors in both packages.
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from xgpr_tpu.kernels import MiniARD as JaxMiniARD
from xgpr_tpu.ops.ard import mini_ard_grad as jax_mini_ard_grad
from xgpr_tpu_torch.kernels import RBF, MiniARD
from xgpr_tpu_torch.ops.ard import mini_ard_grad
from tests.utils.synthetic import tabular_data

torch.set_num_threads(1)

FEATURE_RTOL = 1e-10
MODEL_RTOL = 1e-8
SETTINGS = {"split_points": [5, 9]}
HPARAMS = np.array([-1.0, -2.5, -2.0, -1.5])


@pytest.fixture(scope="module")
def data():
    return tabular_data(n_train=500, n_test=80, n_features=12)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _kernels(x, num_rffs=128, settings=SETTINGS, dense=True):
    jk = JaxMiniARD(x.shape, num_rffs, kernel_spec_parms=settings)
    tk = MiniARD(x.shape, num_rffs, device="cpu", kernel_spec_parms=settings)
    jk.use_dense_projection = tk.use_dense_projection = dense
    for k in (jk, tk):
        k.set_hyperparams(HPARAMS)
    return jk, tk


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("intercept", [True, False])
def test_mini_ard_features_match_jax(data, dense, intercept):
    x = data[0][0][:100]
    settings = dict(SETTINGS, intercept=intercept)
    jk, tk = _kernels(x, 100, settings, dense)
    assert np.array_equal(tk.get_bounds(), jk.get_bounds())
    _close(tk.transform_x(x).numpy(), np.asarray(jk.transform_x(x)),
           FEATURE_RTOL)
    z = tk.pure_feature_fn()(tk.feature_params(), torch.as_tensor(x))
    _close(z.numpy(), np.asarray(jk.pure_feature_fn()(jk.feature_params(),
                                                      x)), FEATURE_RTOL)
    tz, tdz = tk.pure_gradient_fn()(tk.gradient_params(), torch.as_tensor(x))
    jz, jdz = jk.pure_gradient_fn()(jk.gradient_params(), x)
    assert tdz.shape == (100, 100, 3)
    _close(tz.numpy(), np.asarray(jz), FEATURE_RTOL)
    _close(tdz.numpy(), np.asarray(jdz), FEATURE_RTOL)


def test_mini_ard_grad_op_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 10))
    w = rng.standard_normal((40, 10))
    sig = np.array([0.3, 1.2, 0.7])
    args = ((0, 3, 7), (3, 7, 10))
    jz, jdz = jax_mini_ard_grad(x, w, *args, sig, True)
    tz, tdz = mini_ard_grad(torch.as_tensor(x), torch.as_tensor(w), *args,
                            torch.as_tensor(sig), True)
    _close(tz.numpy(), np.asarray(jz), FEATURE_RTOL)
    _close(tdz.numpy(), np.asarray(jdz), FEATURE_RTOL)


def test_mini_ard_equal_lengthscales_give_rbf_features(data):
    x = torch.as_tensor(data[0][0][:100])
    sigma = np.exp(-2.5)
    rbf = RBF(tuple(x.shape), 256, device="cpu")
    rbf.set_hyperparams(np.array([-1.0, np.log(sigma)]))
    ard = MiniARD(tuple(x.shape), 256, device="cpu",
                  kernel_spec_parms=SETTINGS)
    ard.set_hyperparams(np.array([-1.0] + [np.log(sigma)] * 3))
    assert torch.equal(ard._dense_proj(), rbf._dense_proj())
    assert torch.equal(ard.transform_x(x), rbf.transform_x(x))


def _models(data, num_rffs=128):
    (trx, tr_y), _ = data
    out = []
    for pkg, kw in ((xgpr_tpu, {}), (xgpr_tpu_torch, {"device": "cpu"})):
        dset = pkg.build_regression_dataset(trx, tr_y, chunk_size=200)
        model = pkg.GPRegression(num_rffs=num_rffs, variance_rffs=16,
                                 kernel_choice="MiniARD",
                                 kernel_settings=SETTINGS, verbose=False,
                                 **kw)
        model.set_hyperparams(HPARAMS, dset)
        out.append((model, dset))
    return out


def test_mini_ard_nmll_gradient_matches_jax(data):
    (jm, jd), (tm, td) = _models(data)
    for h in (HPARAMS, HPARAMS + np.array([0.3, -0.4, 0.2, 0.5])):
        _close(tm.exact_nmll(h, td), jm.exact_nmll(h, jd), MODEL_RTOL)
        (js, jg), (ts, tg) = (jm.exact_nmll_gradient(h, jd),
                              tm.exact_nmll_gradient(h, td))
        _close(ts, js, MODEL_RTOL)
        _close(tg, jg, MODEL_RTOL)


def test_mini_ard_fit_predict_matches_jax(data):
    (jm, jd), (tm, td) = _models(data)
    jn, _ = jm.fit(jd, mode="cg", tol=1e-10, run_diagnostics=True)
    tn, _ = tm.fit(td, mode="cg", tol=1e-10, run_diagnostics=True)
    assert jn == tn
    tex = data[1][0]
    jp, jv = jm.predict(tex, get_var=True)
    tp, tv = tm.predict(tex, get_var=True)
    _close(tp, jp, MODEL_RTOL)
    _close(tv, jv, MODEL_RTOL)


def test_mini_ard_crude_tune_matches_jax(data):
    """Three hyperparameters (one split point) take the surrogate tuner;
    both packages propose the same points and land on the same one."""
    (trx, tr_y), _ = data
    out = []
    for pkg, kw in ((xgpr_tpu, {}), (xgpr_tpu_torch, {"device": "cpu"})):
        dset = pkg.build_regression_dataset(trx, tr_y, chunk_size=200)
        model = pkg.GPRegression(num_rffs=64, kernel_choice="MiniARD",
                                 kernel_settings={"split_points": [6]},
                                 verbose=False, **kw)
        out.append(model.tune_hyperparams_crude(dset, max_bayes_iter=8))
    (jh, jn, js), (th, tn, ts) = out
    assert jn == tn
    _close(th, jh, MODEL_RTOL)
    _close(ts, js, MODEL_RTOL)


@pytest.mark.parametrize("settings", [
    {}, {"split_points": 5}, {"split_points": []}, {"split_points": [-1]},
    {"split_points": [20]}, {"split_points": [4, 4]}])
def test_mini_ard_split_point_errors(settings):
    for cls, kw in ((JaxMiniARD, {}), (MiniARD, {"device": "cpu"})):
        with pytest.raises(ValueError):
            cls((10, 12), 64, kernel_spec_parms=settings, **kw)


def test_mini_ard_refuses_sequences():
    with pytest.raises(ValueError):
        MiniARD((10, 5, 12), 64, device="cpu",
                kernel_spec_parms={"split_points": [3]})
