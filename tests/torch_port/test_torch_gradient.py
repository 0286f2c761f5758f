"""The exact NMLL gradient of the port against xgpr_tpu, both in float64
on the CPU: the kernels' gradient fns (features and d features / d sigma)
for RBF (dense and structured projections), Matern, Conv1dRBF and
Conv1dTwoLayer, the engine's gradient terms, and exact_nmll_gradient; then
the analytic gradient against a numerical one, mirroring
tests/gradient_calc_tests/test_nmll_gradient.py (< 0.5% relative).

Same random state on both sides, so the gradient fns and terms agree to
1e-8 relative (measured ~1e-14).
"""
import numpy as np
import pytest
import torch
from scipy.optimize import approx_fprime

import xgpr_tpu
import xgpr_tpu_torch
from tests.utils.synthetic import sequence_data, tabular_data

torch.set_num_threads(1)

RTOL = 1e-8
HPARAMS = np.array([-1.0, -2.5])
SEQ_HPARAMS = np.array([-1.0, -2.0])


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def tab():
    (trx, tr_y), _ = tabular_data(n_train=600)
    return trx, tr_y


@pytest.fixture(scope="module")
def seq():
    (trx, tr_y, trl), _ = sequence_data(n_train=300, n_test=10, max_len=16,
                                        n_features=8, conv_width=5)
    return trx, tr_y, trl


def _models(arrays, kernel, settings, hparams, num_rffs=256, dense=True):
    out = []
    for pkg, kw in ((xgpr_tpu_torch, {"device": "cpu"}), (xgpr_tpu, {})):
        dset = pkg.build_regression_dataset(*arrays, chunk_size=200)
        model = pkg.GPRegression(num_rffs=num_rffs, kernel_choice=kernel,
                                 kernel_settings=settings, verbose=False,
                                 **kw)
        model.set_hyperparams(hparams, dset)
        if not dense:
            model.kernel.use_dense_projection = False
        out.append((model, dset))
    return out


GRAD_FN_CASES = [
    ("RBF", {}, True), ("RBF", {}, False),
    ("Matern", {"matern_nu": 2.5}, True),
    ("Conv1dRBF", {"conv_width": 5, "averaging": "full"}, True),
    ("Conv1dRBF", {"conv_width": 5}, False),
    ("Conv1dTwoLayer", {"conv_width": 5, "init_rffs": 64}, True),
]


@pytest.mark.parametrize("kernel,settings,dense", GRAD_FN_CASES,
                         ids=["rbf", "rbf-structured", "matern",
                              "conv1drbf-full", "conv1drbf-structured",
                              "conv1dtwolayer"])
def test_gradient_fn_and_terms_match_jax(tab, seq, kernel, settings, dense):
    is_seq = kernel.startswith("Conv")
    arrays = seq if is_seq else tab
    hparams = SEQ_HPARAMS if is_seq else HPARAMS
    (tm, td), (jm, jd) = _models(arrays, kernel, settings, hparams,
                                 dense=dense)
    x = arrays[0][:50]
    lens = arrays[2][:50] if is_seq else None
    tz, tdz = tm.kernel.pure_gradient_fn()(
        tm.kernel.gradient_params(), tm.kernel._cast_input(x),
        tm.kernel._cast_lengths(lens))
    jz, jdz = jm.kernel.gradient_x(x, lens)
    assert tuple(tdz.shape) == (50, 256, 1)
    _close(tz, jz)
    _close(tdz, jdz)
    gz, gdz, gy = tm.kernel.gradient_x_y(x, arrays[1][:50], lens)
    _close(gz, jz)
    _close(gdz, jdz)
    _close(gy, jm.kernel.gradient_x_y(x, arrays[1][:50], lens)[2])
    for subsample in (1.0, 0.5):
        got = tm._engine(td).gradient_terms(subsample=subsample)
        want = jm._engine(jd).gradient_terms(subsample=subsample)
        assert got[5] == want[5]
        for g, w in zip(got[:5], want[:5]):
            _close(g, w)


@pytest.mark.parametrize("kernel,settings", [("RBF", {}),
                                             ("Conv1dRBF",
                                              {"conv_width": 5})])
def test_exact_nmll_gradient_matches_jax(tab, seq, kernel, settings):
    is_seq = kernel.startswith("Conv")
    arrays = seq if is_seq else tab
    hparams = SEQ_HPARAMS if is_seq else HPARAMS
    (tm, td), (jm, jd) = _models(arrays, kernel, settings, hparams)
    for h in (hparams, hparams + np.array([0.7, -0.4])):
        ts, tg = tm.exact_nmll_gradient(h, td)
        js, jg = jm.exact_nmll_gradient(h, jd)
        assert ts == pytest.approx(js, rel=RTOL)
        _close(tg, jg)
        assert ts == pytest.approx(tm.exact_nmll(h, td), rel=1e-12)


@pytest.mark.parametrize("kernel,settings", [
    ("RBF", {}), ("Matern", {"matern_nu": 5 / 2}), ("Cauchy", {}),
    ("Conv1dRBF", {"conv_width": 5}),
    ("Conv1dMatern", {"conv_width": 5, "matern_nu": 5 / 2}),
    ("GraphRBF", {"averaging": "sqrt"}),
    ("Conv1dTwoLayer", {"conv_width": 5, "init_rffs": 128}),
])
def test_gradient_matches_numerical(tab, seq, kernel, settings):
    is_seq = kernel.startswith(("Conv", "Graph"))
    arrays = seq if is_seq else tab
    hparams = SEQ_HPARAMS if is_seq else HPARAMS
    dset = xgpr_tpu_torch.build_regression_dataset(*arrays, chunk_size=200)
    model = xgpr_tpu_torch.GPRegression(num_rffs=256, kernel_choice=kernel,
                                        kernel_settings=settings,
                                        device="cpu", verbose=False)
    model.set_hyperparams(dataset=dset)
    _, analytic = model.exact_nmll_gradient(hparams, dset)
    numerical = approx_fprime(
        hparams, lambda h: model.exact_nmll_gradient(h, dset)[0], 1e-7)
    rel_err = np.abs(analytic - numerical) / \
        np.maximum(np.abs(numerical), 1e-8)
    assert rel_err.max() < 0.005


def test_working_dtype_gives_float32_gradient_near_float64(tab):
    """config.working_dtype, with which chip_smoke.py builds its float64
    witness of the card's float32 gradient: models made inside the block
    work in its dtype, and the default comes back after it.  The analytic
    gradient from float32 features (the card's arithmetic; the chunk
    products are float64 in both) stays within 1e-5 relative of the
    float64 one (measured ~2e-7)."""
    dset = xgpr_tpu_torch.build_regression_dataset(*tab, chunk_size=200)
    out = {}
    for dtype in (torch.float32, torch.float64):
        with xgpr_tpu_torch.config.working_dtype(dtype):
            model = xgpr_tpu_torch.GPRegression(
                num_rffs=256, kernel_choice="RBF", device="cpu",
                verbose=False)
            model.set_hyperparams(HPARAMS, dset)
            out[dtype] = model.exact_nmll_gradient(HPARAMS, dset)
            assert model.kernel.dtype == dtype
    assert xgpr_tpu_torch.config.fp_dtype("cpu") == torch.float64
    (s32, g32), (s64, g64) = out[torch.float32], out[torch.float64]
    assert s32 == pytest.approx(s64, rel=1e-5)
    np.testing.assert_allclose(g32, g64, rtol=1e-5)
