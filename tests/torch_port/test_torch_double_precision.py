"""Double precision (``double_precision`` kernels, ``double_precision_fht``
models and tools) against xgpr_tpu's, both in float64 on the CPU.

- The host draws (Rademacher diagonals, chi and the Matern modifier) are
  drawn in float64 where xgpr_tpu draws them so, and are the same bits;
  they are not the float32 draws cast up.
- Features agree to FEATURE_RTOL = 1e-12 of max|ref|: float64 roundoff
  of projections summed in another order (measured 1.0e-15 at worst,
  Matern).
- CG and exact fits (weights, predictions, variance) to FIT_RTOL = 1e-10
  (measured 2.4e-12 at worst, Conv1dRBF's weights).  CG runs to a
  relative residual of 1e-12 in both packages: at 1e-10 the two
  Conv1dRBF iterates stopped 1.05e-10 apart, the solver's own slack.
- The property rebuilds the kernel and keeps its hyperparameters and
  bounds; KernelFGen takes the argument.
- A float64 kernel under a float32 working dtype ignores the precision
  knobs, as xgpr_tpu's float64 runs do: its fit under "max" is the fit
  under "balanced".
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from xgpr_tpu.kernels import KERNEL_NAME_TO_CLASS as J_KERNELS
from xgpr_tpu_torch import config
from xgpr_tpu_torch.kernels import KERNEL_NAME_TO_CLASS as T_KERNELS
from tests.utils.synthetic import sequence_data, tabular_data

torch.set_num_threads(1)

FEATURE_RTOL = 1e-12
FIT_RTOL = 1e-10
HPARAMS = np.array([-1.7908995, -3.9549678])
CONV_HPARAMS = np.log(np.array([0.3, 0.05]))

# (kernel, settings, hyperparameters, sequence input)
KERNELS = [
    ("RBF", {}, np.log([0.1, 0.25]), False),
    ("Matern", {"matern_nu": 1.5}, np.log([0.1, 0.25]), False),
    ("MiniARD", {"split_points": [5, 9]}, np.log([0.1, 0.25, 0.4, 0.2]),
     False),
    ("Conv1dRBF", {"conv_width": 9}, CONV_HPARAMS, True),
    ("Conv1dTwoLayer", {"conv_width": 9, "init_rffs": 64}, CONV_HPARAMS,
     True),
]


@pytest.fixture(scope="module")
def tab():
    return tabular_data(n_train=400, n_test=60, n_features=12)


@pytest.fixture(scope="module")
def seqs():
    return sequence_data(n_train=200, n_test=40)


def _pair(name, settings, xdim, hparams, num_rffs=256, double=True):
    jk = J_KERNELS[name](xdim, num_rffs, 123, None, double,
                         kernel_spec_parms=dict(settings))
    tk = T_KERNELS[name](xdim, num_rffs, 123, "cpu", double,
                         kernel_spec_parms=dict(settings))
    for k in (jk, tk):
        k.set_hyperparams(hparams)
    return jk, tk


def _draws(kernel):
    names = ("radem_diag", "chi_arr", "radem_diag1", "chi_arr1",
             "radem_diag2", "chi_arr2")
    return {n: np.asarray(getattr(kernel, n)) for n in names
            if hasattr(kernel, n)}


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("name,settings,hparams,seq", KERNELS)
def test_draws_are_xgpr_tpus_float64_draws(tab, seqs, name, settings,
                                           hparams, seq):
    xdim = seqs[0][0].shape if seq else tab[0][0].shape
    jk, tk = _pair(name, settings, xdim, hparams)
    assert tk.double_precision and tk.dtype == torch.float64
    want, got = _draws(jk), _draws(tk)
    assert set(got) == set(want) and got
    for key in want:
        assert want[key].dtype == np.float64
        assert np.array_equal(got[key], want[key]), key
    # float64 draws, not the float32 ones cast up.
    _, single = _pair(name, settings, xdim, hparams, double=False)
    chi = "chi_arr" if "chi_arr" in got else "chi_arr2"
    assert not np.array_equal(_draws(single)[chi], got[chi])


@pytest.mark.parametrize("name,settings,hparams,seq", KERNELS)
def test_features_match_xgpr_tpu(tab, seqs, name, settings, hparams, seq):
    if seq:
        (x, _, lengths), _ = seqs
        x, lengths = x[:120], lengths[:120]
    else:
        x, lengths = tab[0][0][:120], None
    jk, tk = _pair(name, settings, x.shape, hparams)
    want = np.asarray(jk.transform_x(x, lengths))
    got = tk.transform_x(x, lengths)
    assert got.dtype == torch.float64
    _close(got.numpy(), want, FEATURE_RTOL)


def _models(pkg, data, seq, kw):
    if seq:
        (x, y, lengths), _ = data
        dset = pkg.build_regression_dataset(x, y, lengths, chunk_size=100)
        model = pkg.GPRegression(num_rffs=256, variance_rffs=32,
                                 kernel_choice="Conv1dRBF",
                                 kernel_settings={"conv_width": 9},
                                 verbose=False, **kw)
        hparams = CONV_HPARAMS
    else:
        (x, y), _ = data
        dset = pkg.build_regression_dataset(x, y, chunk_size=150)
        model = pkg.GPRegression(num_rffs=256, variance_rffs=32,
                                 kernel_choice="RBF", verbose=False, **kw)
        hparams = HPARAMS
    model.double_precision_fht = True
    model.set_hyperparams(hparams, dset)
    return model, dset


@pytest.mark.parametrize("mode", ["cg", "exact"])
@pytest.mark.parametrize("seq", [False, True])
def test_fits_match_xgpr_tpu(tab, seqs, mode, seq):
    data = seqs if seq else tab
    tex = data[1][0]
    te_l = data[1][2] if seq else None
    preds = []
    for pkg, kw in ((xgpr_tpu, {}), (xgpr_tpu_torch, {"device": "cpu"})):
        model, dset = _models(pkg, data, seq, kw)
        assert model.kernel.double_precision
        if mode == "cg":
            pre, _ = model.build_preconditioner(dset, max_rank=64)
            model.fit(dset, preconditioner=pre, mode="cg", tol=1e-12)
        else:
            model.fit(dset, mode="exact")
        weights = model.weights
        weights = weights.numpy() if isinstance(weights, torch.Tensor) \
            else np.asarray(weights)
        p, v = model.predict(tex, te_l, get_var=True) if seq \
            else model.predict(tex, get_var=True)
        preds.append((weights, np.asarray(p), np.asarray(v)))
    for want, got in zip(*preds):
        _close(got, want, FIT_RTOL)


def test_the_property_rebuilds_the_kernel_and_keeps_its_state(tab):
    (x, y), _ = tab
    dset = xgpr_tpu_torch.build_regression_dataset(x, y, chunk_size=150)
    model = xgpr_tpu_torch.GPRegression(num_rffs=128, device="cpu",
                                        verbose=False)
    assert model.double_precision_fht is False
    model.set_hyperparams(HPARAMS, dset)
    bounds = np.log(np.array([[1e-2, 5.0], [1e-4, 10.0]]))
    model.kernel.set_bounds(bounds)
    model.fit(dset, mode="exact")
    old = model.kernel
    model.double_precision_fht = True
    assert model.kernel is not old and model.kernel.double_precision
    assert model.kernel.get_uid() != old.get_uid()
    np.testing.assert_array_equal(model.get_hyperparams(), HPARAMS)
    np.testing.assert_allclose(model.kernel.get_bounds(), bounds)
    assert model.weights is None
    model.fit(dset, mode="exact")
    assert model.weights.dtype == torch.float64
    model.double_precision_fht = False
    assert not model.kernel.double_precision
    # The constructor takes it too; xgpr_tpu's models take it as the
    # property alone.
    built = xgpr_tpu_torch.GPRegression(num_rffs=128, device="cpu",
                                        double_precision_fht=True)
    assert built.double_precision_fht is True
    clf = xgpr_tpu_torch.GPClassification(num_rffs=128, device="cpu",
                                          double_precision_fht=True)
    assert clf.double_precision_fht is True


@pytest.mark.parametrize("kernel_choice,settings,seq", [
    ("RBF", None, False), ("Conv1dRBF", {"conv_width": 9}, True)])
def test_kernel_fgen_takes_double_precision_fht(tab, seqs, kernel_choice,
                                               settings, seq):
    if seq:
        (x, _, lengths), _ = seqs
        x, lengths, d = x[:100], lengths[:100], x.shape[2]
    else:
        x, lengths, d = tab[0][0][:100], None, tab[0][0].shape[1]
    kw = dict(num_rffs=256, hyperparams=np.log([0.3]), num_features=d,
              kernel_choice=kernel_choice, kernel_settings=settings,
              verbose=False, double_precision_fht=True)
    jgen = xgpr_tpu.KernelFGen(**kw)
    tgen = xgpr_tpu_torch.KernelFGen(device="cpu", **kw)
    assert tgen.double_precision_fht and tgen.kernel.double_precision
    assert np.array_equal(np.asarray(tgen.kernel.chi_arr),
                          np.asarray(jgen.kernel.chi_arr))
    want = np.asarray(jgen.predict(x, lengths))
    got = tgen.predict(x, lengths)
    assert got.dtype == np.float64
    _close(got, want, FEATURE_RTOL)


@pytest.mark.parametrize("seq", [False, True])
def test_a_float64_kernel_ignores_the_knobs(tab, seqs, seq):
    """Under a float32 working dtype the "max" preset would round a
    float32 model's projections and matvec operands to bf16; a float64
    model's fit (double_precision_fht) is the same bits under "max" as
    under "balanced"."""
    data = seqs if seq else tab
    weights = []
    with config.working_dtype(torch.float32):
        for preset in ("balanced", "max"):
            config.set_speed_preset(preset)
            try:
                model, dset = _models(xgpr_tpu_torch, data, seq,
                                      {"device": "cpu"})
                assert model.kernel.dtype == torch.float64
                pre, _ = model.build_preconditioner(dset, max_rank=64)
                model.fit(dset, preconditioner=pre, mode="cg", tol=1e-8,
                          suppress_var=True)
            finally:
                config.set_speed_preset("balanced")
            weights.append(model.weights)
        assert config.feature_dtype("cpu") is None
        config.set_speed_preset("max")
        try:
            assert config.feature_dtype("cpu") is torch.bfloat16
            assert config.feature_dtype("cpu", torch.float64) is None
            assert config.feature_matmul_precision("cpu") == "default"
            assert config.feature_matmul_precision(
                "cpu", torch.float64) == "highest"
        finally:
            config.set_speed_preset("balanced")
    assert torch.equal(weights[0], weights[1])
