"""Conv1dTwoLayer on the CPU against its plain float64 reference
(``plain_twolayer.py``, written from the kernel's equations), on seeded
states at a tiny size: ragged lengths, three rows exactly ``conv_width``
long (one window each).

Each number is the largest absolute difference over the largest
absolute reference value.  Tolerances, and why:

- the port in float64: 1e-12.  The same float64 arithmetic in another
  order (its projections are the same dense SORF matrices); read 2e-14
  at most.
- the port in float32 (``config.working_dtype``): the profile's window
  projections are float32 sums of 24 products, 2e-7 read, held to 5e-6;
  the features are cos and sin of a second float32 projection of 32
  profile values, 2e-6 read, held to 2e-5; the exact fit solves with the
  float64 Gram of those features, which the ridge's conditioning
  amplifies, weights 7e-6 read, held to 1e-4, the mean 4e-6 and the
  variance 6e-7 read, held to 5e-5 and 1e-5.
- the control: the reference with both layers' projections rounded to
  TF32 misses every float32 tolerance by 20x or more (5e-4 to 9e-3
  read), so the float32 tolerances are tight enough to tell a float32
  computation from a TF32 one.
"""
import functools

import numpy as np
import pytest
import torch

from xgpr_tpu_torch import GPRegression, build_regression_dataset, config
from xgpr_tpu_torch.ops.conv import conv_maxpool_features

from . import plain_twolayer as plain

N, N_TEST, L, C, WIDTH = 80, 40, 20, 6, 4
INIT_RFFS, RFFS, VAR_RFFS, SEED = 32, 64, 16, 1234
LAMBDA, SIGMA = 0.3, 0.7

TOLERANCES = {
    "float64": dict.fromkeys(("profile", "features", "weights", "mean",
                              "var"), 1e-12),
    "float32": {"profile": 5e-6, "features": 2e-5, "weights": 1e-4,
                "mean": 5e-5, "var": 1e-5},
}
TOLERANCES["tf32"] = TOLERANCES["float32"]
SIDES = ("float64", "float32", "tf32")


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.default_rng(7)
    letters = rng.integers(0, C - 1, size=(N + N_TEST, L))
    x = np.eye(C)[letters] + 0.1 * rng.standard_normal((N + N_TEST, L, C))
    lengths = rng.integers(WIDTH, L + 1, size=N + N_TEST).astype(np.int32)
    lengths[:3] = WIDTH
    lengths[N:N + 3] = WIDTH
    for i, length in enumerate(lengths):
        x[i, length:] = 0.0
    y = 0.3 * x[:, :, 0].sum(1) + np.sin(x[:, :, 1].sum(1)) \
        + 0.1 * rng.standard_normal(N + N_TEST)
    return x, y, lengths


@functools.lru_cache(maxsize=None)
def _outputs(side):
    """The profile and features of the test rows, the exact fit's
    weights and the test rows' mean and variance, all float64: the
    port's at ``side``'s working dtype, or the reference's at TF32."""
    x, y, lengths = _data()
    if side == "tf32":
        return _plain("tf32")
    dtype = torch.float64 if side == "float64" else torch.float32
    with config.working_dtype(dtype):
        data = build_regression_dataset(x[:N], y[:N], lengths[:N],
                                        chunk_size=32)
        model = GPRegression(
            num_rffs=RFFS, variance_rffs=VAR_RFFS, device="cpu",
            kernel_choice="Conv1dTwoLayer", random_seed=SEED, verbose=False,
            kernel_settings={"conv_width": WIDTH, "init_rffs": INIT_RFFS})
        model.set_hyperparams(np.log(np.array([LAMBDA, SIGMA])), data)
        model.fit(data, mode="exact")
        mean, var = model.predict(x[N:], lengths[N:], get_var=True)
        kernel = model.kernel
        params = kernel.feature_params()
        xt = torch.as_tensor(x[N:], dtype=dtype)
        lt = torch.as_tensor(lengths[N:])
        profile = conv_maxpool_features(xt, lt, params["radem1"],
                                        params["chi1"], WIDTH,
                                        proj=params.get("proj1"))
        features = kernel.pure_feature_fn()(params, xt, lt)
        assert np.array_equal(kernel.variance_column_indices(VAR_RFFS),
                              _reference().variance_columns(VAR_RFFS))
    return {"profile": profile.double(), "features": features.double(),
            "weights": model.weights.double(), "mean": torch.as_tensor(mean),
            "var": torch.as_tensor(var)}


@functools.lru_cache(maxsize=None)
def _reference():
    return plain.TwoLayer(C, WIDTH, INIT_RFFS, RFFS, SEED)


@functools.lru_cache(maxsize=None)
def _plain(precision):
    x, y, lengths = _data()
    ref = _reference()
    xt = torch.as_tensor(x)
    z_train = ref.features(xt[:N], lengths[:N], SIGMA, precision)
    z_test = ref.features(xt[N:], lengths[N:], SIGMA, precision)
    fit = plain.ExactFit(z_train, y[:N], LAMBDA,
                         ref.variance_columns(VAR_RFFS))
    mean, var = fit.predict(z_test)
    return {"profile": ref.profile(xt[N:], lengths[N:], precision),
            "features": z_test, "weights": fit.weights, "mean": mean,
            "var": var}


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _check(side, names):
    got, want = _outputs(side), _plain("float64")
    tol = TOLERANCES[side]
    gaps = {k: _gap(got[k], want[k]) for k in names}
    if side == "tf32":
        assert all(gaps[k] > tol[k] for k in names), gaps
    else:
        assert all(gaps[k] <= tol[k] for k in names), gaps


@pytest.mark.parametrize("side", SIDES)
def test_layers_match_the_plain_reference(side):
    """Layer 1's profile (ReLU and max over valid windows) and the full
    features; the TF32 control misses the float32 tolerances."""
    _check(side, ("profile", "features"))


@pytest.mark.parametrize("side", SIDES)
def test_exact_fit_matches_the_plain_reference(side):
    """The exact fit's weights and the held-out rows' mean and variance;
    the TF32 control misses the float32 tolerances."""
    _check(side, ("weights", "mean", "var"))


def test_rows_of_one_window_take_their_window():
    """A held-out row exactly ``conv_width`` long has one valid window:
    its profile is that window's projection against 0, whatever lies past
    it, in the reference and in the port."""
    x, _, lengths = _data()
    ref = _reference()
    rows = torch.as_tensor(x[N:N + 3])
    want = torch.clamp_min(rows[:, :WIDTH].reshape(3, WIDTH * C)
                           @ ref.proj1, 0.0)
    assert torch.equal(ref.profile(rows, lengths[N:N + 3]), want)
    port = _outputs("float64")["profile"][:3]
    assert _gap(port, want) <= TOLERANCES["float64"]["profile"]
