"""The slice end to end: GPRegression fit + predict of the port against
xgpr_tpu, both in float64 on the CPU, through the public entry points.

Same synthetic data (tests/utils/synthetic.py), seed, hyperparameters,
preconditioner rank and tolerance on both sides, so the random state and
every reduction are the same up to summation order.  The CG iteration
count must be equal, and weights, predictions and variance must agree to
rtol 1e-7 (measured ~1e-13; the bound leaves room for the iterative
solver's sensitivity to roundoff).
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from tests.utils.synthetic import spearman, tabular_data

torch.set_num_threads(1)

HPARAMS = np.array([-1.7908995, -3.9549678])
RTOL = 1e-7


@pytest.fixture(scope="module")
def data():
    (trx, tr_y), (tex, te_y) = tabular_data()
    return trx, tr_y, tex, te_y


def _models(data, num_rffs=1024, variance_rffs=64):
    trx, tr_y, _, _ = data
    out = []
    for pkg, kw in ((xgpr_tpu, {}), (xgpr_tpu_torch, {"device": "cpu"})):
        dset = pkg.build_regression_dataset(trx, tr_y, chunk_size=400)
        model = pkg.GPRegression(num_rffs=num_rffs,
                                 variance_rffs=variance_rffs,
                                 kernel_choice="RBF", verbose=False, **kw)
        model.set_hyperparams(HPARAMS, dset)
        out.append((model, dset))
    return out


def _compare(jm, tm, tex):
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               rtol=RTOL, atol=RTOL * np.abs(
                                   np.asarray(jm.weights)).max())
    jp, jv = jm.predict(tex, get_var=True)
    tp, tv = tm.predict(tex, get_var=True)
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=RTOL * np.abs(jp).max())
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=RTOL * np.abs(jv).max())
    return tp, tv


def test_cg_fit_predict_matches_jax(data):
    (jm, jd), (tm, td) = _models(data)
    iters = []
    for model, dset in ((jm, jd), (tm, td)):
        precond, _ = model.build_preconditioner(dset, max_rank=256)
        n_iter, _ = model.fit(dset, preconditioner=precond, mode="cg",
                              tol=1e-8, run_diagnostics=True)
        iters.append(n_iter)
    assert iters[0] == iters[1]
    tp, tv = _compare(jm, tm, data[2])
    assert spearman(tp, data[3]) > 0.62 and np.all(tv >= 0)


def test_autoselected_preconditioner_matches_jax(data):
    (jm, jd), (tm, td) = _models(data)
    jn, _ = jm.fit(jd, mode="cg", run_diagnostics=True)
    tn, _ = tm.fit(td, mode="cg", run_diagnostics=True)
    assert jn == tn
    _compare(jm, tm, data[2])


def test_exact_fit_matches_jax(data):
    (jm, jd), (tm, td) = _models(data, num_rffs=512, variance_rffs=32)
    jm.fit(jd, mode="exact")
    tm.fit(td, mode="exact")
    _compare(jm, tm, data[2])


def test_streaming_engine_matches_stacked(data):
    """The chunk-streamed engine (the loop CG) gives the stacked engine's
    fit on the same data."""
    from xgpr_tpu_torch import config
    (_, _), (tm, td) = _models(data)
    precond, _ = tm.build_preconditioner(td, max_rank=256)
    tm.fit(td, preconditioner=precond, tol=1e-8, suppress_var=True)
    stacked = tm.weights.clone()
    limit = config.stacked_element_limit()
    config.set_stacked_limit(1)
    try:
        (_, _), (sm, sd) = _models(data)
        precond, _ = sm.build_preconditioner(sd, max_rank=256)
        sm.fit(sd, preconditioner=precond, tol=1e-8, suppress_var=True)
        assert sm._engine(sd).mode == "streaming"
    finally:
        config.set_stacked_limit(limit)
    np.testing.assert_allclose(sm.weights.numpy(), stacked.numpy(),
                               rtol=RTOL, atol=RTOL * stacked.abs().max())


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xgpr_tpu_torch.GPRegression(num_rffs=64)
