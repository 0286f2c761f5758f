"""The tuners of the port against xgpr_tpu, both in float64 on the CPU:
the closed-form lambda grid (get_eigvals, generate_scoregrid), the
surrogate's pieces (the lattice and a Thompson round), the crude tuner,
and the scipy tuners (Powell, L-BFGS-B) through tune_hyperparams.

Same data, seeds, lattice and normal draws on both sides, so both propose
the same points: the crude tuner takes the same number of evaluations and
lands on the same hyperparameters (within 1e-6; its scores are rounded to
3 places and log-lambda to 7 on both sides), and the scipy tuners follow
the same path to 1e-5.
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from xgpr_tpu.scoring import lb_optimizer as jax_lb
from xgpr_tpu.scoring import surrogate_tuner as jax_st
from xgpr_tpu_torch.scoring import lb_optimizer, surrogate_tuner
from tests.utils.synthetic import sequence_data, tabular_data

torch.set_num_threads(1)

HPARAMS = np.array([-1.7908995, -3.9549678])


@pytest.fixture(scope="module")
def tab():
    (trx, tr_y), _ = tabular_data(n_train=500)
    return trx, tr_y


@pytest.fixture(scope="module")
def seq():
    (trx, tr_y, trl), _ = sequence_data(n_train=250, n_test=10)
    return trx, tr_y, trl


def _models(arrays, kernel="RBF", settings=None, num_rffs=128):
    out = []
    for pkg, kw in ((xgpr_tpu_torch, {"device": "cpu"}), (xgpr_tpu, {})):
        dset = pkg.build_regression_dataset(*arrays, chunk_size=200)
        model = pkg.GPRegression(num_rffs=num_rffs, kernel_choice=kernel,
                                 kernel_settings=settings or {},
                                 verbose=False, **kw)
        model.set_hyperparams(HPARAMS, dset)
        out.append((model, dset))
    return out


@pytest.mark.parametrize("subsample", [1.0, 0.5])
def test_eigvals_and_scoregrid_match_jax(tab, subsample):
    (tm, td), (jm, jd) = _models(tab)
    got = lb_optimizer.get_eigvals(tm._engine(td), subsample)
    want = jax_lb.get_eigvals(jm._engine(jd), subsample)
    assert got[3] == want[3]
    assert got[2] == pytest.approx(want[2], rel=1e-12)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9 * np.abs(
            w).max())
    grid = np.exp(np.linspace(np.log(1e-3), np.log(10.0), 100))
    # The same inputs through both scorers: roundoff only.
    np.testing.assert_allclose(
        lb_optimizer.generate_scoregrid(128, *want[:2], grid, *want[2:]),
        jax_lb.generate_scoregrid(128, *want[:2], grid, *want[2:]),
        rtol=1e-12)


def test_scoregrid_penalises_inconsistent_eigenpairs():
    eigvals = np.array([4.0, 1.0, 1e-7])
    proj = np.array([10.0, 3.0, 0.0])
    grid = np.array([0.01, 0.1, 1.0])
    got = lb_optimizer.generate_scoregrid(3, eigvals, proj, grid, 1.0, 50)
    want = jax_lb.generate_scoregrid(3, eigvals, proj, grid, 1.0, 50)
    np.testing.assert_array_equal(got, want)
    assert np.all(got == xgpr_tpu_torch.constants.DEFAULT_SCORE_IF_PROBLEM)


@pytest.mark.parametrize("n_live", [3, 10])
@pytest.mark.parametrize("dim", [1, 2])
def test_thompson_round_matches_jax(dim, n_live):
    rng = np.random.default_rng(dim * 10 + n_live)
    nmax = 12
    pts = np.zeros((nmax, dim))
    pts[:n_live] = surrogate_tuner._lattice(n_live, dim, 123)
    np.testing.assert_array_equal(pts[:n_live],
                                  jax_st._lattice(n_live, dim, 123))
    scores = np.where(np.arange(nmax) < n_live,
                      rng.standard_normal(nmax) * 50 + 700, 0.0)
    mask = (np.arange(nmax) < n_live).astype(np.float64)
    cands = surrogate_tuner._lattice(1024, dim, 8042, offset=n_live * 1024)
    draws = rng.standard_normal(1024)
    got, got_val = surrogate_tuner._thompson_round(pts, scores, mask, cands,
                                                   draws)
    want, want_val = jax_st._thompson_round(pts, scores, mask, cands, draws)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got_val == pytest.approx(float(want_val), rel=1e-10)


CRUDE_CASES = [("RBF", None, 128, 1.0), ("RBF", None, 128, 0.6),
               ("Conv1dRBF", {"conv_width": 9}, 128, 1.0)]


@pytest.mark.parametrize("kernel,settings,num_rffs,subsample", CRUDE_CASES,
                         ids=["rbf", "rbf-subsample", "conv1drbf"])
def test_crude_tuning_matches_jax(tab, seq, kernel, settings, num_rffs,
                                  subsample):
    arrays = seq if kernel.startswith("Conv") else tab
    (tm, td), (jm, jd) = _models(arrays, kernel, settings, num_rffs)
    got = tm.tune_hyperparams_crude(td, max_bayes_iter=8,
                                    subsample=subsample)
    want = jm.tune_hyperparams_crude(jd, max_bayes_iter=8,
                                     subsample=subsample)
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    assert got[2] == pytest.approx(want[2], abs=1e-3)
    np.testing.assert_allclose(tm.get_hyperparams(), got[0])


@pytest.mark.parametrize("method,nmll_method", [("Powell", "exact"),
                                                ("L-BFGS-B", "exact"),
                                                ("Powell", "approximate")])
def test_scipy_tuning_matches_jax(tab, method, nmll_method):
    (tm, td), (jm, jd) = _models(tab)
    start = np.array([-1.0, -3.0])
    kw = dict(tuning_method=method, max_iter=5, nmll_method=nmll_method,
              starting_hyperparams=start)
    if nmll_method == "approximate":
        kw["manual_settings"] = {"max_rank": 32}
    got = tm.tune_hyperparams(td, **kw)
    want = jm.tune_hyperparams(jd, **kw)
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    assert got[2] == pytest.approx(want[2], rel=1e-8)
    assert got[2] <= tm.exact_nmll(start, td)


def test_tuning_rejects_unknown_methods(tab):
    (tm, td), _ = _models(tab)
    with pytest.raises(RuntimeError, match="tuning_method"):
        tm.tune_hyperparams(td, tuning_method="BFGS")
    with pytest.raises(RuntimeError, match="no gradient"):
        tm.tune_hyperparams(td, tuning_method="L-BFGS-B",
                            nmll_method="approximate")
