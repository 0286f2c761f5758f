"""exact_nmll and approximate_nmll of the port against xgpr_tpu, both in
float64 on the CPU, through the public entry points; SLQ against the
exact NMLL; the amortized preconditioner's rank cache; and the split
between failures that become the penalty score and failures that raise.

Same data, seeds, probes and preconditioner ranks on both sides: the
NMLLs agree to 1e-8 relative (measured ~1e-13).  SLQ lands within 1% of
the exact NMLL, the JAX suite's gate (tests/approximate_nmll_tests/).
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from xgpr_tpu_torch import constants
from xgpr_tpu_torch.models import baseclass
from tests.utils.synthetic import sequence_data, tabular_data

torch.set_num_threads(1)

EASY_HPARAMS = np.array([-1.7908995, -3.9549678])
HARD_HPARAMS = np.array([-3.2, -2.0])
NEARBY_HPARAMS = np.array([-1.6, -3.7])
RTOL = 1e-8


@pytest.fixture(scope="module")
def tab():
    (trx, tr_y), _ = tabular_data(n_train=900)
    return trx, tr_y


@pytest.fixture(scope="module")
def seq():
    (trx, tr_y, trl), _ = sequence_data(n_train=300, n_test=10)
    return trx, tr_y, trl


def _model(pkg, arrays, kernel="RBF", settings=None, num_rffs=256,
           hparams=EASY_HPARAMS):
    kw = {"device": "cpu"} if pkg is xgpr_tpu_torch else {}
    dset = pkg.build_regression_dataset(*arrays, chunk_size=300)
    model = pkg.GPRegression(num_rffs=num_rffs, kernel_choice=kernel,
                             kernel_settings=settings or {}, verbose=False,
                             **kw)
    model.set_hyperparams(hparams, dset)
    return model, dset


CASES = [("RBF", None, EASY_HPARAMS), ("RBF", None, HARD_HPARAMS),
         ("Matern", {"matern_nu": 1.5}, EASY_HPARAMS),
         ("Conv1dRBF", {"conv_width": 9, "averaging": "sqrt"},
          np.log(np.array([0.3, 0.05])))]


@pytest.mark.parametrize("kernel,settings,hparams", CASES,
                         ids=["rbf", "rbf-hard", "matern", "conv1drbf"])
def test_nmll_matches_jax(tab, seq, kernel, settings, hparams):
    arrays = seq if kernel.startswith("Conv") else tab
    got, want = [], []
    for pkg, out in ((xgpr_tpu_torch, got), (xgpr_tpu, want)):
        model, dset = _model(pkg, arrays, kernel, settings, hparams=hparams)
        out.append(model.exact_nmll(hparams, dset))
        out.append(model.approximate_nmll(hparams, dset,
                                          manual_settings={"max_rank": 64}))
        out.append(model.approximate_nmll(hparams, dset))
        out.append(model._nmll_rank_cache[1])
    np.testing.assert_allclose(got, want, rtol=RTOL)
    exact, approx_manual, approx_amortized, _ = got
    assert abs(approx_manual - exact) < 0.01 * abs(exact)
    assert abs(approx_amortized - exact) < 0.01 * abs(exact)


@pytest.mark.parametrize("hparams", [EASY_HPARAMS, HARD_HPARAMS],
                         ids=["easy", "hard"])
def test_slq_within_one_percent_at_1024_rffs(tab, hparams):
    model, dset = _model(xgpr_tpu_torch, tab, num_rffs=1024, hparams=hparams)
    exact = model.exact_nmll(hparams, dset)
    approx = model.approximate_nmll(hparams, dset,
                                    manual_settings={"max_rank": 256})
    assert abs(approx - exact) / abs(exact) < 0.01


def test_streaming_engine_gives_the_stacked_nmll(tab):
    from xgpr_tpu_torch import config
    model, dset = _model(xgpr_tpu_torch, tab)
    stacked = model.approximate_nmll(EASY_HPARAMS, dset)
    limit = config.stacked_element_limit()
    config.set_stacked_limit(1)
    try:
        model, dset = _model(xgpr_tpu_torch, tab)
        streamed = model.approximate_nmll(EASY_HPARAMS, dset)
        assert model._engine(dset).mode == "streaming"
    finally:
        config.set_stacked_limit(limit)
    assert streamed == pytest.approx(stacked, rel=1e-10)


# ---------------------------------------------------------------------------
# The rank cache (mirrors tests/approximate_nmll_tests/test_amortized_autoselect.py)
def test_rank_cache_hit_stays_within_one_percent(tab):
    model, dset = _model(xgpr_tpu_torch, tab, num_rffs=1024)
    assert model._nmll_rank_cache is None
    approx_a = model.approximate_nmll(EASY_HPARAMS, dset)
    token, rank = model._nmll_rank_cache
    assert token == ("uid", dset.get_uid())
    approx_b = model.approximate_nmll(NEARBY_HPARAMS, dset)
    assert model._nmll_rank_cache[0] == token
    for approx, h in ((approx_a, EASY_HPARAMS), (approx_b, NEARBY_HPARAMS)):
        exact = model.exact_nmll(h, dset)
        assert abs(approx - exact) / abs(exact) < 0.01
    fresh, fdset = _model(xgpr_tpu_torch, tab, num_rffs=1024,
                          hparams=NEARBY_HPARAMS)
    approx_fresh = fresh.approximate_nmll(NEARBY_HPARAMS, fdset)
    assert abs(approx_b - approx_fresh) / abs(approx_fresh) < 0.01


def test_manual_settings_bypass_the_cache(tab):
    model, dset = _model(xgpr_tpu_torch, tab)
    model.approximate_nmll(EASY_HPARAMS, dset,
                           manual_settings={"max_rank": 64})
    assert model._nmll_rank_cache is None


def test_kernel_rebuild_drops_the_cache(tab):
    model, dset = _model(xgpr_tpu_torch, tab)
    model.approximate_nmll(EASY_HPARAMS, dset)
    assert model._nmll_rank_cache is not None
    model.num_rffs = 512
    assert model._nmll_rank_cache is None


def test_cache_is_keyed_by_dataset(tab):
    model, dset = _model(xgpr_tpu_torch, tab)
    model.approximate_nmll(EASY_HPARAMS, dset)
    token_a, _ = model._nmll_rank_cache
    rng = np.random.default_rng(7)
    other = xgpr_tpu_torch.build_regression_dataset(
        rng.standard_normal((500, tab[0].shape[1])),
        rng.standard_normal(500), chunk_size=300)
    approx_other = model.approximate_nmll(EASY_HPARAMS, other)
    assert model._nmll_rank_cache[0] != token_a
    fresh, _ = _model(xgpr_tpu_torch, tab)
    fresh.set_hyperparams(EASY_HPARAMS, other)
    assert approx_other == pytest.approx(
        fresh.approximate_nmll(EASY_HPARAMS, other), rel=0.01)


def test_cache_hit_grows_until_the_ratio_is_met(tab, monkeypatch):
    model, dset = _model(xgpr_tpu_torch, tab, num_rffs=1030)
    token = model._dataset_token(dset)
    model._nmll_rank_cache = (token, 128)
    built = []
    real = baseclass.NystromPreconditioner

    class Recording(real):
        def __init__(self, engine, max_rank, *a, **k):
            built.append(max_rank)
            super().__init__(engine, max_rank, *a, **k)

    monkeypatch.setattr(baseclass, "NystromPreconditioner", Recording)
    precond = model._amortized_nmll_preconditioner(dset, ratio_target=-1.0)
    assert built == [128, 640, 1029]
    assert precond.get_rank() == 1029
    assert model._nmll_rank_cache == (token, 1029)


# ---------------------------------------------------------------------------
# What becomes the penalty score, and what raises
def _raise(exc):
    def fn(*args, **kwargs):
        raise exc
    return fn


def test_numerical_failure_becomes_the_penalty_score(tab, monkeypatch):
    from xgpr_tpu_torch.scoring import slq
    model, dset = _model(xgpr_tpu_torch, tab)
    model.approximate_nmll(EASY_HPARAMS, dset)
    monkeypatch.setattr(slq, "estimate_logdet", _raise(
        FloatingPointError("SLQ: no usable probe sequences.")))
    with pytest.warns(UserWarning, match="Numerical failure"):
        score = model.approximate_nmll(EASY_HPARAMS, dset)
    assert score == constants.DEFAULT_SCORE_IF_PROBLEM
    assert model._nmll_rank_cache is None


@pytest.mark.parametrize("where", ["matvec", "feature map"])
def test_kernel_launch_error_propagates(tab, monkeypatch, where):
    """A kernel that fails to launch raises out of approximate_nmll (on the
    card ops/cuda/build.check raises this RuntimeError); it must not turn
    into the penalty score and let a tuner carry on."""
    from xgpr_tpu_torch.kernels import basic
    error = RuntimeError("ztzv kernel: CUDA error 700 at launch")
    model, dset = _model(xgpr_tpu_torch, tab)
    if where == "matvec":
        # K1's wrapper, as the stacked solver calls it.
        monkeypatch.setattr(basic, "ztzv_parts", _raise(error))
    else:
        monkeypatch.setattr(basic, "fused_feature_map", _raise(error))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        model.approximate_nmll(EASY_HPARAMS, dset)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        model.tune_hyperparams(dset, tuning_method="Powell", max_iter=3,
                               nmll_method="approximate")
