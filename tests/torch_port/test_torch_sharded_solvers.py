"""The port's sharded solvers and models on a 2-rank gloo job on the CPU,
in float64, against the port's and xgpr_tpu's one-process runs.

One job (tests/torch_port/scale_out_jobs.py ``job_solvers``) serves the
session.  The M-sharded CG against the replicated one at
tests/parallel_tests/test_msharded_cg.py's tolerances: rtol 1e-8 for the
weights and SLQ's alphas and betas, 1e-7 for the iterates.  The looped CG
against the fused one.  Streamed sharded fits on an unequal split (5
chunks against 3) and a ragged one (each rank's sequences cut to its own
longest) against the one-process fit: iterations within one, weights
within 1e-6 x max|w| (float64 sums in another order).  The models' entry
points on a sharded engine: the exact fit, the exact NMLL and its
gradient against xgpr_tpu at 1e-9, the CG fit, SLQ, the crude tune and
the classifier against the port's one-process runs.
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from tests.torch_port import scale_out_jobs as jobs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return jobs.shared_job("solvers", tmp_path_factory)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_msharded_matches_replicated_fit(ranks):
    (w_off, n_off), (w_on, n_on) = ranks[0]["fit off"], ranks[0]["fit on"]
    assert n_off == n_on
    np.testing.assert_allclose(w_on, w_off, rtol=1e-8, atol=1e-10)
    assert not ranks[0]["auto_m_sharding"]      # 512 RFFs: below 32768


def test_msharded_slq_coefficients_match(ranks):
    x_on, a_on, b_on = ranks[0]["slq on"]
    x_off, a_off, b_off = ranks[0]["slq off"]
    assert a_on.shape == a_off.shape
    np.testing.assert_allclose(a_on, a_off, rtol=1e-8)
    np.testing.assert_allclose(b_on, b_off, rtol=1e-8)
    np.testing.assert_allclose(x_on, x_off, rtol=1e-7, atol=1e-9)


def test_msharded_no_preconditioner(ranks):
    x_on, _, n_on = ranks[0]["plain on"]
    x_off, _, n_off = ranks[0]["plain off"]
    assert n_on == n_off
    np.testing.assert_allclose(x_on, x_off, rtol=1e-7, atol=1e-9)


def test_looped_matches_fused(ranks):
    (w_loop, n_loop), (w_fused, n_fused) = ranks[0]["fit looped"], \
        ranks[0]["fit off"]
    assert n_loop == n_fused
    assert _rel(w_loop, w_fused) < 1e-8


def test_every_rank_holds_the_same_solution(ranks):
    for key in ("fit on", "slq on", "unequal", "ragged", "cg_fit"):
        for a, b in zip(ranks[0][key], ranks[1][key]):
            assert np.array_equal(np.asarray(a), np.asarray(b)), key


@pytest.mark.parametrize("split", ["unequal", "ragged"])
def test_streamed_split_matches_single_fit(ranks, split):
    if split == "unequal":
        model, d = jobs.rbf_model(xgpr_tpu_torch, (0, 800), rffs=256,
                                  chunk=100, device="cpu", n=800)
    else:
        model, d = jobs.conv_model(xgpr_tpu_torch, (0, 320), device="cpu")
    n_iter = model.fit(d, tol=1e-8, run_diagnostics=True)[0]
    got = ranks[0][split]
    assert got[2] == "StreamingShardedEngine"
    assert abs(got[0] - n_iter) <= 1
    assert _rel(got[1], model.weights.numpy()) < 1e-6
    if split == "ragged":
        assert got[3] == 5                     # rank 0's 5 chunks of 40


@pytest.fixture(scope="module")
def single():
    """The port's and xgpr_tpu's one-process models on all 1600 rows."""
    port, d = jobs.rbf_model(xgpr_tpu_torch, (0, 1600), rffs=256,
                             device="cpu")
    jax_model, jd = jobs.rbf_model(xgpr_tpu, (0, 1600), rffs=256)
    return port, d, jax_model, jd


def test_models_route_to_the_sharded_engine(ranks):
    assert ranks[0]["engine_kind"] == "ShardedEngine"


def test_exact_fit_and_nmll_match_xgpr_tpu(ranks, single):
    _, _, jm, jd = single
    jm.fit(jd, mode="exact")
    w, var = ranks[0]["exact_fit"]
    assert _rel(w, np.asarray(jm.weights)) < 1e-9
    assert _rel(var, np.asarray(jm.var)) < 1e-9
    want = jm.exact_nmll(jobs.HPARAMS, jd)
    assert abs(ranks[0]["exact_nmll"] - want) < 1e-9 * abs(want)
    score, grad = ranks[0]["nmll_gradient"]
    want_score, want_grad = jm.exact_nmll_gradient(jobs.HPARAMS, jd)
    assert abs(score - want_score) < 1e-9 * abs(want_score)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-9, atol=1e-12)


def test_cg_fit_slq_and_tune_match_single(ranks, single):
    port, d, _, _ = single
    n_iter = port.fit(d, tol=1e-8, run_diagnostics=True)[0]
    got_iter, got_w = ranks[0]["cg_fit"]
    assert abs(got_iter - n_iter) <= 1
    assert _rel(got_w, port.weights.numpy()) < 1e-6
    want = port.approximate_nmll(jobs.HPARAMS, d)
    assert abs(ranks[0]["approximate_nmll"] - want) < 1e-8 * abs(want)
    hp, n_eval, best = port.tune_hyperparams_crude(d, max_bayes_iter=3)
    got_hp, got_n, got_best = ranks[0]["crude_tune"]
    assert got_n == n_eval
    np.testing.assert_allclose(got_hp, hp, rtol=1e-8)
    assert abs(got_best - best) < 1e-8 * abs(best)


def test_classifier_fit_matches_single(ranks):
    model, d = jobs.class_model(xgpr_tpu_torch, (0, 900), device="cpu")
    model.fit(d, tol=1e-6)
    w, probs = ranks[0]["classifier"]
    assert _rel(w, model.weights.numpy()) < 1e-6
    want = model.predict(jobs.class_data()[0][:64])
    np.testing.assert_allclose(probs, want, rtol=0, atol=1e-8)
