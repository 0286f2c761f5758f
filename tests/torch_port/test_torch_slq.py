"""SLQ's pieces in the port against xgpr_tpu, both in float64 on the CPU:
the CG coefficients that PCG records for the probes (stacked and
streaming engines), the logdet estimate from them, the preconditioner's
logdet and square root, and the alpha/beta optimiser.

Same data, seed, preconditioner and probes on both sides, so the CG runs
take the same number of iterations and every coefficient agrees to 1e-10
relative (the sums run in another order); the closed-form pieces agree
to 1e-12.
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from xgpr_tpu.fitting.cg import ConjugateGrad as JaxCG
from xgpr_tpu.fitting.engine import Engine as JaxEngine
from xgpr_tpu.preconditioners.nystrom import \
    NystromPreconditioner as JaxPrecond
from xgpr_tpu.scoring.alpha_beta import optimize_alpha_beta as jax_ab
from xgpr_tpu.scoring.slq import estimate_logdet as jax_logdet
from xgpr_tpu.utils import rng as jax_rng
from xgpr_tpu_torch.fitting.cg import ConjugateGrad
from xgpr_tpu_torch.fitting.engine import Engine
from xgpr_tpu_torch.preconditioners.nystrom import NystromPreconditioner
from xgpr_tpu_torch.scoring.alpha_beta import optimize_alpha_beta
from xgpr_tpu_torch.scoring.slq import estimate_logdet
from tests.utils.synthetic import tabular_data

torch.set_num_threads(1)

HPARAMS = np.array([-1.7908995, -3.9549678])
NUM_RFFS, RANK, NSAMPLES = 256, 64, 6


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def setup():
    """(port engine, preconditioner), (xgpr_tpu's), per engine mode, and
    the rhs: Z^T y / N and N(0, P) probes."""
    (trx, tr_y), _ = tabular_data(n_train=600)
    out = {}
    for mode in ("stacked", "streaming"):
        sides = []
        for pkg, eng_cls, pre_cls, kw in (
                (xgpr_tpu_torch, Engine, NystromPreconditioner,
                 {"device": "cpu"}),
                (xgpr_tpu, JaxEngine, JaxPrecond, {})):
            dset = pkg.build_regression_dataset(trx, tr_y, chunk_size=200)
            model = pkg.GPRegression(num_rffs=NUM_RFFS, kernel_choice="RBF",
                                     verbose=False, **kw)
            model.set_hyperparams(HPARAMS, dset)
            engine = eng_cls(model.kernel, dset, mode=mode)
            sides.append((engine, pre_cls(engine, RANK, False, 123,
                                          "srht_2")))
        out[mode] = sides
    return out


def _rhs(engine, precond, as_tensor):
    probes = jax_rng.normal_probes(123, NUM_RFFS, NSAMPLES)
    if as_tensor:
        probes = precond.matvec_for_sampling(torch.as_tensor(probes))
        zty = precond.get_zty()
        return torch.cat([zty[:, None] / engine.ndatapoints, probes], dim=1)
    probes = np.asarray(precond.matvec_for_sampling(probes))
    zty = np.asarray(precond.get_zty())
    return np.concatenate([zty[:, None] / engine.ndatapoints, probes], 1)


@pytest.mark.parametrize("mode", ["stacked", "streaming"])
def test_cg_coefficients_match_jax(setup, mode):
    (te, tp), (je, jp) = setup[mode]
    assert te.mode == mode and je.mode == mode
    lam = te.kernel.get_lambda()
    tx, ta, tb = ConjugateGrad(te).fit(_rhs(te, tp, True), lam, tp, 500,
                                       1e-6, nmll_settings=True)
    jx, ja, jb = JaxCG(je).fit(_rhs(je, jp, False), lam, jp, 500, 1e-6,
                               verbose=False, nmll_settings=True)
    assert ta.shape == ja.shape and ta.shape[1] == NSAMPLES
    assert ta.dtype == torch.float64
    _close(ta, ja, 1e-10)
    _close(tb, jb, 1e-10)
    _close(tx, jx, 1e-10)
    # estimate_logdet takes the coefficients as tensors or arrays.
    want = jax_logdet(ja, jb, NUM_RFFS, jp)
    for a, b in ((ta, tb), (ta.numpy(), tb.numpy())):
        assert estimate_logdet(a, b, NUM_RFFS, tp) == \
            pytest.approx(want, rel=1e-10)


def test_preconditioner_slq_pieces_match_jax(setup):
    (_, tp), (_, jp) = setup["stacked"]
    assert tp.get_rank() == jp.get_rank() == RANK
    assert tp.get_logdet() == pytest.approx(jp.get_logdet(), rel=1e-12)
    assert tp.get_yty() == pytest.approx(jp.get_yty(), rel=1e-12)
    v = np.random.default_rng(3).standard_normal((NUM_RFFS, 4))
    for name in ("matvec_for_sampling", "rev_batch_matvec", "batch_matvec"):
        _close(getattr(tp, name)(torch.as_tensor(v)),
               getattr(jp, name)(v), 1e-12)
    # P (P^{1/2} v) (P^{1/2} w) consistency: P^{1/2} P^{1/2} == P.
    half = tp.matvec_for_sampling(tp.matvec_for_sampling(torch.as_tensor(v)))
    _close(half, tp.rev_batch_matvec(torch.as_tensor(v)), 1e-12)


def test_estimate_logdet_on_synthetic_coefficients():
    """Truncation at the first non-positive alpha, a length-1 sequence, a
    probe with none, and the no-usable-probe failure."""
    rng = np.random.default_rng(5)
    alphas = rng.uniform(0.5, 2.0, (12, 5))
    betas = rng.uniform(0.0, 0.8, (12, 5))
    alphas[7:, 1] = 0.0
    alphas[1:, 2] = 0.0
    alphas[:, 3] = 0.0
    assert estimate_logdet(alphas, betas, 100) == pytest.approx(
        jax_logdet(alphas, betas, 100), rel=1e-12)
    with pytest.raises(FloatingPointError):
        estimate_logdet(np.zeros((3, 2)), np.zeros((3, 2)), 10)


@pytest.mark.parametrize("terms,n,m", [((40.0, 12.5), 600, 256),
                                       ((1e-3, -3.0), 50, 10),
                                       ((5e4, 900.0), 1000, 64)])
@pytest.mark.parametrize("lam", [0.05, 0.7, 3.0])
def test_optimize_alpha_beta_matches_jax(terms, n, m, lam):
    got = optimize_alpha_beta(lam, np.array(terms), n, m)
    want = jax_ab(lam, np.array(terms), n, m)
    np.testing.assert_allclose(got, want, rtol=1e-12)
