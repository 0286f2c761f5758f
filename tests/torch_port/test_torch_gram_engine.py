"""The port's GramEngine, and Engine.design_mat's float64 products.

Mirrors tests/fitting_tests/test_gram_engine.py: a run through GramEngine
is the same algorithm as a run that re-streams features, so in float64 on
the CPU its reductions equal the streaming Engine's to 1e-10 relative (the
sums run in another order), and the SLQ NMLL through either to 1e-8.  On
one float64 Gram the port's GramEngine and xgpr_tpu's agree to 1e-12, and
so do their SLQ NMLLs to 1e-8.  design_mat under a float32 working dtype
returns the float64 product of the float32 features, to 1e-12.
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from xgpr_tpu.fitting.gram_engine import GramEngine as JaxGramEngine
from xgpr_tpu.preconditioners.nystrom import \
    NystromPreconditioner as JaxPrecond
from xgpr_tpu.scoring.slq import slq_nmll_from_engine as jax_slq
from xgpr_tpu_torch import config, constants
from xgpr_tpu_torch.fitting.engine import Engine
from xgpr_tpu_torch.fitting.gram_engine import GramEngine
from xgpr_tpu_torch.preconditioners.nystrom import NystromPreconditioner
from xgpr_tpu_torch.scoring.slq import slq_nmll_from_engine
from xgpr_tpu_torch.utils import rng as state_rng
from tests.utils.synthetic import tabular_data

torch.set_num_threads(1)

HPARAMS = np.log(np.array([0.3, 1.2]))
NUM_RFFS, RANK, SEED = 128, 32, 123
NMLL = constants.DEFAULT_NMLL_PARAMS


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _model(pkg, dset, **kw):
    model = pkg.GPRegression(num_rffs=NUM_RFFS, kernel_choice="RBF",
                             variance_rffs=16, verbose=False, **kw)
    model.set_hyperparams(HPARAMS, dset)
    return model


@pytest.fixture(scope="module")
def engines():
    """The port's streaming Engine over 900 rows of 20 features in
    float64 on the CPU, and a GramEngine over its design matrix."""
    (x, y), _ = tabular_data(n_train=900, n_features=20)
    dset = xgpr_tpu_torch.build_regression_dataset(x, y, chunk_size=250)
    model = _model(xgpr_tpu_torch, dset, device="cpu")
    engine = Engine(model.kernel, dset, mode="streaming")
    gram, zty, yty = engine.design_mat()
    return model, dset, engine, GramEngine(gram, zty, yty, model.kernel,
                                           dset.get_ndatapoints())


def _sketch_state():
    return state_rng.srht_state(SEED, NUM_RFFS, RANK, np.float64)


@pytest.mark.parametrize("reduction", ["ztzv", "gauss_pass", "zty",
                                       "sketch"])
def test_gram_engine_matches_engine(engines, reduction):
    _, _, engine, gram_engine = engines
    rng = np.random.default_rng(3)
    args = {"ztzv": (rng.standard_normal(NUM_RFFS),),
            "gauss_pass": (torch.as_tensor(
                rng.standard_normal((NUM_RFFS, 7))),),
            "zty": (), "sketch": _sketch_state()}[reduction]
    got = getattr(gram_engine, reduction)(*args)
    want = getattr(engine, reduction)(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, 1e-10)


def test_gram_engine_slq_nmll_matches_engine(engines):
    model, dset, _, gram_engine = engines
    direct = model.approximate_nmll(
        HPARAMS, dset, manual_settings={"max_rank": RANK,
                                        "preconditioner_mode": "srht_2"})
    precond = NystromPreconditioner(gram_engine, RANK, False, SEED, "srht_2")
    via_gram = slq_nmll_from_engine(gram_engine, precond, SEED,
                                    NMLL["nsamples"], NMLL["nmll_iter"],
                                    NMLL["nmll_tol"])
    assert abs(via_gram - direct) / abs(direct) < 1e-8


def test_gram_engine_matches_jax(engines):
    """On one float64 Gram: the reductions agree to 1e-12 and the SLQ
    NMLL, each package's own preconditioner and solver, to 1e-8."""
    _, _, _, gram_engine = engines
    (x, y), _ = tabular_data(n_train=900, n_features=20)
    jmodel = _model(xgpr_tpu, xgpr_tpu.build_regression_dataset(
        x, y, chunk_size=250))
    gram, zty, yty = (a.numpy() if isinstance(a, torch.Tensor) else a
                      for a in gram_engine.design_mat())
    jax_engine = JaxGramEngine(gram, zty, yty, jmodel.kernel,
                               gram_engine.ndatapoints)
    vec = np.random.default_rng(4).standard_normal((NUM_RFFS, 3))
    _close(gram_engine.ztzv(vec), jax_engine.ztzv(vec), 1e-12)
    radem, idx = _sketch_state()
    _close(gram_engine.sketch(radem, idx, with_zty=False),
           jax_engine.sketch(radem, idx, with_zty=False), 1e-12)
    _close(gram_engine.zty()[0], jax_engine.zty()[0], 1e-12)

    ours = slq_nmll_from_engine(
        gram_engine, NystromPreconditioner(gram_engine, RANK, False, SEED,
                                           "srht_2"),
        SEED, NMLL["nsamples"], NMLL["nmll_iter"], NMLL["nmll_tol"])
    theirs = jax_slq(jax_engine, JaxPrecond(jax_engine, RANK, False, SEED,
                                            "srht_2"),
                     SEED, NMLL["nsamples"], NMLL["nmll_iter"],
                     NMLL["nmll_tol"])
    assert abs(ours - theirs) / abs(theirs) < 1e-8


def test_gram_engine_rejects_row_subsampling(engines):
    radem, idx = _sketch_state()
    with pytest.raises(RuntimeError):
        engines[3].sketch(radem, idx, row_keep_prob=0.1)


def test_design_mat_products_are_float64():
    """With float32 features (a float32 working dtype, as on the card) the
    design matrix is the float64 product of those features: each chunk's
    products in float64, not rounded to float32."""
    (x, y), _ = tabular_data(n_train=700, n_features=20)
    with config.working_dtype(torch.float32):
        dset = xgpr_tpu_torch.build_regression_dataset(x, y, chunk_size=300)
        model = _model(xgpr_tpu_torch, dset, device="cpu")
        assert model.kernel.dtype == torch.float32
        engine = Engine(model.kernel, dset)
        ztz, zty, yty = engine.design_mat()
        ztz32 = torch.zeros_like(ztz)
        zs, ys = [], []
        for xb, yb, lb in dset.get_chunked_data():
            zs.append(model.kernel.transform_x(xb, lb).double())
            ys.append(torch.as_tensor(yb, dtype=torch.float32).double())
            z32 = zs[-1].float()
            ztz32 += (z32.T @ z32).double()
    z, yv = torch.cat(zs), torch.cat(ys)
    assert ztz.dtype == torch.float64
    _close(ztz, z.T @ z, 1e-12)
    _close(zty, z.T @ yv, 1e-12)
    assert abs(yty - float(yv @ yv)) < 1e-12 * float(yv @ yv)
    # The float32 product is measurably further off.
    assert float((ztz32 - z.T @ z).abs().max()) > \
        1e3 * float((ztz - z.T @ z).abs().max())
