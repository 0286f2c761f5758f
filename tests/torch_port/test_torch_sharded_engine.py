"""The port's ShardedEngine on a 2-rank gloo job on the CPU against
xgpr_tpu's ShardedEngine on the 8-device CPU mesh (tests/conftest.py) and
its single Engine, in float64.

One job (tests/torch_port/scale_out_jobs.py ``job_reductions``) serves
the session (``shared_job``): each rank holds half the rows.  Every
reduction is held at rtol 1e-9, as
tests/parallel_tests/test_sharded_engine.py holds xgpr_tpu's mesh against
its single engine; the row-subsampled sketch and gradient terms against
the sum of one engine per half (each rank draws from its own stream);
the CG fit at xgpr_tpu's 1e-6.  Both ranks must
return the same bits: the loop that reads a flag on the host relies on
it.  Also global_host_reduce, the class count agreed over ranks and the
engine selection with unequal ranks.
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
from xgpr_tpu.fitting.cg import cg_fit
from xgpr_tpu.fitting.engine import Engine
from xgpr_tpu.parallel import ShardedEngine, data_mesh
from xgpr_tpu.preconditioners.nystrom import NystromPreconditioner
from xgpr_tpu.utils.rng import srht_state
from tests.torch_port import scale_out_jobs as jobs

torch.set_num_threads(1)

RTOL = 1e-9


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return jobs.shared_job("reductions", tmp_path_factory)


@pytest.fixture(scope="module")
def rbf():
    model, d = jobs.rbf_model(xgpr_tpu, (0, 1600))
    return (model, Engine(model.kernel, d),
            ShardedEngine(model.kernel, d, data_mesh(8)))


def _close(got, want, rtol=RTOL):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()))


def _equal(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_equal, a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def _same_on_every_rank(ranks, key):
    for other in ranks[1:]:
        assert _equal(ranks[0][key], other[key]), key


@pytest.mark.parametrize("key", ["ztzv", "gauss_pass", "design_mat", "zty",
                                 "var_design_mat", "sketch",
                                 "gradient_terms"])
def test_reduction_matches_single_and_mesh(ranks, rbf, key):
    model, single, mesh = rbf
    q = np.linalg.qr(jobs.probe_vectors(512, 16, 4))[0]
    radem, idx = srht_state(42, 512, 128, np.float64)
    calls = {"ztzv": lambda e: e.ztzv(jobs.probe_vectors(512, 3, 0)),
             "gauss_pass": lambda e: e.gauss_pass(q),
             "design_mat": lambda e: e.design_mat(),
             "zty": lambda e: e.zty(),
             "var_design_mat": lambda e: e.var_design_mat(64),
             "sketch": lambda e: e.sketch(radem, idx, with_zty=True),
             "gradient_terms": lambda e: e.gradient_terms()}
    got = ranks[0][key]
    for engine in (single, mesh):
        _close(got, calls[key](engine))
    _same_on_every_rank(ranks, key)


def test_row_subsamples_are_per_rank(ranks):
    """Each rank subsamples its own chunks from its own stream: the sum of
    one engine per half, each with the same seed."""
    radem, idx = srht_state(42, 512, 128, np.float64)
    sketch, terms = 0.0, None
    for rank in range(2):
        model, d = jobs.rbf_model(xgpr_tpu, jobs.split(1600, rank, 2))
        engine = Engine(model.kernel, d)
        sketch = sketch + np.asarray(engine.sketch(
            radem, idx, with_zty=False, row_keep_prob=0.5, seed=7))
        part = engine.gradient_terms(subsample=0.5, seed=5)
        terms = part if terms is None else \
            [np.asarray(a) + np.asarray(b) for a, b in zip(terms, part)]
    _close(ranks[0]["sketch_sub"], sketch)
    _close(ranks[0]["gradient_terms_sub"], terms)


def test_cg_fit_matches_single(ranks, rbf):
    model, single, _ = rbf
    precond = NystromPreconditioner(single, 128, random_state=123,
                                    method="srht")
    w, n_iter, _ = cg_fit(single, precond, tol=1e-7, verbose=False)
    assert ranks[0]["cg_iter"] == n_iter
    _close(ranks[0]["cg_weights"], w, 1e-6)
    assert ranks[0]["ndatapoints"] == 1600
    _same_on_every_rank(ranks, "cg_weights")


@pytest.mark.parametrize("kind", ["conv", "ard"])
def test_sequence_and_ard_kernels(ranks, kind):
    if kind == "conv":
        model, d = jobs.conv_model(xgpr_tpu, (0, 320))
        engine = Engine(model.kernel, d)
        _close(ranks[0]["conv_ztzv"],
               engine.ztzv(jobs.probe_vectors(128, 2, 5)))
        _close(ranks[0]["conv_design_mat"], engine.design_mat())
        mesh = ShardedEngine(model.kernel, d, data_mesh(8))
        _close(ranks[0]["conv_ztzv"],
               mesh.ztzv(jobs.probe_vectors(128, 2, 5)))
    else:
        model, d = jobs.ard_model(xgpr_tpu, (0, 800))
        _close(ranks[0]["ard_ztzv"], Engine(model.kernel, d).ztzv(
            jobs.probe_vectors(256, 2, 9)))


def test_classifier_reductions(ranks):
    model, d = jobs.class_model(xgpr_tpu, (0, 900))
    engine = Engine(model.kernel, d)
    w0, dirn = jobs.class_directions(256, 3)
    _close(ranks[0]["class_loss_grad"],
           engine.classification_loss_grad(w0, 0.3))
    _close(ranks[0]["class_linesearch"],
           engine.softmax_linesearch(w0, dirn, jobs.LINESEARCH_STEPS, 0.3))
    assert ranks[0]["class_n"] == 3
    _same_on_every_rank(ranks, "class_loss_grad")


def test_global_host_reduce(ranks):
    """Sums and maxima over the two ranks, the same on both."""
    for r in ranks:
        assert r["host_reduce"] == [4.0, 10.0, 0.0]


def test_engine_selection_agrees_over_ranks(ranks):
    """A stacked limit between the ranks' sizes streams on both ranks (the
    larger load, agreed by max); "single" builds the plain Engine; "auto"
    shards over a group of two."""
    want = {f"sharded {600 * 84 - 1}": "StreamingShardedEngine",
            "sharded 1000000000": "ShardedEngine",
            "single 1000000000": "Engine",
            "auto 1000000000": "ShardedEngine"}
    for r in ranks:
        assert r["engine_kinds"] == want
