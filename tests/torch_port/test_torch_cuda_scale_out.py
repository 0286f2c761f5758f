"""The scale-out layer on the card: NCCL at world size 1 and two gloo
ranks sharing one device, at small shapes, with the collectives on CUDA
tensors; the compiled and vmapped export and the custom operators there.

Needs a CUDA device and nvcc; skips without them.  Imports nothing of
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/torch_port/test_torch_cuda_scale_out.py

- NCCL at world size 1: the sharded fit, its preconditioner and SLQ
  equal the single engine's bitwise (an all-reduce over one rank is the
  identity).
- Two gloo ranks (tests/torch_port/scale_out_jobs.py, each rank on card
  0 with half the rows): the reductions against the single engine on the
  card at rtol 1e-9 (the same float32 chunk features, float64 sums in
  another order); the M-sharded CG against the replicated one at 1e-6
  (K1 takes the direction rounded to float32, so iterates that differ in
  their last float64 bits now and then round to neighbouring float32
  values: 1.3e-8 seen on SLQ's alphas, above the CPU tests' float64
  1e-8); the streamed unequal and ragged splits against the one-process
  streamed fit, the same solver on the same float32 features (1e-6 x
  max|w|).
- ``torch.compile(fullgraph=True)`` (inductor) and ``torch.func.vmap`` of
  the exported fns against the fn within 1e-6 x max|pred| (float32
  features, the same kernels), and ``torch.library.opcheck`` of K2, K3
  and K4 on CUDA tensors.
"""
import numpy as np
import pytest
import torch

import xgpr_tpu_torch
from xgpr_tpu_torch import config
from xgpr_tpu_torch.fitting.engine import Engine
from xgpr_tpu_torch.ops.cuda import build, conv, feature_map
from xgpr_tpu_torch.parallel import ShardedEngine
from xgpr_tpu_torch.parallel.distributed import initialize_distributed
from xgpr_tpu_torch.utils.rng import srht_state
from tests.torch_port import scale_out_jobs as jobs

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    build.library()          # the ranks load this build, never build
    return torch.device("cuda")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_nccl_world_of_one_is_the_single_engine(cuda):
    initialize_distributed(f"127.0.0.1:{jobs.free_port()}", 1, 0)
    try:
        assert torch.distributed.get_backend() == "nccl"
        model, d = jobs.rbf_model(xgpr_tpu_torch, (0, 4096), rffs=1024,
                                  chunk=1024, device="cuda", n=4096)
        runs = []
        for mode in ("single", "sharded"):
            config.set_engine_mode(mode)
            n_iter = model.fit(d, tol=1e-6, run_diagnostics=True)[0]
            runs.append((type(model._engine(d)), n_iter,
                         model.weights.clone(),
                         model.approximate_nmll(jobs.HPARAMS, d)))
    finally:
        config.set_engine_mode("auto")
        torch.distributed.destroy_process_group()
    (k1, n1, w1, s1), (k2, n2, w2, s2) = runs
    assert (k1, k2) == (Engine, ShardedEngine)
    assert n1 == n2 and torch.equal(w1, w2) and s1 == s2


@pytest.fixture(scope="module")
def reductions(cuda):
    return jobs.run_job("reductions", device="cuda")


@pytest.mark.parametrize("key", ["ztzv", "design_mat", "sketch",
                                 "gradient_terms", "conv_ztzv"])
def test_two_ranks_on_one_card_match_the_single_engine(reductions, key):
    if key == "conv_ztzv":
        model, d = jobs.conv_model(xgpr_tpu_torch, (0, 320), device="cuda")
        want = Engine(model.kernel, d).ztzv(jobs.probe_vectors(128, 2, 5))
    else:
        model, d = jobs.rbf_model(xgpr_tpu_torch, (0, 1600), device="cuda")
        engine = Engine(model.kernel, d)
        radem, idx = srht_state(42, 512, 128, np.float64)
        want = {"ztzv": lambda: engine.ztzv(jobs.probe_vectors(512, 3, 0)),
                "design_mat": engine.design_mat,
                "sketch": lambda: engine.sketch(radem, idx),
                "gradient_terms": engine.gradient_terms}[key]()
    got = reductions[0][key]
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, tuple) else [want]):
        w = w.cpu().numpy() if torch.is_tensor(w) else np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max())


@pytest.fixture(scope="module")
def solvers(cuda):
    return jobs.run_job("solvers", device="cuda")


def test_two_ranks_msharded_matches_replicated(solvers):
    r = solvers[0]
    assert r["fit on"][1] == r["fit off"][1]
    assert _rel(r["fit on"][0], r["fit off"][0]) < 1e-6
    for got, want in zip(r["slq on"], r["slq off"]):
        assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("split", ["unequal", "ragged"])
def test_two_ranks_streamed_split_matches_single_fit(solvers, split):
    if split == "unequal":
        model, d = jobs.rbf_model(xgpr_tpu_torch, (0, 800), rffs=256,
                                  chunk=100, device="cuda", n=800)
    else:
        model, d = jobs.conv_model(xgpr_tpu_torch, (0, 320), device="cuda")
    limit = config.stacked_element_limit()
    config.set_stacked_limit(1)
    try:
        n_iter = model.fit(d, tol=1e-8, run_diagnostics=True)[0]
    finally:
        config.set_stacked_limit(limit)
    got = solvers[0][split]
    assert got[2] == "StreamingShardedEngine"
    assert abs(got[0] - n_iter) <= 1
    assert _rel(got[1], model.weights.cpu().numpy()) < 1e-6


def _exported(kind):
    if kind == "Conv1dRBF":
        model, d = jobs.conv_model(xgpr_tpu_torch, (0, 320), device="cuda")
        x, _, lengths = jobs.conv_data(400)
        args = (torch.as_tensor(x[320:], dtype=torch.float32, device="cuda"),
                torch.as_tensor(lengths[320:], dtype=torch.int32,
                                device="cuda"))
    else:
        model, d = jobs.rbf_model(xgpr_tpu_torch, (0, 1600), rffs=1024,
                                  device="cuda", n=1680)
        x, _ = jobs.rbf_data(1680)
        args = (torch.as_tensor(x[1600:], dtype=torch.float32,
                                device="cuda"), None)
    model.fit(d, tol=1e-6)
    fn, state = model.export_predict_fn(get_var=kind == "RBF")
    return fn, state, args


def _close(got, want, rtol=1e-6):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= rtol * float(w.abs().max())


@pytest.mark.parametrize("kind", ["RBF", "Conv1dRBF"])
def test_compiled_and_vmapped_export_on_card(cuda, kind):
    fn, state, (x, lengths) = _exported(kind)
    want = fn(state, x, lengths)
    torch._dynamo.reset()
    launches = feature_map.LAUNCHES.total() + conv.PARTS_LAUNCHES.total()
    _close(torch.compile(fn, fullgraph=True)(state, x, lengths), want)
    assert feature_map.LAUNCHES.total() + conv.PARTS_LAUNCHES.total() > \
        launches
    xs = x.reshape((4, -1) + tuple(x.shape[1:]))
    if lengths is None:
        got = torch.func.vmap(lambda xb: fn(state, xb))(xs)
    else:
        got = torch.func.vmap(lambda xb, lb: fn(state, xb, lb))(
            xs, lengths.reshape(4, -1))
    flat = (lambda t: t.reshape((-1,) + tuple(t.shape[2:])))
    _close(tuple(map(flat, got)) if isinstance(got, tuple) else flat(got),
           want)


def test_custom_ops_on_card(cuda):
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device="cuda")
    x, proj = t(rng.standard_normal((300, 20))), t(rng.standard_normal(
        (20, 256)) * 0.5)
    xs = t(rng.standard_normal((300, 12, 8)))
    lengths = t(rng.integers(5, 13, 300), torch.int32)
    p3 = t(rng.standard_normal((40, 256)) * 0.3)
    for op, args in (
            (feature_map._rbf_feature_map_op, (x, proj, True, 16, "hi",
                                               "high")),
            (conv._conv_parts_op, (xs, lengths, p3, 0.7, 5, None, "hi",
                                   "high")),
            (conv._conv_maxpool_op, (xs, lengths, p3, 5, "high"))):
        torch.library.opcheck(op, args)
