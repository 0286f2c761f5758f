"""The exported predict fn under torch.compile and torch.func.vmap, in
float64 on the CPU, and the three custom operators it reaches
(K2 ``rbf_feature_map``, K3 ``conv_parts``, K4 ``conv_maxpool``).

``torch.compile(fn, fullgraph=True, backend="aot_eager")`` traces through
the operators' fake implementations and must give fn's numbers; vmap
over a stacked batch of x (and of the lengths) goes through their
batching rules and must give fn's on the rows in order, as xgpr_tpu's
export is held under jax.jit and jax.vmap
(tests/api_tests/test_export_predict.py).  Equal to 1e-12 of max|pred|:
the operators run the same plain versions on the same rows.
``torch.library.opcheck`` checks each operator's registration.
"""
import numpy as np
import pytest
import torch

import xgpr_tpu_torch
from xgpr_tpu_torch.ops.cuda import conv, feature_map
from tests.utils.synthetic import (classification_data, sequence_data,
                                   tabular_data)

torch.set_num_threads(1)

HPARAMS = np.array([-1.7908995, -3.9549678])
BATCH = 4
RTOL = 1e-12


def _fitted(kind):
    if kind in ("Conv1dRBF", "Conv1dTwoLayer"):
        (trx, tr_y, trl), (tex, _, tel) = sequence_data(n_train=300,
                                                        n_test=60)
        settings = {"conv_width": 5}
        if kind == "Conv1dTwoLayer":
            settings["init_rffs"] = 64
        data = xgpr_tpu_torch.build_regression_dataset(trx, tr_y, trl,
                                                       chunk_size=200)
        test = (torch.as_tensor(tex), torch.as_tensor(tel,
                                                      dtype=torch.int32))
    elif kind == "classifier":
        (trx, tr_y), (tex, _) = classification_data(n_train=600, n_test=60)
        data = xgpr_tpu_torch.build_classification_dataset(trx, tr_y,
                                                           chunk_size=200)
        test = (torch.as_tensor(tex), None)
        model = xgpr_tpu_torch.GPClassification(
            num_rffs=128, device="cpu", verbose=False)
        model.set_hyperparams(np.log(np.array([0.3, 0.2])), data)
        model.fit(data)
        return model.export_predict_fn(), test
    else:
        (trx, tr_y), (tex, _) = tabular_data(n_train=600, n_test=60,
                                             n_features=12)
        settings = None
        data = xgpr_tpu_torch.build_regression_dataset(trx, tr_y,
                                                       chunk_size=200)
        test = (torch.as_tensor(tex), None)
    model = xgpr_tpu_torch.GPRegression(
        num_rffs=128, variance_rffs=8, kernel_choice=kind.split("+")[0],
        kernel_settings=settings, device="cpu", verbose=False)
    model.set_hyperparams(HPARAMS, data)
    model.fit(data, mode="exact")
    return model.export_predict_fn(get_var=kind == "RBF+var"), test


def _close(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
        return
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= RTOL * scale


KINDS = ["RBF+var", "RBF", "Conv1dRBF", "Conv1dTwoLayer", "classifier"]


@pytest.fixture(scope="module")
def exports():
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _fitted(kind)
        return cache[kind]
    return get


@pytest.mark.parametrize("kind", KINDS)
def test_compiled_export_matches_fn(exports, kind):
    (fn, state), (x, lengths) = exports(kind)
    torch._dynamo.reset()
    compiled = torch.compile(fn, fullgraph=True, backend="aot_eager")
    _close(compiled(state, x, lengths), fn(state, x, lengths))


@pytest.mark.parametrize("kind", KINDS)
def test_vmapped_export_matches_fn(exports, kind):
    (fn, state), (x, lengths) = exports(kind)
    want = fn(state, x, lengths)
    xs = x.reshape((BATCH, -1) + tuple(x.shape[1:]))
    if lengths is None:
        got = torch.func.vmap(lambda xb: fn(state, xb))(xs)
    else:
        got = torch.func.vmap(lambda xb, lb: fn(state, xb, lb))(
            xs, lengths.reshape(BATCH, -1))

    def flat(t):
        return t.reshape((-1,) + tuple(t.shape[2:]))
    _close(tuple(map(flat, got)) if isinstance(got, tuple) else flat(got),
           want)


def _op_cases():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((6, 5)))
    proj = torch.as_tensor(rng.standard_normal((5, 8)))
    xs = torch.as_tensor(rng.standard_normal((6, 7, 3)))
    lengths = torch.tensor([7, 5, 3, 7, 4, 6], dtype=torch.int32)
    p3 = torch.as_tensor(rng.standard_normal((9, 8)))
    scale = torch.linspace(0.5, 2.0, 6, dtype=torch.float64)
    return [
        (feature_map._rbf_feature_map_op, (x, proj, True, 4, "hi",
                                           "highest")),
        (conv._conv_parts_op, (xs, lengths, p3, 0.7, 3, scale, "hi",
                               "highest")),
        (conv._conv_parts_op, (xs, lengths, p3, 0.7, 3, None, "hi",
                               "highest")),
        (conv._conv_maxpool_op, (xs, lengths, p3, 3, "highest"))]


@pytest.mark.parametrize("case", range(4))
def test_custom_ops_register_cleanly(case):
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)


def test_vmap_over_projections_is_refused():
    _, (x, proj, *_) = _op_cases()[0]
    with pytest.raises(NotImplementedError):
        torch.func.vmap(lambda p: feature_map.rbf_feature_map(
            x, p, True, 4))(proj.expand(2, *proj.shape))


@pytest.mark.parametrize("preset,precision", [
    ("balanced", "high"), ("reference", "highest"), ("max", "default")])
def test_rbf_export_at_each_precision_compiles_and_vmaps(preset, precision):
    """Slice A's RBF export, in float32 under each preset: its feature fn
    hands K2 the preset's feature precision as a plain string, and the fn
    still compiles (fullgraph) and vmaps to its own numbers."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from xgpr_tpu_torch import config
    (trx, tr_y), (tex, _) = tabular_data(n_train=400, n_test=40,
                                         n_features=12)
    config.set_speed_preset(preset)
    try:
        with config.working_dtype(torch.float32):
            data = xgpr_tpu_torch.build_regression_dataset(trx, tr_y,
                                                           chunk_size=200)
            model = xgpr_tpu_torch.GPRegression(
                num_rffs=128, kernel_choice="RBF", device="cpu",
                verbose=False)
            model.set_hyperparams(HPARAMS, data)
            model.fit(data, mode="exact")
            fn, state = model.export_predict_fn()
            x = torch.as_tensor(tex, dtype=torch.float32)
            want = fn(state, x)
            op = torch.ops.xgpr_tpu_torch.rbf_feature_map.default
            graph = make_fx(lambda xb: fn(state, xb))(x).graph
            assert [n.args[-1] for n in graph.nodes if n.target is op] == \
                [precision]
            torch._dynamo.reset()
            compiled = torch.compile(fn, fullgraph=True, backend="aot_eager")
            _close(compiled(state, x), want)
            got = torch.func.vmap(lambda xb: fn(state, xb))(
                x.reshape(BATCH, -1, x.shape[1]))
            _close(got.reshape(want.shape), want)
    finally:
        config.set_speed_preset("balanced")
