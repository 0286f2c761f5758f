"""The port's named spans (``utils/diagnostics.span``) on the CPU, in
float64, on tiny data.

Under ``torch.profiler`` a CG fit with the autoselect, an SLQ NMLL, a
Conv1dRBF predict with its variance and a Conv1dTwoLayer fit and
gradient show their ``xgpr/`` spans, each as often and nested as the
program's layers say.  With the profiler off a
span never calls into ``torch.profiler``, and the program's outputs are
the same bits with the profiler on and off.
"""
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from xgpr_tpu_torch import GPRegression, build_regression_dataset
from xgpr_tpu_torch.utils import diagnostics
from tests.utils.synthetic import sequence_data, tabular_data

torch.set_num_threads(1)

ROWS, CHUNK = 1500, 400
HPARAMS = np.log(np.array([0.3, 0.25]))
# A trial rank of 64 below a cap of 200: the autoselect checks one rank.
FIT = {"mode": "cg", "min_rank": 64, "max_rank": 200}
NMLL = {"max_rank": 64, "preconditioner_mode": "srht_2", "nsamples": 5,
        "nmll_iter": 200, "nmll_tol": 1e-6}


def _tabular():
    (x, y), (x_test, _) = tabular_data(n_train=ROWS, n_test=100,
                                       n_features=12)
    return build_regression_dataset(x, y, chunk_size=CHUNK), x_test


def _rbf(data):
    model = GPRegression(num_rffs=256, variance_rffs=32, kernel_choice="RBF",
                         device="cpu", verbose=False)
    model.set_hyperparams(HPARAMS, data)
    return model


def _profiled(fn):
    """fn's result and the ``xgpr/`` spans it opened, as (start, end,
    name) in order of their starts."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events() if e.name.startswith("xgpr/"))


def _named(spans, name):
    return [(s, e) for s, e, n in spans if n == name]


def _within(inner, outer):
    """How many of ``outer``'s intervals hold each of ``inner``'s."""
    return [sum(o0 <= s and e <= o1 for o0, o1 in outer) for s, e in inner]


def test_a_cg_fit_shows_its_spans():
    data, _ = _tabular()
    model = _rbf(data)
    (n_iter, losses), spans = _profiled(
        lambda: model.fit(data, run_diagnostics=True, **FIT))
    assert 0 < n_iter < 500 and losses[-1] < 1e-6
    iters = _named(spans, "xgpr/cg.iter")
    assert len(iters) == n_iter
    k1 = _named(spans, "xgpr/k1")
    assert len(k1) == -(-ROWS // CHUNK) * n_iter
    assert _within(k1, iters) == [1] * len(k1)
    # One flag read before the loop, then one closing each iteration.
    waits = _named(spans, "xgpr/wait.cg_flag")
    assert len(waits) == n_iter + 1
    assert [sum(_within(waits, [iv])) for iv in iters] == [1] * n_iter
    checks = _named(spans, "xgpr/precond.ratio_check")
    assert len(checks) == 1
    builds = _named(spans, "xgpr/precond.build")
    assert len(builds) == 1 and builds[0][0] > checks[0][1]
    factor = _named(spans, "xgpr/precond.factor")
    assert factor and all(n == 1 for n in _within(factor, checks + builds))
    sketches = _named(spans, "xgpr/precond.sketch")
    assert _within(sketches, checks + builds) == [1] * len(sketches)


def test_approximate_nmll_shows_the_slq_spans():
    data, _ = _tabular()
    model = _rbf(data)
    value, spans = _profiled(
        lambda: model.approximate_nmll(HPARAMS, data, manual_settings=NMLL))
    assert np.isfinite(value)
    parts = [_named(spans, f"xgpr/slq.{p}")
             for p in ("probes", "pcg", "lanczos")]
    assert [len(p) for p in parts] == [1, 1, 1]
    (probes,), (pcg,), (lanczos,) = parts
    assert probes[1] <= pcg[0] and pcg[1] <= lanczos[0]
    iters = _named(spans, "xgpr/cg.iter")
    assert iters and _within(iters, [pcg]) == [1] * len(iters)
    assert _named(spans, "xgpr/precond.power")


def test_a_conv_predict_shows_its_spans():
    (x, y, lengths), (x_test, _, lengths_test) = sequence_data(
        n_train=300, n_test=100)
    data = build_regression_dataset(x, y, lengths, chunk_size=128)
    model = GPRegression(num_rffs=128, variance_rffs=16, device="cpu",
                         kernel_choice="Conv1dRBF", verbose=False,
                         kernel_settings={"conv_width": 9})
    model.set_hyperparams(np.log(np.array([0.3, 0.05])), data)
    model.fit(data, mode="cg")
    (mean, var), spans = _profiled(lambda: model.predict(
        x_test, lengths_test, get_var=True, chunk_size=40))
    assert mean.shape == var.shape == (100,)
    predict = _named(spans, "xgpr/predict")
    assert len(predict) == 1
    chunks = 3
    for name, count in (("xgpr/predict.var", chunks),
                        ("xgpr/wait.lengths", chunks),
                        ("xgpr/wait.to_host", 2)):
        inner = _named(spans, name)
        assert _within(inner, predict) == [1] * count, name


def test_spans_make_no_profiler_call_with_tracing_off(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")
    monkeypatch.setattr(diagnostics, "record_function", refuse)
    assert diagnostics.span("xgpr/a") is diagnostics.span("xgpr/b")
    data, x_test = _tabular()
    model = _rbf(data)
    n_iter, _ = model.fit(data, run_diagnostics=True, **FIT)
    assert n_iter > 0
    assert np.all(np.isfinite(model.predict(x_test, get_var=True)[1]))
    assert np.isfinite(model.approximate_nmll(HPARAMS, data,
                                              manual_settings=NMLL))


def test_outputs_are_bit_identical_with_tracing_on_and_off():
    data, x_test = _tabular()

    def run():
        model = _rbf(data)
        model.fit(data, **FIT)
        weights = model.weights.clone()
        mean, var = model.predict(x_test, get_var=True, chunk_size=40)
        nmll = model.approximate_nmll(HPARAMS, data, manual_settings=NMLL)
        return weights, nmll, mean, var

    off = run()
    on, spans = _profiled(run)
    assert spans
    assert torch.equal(off[0], on[0])
    assert off[1] == on[1]
    np.testing.assert_array_equal(off[2], on[2])
    np.testing.assert_array_equal(off[3], on[3])


def _two_layer():
    """A Conv1dTwoLayer model on 300 ragged sequences in chunks of 128
    (three chunks), and its dataset."""
    (x, y, lengths), _ = sequence_data(n_train=300, n_test=10)
    data = build_regression_dataset(x, y, lengths, chunk_size=128)
    model = GPRegression(num_rffs=128, variance_rffs=16, device="cpu",
                         kernel_choice="Conv1dTwoLayer", verbose=False,
                         kernel_settings={"conv_width": 9, "init_rffs": 32})
    model.set_hyperparams(np.log(np.array([0.3, 0.5])), data)
    return model, data


def test_two_layer_spans_open_once_a_chunk():
    """Each chunk's feature call opens ``xgpr/twolayer.l1`` around layer
    1's K4 op and then ``xgpr/twolayer.l2`` around layer 2's K2 op, in a
    CG fit (preconditioner, iterations, variance) and in the gradient's
    feature call, with its plain SORF map in ``.l2``."""
    model, data = _two_layer()
    chunks = 3
    names = ("xgpr/twolayer.l1", "xgpr/twolayer.l2",
             "xgpr_tpu_torch::conv_maxpool",
             "xgpr_tpu_torch::rbf_feature_map")

    def events(fn):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        found = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events() if e.name in names)
        return [_named(found, n) for n in names]

    l1, l2, k4, k2 = events(lambda: model.fit(
        data, mode="cg", min_rank=64, max_rank=100))
    assert len(l1) == len(l2) == len(k4) == len(k2) > chunks
    assert len(l1) % chunks == 0
    assert _within(k4, l1) == [1] * len(k4)
    assert _within(k2, l2) == [1] * len(k2)
    # Layer 2 follows its own layer 1, before the next chunk's.
    starts = [s for s, _ in l1[1:]] + [float("inf")]
    assert all(a[1] <= b[0] and b[1] <= nxt
               for a, b, nxt in zip(l1, l2, starts))
    l1, l2, k4, k2 = events(lambda: model.exact_nmll_gradient(
        np.log(np.array([0.3, 0.5])), data))
    assert len(l1) == len(l2) == len(k4) == chunks and not k2


def test_two_layer_spans_make_no_profiler_call_with_tracing_off(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")
    monkeypatch.setattr(diagnostics, "record_function", refuse)
    model, data = _two_layer()
    n_iter, _ = model.fit(data, mode="cg", min_rank=64, max_rank=100,
                          run_diagnostics=True)
    assert n_iter > 0
    assert np.isfinite(model.exact_nmll_gradient(
        np.log(np.array([0.3, 0.5])), data)[0])
