"""GPClassification of the port against xgpr_tpu, both in float64 on the
CPU: the engine's two classifier reductions, the softmax NCG fit and the
softmax predict, on the JAX suite's classifier fixtures
(tests/classification_tests/): RBF on tests/utils/synthetic.py::
classification_data (900 x 12, 3 classes, 512 RFFs) and Conv1dRBF on
600 x 16 x 6 sequences (w 3, 256 RFFs, 2 classes).

Same data, seed and hyperparameters on both sides, so the random state and
every reduction are the same up to summation order: the reductions agree
to 1e-10 relative, the fit takes the same iterations along the same
objective history (1e-10 relative) to weights within 1e-8, and the
probabilities agree within 1e-10.  The JAX suite's accuracy gates (> 0.8)
hold too.
"""
import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from xgpr_tpu.fitting.engine import Engine as JaxEngine
from xgpr_tpu.fitting.softmax_solver import _STEP_GRID as JAX_STEP_GRID
from xgpr_tpu_torch.fitting.engine import Engine
from xgpr_tpu_torch.fitting.softmax_solver import _STEP_GRID
from tests.utils.synthetic import classification_data

torch.set_num_threads(1)

RTOL = 1e-10


def _rbf_data():
    (trx, tr_y), (tex, te_y) = classification_data()
    return (trx, tr_y, None), (tex, te_y, None)


def _conv_data():
    """tests/classification_tests/test_conv_classification.py's data."""
    rng = np.random.default_rng(0)
    n, l, d = 600, 16, 6
    x = rng.standard_normal((n, l, d))
    lengths = rng.integers(5, l + 1, size=(n,)).astype(np.int32)
    w = rng.standard_normal(d)
    score = np.zeros(n)
    for i in range(n):
        x[i, lengths[i]:] = 0
        score[i] = np.tanh(x[i, :lengths[i]] @ w).mean()
    y = (score > np.median(score)).astype(np.int64)
    return (x, y, lengths), (x, y, lengths)


# kernel, settings, data, chunk, RFFs, log hyperparameters, max_iter: the
# JAX suite's classifier tests.
CASES = {
    "RBF": ("RBF", None, _rbf_data, 300, 512, np.log([0.1, 0.2]), 100),
    "Conv1dRBF": ("Conv1dRBF", {"conv_width": 3}, _conv_data, 150, 256,
                  np.log([0.1, 1.0]), 60),
}


def _model(pkg, case, **kw):
    kernel, settings, data, chunk, rffs, hparams, _ = CASES[case]
    (x, y, lens), test = data()
    dset = pkg.build_classification_dataset(x, y, sequence_lengths=lens,
                                            chunk_size=chunk)
    model = pkg.GPClassification(num_rffs=rffs, kernel_choice=kernel,
                                 kernel_settings=settings, verbose=False,
                                 **kw)
    model.set_hyperparams(hparams, dset)
    return model, dset, test


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_step_grid_is_xgpr_tpus():
    assert np.array_equal(_STEP_GRID, JAX_STEP_GRID)


@pytest.mark.parametrize("mode", ["stacked", "streaming"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reductions_match_xgpr_tpu(case, mode):
    """classification_loss_grad and softmax_linesearch at a seeded W, D
    and step grid, in either engine mode."""
    jm, jdset, _ = _model(xgpr_tpu, case)
    tm, tdset, _ = _model(xgpr_tpu_torch, case, device="cpu")
    jeng = JaxEngine(jm.kernel, jdset, mode=mode)
    teng = Engine(tm.kernel, tdset, mode=mode)
    assert teng.mode == mode
    rng = np.random.default_rng(3)
    n_cls = int(tdset.get_n_classes())
    w = rng.standard_normal((tm.kernel.get_num_rffs(), n_cls)) * 0.3
    d = rng.standard_normal(w.shape) * 0.3
    steps = 0.7 * _STEP_GRID
    lam = tm.kernel.get_lambda()
    jg, jloss = jeng.classification_loss_grad(w, lam)
    tg, tloss = teng.classification_loss_grad(torch.as_tensor(w), lam)
    assert tg.dtype == torch.float64
    _close(tg.numpy(), jg)
    _close(tloss, jloss)
    want = jeng.softmax_linesearch(w, d, steps, lam)
    got = teng.softmax_linesearch(torch.as_tensor(w), torch.as_tensor(d),
                                  steps, lam)
    assert got.shape == (steps.shape[0],) and got.dtype == torch.float64
    _close(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_and_predict_match_xgpr_tpu(case):
    """fit (autoselected preconditioner + NCG) and predict through the
    entry points: the same iterations and history, weights within 1e-8,
    probabilities within 1e-10; the JAX suite's accuracy gate."""
    max_iter = CASES[case][-1]
    jm, jdset, (tex, te_y, tel) = _model(xgpr_tpu, case)
    tm, tdset, _ = _model(xgpr_tpu_torch, case, device="cpu")
    j_iter, j_hist = jm.fit(jdset, max_iter=max_iter, run_diagnostics=True)
    t_iter, t_hist = tm.fit(tdset, max_iter=max_iter, run_diagnostics=True)
    assert t_iter == j_iter and len(t_hist) == len(j_hist)
    _close(t_hist, j_hist)
    assert tm.weights.shape == (tm.kernel.get_num_rffs(), tm.n_classes)
    assert tm.weights.dtype == torch.float64
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               rtol=0, atol=1e-8)
    assert np.array_equal(tm.gamma, np.zeros(tm.n_classes))
    assert np.all(np.diff(t_hist) <= 0)
    tp = tm.predict(tex, tel)
    jp = jm.predict(tex, sequence_lengths=tel)
    assert tp.shape == (tex.shape[0], tm.n_classes)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-10)
    assert np.allclose(tp.sum(axis=1), 1.0, atol=1e-6)
    assert float((np.argmax(tp, axis=1) == te_y).mean()) > 0.8


def test_streamed_labels_and_passes_equal_stacked():
    """Labels reach the reductions as torch.long; a streamed pass gives
    the stacked pass's bits."""
    tm, tdset, _ = _model(xgpr_tpu_torch, "RBF", device="cpu")
    stacked = Engine(tm.kernel, tdset, mode="stacked")
    streamed = Engine(tm.kernel, tdset, mode="streaming")
    assert stacked._stacked["y"].dtype == torch.long
    assert all(yb.dtype == torch.long
               for _, yb, _, _, _ in streamed._batches())
    w = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (tm.kernel.get_num_rffs(), 3)))
    lam = tm.kernel.get_lambda()
    a, b = (e.classification_loss_grad(w, lam) for e in (stacked, streamed))
    assert torch.equal(a[0], b[0]) and a[1] == b[1]
    a, b = (e.softmax_linesearch(w, -w, _STEP_GRID, lam)
            for e in (stacked, streamed))
    assert torch.equal(a, b)


def test_predict_before_fit_raises():
    model, _, (tex, _, _) = _model(xgpr_tpu_torch, "RBF", device="cpu")
    with pytest.raises(RuntimeError):
        model.predict(tex)
    unbuilt = xgpr_tpu_torch.GPClassification(num_rffs=128, device="cpu",
                                              verbose=False)
    with pytest.raises(RuntimeError):
        unbuilt.predict(tex)


def test_default_device_raises_without_a_card():
    assert xgpr_tpu_torch.xGPClassification is \
        xgpr_tpu_torch.GPClassification
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xgpr_tpu_torch.GPClassification(num_rffs=128)
