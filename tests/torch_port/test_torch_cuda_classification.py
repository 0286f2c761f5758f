"""GPClassification on the card against the same fit on the CPU.

Needs a CUDA device and nvcc; skips without them.  Imports nothing of
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/torch_port/test_torch_cuda_classification.py

The card computes features in float32 (the K2 kernel) and their products
with the weights in float32, with the weights, the gradient, the
direction, the softmax and every sum over chunks in float64; the CPU runs
everything in float64.  Same data (chip_smoke.py's classifier generator,
16,384 rows x 84, 5 classes), seed, hyperparameters and preconditioner on
both sides, at 1024 RFFs: the final objective agrees to 1e-4 relative and
the predicted classes on at least 99.5% of the held-out rows.  A streamed
fit on the card takes the stacked fit's iterations and gives its
probabilities bitwise.
"""
import numpy as np
import pytest
import torch

from xgpr_tpu_torch import (GPClassification, build_classification_dataset,
                            config)
from xgpr_tpu_torch.ops.cuda import feature_map
from tests.utils.synthetic import classification_data

pytestmark = pytest.mark.cuda

# chip_smoke.py's CLASS_HPARAMS.
HPARAMS = np.log(np.array([0.3, 0.03]))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fit(dev, data, num_rffs=1024):
    (trx, tr_y), (tex, _) = data
    dset = build_classification_dataset(trx, tr_y, chunk_size=4096)
    model = GPClassification(num_rffs=num_rffs, kernel_choice="RBF",
                             device=dev, verbose=False)
    model.set_hyperparams(HPARAMS, dset)
    n_iter, hist = model.fit(dset, run_diagnostics=True)
    return model, n_iter, hist, model.predict(tex)


def test_classifier_on_the_card_matches_the_cpu(cuda):
    data = classification_data(n_train=16384, n_test=4096, n_features=84,
                               n_classes=5)
    before = feature_map.LAUNCHES.total()
    card, _, card_hist, card_probs = _fit(cuda, data)
    assert feature_map.LAUNCHES.total() > before
    assert card.weights.dtype == torch.float64
    _, _, cpu_hist, cpu_probs = _fit("cpu", data)
    assert abs(card_hist[-1] - cpu_hist[-1]) < 1e-4 * abs(cpu_hist[-1])
    agree = np.mean(np.argmax(card_probs, 1) == np.argmax(cpu_probs, 1))
    assert agree >= 0.995
    assert np.allclose(card_probs.sum(axis=1), 1.0, atol=1e-5)


def test_streamed_classifier_matches_stacked(cuda):
    data = classification_data(n_train=6000, n_test=1000, n_features=84,
                               n_classes=5)
    stacked = _fit(cuda, data, num_rffs=512)
    limit = config.stacked_element_limit()
    config.set_stacked_limit(1)
    try:
        streamed = _fit(cuda, data, num_rffs=512)
    finally:
        config.set_stacked_limit(limit)
    engine = next(iter(streamed[0]._engines.values()))
    assert engine.mode == "streaming" and engine.prefetcher is not None
    assert streamed[1] == stacked[1] and streamed[2] == stacked[2]
    assert np.array_equal(streamed[3], stacked[3])
