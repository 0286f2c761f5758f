"""Card tests of the benchmark (skip without a CUDA device): the seeded
generators on the card, and the port's float32 features on the card
against the float64 reference, with the TF32 control's features erring
far more.  Run on the card with

    python -m pytest -m cuda gpbench/tests/test_gpbench_card.py
"""
import numpy as np
import pytest
import torch

from gpbench.data import motif, tabular
from gpbench.reference import features as ref_features

pytestmark = pytest.mark.cuda


def test_generators_are_seeded(cuda):
    a = motif.corpus(2 ** 31 + 5, 4096, device=cuda)
    b = motif.corpus(2 ** 31 + 5, 4096, device=cuda)
    c = motif.corpus(2 ** 31 + 6, 4096, device=cuda)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.equal(a[0], c[0])
    lengths = a[2]
    assert int(lengths.min()) >= 9 and int(lengths.max()) <= 16
    assert float(a[1].std()) == pytest.approx(
        (0.4 ** 2 + 0.1 ** 2) ** 0.5, rel=0.1)
    x, y = tabular.regression_set(9, 4096, 90, device=cuda)
    x2, y2 = tabular.regression_set(9, 4096, 90, device=cuda)
    assert torch.equal(x, x2) and torch.equal(y, y2)


def _errors(kind, kernel, x, lengths, sigma, settings, dim, width):
    from xgpr_tpu_torch import config
    from xgpr_tpu_torch.kernels import KERNEL_NAME_TO_CLASS
    config.set_speed_preset("balanced")
    kern = KERNEL_NAME_TO_CLASS[kernel](tuple(x.shape), 8192, 77, "cuda",
                                        False, kernel_spec_parms=settings)
    kern.set_hyperparams(np.log([0.2, sigma]))
    port = kern.transform_x(
        x, None if lengths is None else lengths.cpu().numpy()).double()
    fmap = ref_features.FeatureMap(kind, dim, 8192, 77, width=width,
                                   device="cuda")
    ref = fmap.features(x, sigma, lengths)
    ctl = fmap.features(x, sigma, lengths, precision="tf32")

    def rel(a):
        return float(torch.linalg.vector_norm(a - ref)
                     / torch.linalg.vector_norm(ref))
    return rel(port), rel(ctl)


def test_k3_features_against_the_reference(cuda):
    x, _, lengths = motif.corpus(11, 16384, device=cuda)
    port, control = _errors("conv", "Conv1dRBF", x, lengths,
                            float(np.exp(-3.9336658309141335)),
                            {"conv_width": 9}, 64, 9)
    assert port < 1e-5 and control > 10 * port, (port, control)


def test_k2_features_against_the_reference(cuda):
    x, _ = tabular.regression_set(12, 8192, 90, device=cuda)
    port, control = _errors("rbf", "RBF", x, None,
                            float(np.exp(-3.2762456809555385)), {}, 90, 1)
    assert port < 1e-5 and control > 10 * port, (port, control)
