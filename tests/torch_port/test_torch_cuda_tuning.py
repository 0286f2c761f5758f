"""Slice B's NMLL evaluations on the card against the same calls on the
CPU, at a small size.

Needs a CUDA device and nvcc; skips without them.  Imports nothing of
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/torch_port/test_torch_cuda_tuning.py

The card computes features in float32 (the K1/K2 kernels) with the solver
state, the Nystrom algebra and the Cholesky factors in float64; the CPU
runs everything in float64.  Same data, seeds, probes and preconditioner
rank on both sides, so the differences are the float32 features'
rounding: the exact NMLL agrees to 1e-5 relative, the SLQ estimate (a
different CG path through the same probes) to 1e-3, and each gradient
component to 1e-3 of the gradient's largest.
"""
import numpy as np
import pytest
import torch

from xgpr_tpu_torch import GPRegression, build_regression_dataset
from xgpr_tpu_torch.ops.cuda import feature_map, ztzv
from tests.utils.synthetic import tabular_data

pytestmark = pytest.mark.cuda

HPARAMS = np.array([-1.7908995, -3.9549678])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(cuda, num_rffs):
    (trx, tr_y), _ = tabular_data(n_train=1800)
    out = []
    for dev in (cuda, "cpu"):
        dset = build_regression_dataset(trx, tr_y, chunk_size=400)
        model = GPRegression(num_rffs=num_rffs, kernel_choice="RBF",
                             device=dev, verbose=False)
        model.set_hyperparams(HPARAMS, dset)
        out.append((model, dset))
    return out


def test_nmll_on_the_card_matches_the_cpu(cuda):
    (cm, cd), (hm, hd) = _pair(cuda, 1024)
    settings = {"max_rank": 256}
    exact = [m.exact_nmll(HPARAMS, d) for m, d in ((cm, cd), (hm, hd))]
    k26_before = sum(n for shape, n in ztzv.LAUNCHES.items()
                     if shape[3] == 26)
    k2_before = feature_map.LAUNCHES.total()
    approx = [m.approximate_nmll(HPARAMS, d, manual_settings=settings)
              for m, d in ((cm, cd), (hm, hd))]
    assert sum(n for shape, n in ztzv.LAUNCHES.items()
               if shape[3] == 26) > k26_before
    assert feature_map.LAUNCHES.total() > k2_before
    assert abs(exact[0] - exact[1]) < 1e-5 * abs(exact[1])
    assert abs(approx[0] - approx[1]) < 1e-3 * abs(approx[1])
    assert abs(approx[0] - exact[0]) < 1e-2 * abs(exact[0])


def test_nmll_gradient_on_the_card_matches_the_cpu(cuda):
    (cm, cd), (hm, hd) = _pair(cuda, 512)
    start = HPARAMS + 0.5
    (cs, cg), (hs, hg) = (m.exact_nmll_gradient(start, d)
                          for m, d in ((cm, cd), (hm, hd)))
    assert abs(cs - hs) < 1e-5 * abs(hs)
    assert np.abs(cg - hg).max() < 1e-3 * np.abs(hg).max()
