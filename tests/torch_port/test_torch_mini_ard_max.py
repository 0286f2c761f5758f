"""MiniARD under the "max" speed preset against xgpr_tpu's "max" fit, in
float32 on the CPU (xgpr_tpu inside ``jax.enable_x64(False)``, the port
inside ``config.working_dtype(torch.float32)``), as test_torch_precision.py
holds RBF: 1200 rows of the tabular fixture, 84 features split at column
42, 1024 RFFs, a rank-128 srht preconditioner, CG to 1e-5.

Under "max" both packages contract bf16-materialised features in the CG
matvec.  The port's features are K2's full-precision ones (K2 keeps full
precision in every preset, on the card and in its plain version), where
xgpr_tpu's CPU path rounds the scaled rows and the projection to bf16, so
the two fits solve slightly different random-feature models.  Held to
RBF's gates: predictions within PREDICT_RTOL = 2% of max|pred| (measured
4.8e-3), held-out Spearman within 0.02 of xgpr_tpu's and of the port's
"balanced" fit (measured 4e-4 and 8e-5).
"""
import jax
import numpy as np
import pytest
import torch

from xgpr_tpu import GPRegression as JaxGPRegression
from xgpr_tpu import build_regression_dataset as jax_dataset
from xgpr_tpu import config as jax_config
from xgpr_tpu_torch import GPRegression, build_regression_dataset, config
from tests.utils.synthetic import spearman, tabular_data

torch.set_num_threads(1)

PREDICT_RTOL = 0.02
RHO_GATE = 0.02
HPARAMS = np.array([-1.7908995, -3.9549678, -3.9549678])
SETTINGS = {"split_points": [42]}


@pytest.fixture
def fp32():
    """Both packages in float32 under a preset, "balanced" after."""
    try:
        with jax.enable_x64(False), config.working_dtype(torch.float32):
            yield
    finally:
        config.set_speed_preset("balanced")
        jax_config.set_speed_preset("balanced")


def _fit(pkg_model, pkg_dataset, data, **kw):
    (trx, tr_y), (tex, _) = data
    ds = pkg_dataset(trx, tr_y, chunk_size=300)
    model = pkg_model(num_rffs=1024, kernel_choice="MiniARD",
                      kernel_settings=dict(SETTINGS), verbose=False, **kw)
    model.set_hyperparams(HPARAMS, ds)
    pre, _ = model.build_preconditioner(ds, max_rank=128, method="srht")
    model.fit(ds, preconditioner=pre, mode="cg", tol=1e-5,
              suppress_var=True)
    return np.asarray(model.predict(tex), np.float64)


def test_mini_ard_max_fit_is_within_xgpr_tpus_gates(fp32):
    data = tabular_data(n_train=1200)
    te_y = data[1][1]
    config.set_speed_preset("balanced")
    p_bal = _fit(GPRegression, build_regression_dataset, data,
                 device="cpu")
    config.set_speed_preset("max")
    p_max = _fit(GPRegression, build_regression_dataset, data,
                 device="cpu")
    jax_config.set_speed_preset("max")
    p_jax = _fit(JaxGPRegression, jax_dataset, data)
    assert not np.array_equal(p_max, p_bal)
    assert np.abs(p_max - p_jax).max() < PREDICT_RTOL * np.abs(p_jax).max()
    rho = spearman(p_max, te_y)
    assert abs(rho - spearman(p_jax, te_y)) < RHO_GATE
    assert abs(rho - spearman(p_bal, te_y)) < RHO_GATE
