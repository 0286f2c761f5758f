"""The plain version of the K2 feature-map kernel against xgpr_tpu.

In float32, the plain version must match the Pallas kernel it replaces
(``rbf_feature_map_pallas``, run in interpret mode as the JAX suite runs
it on the CPU) to 1e-5 absolute on the cases of
tests/ops_tests/test_sorf_feature_pallas.py.  Features are O(1/sqrt(F))
and the two sides differ only in summation order, so this is a loose
bound.  A ragged last block, which the Pallas gate rejects, is held
against the JAX XLA path ``rbf_feature_map_dense``.  At the kernel level
the float64 feature fns of RBF, Matern and Cauchy must agree at roundoff
(rtol 1e-12).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgpr_tpu.kernels import KERNEL_NAME_TO_CLASS as J_KERNELS
from xgpr_tpu.ops.pallas.sorf_pallas import (pad_operands,
                                             rbf_feature_map_pallas)
from xgpr_tpu.ops.sorf import rbf_feature_map_dense
from xgpr_tpu_torch.kernels import KERNEL_NAME_TO_CLASS as T_KERNELS
from xgpr_tpu_torch.ops.cuda import feature_map

torch.set_num_threads(1)

ATOL = 1e-5


def _inputs(n, d, f, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    proj = (rng.standard_normal((d, f)) * 0.3).astype(np.float32)
    return x, proj


@pytest.mark.parametrize("intercept", [False, True])
@pytest.mark.parametrize("n,d,padded,f", [
    (128, 84, 128, 256),    # multi-block (256 = 2 x 128)
    (100, 84, 128, 128),    # rows not a tile multiple
    (64, 200, 256, 256),    # d > 128, padded 256
    (32, 84, 128, 64),      # F < padded (single narrow block)
])
def test_plain_feature_map_matches_pallas(intercept, n, d, padded, f):
    x, proj = _inputs(n, d, f, n + d + f)
    xp, pp = pad_operands(jnp.asarray(x), jnp.asarray(proj))
    want = np.asarray(rbf_feature_map_pallas(xp, pp, intercept, padded,
                                             interpret=True))
    got = feature_map.rbf_feature_map(torch.from_numpy(x),
                                      torch.from_numpy(proj), intercept,
                                      padded)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < ATOL


@pytest.mark.parametrize("intercept", [False, True])
def test_plain_feature_map_ragged_blocks_match_xla(intercept):
    x, proj = _inputs(57, 10, 200, 3)      # padded 16: 12 blocks + 8
    want = np.asarray(rbf_feature_map_dense(jnp.asarray(x),
                                            jnp.asarray(proj), intercept,
                                            16))
    got = feature_map.rbf_feature_map(torch.from_numpy(x),
                                      torch.from_numpy(proj), intercept, 16)
    assert np.abs(got.numpy() - want).max() < ATOL


def test_cpu_tensor_takes_the_plain_version_and_modes_are_checked():
    x, proj = _inputs(8, 10, 32, 1)
    before = feature_map.LAUNCHES.total()
    got = feature_map.rbf_feature_map(torch.from_numpy(x),
                                      torch.from_numpy(proj), True, 16)
    want = feature_map.rbf_feature_map_plain(torch.from_numpy(x),
                                             torch.from_numpy(proj), True, 16)
    assert torch.equal(got, want) and feature_map.LAUNCHES.total() == before
    with pytest.raises(ValueError):
        feature_map.rbf_feature_map(torch.from_numpy(x).to("meta"),
                                    torch.from_numpy(proj).to("meta"),
                                    True, 16)
    assert feature_map.kernel_sincos_flag("auto") == 0
    assert feature_map.kernel_sincos_flag("exact") == 1
    assert feature_map.kernel_sincos_flag("fast") == 2
    assert feature_map.kernel_sincos_flag("poly") == 3
    with pytest.raises(ValueError):
        feature_map.kernel_sincos_flag("builtin")


@pytest.mark.parametrize("name,settings", [
    ("RBF", None), ("Matern", {"matern_nu": 1.5, "intercept": True}),
    ("Cauchy", {"intercept": False})])
def test_kernel_feature_fn_fp64(name, settings):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 30))
    jk = J_KERNELS[name]((40, 30), 200, 123, kernel_spec_parms=settings)
    tk = T_KERNELS[name]((40, 30), 200, 123, device="cpu",
                         kernel_spec_parms=settings)
    hp = np.log(np.array([0.3, 0.7]))
    jk.set_hyperparams(hp)
    tk.set_hyperparams(hp)
    want = np.asarray(jk.transform_x(x))
    got = tk.transform_x(x)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-13)
    jc, js = jk.pure_feature_parts_fn()(jk.feature_params(), jnp.asarray(x))
    tc, ts = tk.pure_feature_parts_fn()(tk.feature_params(),
                                        torch.from_numpy(x))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-12,
                               atol=1e-13)
