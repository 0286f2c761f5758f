"""The convolution kernel classes of the port against xgpr_tpu.

The six Conv1d/Graph kernels, Conv1dTwoLayer and the FastConv1d extractor
draw their state with the same numpy code, so radem and chi must be equal
bit for bit, and the float64 feature fns must agree at roundoff (rtol
1e-12).  The kernels' length contract is held at the kernel level here
and at the model level in test_torch_conv_regression.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgpr_tpu
import xgpr_tpu_torch
from xgpr_tpu.kernels import KERNEL_NAME_TO_CLASS as J_KERNELS
from xgpr_tpu_torch.kernels import (ARR_3D_KERNELS,
                                    KERNEL_NAME_TO_CLASS as T_KERNELS)
from xgpr_tpu.kernels import ARR_3D_KERNELS as J_ARR_3D_KERNELS

torch.set_num_threads(1)

XDIM = (30, 12, 5)


def _data(seed=4, width=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(XDIM)
    slen = rng.integers(width, XDIM[1] + 1, size=XDIM[0]).astype(np.int32)
    return x, slen


def _pair(name, settings, num_rffs=100):
    jk = J_KERNELS[name](XDIM, num_rffs, 123, kernel_spec_parms=settings)
    tk = T_KERNELS[name](XDIM, num_rffs, 123, device="cpu",
                         kernel_spec_parms=settings)
    hp = np.log(np.array([0.3, 0.45]))
    jk.set_hyperparams(hp)
    tk.set_hyperparams(hp)
    return jk, tk


def _close(got, want):
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-13)


@pytest.mark.parametrize("name,settings", [
    ("Conv1dRBF", {"conv_width": 3}),
    ("Conv1dRBF", {"conv_width": 3, "averaging": "sqrt", "intercept": False}),
    ("Conv1dMatern", {"conv_width": 4, "matern_nu": 1.5,
                      "averaging": "full"}),
    ("Conv1dCauchy", {"conv_width": 2}),
    ("GraphRBF", {"averaging": "full"}),
    ("GraphMatern", {"matern_nu": 2.5}),
    ("GraphCauchy", {"averaging": "sqrt"}),
])
def test_conv_kernels_match_jax(name, settings):
    jk, tk = _pair(name, settings)
    assert np.array_equal(tk.radem_diag.numpy(), np.asarray(jk.radem_diag))
    assert np.array_equal(tk.chi_arr.numpy(), np.asarray(jk.chi_arr))
    assert tk.padded_dims == jk.padded_dims and \
        tk.scaling_type == jk.scaling_type
    np.testing.assert_array_equal(tk.bounds, jk.bounds)
    x, slen = _data(width=tk.conv_width)
    _close(tk.transform_x(x, slen), jk.transform_x(x, slen))
    jc, js = jk.pure_feature_parts_fn()(jk.feature_params(), jnp.asarray(x),
                                        jnp.asarray(slen))
    tc, ts = tk.pure_feature_parts_fn()(tk.feature_params(),
                                        torch.from_numpy(x),
                                        torch.from_numpy(slen))
    _close(tc, jc)
    _close(ts, js)
    assert tk.pure_ztzv_parts_fn() is None
    np.testing.assert_array_equal(tk.feature_positions()[0],
                                  jk.feature_positions()[0])


@pytest.mark.parametrize("dense", [True, False])
def test_two_layer_matches_jax(dense, monkeypatch):
    settings = {"conv_width": 3, "init_rffs": 24}
    if not dense:
        # Push both layers onto the structured FWHT route.
        from xgpr_tpu_torch.kernels import l2_conv1d as tl2
        from xgpr_tpu.ops import sorf as jsorf
        monkeypatch.setattr(tl2, "dense_threshold_ok", lambda *a: False)
        monkeypatch.setattr(jsorf, "dense_threshold_ok", lambda *a: False)
    jk, tk = _pair("Conv1dTwoLayer", settings)
    assert tk.use_dense_projection == jk.use_dense_projection == dense
    for a, b in (("radem_diag1", "radem_diag1"), ("chi_arr1", "chi_arr1"),
                 ("radem_diag2", "radem_diag2"), ("chi_arr2", "chi_arr2")):
        assert np.array_equal(getattr(tk, a).numpy(),
                              np.asarray(getattr(jk, b)))
    x, slen = _data()
    _close(tk.transform_x(x, slen), jk.transform_x(x, slen))
    assert tk.pure_feature_parts_fn() is None


def test_fast_conv1d_matches_jax():
    x, slen = _data()
    jf = xgpr_tpu.FastConv1d(seq_width=XDIM[2], conv_width=3,
                             num_features=40)
    tf = xgpr_tpu_torch.FastConv1d(seq_width=XDIM[2], device="cpu",
                                   conv_width=3, num_features=40)
    assert np.array_equal(tf.conv_kernel.chi_arr.numpy(),
                          np.asarray(jf.conv_kernel.chi_arr))
    want = jf.predict(x, slen, chunk_size=7)
    got = tf.predict(x, slen, chunk_size=7)
    assert got.shape == (XDIM[0], 40)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    with pytest.raises(RuntimeError):
        tf.predict(x, slen[:-1])


def test_registry_and_length_contract():
    assert ARR_3D_KERNELS == J_ARR_3D_KERNELS
    assert ARR_3D_KERNELS <= set(T_KERNELS)
    _, tk = _pair("Conv1dRBF", {"conv_width": 3})
    x, slen = _data()
    with pytest.raises(RuntimeError):          # no lengths
        tk.transform_x(x)
    short = slen.copy()
    short[0] = 2                               # below conv_width
    with pytest.raises(RuntimeError):
        tk.transform_x(x, short)
    long = slen.copy()
    long[0] = XDIM[1] + 1                      # past the sequence axis
    with pytest.raises(RuntimeError):
        tk.transform_x(x, long)
    with pytest.raises(RuntimeError):          # channel count differs
        tk.transform_x(x[:, :, :4], slen)
    with pytest.raises(ValueError):            # conv_width is required
        T_KERNELS["Conv1dRBF"](XDIM, 64, device="cpu")
    with pytest.raises(RuntimeError):          # 3d kernels need 3d input
        T_KERNELS["Conv1dRBF"]((30, 12), 64, device="cpu",
                               kernel_spec_parms={"conv_width": 3})
    with pytest.raises(ValueError):
        T_KERNELS["Conv1dTwoLayer"](XDIM, 64, device="cpu",
                                    kernel_spec_parms={"conv_width": 3})
