"""The "fast" and "poly" sincos modes of the kernels' plain versions
against xgpr_tpu's Pallas kernels under the same mode.

Each mode is set in both packages' config (``set_sincos_mode``) by a
fixture that restores the previous one.  The plain versions are the CUDA
kernels' oracles on the card, so here they are held, in float32, against
the Pallas bodies they replace, run in interpret mode as the JAX suite
runs them on the CPU: K2's feature map to 1e-5 absolute, K1's matvec and
K3's window sums to 3e-5 * max(1, |ref|) (fp32 on both sides, different
summation orders; the tolerances of test_torch_feature_map.py,
test_torch_ztzv.py and test_torch_conv_ops.py).  The evaluators
themselves match xgpr_tpu's ``kernel_sincos`` pairs to 1e-6 inside the
reduction's range, and past it the port takes the builtin per element.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgpr_tpu import config as jax_config
from xgpr_tpu.ops.pallas.conv_pallas import conv_parts_pallas
from xgpr_tpu.ops.pallas.sorf_pallas import (pad_operands,
                                             rbf_feature_map_pallas)
from xgpr_tpu.ops.pallas.ztzv_pallas import ztzv_parts_pallas
from xgpr_tpu.ops.sincos import kernel_sincos as jax_kernel_sincos
from xgpr_tpu_torch import config
from xgpr_tpu_torch.ops import sincos as tsincos
from xgpr_tpu_torch.ops.cuda import conv, feature_map, ztzv
from tests.torch_port.test_torch_conv_ops import _inputs as conv_inputs

torch.set_num_threads(1)

MODES = ["fast", "poly"]


@pytest.fixture(params=MODES)
def mode(request):
    saved = (jax_config.sincos_mode(), config.sincos_mode())
    jax_config.set_sincos_mode(request.param)
    config.set_sincos_mode(request.param)
    try:
        yield request.param
    finally:
        jax_config.set_sincos_mode(saved[0])
        config.set_sincos_mode(saved[1])


def _t(a):
    return torch.from_numpy(np.array(a))


def test_kernel_mode_flags():
    flags = {m: feature_map.kernel_sincos_flag(m)
             for m in ("auto", "hi", "exact", "fast", "poly")}
    assert flags == {"auto": 0, "hi": 0, "exact": 1, "fast": 2, "poly": 3}
    with pytest.raises(ValueError):
        feature_map.kernel_sincos_flag("cephes")


def test_evaluators_match_xgpr_tpu(mode):
    rng = np.random.default_rng(2)
    x = (rng.uniform(-8192.0, 8192.0, 4096)).astype(np.float32)
    x[:64] = rng.uniform(-7.0, 7.0, 64)
    w = rng.uniform(0.5, 1.5, 4096).astype(np.float32)
    jc, js = jax_kernel_sincos(jnp.float32, mode)(jnp.asarray(x),
                                                  jnp.asarray(w))
    tc, ts = tsincos.sincos(_t(x), _t(w))
    assert tc.dtype == torch.float32
    assert np.abs(tc.numpy() - np.asarray(jc)).max() < 1e-6
    assert np.abs(ts.numpy() - np.asarray(js)).max() < 1e-6
    # Past the reduction's range each element takes the builtin.
    big = np.array([9000.5, -12345.25, 1e6], np.float32)
    bc, bs = tsincos.sincos(_t(big))
    assert torch.equal(bc, torch.cos(_t(big)))
    assert torch.equal(bs, torch.sin(_t(big)))


@pytest.mark.parametrize("intercept", [False, True])
@pytest.mark.parametrize("n,d,padded,f", [(128, 84, 128, 256),
                                          (100, 84, 128, 128)])
def test_feature_map_matches_pallas(mode, intercept, n, d, padded, f):
    rng = np.random.default_rng(n + f)
    x = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    proj = (rng.standard_normal((d, f)) * 0.3).astype(np.float32)
    xp, pp = pad_operands(jnp.asarray(x), jnp.asarray(proj))
    want = np.asarray(rbf_feature_map_pallas(xp, pp, intercept, padded,
                                             interpret=True))
    got = feature_map.rbf_feature_map(_t(x), _t(proj), intercept, padded)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < 1e-5


@pytest.mark.parametrize("intercept", [False, True])
@pytest.mark.parametrize("n,d,f,k", [(128, 84, 256, 1), (96, 10, 384, 8)])
def test_ztzv_matches_pallas(mode, intercept, n, d, f, k):
    rng = np.random.default_rng(n * 7 + f + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    m = (rng.random(n) > 0.25).astype(np.float32)
    proj = (rng.standard_normal((d, f)) * 0.3).astype(np.float32)
    vc = rng.standard_normal((f, k)).astype(np.float32)
    vs = rng.standard_normal((f, k)).astype(np.float32)
    sigma = np.float32(0.7)
    oc_ref, os_ref = (np.asarray(a) for a in ztzv_parts_pallas(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(proj), sigma,
        jnp.asarray(vc), jnp.asarray(vs), intercept, f, interpret=True))
    oc, os_ = ztzv.ztzv_parts(_t(x), _t(m), _t(proj), float(sigma), _t(vc),
                              _t(vs), intercept)
    tol = 3e-5 * max(1.0, np.abs(oc_ref).max())
    assert np.abs(oc.numpy() - oc_ref).max() < tol
    assert np.abs(os_.numpy() - os_ref).max() < tol


@pytest.mark.parametrize("n,l,d,width,num_freqs", [(24, 30, 21, 9, 256),
                                                   (8, 16, 8, 3, 1000)])
def test_conv_parts_matches_pallas(mode, n, l, d, width, num_freqs):
    x, seq_len, _, _, proj = conv_inputs(n, l, d, width, num_freqs)
    sigma = np.float32(0.61)
    want = conv_parts_pallas(jnp.asarray(x), jnp.asarray(seq_len),
                             jnp.asarray(proj), sigma, width, num_freqs,
                             interpret=True)
    got = conv.conv_parts(_t(x), _t(seq_len), _t(proj), float(sigma), width)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        assert np.abs(g.numpy() - w).max() < 3e-5 * max(1.0,
                                                        np.abs(w).max())
