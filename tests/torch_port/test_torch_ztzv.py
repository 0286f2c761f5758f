"""The plain version of the K1 fused CG-matvec kernel against xgpr_tpu.

In float32 it must match the Pallas kernel it replaces
(``ztzv_parts_pallas``, run in interpret mode as the JAX suite runs it
on the CPU) on the shapes of tests/ops_tests/test_ztzv_pallas.py plus
K = 26 (the SLQ probe count), intercept on and off, masked rows, to
3e-5 * max(1, |ref|): both sides sum R x F fp32 products in different
orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgpr_tpu.ops.pallas.ztzv_pallas import ztzv_parts_pallas
from xgpr_tpu_torch.ops.cuda import ztzv

torch.set_num_threads(1)


def _inputs(n, d, f, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    m = (rng.random(n) > 0.25).astype(np.float32)
    proj = (rng.standard_normal((d, f)) * 0.3).astype(np.float32)
    vc = rng.standard_normal((f, k)).astype(np.float32)
    vs = rng.standard_normal((f, k)).astype(np.float32)
    return x, m, proj, vc, vs


@pytest.mark.parametrize("intercept", [False, True])
@pytest.mark.parametrize("n,d,f,k", [
    (128, 84, 256, 5), (64, 128, 128, 1), (96, 10, 384, 8),
    (2000, 84, 256, 2), (128, 84, 200, 3), (231, 56, 500, 2),
    (10, 50, 32, 1), (128, 84, 256, 26),
])
def test_plain_ztzv_matches_pallas(intercept, n, d, f, k):
    x, m, proj, vc, vs = _inputs(n, d, f, k, n * 7 + f + k)
    sigma = np.float32(0.7)
    oc_ref, os_ref = ztzv_parts_pallas(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(proj), sigma,
        jnp.asarray(vc), jnp.asarray(vs), intercept, f, interpret=True)
    oc, os_ = ztzv.ztzv_parts(*(torch.from_numpy(a) for a in (x, m, proj)),
                              float(sigma), torch.from_numpy(vc),
                              torch.from_numpy(vs), intercept)
    assert oc.dtype == torch.float32 and oc.shape == (f, k)
    oc_ref, os_ref = np.asarray(oc_ref), np.asarray(os_ref)
    tol = 3e-5 * max(1.0, np.abs(oc_ref).max())
    assert np.abs(oc.numpy() - oc_ref).max() < tol
    assert np.abs(os_.numpy() - os_ref).max() < tol


def test_cpu_tensors_take_the_plain_version():
    x, m, proj, vc, vs = (torch.from_numpy(a)
                          for a in _inputs(33, 12, 40, 2, 0))
    before = ztzv.LAUNCHES
    got = ztzv.ztzv_parts(x, m, proj, 0.5, vc, vs, True)
    want = ztzv.ztzv_parts_plain(x, m, proj, 0.5, vc, vs, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ztzv.LAUNCHES == before
    with pytest.raises(ValueError):
        ztzv.ztzv_parts(x, m[:-1], proj, 0.5, vc, vs, True)
    with pytest.raises(ValueError):
        ztzv.ztzv_parts(*(t.to("meta") for t in (x, m, proj)), 0.5,
                        vc.to("meta"), vs.to("meta"), True)
