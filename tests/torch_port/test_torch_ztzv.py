"""The plain version of the K1 fused CG-matvec kernel against xgpr_tpu.

In float32 it must match the Pallas kernel it replaces
(``ztzv_parts_pallas``, run in interpret mode as the JAX suite runs it
on the CPU) on the shapes of tests/ops_tests/test_ztzv_pallas.py plus
K = 26 (the SLQ probe count), intercept on and off, masked rows, to
3e-5 * max(1, |ref|): both sides sum R x F fp32 products in different
orders.  The wrapper's block arithmetic (``launch_plan``: blocks of
right-hand sides, the splits of the walks, the launches past the grid's
65,535 blocks) at slice A's chunk for K in {1, 8, 26, 33, 64, 70,000} in
both float32 bodies.
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
    before = ztzv.LAUNCHES.total()
    got = ztzv.ztzv_parts(x, m, proj, 0.5, vc, vs, True)
    want = ztzv.ztzv_parts_plain(x, m, proj, 0.5, vc, vs, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ztzv.LAUNCHES.total() == before
    with pytest.raises(ValueError):
        ztzv.ztzv_parts(x, m[:-1], proj, 0.5, vc, vs, True)
    with pytest.raises(ValueError):
        ztzv.ztzv_parts(*(t.to("meta") for t in (x, m, proj)), 0.5,
                        vc.to("meta"), vs.to("meta"), True)


# Right-hand sides a block carries (csrc/ztzv.cu: xgpr_ztzv_rhs_per_block,
# held to these counts on the card by test_torch_cuda_kernels.py's
# test_rhs_per_block_is_the_librarys): K 1 takes
# the one-rhs passes; the tensor-core passes carry 8 up to K 8, then 16
# (3xTF32) or 32 (bf16); the float64 passes 8 up to K 8, else 32 (so K 26
# projects once a pass).
def rhs_per_block(body, k):
    if body == "f64":
        return 8 if k <= 8 else 32
    if k == 1:
        return 1
    return 8 if k <= 8 else 32 if body == "bf16" else 16


# launch_plan at slice A's chunk (8192 rows, F 4096) on the H100's 132
# SMs: (blocks of right-hand sides, zsplit, osplit, launches of each
# pass).
PLANS = {
    ("tf32x3", 1): (1, 2, 4, 1), ("bf16", 1): (1, 2, 4, 1),
    ("tf32x3", 8): (1, 2, 4, 1), ("bf16", 8): (1, 2, 4, 1),
    ("tf32x3", 26): (2, 1, 2, 1), ("bf16", 26): (1, 2, 4, 1),
    ("tf32x3", 33): (3, 2, 4, 1), ("bf16", 33): (2, 1, 2, 1),
    ("tf32x3", 64): (4, 1, 1, 1), ("bf16", 64): (2, 1, 2, 1),
    ("tf32x3", 70_000): (4375, 4, 8, 1),
    ("bf16", 70_000): (2188, 8, 16, 1),
    ("f64", 1): (1, 2, 4, 1), ("f64", 8): (1, 2, 4, 1),
    ("f64", 26): (1, 2, 4, 1), ("f64", 33): (2, 1, 2, 1),
    ("f64", 64): (2, 1, 2, 1), ("f64", 70_000): (2188, 8, 16, 1),
}


@pytest.mark.parametrize("body,k", sorted(PLANS))
def test_launch_plan(body, k):
    rhs = rhs_per_block(body, k)
    plan = ztzv.launch_plan(rhs, 8192, 4096, k, 132)
    assert tuple(plan) == PLANS[(body, k)]
    assert (plan.blocks - 1) * rhs < k <= plan.blocks * rhs


@pytest.mark.parametrize("body", ["tf32x3", "bf16", "f64"])
def test_launch_plan_chunks_past_the_grid(body):
    """Past MAX_GRID_Z blocks of right-hand sides each pass launches again:
    K is not bounded by the launch grid."""
    k = ztzv.MAX_GRID_Z * rhs_per_block(body, 100)
    assert ztzv.launch_plan(rhs_per_block(body, k), 40, 16, k,
                            132).launches == 1
    assert ztzv.launch_plan(rhs_per_block(body, k + 1), 40, 16, k + 1,
                            132).launches == 2
