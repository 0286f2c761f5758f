"""The dense kernels' host-side operand preparation (ops/cuda/operands.py).

Before a launch the K1 and K2 wrappers pad x's columns to a multiple of 4
(``pad_depth``), split x into TF32 high parts and remainders
(``split_tf32``), take proj's padded, split transpose from a cache kept
with proj (``projT_planes`` in "tf32x3") and choose how many blocks share a loop over
tiles (``tile_split``).  These are plain torch functions, held here on the
CPU: the splits are exact, the padding leaves the plain versions' results
unchanged at fp64 roundoff, the cache never returns a stale split, and the
split count is the one with the fewest tile-times.
"""
import gc

import numpy as np
import pytest
import torch

from xgpr_tpu_torch.ops.cuda import feature_map, operands, ztzv


def _proj(d, f, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((d, f)) * 0.3, dtype=dtype)


@pytest.mark.parametrize("d,f", [(84, 256), (10, 200), (1024, 64), (3, 5),
                                 (200, 333)])
def test_projT_split_is_the_exact_split_of_the_padded_transpose(d, f):
    proj = _proj(d, f, d + f)
    hi, lo = operands.projT_planes(proj, "tf32x3")
    dp = -(-d // 4) * 4
    assert hi.shape == lo.shape == (f, dp)
    assert hi.is_contiguous() and lo.is_contiguous()
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi[:, :d] + lo[:, :d], proj.t())    # exact, in fp32
    assert float(hi[:, d:].abs().sum() + lo[:, d:].abs().sum()) == 0.0
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0


def test_projT_split_is_cached_with_proj_and_never_stale():
    proj = _proj(84, 256, 0)
    first = operands.projT_planes(proj, "tf32x3")
    assert operands.projT_planes(proj, "tf32x3")[0] is first[0]        # a cache hit
    # Equal values in another tensor get their own entry.
    twin = proj.clone()
    assert operands.projT_planes(twin, "tf32x3")[0] is not first[0]
    # An in-place change (the version counter moves) builds it anew.
    proj.mul_(2.0)
    again = operands.projT_planes(proj, "tf32x3")
    assert again[0] is not first[0]
    assert torch.equal(again[0] + again[1], proj.t())
    # The entry goes with its tensor.
    key = id(proj)
    assert key in operands._PROJ_SPLITS
    del proj
    gc.collect()
    assert key not in operands._PROJ_SPLITS


@pytest.mark.parametrize("n,d", [(10, 84), (7, 10), (5, 3), (4, 1), (0, 6)])
def test_pad_depth_pads_with_zeros_to_a_multiple_of_4(n, d):
    x = torch.as_tensor(np.random.default_rng(d).standard_normal((n, d)),
                        dtype=torch.float32)
    xp = operands.pad_depth(x)
    dp = -(-d // 4) * 4
    assert xp.shape == (n, dp) and xp.is_contiguous()
    assert torch.equal(xp[:, :d], x)
    assert float(xp[:, d:].abs().sum()) == 0.0
    if dp == d:
        assert xp is x


@pytest.mark.parametrize("mode", ["hi", "exact"])
@pytest.mark.parametrize("n,d,f,padded", [(40, 10, 64, 16), (33, 83, 50, 32),
                                          (17, 3, 30, 16)])
def test_depth_padding_leaves_plain_versions_unchanged(mode, n, d, f, padded):
    rng = np.random.default_rng(n + d)
    x = torch.as_tensor(rng.standard_normal((n, d)) * 0.5)
    proj = _proj(d, f, n, torch.float64)
    xp = operands.pad_depth(x)
    projp = operands.pad_depth(proj.t()).t()
    np.testing.assert_allclose(
        feature_map.rbf_feature_map_plain(xp, projp, True, padded,
                                          mode).numpy(),
        feature_map.rbf_feature_map_plain(x, proj, True, padded,
                                          mode).numpy(),
        rtol=1e-12, atol=1e-12)
    m = torch.as_tensor((rng.random(n) > 0.25).astype(np.float64))
    vc = torch.as_tensor(rng.standard_normal((f, 3)))
    vs = torch.as_tensor(rng.standard_normal((f, 3)))
    for intercept in (False, True):
        got = ztzv.ztzv_parts_plain(xp, m, projp, 0.7, vc, vs, intercept,
                                    mode)
        want = ztzv.ztzv_parts_plain(x, m, proj, 0.7, vc, vs, intercept,
                                     mode)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12)


def _cost(tiles, other, sms, s):
    return -(-other * s // sms) * -(-tiles // s)


@pytest.mark.parametrize("tiles,other,sms,cap,want", [
    (32, 64, 132, 16, 2),    # K1's zv pass at RBF's chunk
    (64, 32, 132, 32, 4),    # K1's out pass and K2 at RBF's chunk
    (64, 16, 132, 64, 8),    # K2 at Conv1dTwoLayer's second layer
    (3, 1, 132, 64, 3),      # a small launch takes every tile apart
    (0, 5, 132, 16, 1),
    (40, 528, 132, 16, 1),   # four full waves already
    (40, 500, 132, 16, 5)])  # 19 fuller waves of 8 tiles beat 4 of 40
def test_tile_split_takes_the_fewest_tile_times(tiles, other, sms, cap, want):
    got = operands.tile_split(tiles, other, sms, cap)
    assert got == want
    assert 1 <= got <= max(1, min(tiles, cap))
    best = min(_cost(tiles, other, sms, s)
               for s in range(1, max(1, min(tiles, cap)) + 1))
    assert _cost(tiles, other, sms, got) == best


def test_dense_wrappers_take_the_plain_route_on_the_cpu():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((10, 6)), dtype=torch.float32)
    proj = _proj(6, 8, 1)
    m = torch.ones(10)
    v = torch.as_tensor(rng.standard_normal((8, 2)), dtype=torch.float32)
    before = (feature_map.LAUNCHES.total(), ztzv.LAUNCHES.total())
    z = feature_map.rbf_feature_map(x, proj, True, 4)
    oc, os_ = ztzv.ztzv_parts(x, m, proj, 0.5, v, v, True)
    assert (feature_map.LAUNCHES.total(), ztzv.LAUNCHES.total()) == before
    assert torch.equal(z, feature_map.rbf_feature_map_plain(x, proj, True, 4))
    want = ztzv.ztzv_parts_plain(x, m, proj, 0.5, v, v, True)
    assert torch.equal(oc, want[0]) and torch.equal(os_, want[1])
