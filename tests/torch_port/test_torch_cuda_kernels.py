"""The CUDA kernels on the card against their plain PyTorch versions.

Needs a CUDA device and nvcc; skips without them.  Imports nothing of
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/torch_port/test_torch_cuda_kernels.py

Tolerances as in chip_smoke.py: fp32 on both sides with a different
summation order, features to 1e-5 absolute, the matvec and the conv
window loops (sums of up to nw terms of fp32 projections) to 1e-4 of
max(1, max |ref|).
"""
import numpy as np
import pytest
import torch

from xgpr_tpu_torch.ops.cuda import conv, feature_map, ztzv
from xgpr_tpu_torch.ops.cuda.operands import split_tf32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                           device=dev)


# (n, d, f, padded): D in {10, 84, 200, 1024}, N and F off the 128 tile,
# ragged last blocks (F not a multiple of padded; an odd last block at
# F 333), and Conv1dTwoLayer's second layer (D 1024, padded 1024).
FEATURE_CASES = [(100, 84, 256, 128), (257, 10, 200, 16), (64, 200, 300, 256),
                 (129, 84, 4100, 128), (200, 200, 333, 16),
                 (300, 1024, 2100, 1024), (1000, 1024, 2048, 1024)]


@pytest.mark.parametrize("mode", ["hi", "exact"])
@pytest.mark.parametrize("n,d,f,padded", FEATURE_CASES)
def test_feature_map_kernel(cuda, mode, n, d, f, padded):
    rng = np.random.default_rng(n + f)
    x = _t(rng.standard_normal((n, d)) * 0.5, cuda)
    proj = _t(rng.standard_normal((d, f)) * 0.5, cuda)
    # Row 0 has one nonzero, so its arguments are single exact products
    # on both sides, some past the polynomial's range: the kernel's 3xTF32
    # product of 5e4 (hi 50016, lo -16) by a proj row rounded to TF32 is
    # exact, as the plain fp32 product is.
    x[0] = 0.0
    x[0, 0] = 5e4
    proj[0] = split_tf32(proj[0])[0]
    before = feature_map.LAUNCHES.total()
    got = feature_map.rbf_feature_map(x, proj, True, padded, mode)
    want = feature_map.rbf_feature_map_plain(x, proj, True, padded, mode)
    torch.cuda.synchronize()
    assert feature_map.LAUNCHES.total() == before + 1
    assert float((got - want).abs().max()) < 1e-5


# (n, d, f, k): K in {1, 8, 26, 64}, R and F off the 128 tile.
ZTZV_CASES = [(2000, 84, 500, 3), (96, 10, 384, 8), (10, 50, 32, 1),
              (300, 84, 256, 26), (1000, 84, 4100, 1), (777, 84, 300, 64),
              (2500, 84, 1000, 1), (130, 1024, 200, 8)]


def _ztzv_inputs(dev, n, d, f, k):
    rng = np.random.default_rng(n * 3 + k)
    x = _t(rng.standard_normal((n, d)), dev)
    m = _t(rng.random(n) > 0.25, dev)
    proj = _t(rng.standard_normal((d, f)) * 0.3, dev)
    vc = _t(rng.standard_normal((f, k)), dev)
    vs = _t(rng.standard_normal((f, k)), dev)
    return x, m, proj, vc, vs


@pytest.mark.parametrize("intercept", [False, True])
@pytest.mark.parametrize("n,d,f,k", ZTZV_CASES)
def test_ztzv_kernel(cuda, intercept, n, d, f, k):
    x, m, proj, vc, vs = _ztzv_inputs(cuda, n, d, f, k)
    before = ztzv.LAUNCHES.total()
    oc, os_ = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, intercept)
    rc, rs = ztzv.ztzv_parts_plain(x, m, proj, 0.7, vc, vs, intercept)
    torch.cuda.synchronize()
    assert ztzv.LAUNCHES.total() == before + 1
    tol = 1e-4 * max(1.0, float(rc.abs().max()))
    assert float((oc - rc).abs().max()) < tol
    assert float((os_ - rs).abs().max()) < tol


@pytest.mark.parametrize("n,d,f,k", [(8192, 84, 4096, 1), (3000, 84, 1000, 26)])
def test_ztzv_kernel_is_deterministic(cuda, n, d, f, k):
    """No atomics: two calls on the same inputs give the same bits."""
    x, m, proj, vc, vs = _ztzv_inputs(cuda, n, d, f, k)
    first = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, True)
    second = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (n, l, d, w, f, lengths): "spread" draws lengths over [w - 1, L] in
# shuffled row order, with row 0 below w (no valid window); "equal" gives
# every row the same length.
CONV_CASES = [(300, 16, 64, 9, 256, "spread"),   # the motif slice's L, D, w
              (257, 20, 7, 5, 200, "spread"),    # ragged rows and F
              (70, 6, 10, 1, 96, "spread"),      # GraphRBF's w = 1
              (65, 12, 3, 9, 130, "spread"),     # nw = 4, D = 3
              (1000, 16, 64, 9, 300, "spread"),  # 16 tiles, F off the tile
              (500, 16, 64, 9, 256, "equal"),    # all rows of one length
              (200, 10, 21, 4, 129, "spread"),   # D = 21
              (90, 7, 21, 1, 40, "equal"),       # w = 1, D = 21
              (1000, 16, 64, 9, 4096, "spread"),  # a cut of the motif shape
              (2048, 16, 64, 9, 128, "spread")]  # verify width: one F tile


def _conv_inputs(dev, n, l, d, width, f, kind):
    rng = np.random.default_rng(n + l + width + d)
    x = _t(rng.standard_normal((n, l, d)) * 0.5, dev)
    if kind == "equal":
        lengths = np.full(n, (l + width) // 2, dtype=np.int32)
    else:
        lengths = rng.integers(width - 1, l + 1, size=n).astype(np.int32)
        lengths[0] = width - 1              # no valid window at all
    lengths = torch.as_tensor(lengths, device=dev)
    proj = _t(rng.standard_normal((width * d, f)) * 0.3, dev)
    return x, lengths, proj


@pytest.mark.parametrize("mode", ["hi", "exact"])
@pytest.mark.parametrize("n,l,d,width,f,kind", CONV_CASES)
def test_conv_parts_kernel(cuda, mode, n, l, d, width, f, kind):
    x, lengths, proj = _conv_inputs(cuda, n, l, d, width, f, kind)
    scale = torch.linspace(0.5, 1.5, n, device=cuda)
    for row_scale in (None, scale):
        before = conv.PARTS_LAUNCHES.total()
        got = conv.conv_parts(x, lengths, proj, 0.7, width, row_scale, mode)
        want = conv.conv_parts_plain(x, lengths, proj, 0.7, width,
                                     row_scale, mode)
        torch.cuda.synchronize()
        assert conv.PARTS_LAUNCHES.total() == before + 1
        for g, w in zip(got, want):
            tol = 1e-4 * max(1.0, float(w.abs().max()))
            assert float((g - w).abs().max()) < tol
        if kind == "spread":
            assert float(got[0][0].abs().max()) == 0.0


@pytest.mark.parametrize("n,l,d,width,f,kind", CONV_CASES)
def test_conv_maxpool_kernel(cuda, n, l, d, width, f, kind):
    x, lengths, proj = _conv_inputs(cuda, n, l, d, width, f, kind)
    before = conv.MAXPOOL_LAUNCHES.total()
    got = conv.conv_maxpool(x, lengths, proj, width)
    want = conv.conv_maxpool_plain(x, lengths, proj, width)
    torch.cuda.synchronize()
    assert conv.MAXPOOL_LAUNCHES.total() == before + 1
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) < tol
    if kind == "spread":
        assert float(got[0].abs().max()) == 0.0


def test_conv_kernels_return_input_row_order(cuda):
    """The kernels read rows sorted by window count; permuting the input
    rows permutes the outputs and nothing else."""
    x, lengths, proj = _conv_inputs(cuda, 1000, 16, 64, 9, 300, "spread")
    perm = torch.as_tensor(np.random.default_rng(5).permutation(1000),
                           device=cuda)
    xq, lq = x[perm].contiguous(), lengths[perm].contiguous()
    c, s = conv.conv_parts(x, lengths, proj, 0.7, 9)
    cq, sq = conv.conv_parts(xq, lq, proj, 0.7, 9)
    m, mq = conv.conv_maxpool(x, lengths, proj, 9), \
        conv.conv_maxpool(xq, lq, proj, 9)
    torch.cuda.synchronize()
    for a, b in ((c, cq), (s, sq), (m, mq)):
        assert float((a[perm] - b).abs().max()) < 1e-6


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((4, 3), dtype=torch.float64, device=cuda)
    proj = torch.zeros((3, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        feature_map.rbf_feature_map(x, proj, True, 4)
    with pytest.raises(NotImplementedError):
        feature_map.rbf_feature_map(x.float(), proj.float(), True, 4, "fast")
    xs = torch.zeros((4, 5, 3), dtype=torch.float32, device=cuda)
    lengths = torch.full((4,), 5, dtype=torch.int32, device=cuda)
    proj2 = torch.zeros((6, 8), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        conv.conv_parts(xs.double(), lengths, proj2.double(), 0.5, 2)
    with pytest.raises(TypeError):
        conv.conv_maxpool(xs, lengths.long(), proj2, 2)
    with pytest.raises(NotImplementedError):
        conv.conv_parts(xs, lengths, proj2, 0.5, 2, None, "poly")
