"""The CUDA kernels on the card against their plain PyTorch versions.

Needs a CUDA device and nvcc; skips without them.  Imports nothing of
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/torch_port/test_torch_cuda_kernels.py

Tolerances as in chip_smoke.py: fp32 on both sides with a different
summation order, features to 1e-5 absolute, the matvec and the conv
window loops (sums of up to nw terms of fp32 projections) to 1e-4 of
max(1, max |ref|).  K1, K2 and K3 are held in each sincos mode against
their plain versions in the same mode, and K1, K3 and K4 in each feature
precision ("high" 3xTF32; "highest" 3xTF32 for K1, fp32 FMAs on the CUDA
cores for K3 and K4; "default" one bf16 pass) against their plain
versions at the same precision.  The float64 bodies (float64 operands,
any precision) are held against the plain float64 versions to
F64_RTOL = 1e-11 of max(1, max |ref|): the same float64 arithmetic summed
in another order.  Under "default" the
kernel and the plain version round the same operands to bf16 and their
products are exact in fp32, so what differs is the fp32 summation order:
K3 and K4 keep the tolerances above.  In K1 that order can also round a
zv (or a c, s) to the neighbouring bf16 value on one side, which moves
that row's terms by one bf16 step, up to 2^-7 * scale * |zv|: 1.4e-4 of
max |ref| at 2000 rows and 500 frequencies, less at the slice's 8192 x
4096.  K1 "default" is held to K1_DEFAULT_RTOL = 1e-3 of max(1, max
|ref|), room for a few such steps.
"""
import numpy as np
import pytest
import torch

from xgpr_tpu_torch.ops.cuda import conv, feature_map, ztzv
from xgpr_tpu_torch.ops.cuda.operands import split_tf32

pytestmark = pytest.mark.cuda

MODES = ["hi", "exact", "fast", "poly"]


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


@pytest.mark.parametrize("mode", MODES)
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


@pytest.mark.parametrize("mode", ["exact", "hi"])
@pytest.mark.parametrize("n,d,f,padded", FEATURE_CASES)
def test_feature_map_kernel_highest(cuda, mode, n, d, f, padded):
    """K2 at "highest" (the "reference" preset) runs its fp32 CUDA-core
    body against the plain fp32 version, to 1e-5 absolute."""
    rng = np.random.default_rng(n + f + 1)
    x = _t(rng.standard_normal((n, d)) * 0.5, cuda)
    proj = _t(rng.standard_normal((d, f)) * 0.5, cuda)
    before = feature_map.LAUNCHES[(n, d, f, mode, "highest")]
    got = feature_map.rbf_feature_map(x, proj, True, padded, mode,
                                      "highest")
    want = feature_map.rbf_feature_map_plain(x, proj, True, padded, mode)
    torch.cuda.synchronize()
    assert feature_map.LAUNCHES[(n, d, f, mode, "highest")] == before + 1
    assert float((got - want).abs().max()) < 1e-5


# Right-hand sides a block of K1's passes carries, (3xTF32, bf16,
# float64) by K: the one-rhs passes at K 1 in float32, the tensor-core
# passes' 8 up to K 8, then 16 (3xTF32) or 32 (bf16); the float64 passes
# 8 up to K 8, else 32 (the counts test_torch_ztzv.py's CPU tests of
# launch_plan take).
RHS_PER_BLOCK = {1: (1, 1, 8), 2: (8, 8, 8), 8: (8, 8, 8),
                 9: (16, 32, 32), 26: (16, 32, 32), 64: (16, 32, 32),
                 70_000: (16, 32, 32)}


@pytest.mark.parametrize("k", sorted(RHS_PER_BLOCK))
def test_rhs_per_block_is_the_librarys(cuda, k):
    """The library's count of right-hand sides a block, the same in both
    passes, which the wrapper's launch_plan takes."""
    from xgpr_tpu_torch.ops.cuda import build
    lib = build.library()
    for body, want in zip(("tf32x3", "bf16", "f64"), RHS_PER_BLOCK[k]):
        for which in (0, 1):
            assert lib.xgpr_ztzv_rhs_per_block(
                feature_map.BODY_FLAGS[body], k, which) == want


# (n, d, f, k): K in {1, 8, 26, 64}, R and F off the 128 tile; K on both
# sides of the right-hand sides a block of the tensor-core passes carries
# (8; 16 in 3xTF32, 32 in bf16) and K 100; K 70,000 on a tiny chunk,
# past the 65,535 blocks a launch grid may have along z in the one-rhs
# layout the passes had before.
ZTZV_CASES = [(2000, 84, 500, 3), (96, 10, 384, 8), (10, 50, 32, 1),
              (300, 84, 256, 26), (1000, 84, 4100, 1), (777, 84, 300, 64),
              (2500, 84, 1000, 1), (130, 1024, 200, 8), (300, 84, 256, 9),
              (300, 84, 256, 15), (300, 84, 256, 17), (300, 84, 256, 31),
              (300, 84, 256, 33), (600, 84, 300, 100),
              (40, 8, 16, 70_000)]


def _ztzv_inputs(dev, n, d, f, k):
    rng = np.random.default_rng(n * 3 + k)
    x = _t(rng.standard_normal((n, d)), dev)
    m = _t(rng.random(n) > 0.25, dev)
    proj = _t(rng.standard_normal((d, f)) * 0.3, dev)
    vc = _t(rng.standard_normal((f, k)), dev)
    vs = _t(rng.standard_normal((f, k)), dev)
    return x, m, proj, vc, vs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("intercept", [False, True])
@pytest.mark.parametrize("n,d,f,k", ZTZV_CASES)
def test_ztzv_kernel(cuda, mode, intercept, n, d, f, k):
    x, m, proj, vc, vs = _ztzv_inputs(cuda, n, d, f, k)
    before = ztzv.LAUNCHES.total()
    oc, os_ = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, intercept, mode)
    rc, rs = ztzv.ztzv_parts_plain(x, m, proj, 0.7, vc, vs, intercept,
                                   mode)
    torch.cuda.synchronize()
    assert ztzv.LAUNCHES.total() == before + 1
    tol = 1e-4 * max(1.0, float(rc.abs().max()))
    assert float((oc - rc).abs().max()) < tol
    assert float((os_ - rs).abs().max()) < tol


@pytest.mark.parametrize("n,d,f,k", [(8192, 84, 4096, 1), (3000, 84, 1000, 26),
                                     (8192, 84, 4096, 26)])
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


@pytest.mark.parametrize("mode", MODES)
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
    x = torch.zeros((4, 3), dtype=torch.float32, device=cuda)
    proj = torch.zeros((3, 8), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        feature_map.rbf_feature_map(x.half(), proj.half(), True, 4)
    with pytest.raises(ValueError):
        feature_map.rbf_feature_map(x, proj, True, 4, "cephes")
    xs = torch.zeros((4, 5, 3), dtype=torch.float32, device=cuda)
    lengths = torch.full((4,), 5, dtype=torch.int32, device=cuda)
    proj2 = torch.zeros((6, 8), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        conv.conv_parts(xs.half(), lengths, proj2.half(), 0.5, 2)
    with pytest.raises(TypeError):
        conv.conv_maxpool(xs, lengths.long(), proj2, 2)
    with pytest.raises(ValueError):
        conv.conv_parts(xs, lengths, proj2, 0.5, 2, None, "cephes")


@pytest.mark.parametrize("mode", ["fast", "poly"])
def test_a_mode_runs_its_own_instantiation(cuda, mode):
    """The configured mode reaches each kernel, whose launch is counted
    under it; the kernel's values are the mode's, not "hi"'s."""
    from xgpr_tpu_torch import config
    x, m, proj, vc, vs = _ztzv_inputs(cuda, 300, 84, 256, 1)
    saved = config.sincos_mode()
    config.set_sincos_mode(mode)
    try:
        feats = feature_map.rbf_feature_map(x * 0.5, proj, True, 128)
        oc, _ = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, True)
    finally:
        config.set_sincos_mode(saved)
    hi = feature_map.rbf_feature_map_plain(x * 0.5, proj, True, 128, "hi")
    own = feature_map.rbf_feature_map_plain(x * 0.5, proj, True, 128, mode)
    torch.cuda.synchronize()
    assert (300, 84, 256, mode, "high") in feature_map.LAUNCHES
    assert (300, 84, 256, 1, mode, "high") in ztzv.LAUNCHES
    assert float((feats - own).abs().max()) < 1e-5
    assert float((own - hi).abs().max()) > 0.0
    assert torch.isfinite(oc).all()


PRECISIONS = ["default", "highest"]
K1_DEFAULT_RTOL = 1e-3


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mode", ["hi", "fast"])
@pytest.mark.parametrize("intercept", [False, True])
@pytest.mark.parametrize("n,d,f,k", ZTZV_CASES)
def test_ztzv_kernel_precision(cuda, precision, mode, intercept, n, d, f, k):
    x, m, proj, vc, vs = _ztzv_inputs(cuda, n, d, f, k)
    before = ztzv.LAUNCHES[(n, d, f, k, mode, precision)]
    oc, os_ = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, intercept, mode,
                              precision)
    rc, rs = ztzv.ztzv_parts_plain(x, m, proj, 0.7, vc, vs, intercept,
                                   mode, precision)
    torch.cuda.synchronize()
    assert ztzv.LAUNCHES[(n, d, f, k, mode, precision)] == before + 1
    rtol = K1_DEFAULT_RTOL if precision == "default" else 1e-4
    for got, want in ((oc, rc), (os_, rs)):
        tol = rtol * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) < tol


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n,l,d,width,f,kind", CONV_CASES)
def test_conv_kernels_precision(cuda, precision, n, l, d, width, f, kind):
    x, lengths, proj = _conv_inputs(cuda, n, l, d, width, f, kind)
    scale = torch.linspace(0.5, 1.5, n, device=cuda)
    got = conv.conv_parts(x, lengths, proj, 0.7, width, scale, "hi",
                          precision) + \
        (conv.conv_maxpool(x, lengths, proj, width, precision),)
    want = conv.conv_parts_plain(x, lengths, proj, 0.7, width, scale, "hi",
                                 precision) + \
        (conv.conv_maxpool_plain(x, lengths, proj, width, precision),)
    torch.cuda.synchronize()
    assert (n, l, d, width, f, "hi", precision) in conv.PARTS_LAUNCHES
    assert (n, l, d, width, f, precision) in conv.MAXPOOL_LAUNCHES
    for g, w in zip(got, want):
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) < tol


@pytest.mark.parametrize("precision", PRECISIONS)
def test_precision_bodies_are_deterministic(cuda, precision):
    """Two calls on the same inputs give the same bits in every body, K1
    at K 1 and 26."""
    x, m, proj, vc, vs = _ztzv_inputs(cuda, 8192, 84, 4096, 1)
    v26 = _ztzv_inputs(cuda, 8192, 84, 4096, 26)[3:]
    xs, lengths, projc = _conv_inputs(cuda, 1000, 16, 64, 9, 4096, "spread")
    runs = [ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, True, None, precision)
            + ztzv.ztzv_parts(x, m, proj, 0.7, *v26, True, None, precision)
            + conv.conv_parts(xs, lengths, projc, 0.7, 9, None, None,
                              precision)
            + (conv.conv_maxpool(xs, lengths, projc, 9, precision),)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_balanced_runs_the_3xtf32_body(cuda):
    """With every knob at its default ("balanced") K1, K3 and K4 launch
    their "high" body: the same bits as a call that names it."""
    from xgpr_tpu_torch import config
    config.set_speed_preset("balanced")
    x, m, proj, vc, vs = _ztzv_inputs(cuda, 300, 84, 256, 1)
    xs, lengths, projc = _conv_inputs(cuda, 300, 16, 64, 9, 256, "spread")
    default = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, True) \
        + conv.conv_parts(xs, lengths, projc, 0.7, 9) \
        + (conv.conv_maxpool(xs, lengths, projc, 9),)
    named = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, True, "hi", "high") \
        + conv.conv_parts(xs, lengths, projc, 0.7, 9, None, "hi", "high") \
        + (conv.conv_maxpool(xs, lengths, projc, 9, "high"),)
    torch.cuda.synchronize()
    for a, b in zip(default, named):
        assert torch.equal(a, b)


def test_highest_runs_the_3xtf32_body(cuda):
    """"highest" launches under its own precision key: K1 runs the 3xTF32
    body (the bits of "high", at K 1 and 26), K2, K3 and K4 the fp32
    CUDA-core body, whose values are the plain fp32 versions' and not the
    3xTF32 body's bits."""
    x, m, proj, vc, vs = _ztzv_inputs(cuda, 300, 84, 256, 1)
    v26 = _ztzv_inputs(cuda, 300, 84, 256, 26)[3:]
    xs, lengths, projc = _conv_inputs(cuda, 300, 16, 64, 9, 256, "spread")
    xf = x * 0.5
    out = {p: ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, True, "hi", p)
           + ztzv.ztzv_parts(x, m, proj, 0.7, *v26, True, "hi", p)
           + (feature_map.rbf_feature_map(xf, proj, True, 128, "hi", p),)
           + conv.conv_parts(xs, lengths, projc, 0.7, 9, None, "hi", p)
           + (conv.conv_maxpool(xs, lengths, projc, 9, p),)
           for p in ("highest", "high")}
    plain = (feature_map.rbf_feature_map_plain(xf, proj, True, 128, "hi"),) \
        + conv.conv_parts_plain(xs, lengths, projc, 0.7, 9, None, "hi",
                                "highest") + \
        (conv.conv_maxpool_plain(xs, lengths, projc, 9, "highest"),)
    torch.cuda.synchronize()
    assert (300, 84, 256, 1, "hi", "highest") in ztzv.LAUNCHES
    assert (300, 84, 256, 26, "hi", "highest") in ztzv.LAUNCHES
    assert (300, 84, 256, "hi", "highest") in feature_map.LAUNCHES
    assert (300, 16, 64, 9, 256, "hi", "highest") in conv.PARTS_LAUNCHES
    assert (300, 16, 64, 9, 256, "highest") in conv.MAXPOOL_LAUNCHES
    for a, b in zip(out["highest"][:4], out["high"][:4]):
        assert torch.equal(a, b)
    for a, b, want in zip(out["highest"][4:], out["high"][4:], plain):
        assert float((a - want).abs().max()) < \
            1e-4 * max(1.0, float(want.abs().max()))
        assert not torch.equal(a, b)


def test_max_preset_runs_the_bf16_bodies(cuda):
    """Under set_speed_preset("max") K1, K3 and K4 launch their "default"
    bodies in the "fast" mode, and their values are the bf16 plain
    versions', not the 3xTF32 ones'."""
    from xgpr_tpu_torch import config
    x, m, proj, vc, vs = _ztzv_inputs(cuda, 300, 84, 256, 1)
    xs, lengths, projc = _conv_inputs(cuda, 300, 16, 64, 9, 256, "spread")
    config.set_speed_preset("max")
    try:
        oc, _ = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, True)
        c, _ = conv.conv_parts(xs, lengths, projc, 0.7, 9)
        mx = conv.conv_maxpool(xs, lengths, projc, 9)
    finally:
        config.set_speed_preset("balanced")
    torch.cuda.synchronize()
    assert (300, 84, 256, 1, "fast", "default") in ztzv.LAUNCHES
    assert (300, 16, 64, 9, 256, "fast", "default") in conv.PARTS_LAUNCHES
    assert (300, 16, 64, 9, 256, "default") in conv.MAXPOOL_LAUNCHES
    for got, (bf, hi), rtol in (
            (oc, [ztzv.ztzv_parts_plain(x, m, proj, 0.7, vc, vs, True,
                                        "fast", p)[0]
                  for p in ("default", "high")], K1_DEFAULT_RTOL),
            (c, [conv.conv_parts_plain(xs, lengths, projc, 0.7, 9, None,
                                       "fast", p)[0]
                 for p in ("default", "high")], 1e-4),
            (mx, [conv.conv_maxpool_plain(xs, lengths, projc, 9, p)
                  for p in ("default", "high")], 1e-4)):
        tol = rtol * max(1.0, float(bf.abs().max()))
        assert float((got - bf).abs().max()) < tol
        assert float((got - hi).abs().max()) > tol


def test_unknown_precisions_are_refused(cuda):
    """The wrappers refuse a precision they do not know, and the C entry
    points refuse an unknown flag (cudaErrorInvalidValue) before any
    launch."""
    from xgpr_tpu_torch.ops.cuda import build
    x, m, proj, vc, vs = _ztzv_inputs(cuda, 10, 8, 16, 1)
    with pytest.raises(ValueError):
        ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, True, None, "bf16")
    xs, lengths, projc = _conv_inputs(cuda, 10, 6, 4, 3, 16, "equal")
    with pytest.raises(ValueError):
        conv.conv_maxpool(xs, lengths, projc, 3, "tf32")
    lib = build.library()
    invalid = 1  # cudaErrorInvalidValue
    assert lib.xgpr_ztzv(*([None] * 5), 1.0, *([None] * 7), 10, 8, 16, 1,
                         1, 1, 1.0, 0, 0, 7, None) == invalid
    assert lib.xgpr_conv_parts(*([None] * 9), 10, 6, 4, 3, 16, 1.0, 0, 7,
                               None) == invalid
    assert lib.xgpr_conv_maxpool(*([None] * 7), 10, 6, 4, 3, 16, 7,
                                 None) == invalid


# ----------------------------------------------------------------------
# K3 and K4's bf16 body (csrc/conv_ws.cuh): projT's tile resident in
# shared memory at D 64, streamed at D 128 (w 9: the tile and a window
# pair's positions do not fit a block), with the row operands laid out on
# the card (tile_layout).
WS_CASES = [(300, 16, 64, 9, 256, "spread"), (200, 16, 128, 9, 200, "spread"),
            (150, 12, 7, 5, 130, "equal")]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,l,d,width,f,kind", WS_CASES)
def test_conv_bf16_pipeline(cuda, mode, n, l, d, width, f, kind):
    """Each sincos mode of K3 and K4 on the bf16 body, resident and
    streamed: within the tolerance of the plain bf16 versions, two calls
    bitwise equal, one launch each counted under its key."""
    x, lengths, proj = _conv_inputs(cuda, n, l, d, width, f, kind)
    plan = conv.ws_plan(n, -(-d // 8) * 8, width, f, 132)
    assert plan.resident == (d != 128)
    scale = torch.linspace(0.5, 1.5, n, device=cuda)
    k3, k4 = (n, l, d, width, f, mode, "default"), \
        (n, l, d, width, f, "default")
    before = conv.PARTS_LAUNCHES[k3], conv.MAXPOOL_LAUNCHES[k4]
    runs = [conv.conv_parts(x, lengths, proj, 0.7, width, scale, mode,
                            "default")
            + (conv.conv_maxpool(x, lengths, proj, width, "default"),)
            for _ in range(2)]
    want = conv.conv_parts_plain(x, lengths, proj, 0.7, width, scale, mode,
                                 "default") + \
        (conv.conv_maxpool_plain(x, lengths, proj, width, "default"),)
    torch.cuda.synchronize()
    assert (conv.PARTS_LAUNCHES[k3], conv.MAXPOOL_LAUNCHES[k4]) == \
        (before[0] + 2, before[1] + 2)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for g, w in zip(runs[0], want):
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) < tol
    if kind == "spread":
        assert float(runs[0][0][0].abs().max()) == 0.0


@pytest.mark.parametrize("d", [64, 128])
def test_conv_bf16_pipeline_returns_input_row_order(cuda, d):
    """Permuting the input rows permutes the bf16 body's outputs, bit for
    bit: a row's sums read its own windows alone, whatever tile it lands
    in."""
    x, lengths, proj = _conv_inputs(cuda, 1000, 16, d, 9, 300, "spread")
    perm = torch.as_tensor(np.random.default_rng(5).permutation(1000),
                           device=cuda)
    xq, lq = x[perm].contiguous(), lengths[perm].contiguous()
    got = conv.conv_parts(x, lengths, proj, 0.7, 9, None, "fast",
                          "default") + \
        (conv.conv_maxpool(x, lengths, proj, 9, "default"),)
    permuted = conv.conv_parts(xq, lq, proj, 0.7, 9, None, "fast",
                               "default") + \
        (conv.conv_maxpool(xq, lq, proj, 9, "default"),)
    torch.cuda.synchronize()
    for a, b in zip(got, permuted):
        assert torch.equal(a[perm], b)


@pytest.mark.parametrize("n,l,d,width", [(8192, 16, 64, 9), (1000, 20, 7, 5),
                                         (70, 6, 10, 1), (1, 9, 3, 9)])
def test_tile_layout_on_the_card_groups_rows_as_the_plain_version(
        cuda, n, l, d, width):
    """The card's row layout: a permutation of the rows grouped by window
    count as the plain version groups them (the same counts and tile
    maxima), x's rows in that order in bf16 with the channels padded."""
    x, lengths, _ = _conv_inputs(cuda, n, l, d, width, 8, "spread")
    xt, order, nk_t, top = conv.tile_layout(x, lengths, width)
    _, p_order, p_nk, p_top = conv.tile_layout(x.cpu(), lengths.cpu(), width)
    torch.cuda.synchronize()
    o = order.long().cpu()
    assert torch.equal(torch.sort(o).values, torch.arange(n))
    assert torch.equal(nk_t.cpu(), p_nk) and torch.equal(top.cpu(), p_top)
    want = torch.zeros((n, l, xt.shape[2]), dtype=torch.bfloat16)
    want[:, :, :d] = x.cpu().to(torch.bfloat16)[o]
    assert torch.equal(xt.cpu(), want)


def test_bf16_conv_launches_reach_only_the_pipeline(cuda):
    """The implicit-GEMM entry points refuse the bf16 body's flag, and the
    pipeline's entry points refuse a plan it cannot run
    (cudaErrorInvalidValue), before any launch."""
    from xgpr_tpu_torch.ops.cuda import build
    from xgpr_tpu_torch.ops.cuda.feature_map import BODY_FLAGS
    lib = build.library()
    invalid, bf16 = 1, BODY_FLAGS["bf16"]
    assert lib.xgpr_conv_parts(*([None] * 9), 10, 6, 8, 3, 16, 1.0, 0, bf16,
                               None) == invalid
    assert lib.xgpr_conv_maxpool(*([None] * 7), 10, 6, 8, 3, 16, bf16,
                                 None) == invalid
    # (resident, stages, split): too few stages for a resident window
    # pair, a ring of one stage, no block per frequency tile.
    for plan in ((1, 3, 1), (0, 1, 1), (0, 4, 0)):
        assert lib.xgpr_conv_parts_ws(*([None] * 8), 10, 6, 8, 3, 16, 1.0,
                                      0, *plan, None) == invalid
        assert lib.xgpr_conv_maxpool_ws(*([None] * 6), 10, 6, 8, 3, 16,
                                        *plan, None) == invalid


# ----------------------------------------------------------------------
# The float64 bodies (float64 operands, whatever the precision).
F64_RTOL = 1e-11


def _f64(*tensors):
    return tuple(t.double() for t in tensors)


def _f64_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        tol = F64_RTOL * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) < tol


@pytest.mark.parametrize("n,d,f,padded", FEATURE_CASES)
def test_feature_map_kernel_float64(cuda, n, d, f, padded):
    rng = np.random.default_rng(n + f)
    x, proj = _f64(_t(rng.standard_normal((n, d)) * 0.5, cuda),
                   _t(rng.standard_normal((d, f)) * 0.5, cuda))
    x[0] = 0.0
    x[0, 0] = 5e4          # arguments past the polynomial's range
    before = feature_map.LAUNCHES[(n, d, f, "exact", "float64")]
    got = feature_map.rbf_feature_map(x, proj, True, padded, "fast")
    want = feature_map.rbf_feature_map_plain(x, proj, True, padded, "fast")
    torch.cuda.synchronize()
    assert feature_map.LAUNCHES[(n, d, f, "exact", "float64")] == before + 1
    _f64_close((got,), (want,))


@pytest.mark.parametrize("precision", ["high", "highest", "default"])
@pytest.mark.parametrize("intercept", [False, True])
@pytest.mark.parametrize("n,d,f,k", ZTZV_CASES)
def test_ztzv_kernel_float64(cuda, precision, intercept, n, d, f, k):
    """Every precision runs the float64 body on float64 operands."""
    x, m, proj, vc, vs = _f64(*_ztzv_inputs(cuda, n, d, f, k))
    before = ztzv.LAUNCHES[(n, d, f, k, "exact", "float64")]
    got = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, intercept, "hi",
                          precision)
    want = ztzv.ztzv_parts_plain(x, m, proj, 0.7, vc, vs, intercept)
    torch.cuda.synchronize()
    assert ztzv.LAUNCHES[(n, d, f, k, "exact", "float64")] == before + 1
    _f64_close(got, want)


# The float64 passes carry 32 right-hand sides a block from K 9: K on both
# sides of 32, R and F off the 128 tile (and off the passes' 64-wide
# tiles), D past the 96 that stays resident (D 200) and at one line of
# depth (D 16).
F64_ZTZV_CASES = [(1000, 84, 300, 26), (777, 84, 4100, 32),
                  (2500, 84, 1000, 33), (300, 200, 513, 64),
                  (333, 16, 700, 26)]


@pytest.mark.parametrize("n,d,f,k", F64_ZTZV_CASES)
def test_ztzv_kernel_float64_blocks_of_32(cuda, n, d, f, k):
    x, m, proj, vc, vs = _f64(*_ztzv_inputs(cuda, n, d, f, k))
    got = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, True)
    want = ztzv.ztzv_parts_plain(x, m, proj, 0.7, vc, vs, True)
    torch.cuda.synchronize()
    _f64_close(got, want)


@pytest.mark.parametrize("half", [0, 1])
@pytest.mark.parametrize("k", [1, 26])
def test_ztzv_kernel_float64_rows_g8(cuda, half, k):
    """Rows g and g + 8 of every 16-row tile on their own: the mask keeps
    rows r with r % 16 >= 8 (half 1) or < 8 (half 0), so a wrong row g + 8
    cannot hide behind the others' sums (a DMMA's C rows g + 8, the
    accumulators zeroed beside the first products, went wrong once in
    K3)."""
    n, d, f = 8192, 84, 4096
    x, m, proj, vc, vs = _f64(*_ztzv_inputs(cuda, n, d, f, k))
    rows = torch.arange(n, device=cuda)
    m = m * ((rows % 16 >= 8) == bool(half)).double()
    got = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, True)
    want = ztzv.ztzv_parts_plain(x, m, proj, 0.7, vc, vs, True)
    torch.cuda.synchronize()
    _f64_close(got, want)


# K2's float64 kernel at the K4 path's shape (D 1024, F 2048, padded
# 1024), and at ragged block layouts: blocks of 96 (a tile spans two) with
# a ragged last block, and an odd last block at D 1024.
F64_FEATURE_CASES = [(8192, 1024, 2048, 1024), (333, 84, 1000, 96),
                     (257, 1024, 333, 40)]


@pytest.mark.parametrize("n,d,f,padded", F64_FEATURE_CASES)
def test_feature_map_kernel_float64_layouts(cuda, n, d, f, padded):
    rng = np.random.default_rng(n + d)
    x, proj = _f64(_t(rng.random((n, d)) * 0.1, cuda),
                   _t(rng.standard_normal((d, f)) * 0.5, cuda))
    got = feature_map.rbf_feature_map(x, proj, False, padded)
    want = feature_map.rbf_feature_map_plain(x, proj, False, padded)
    torch.cuda.synchronize()
    _f64_close((got,), (want,))


@pytest.mark.parametrize("n,d,f,k", [(8192, 84, 4096, 1), (3000, 84, 1000, 26)])
def test_ztzv_kernel_float64_is_deterministic(cuda, n, d, f, k):
    """The float64 passes (their contractions on DMMA) give the same bits
    on the same inputs."""
    x, m, proj, vc, vs = _f64(*_ztzv_inputs(cuda, n, d, f, k))
    first = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, True)
    second = ztzv.ztzv_parts(x, m, proj, 0.7, vc, vs, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["high", "highest", "default"])
@pytest.mark.parametrize("n,l,d,width,f,kind", CONV_CASES)
def test_conv_kernels_float64(cuda, precision, n, l, d, width, f, kind):
    x, lengths, proj = _conv_inputs(cuda, n, l, d, width, f, kind)
    x, proj = _f64(x, proj)
    scale = torch.linspace(0.5, 1.5, n, device=cuda, dtype=torch.float64)
    got = conv.conv_parts(x, lengths, proj, 0.7, width, scale, "poly",
                          precision) + \
        (conv.conv_maxpool(x, lengths, proj, width, precision),)
    want = conv.conv_parts_plain(x, lengths, proj, 0.7, width, scale) + \
        (conv.conv_maxpool_plain(x, lengths, proj, width),)
    torch.cuda.synchronize()
    assert (n, l, d, width, f, "exact", "float64") in conv.PARTS_LAUNCHES
    assert (n, l, d, width, f, "float64") in conv.MAXPOOL_LAUNCHES
    _f64_close(got, want)
    if kind == "spread":
        assert float(got[0][0].abs().max()) == 0.0


def _strided(a):
    """a's values in a non-contiguous layout."""
    out = torch.stack([a, torch.zeros_like(a)], dim=-1)[..., 0]
    assert not out.is_contiguous()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("precision", ["high", "highest", "default"])
def test_non_contiguous_operands_give_the_contiguous_bits(cuda, dtype,
                                                          precision):
    x, m, proj, vc, vs = (t.to(dtype) for t in
                          _ztzv_inputs(cuda, 300, 84, 256, 3))
    xs, lengths, projc = _conv_inputs(cuda, 300, 16, 64, 9, 256, "spread")
    xs, projc = xs.to(dtype), projc.to(dtype)
    scale = torch.linspace(0.5, 1.5, 300, device=cuda, dtype=dtype)

    def run(f):
        return (feature_map.rbf_feature_map(f(x), f(proj), True, 128),) \
            + ztzv.ztzv_parts(f(x), f(m), f(proj), 0.7, f(vc), f(vs), True,
                              None, precision) \
            + conv.conv_parts(f(xs), f(lengths), f(projc), 0.7, 9, f(scale),
                              None, precision) \
            + (conv.conv_maxpool(f(xs), f(lengths), f(projc), 9, precision),)
    want = run(lambda a: a)
    got = run(_strided)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_mixed_dtypes_raise(cuda):
    x, m, proj, vc, vs = _ztzv_inputs(cuda, 30, 8, 16, 1)
    with pytest.raises(TypeError):
        feature_map.rbf_feature_map(x, proj.double(), True, 8)
    with pytest.raises(TypeError):
        ztzv.ztzv_parts(x.double(), m.double(), proj.double(), 0.7, vc,
                        vs.double(), True)
    xs, lengths, projc = _conv_inputs(cuda, 10, 6, 4, 3, 16, "equal")
    with pytest.raises(TypeError):
        conv.conv_parts(xs.double(), lengths, projc.double(), 0.7, 3,
                        torch.ones(10, device=cuda))
    with pytest.raises(TypeError):
        conv.conv_maxpool(xs, lengths, projc.double(), 3)


# ----------------------------------------------------------------------
# K3 and K4's synchronous kernel (csrc/conv_sync.cuh): fp32 FMAs at
# "highest" (row tiles of 64 sequences, 128 frequencies a block) and
# float64 DMMA (64 frequencies a block), at edge shapes: N off the row
# tile, D odd (and 21, the protein shape of bench.py), rows with no valid
# window, nw below a window pair (L == w), F off the frequency tile (odd
# too), with and without a row scale; each call twice, the same bits.
SYNC_CASES = [(257, 20, 7, 5, 200, "spread"),   # N, D, F off their tiles
              (130, 14, 21, 6, 131, "spread"),  # D 21, F odd
              (70, 9, 9, 9, 65, "spread"),      # L == w: one window
              (65, 10, 3, 9, 7, "equal"),       # nw 2, F below a pair
              (1000, 16, 64, 9, 4100, "spread")]  # the motif cut, F 4100


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,l,d,width,f,kind", SYNC_CASES)
def test_conv_sync_kernel_at_edge_shapes(cuda, dtype, n, l, d, width, f,
                                         kind):
    x, lengths, proj = _conv_inputs(cuda, n, l, d, width, f, kind)
    x, proj = x.to(dtype), proj.to(dtype)
    scale = torch.linspace(0.5, 1.5, n, device=cuda, dtype=dtype)
    mode = "hi" if dtype == torch.float32 else "exact"
    tags = ("exact", "float64") if dtype == torch.float64 else \
        (mode, "highest")
    for row_scale in (None, scale):
        before = (conv.PARTS_LAUNCHES[(n, l, d, width, f) + tags],
                  conv.MAXPOOL_LAUNCHES[(n, l, d, width, f, tags[1])])
        runs = [conv.conv_parts(x, lengths, proj, 0.7, width, row_scale,
                                mode, "highest")
                + (conv.conv_maxpool(x, lengths, proj, width, "highest"),)
                for _ in range(2)]
        want = conv.conv_parts_plain(x, lengths, proj, 0.7, width,
                                     row_scale, mode, "highest") + \
            (conv.conv_maxpool_plain(x, lengths, proj, width, "highest"),)
        torch.cuda.synchronize()
        assert (conv.PARTS_LAUNCHES[(n, l, d, width, f) + tags],
                conv.MAXPOOL_LAUNCHES[(n, l, d, width, f, tags[1])]) == \
            (before[0] + 2, before[1] + 2)
        for a, b in zip(*runs):
            assert torch.equal(a, b)
        if dtype == torch.float64:
            _f64_close(runs[0], want)
        else:
            for g, w in zip(runs[0], want):
                tol = 1e-4 * max(1.0, float(w.abs().max()))
                assert float((g - w).abs().max()) < tol
        if kind == "spread":
            assert float(runs[0][0][0].abs().max()) == 0.0
            assert float(runs[0][2][0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,l,d,width,f,kind", SYNC_CASES[:3])
def test_conv_sync_kernel_non_contiguous_bits(cuda, dtype, n, l, d, width,
                                              f, kind):
    """Non-contiguous x, lengths, proj and row scale give the contiguous
    operands' bits."""
    x, lengths, proj = _conv_inputs(cuda, n, l, d, width, f, kind)
    x, proj = x.to(dtype), proj.to(dtype)
    scale = torch.linspace(0.5, 1.5, n, device=cuda, dtype=dtype)

    def run(t):
        return conv.conv_parts(t(x), t(lengths), t(proj), 0.7, width,
                               t(scale), "exact", "highest") + \
            (conv.conv_maxpool(t(x), t(lengths), t(proj), width,
                               "highest"),)
    want = run(lambda a: a)
    got = run(_strided)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_conv_sync_entry_points_refuse_other_bodies(cuda):
    """The synchronous entry points take the fp32 FMA and float64 bodies
    only, and K3 the four sincos modes; the implicit GEMM's entry points
    no longer take either body."""
    from xgpr_tpu_torch.ops.cuda import build
    lib = build.library()
    invalid = 1  # cudaErrorInvalidValue
    for body in (feature_map.BODY_FLAGS["tf32x3"],
                 feature_map.BODY_FLAGS["bf16"], 7):
        assert lib.xgpr_conv_parts_sync(*([None] * 7), 10, 6, 4, 3, 16, 16,
                                        1.0, 0, body, None) == invalid
        assert lib.xgpr_conv_maxpool_sync(*([None] * 5), 10, 6, 4, 3, 16,
                                          16, body, None) == invalid
    assert lib.xgpr_conv_parts_sync(*([None] * 7), 10, 6, 4, 3, 16, 16, 1.0,
                                    9, feature_map.BODY_FLAGS["fma32"],
                                    None) == invalid
    for body in ("fma32", "f64"):
        flag = feature_map.BODY_FLAGS[body]
        assert lib.xgpr_conv_parts(*([None] * 9), 10, 6, 4, 3, 16, 1.0, 0,
                                   flag, None) == invalid
        assert lib.xgpr_conv_maxpool(*([None] * 7), 10, 6, 4, 3, 16, flag,
                                     None) == invalid
