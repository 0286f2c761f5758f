"""The conv kernels' host-side operand preparation (ops/cuda/conv.py).

Before a launch the K3/K4 wrappers order the rows by valid-window count
(``row_order``), pad the channels to a multiple of 4 and transpose proj to
K-major (``pad_operands``).  These are plain torch functions, held here on
the CPU: the order is a stable permutation that groups equal counts, and
the padding leaves the plain versions' results unchanged at fp64
roundoff.  ``window_slots`` counts the work the kernels' tiles project.
"""
import numpy as np
import pytest
import torch

from xgpr_tpu_torch.ops.cuda import conv


def _lengths(n, l, width, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "equal":
        lens = np.full(n, l - 2)
    else:
        lens = rng.integers(max(width - 2, 0), l + 1, size=n)
    return torch.as_tensor(lens.astype(np.int32))


@pytest.mark.parametrize("n,l,width,kind", [
    (300, 16, 9, "spread"), (257, 20, 5, "spread"), (70, 6, 1, "spread"),
    (65, 12, 9, "equal"), (1, 9, 9, "spread"), (0, 9, 3, "spread")])
def test_row_order_is_a_stable_grouping_permutation(n, l, width, kind):
    lens = _lengths(n, l, width, n + l, kind)
    nw = l - width + 1
    order, nk = conv.row_order(lens, width, nw)
    assert order.dtype == nk.dtype == torch.int32
    want_nk = np.clip(lens.numpy().astype(np.int64) - width + 1, 0, nw)
    np.testing.assert_array_equal(nk.numpy(), want_nk)
    o = order.numpy()
    np.testing.assert_array_equal(np.sort(o), np.arange(n))
    # Grouped by nk, ascending; equal nk keep their input order (stable).
    np.testing.assert_array_equal(o, np.argsort(want_nk, kind="stable"))
    sorted_nk = want_nk[o]
    assert np.all(np.diff(sorted_nk) >= 0)
    for v in np.unique(want_nk):
        assert np.all(np.diff(o[sorted_nk == v]) > 0)
    # Rows shorter than the window have no valid window and come first.
    assert np.all(sorted_nk[:int((lens.numpy() < width).sum())] == 0)


@pytest.mark.parametrize("n,l,d,width,f", [(40, 16, 64, 9, 96),
                                           (33, 20, 7, 5, 50),
                                           (25, 6, 21, 1, 64),
                                           (17, 12, 3, 9, 130)])
def test_channel_padding_leaves_plain_versions_unchanged(n, l, d, width, f):
    rng = np.random.default_rng(n + d)
    x = torch.as_tensor(rng.standard_normal((n, l, d)) * 0.5)
    proj = torch.as_tensor(rng.standard_normal((width * d, f)) * 0.3)
    lens = _lengths(n, l, width, d, "spread")
    xp, projT = conv.pad_operands(x, proj, width)
    dp = -(-d // 4) * 4
    assert xp.shape == (n, l, dp) and projT.shape == (f, width * dp)
    assert xp.is_contiguous() and projT.is_contiguous()
    assert float(xp[:, :, d:].abs().sum()) == 0.0
    assert float(projT.reshape(f, width, dp)[:, :, d:].abs().sum()) == 0.0
    scale = torch.linspace(0.5, 1.5, n, dtype=torch.float64)
    for mode in ("hi", "exact"):
        got = conv.conv_parts_plain(xp, lens, projT.t(), 0.7, width, scale,
                                    mode)
        want = conv.conv_parts_plain(x, lens, proj, 0.7, width, scale, mode)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12)
    np.testing.assert_allclose(
        conv.conv_maxpool_plain(xp, lens, projT.t(), width).numpy(),
        conv.conv_maxpool_plain(x, lens, proj, width).numpy(),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,l,width,kind", [(8192, 16, 9, "spread"),
                                            (1000, 16, 9, "equal"),
                                            (100, 12, 1, "spread")])
def test_window_slots_count_the_tiles_work(n, l, width, kind):
    lens = _lengths(n, l, width, 3, kind)
    nw = l - width + 1
    slots, valid = conv.window_slots(lens, width, nw)
    nk = np.clip(lens.numpy().astype(np.int64) - width + 1, 0, nw)
    assert valid == int(nk.sum())
    # Every valid window is projected, and no tile goes past the groups
    # that cover nw.
    tiles = -(-n // conv.TILE_ROWS)
    groups = -(-nw // conv.WINDOW_GROUP)
    assert valid <= slots <= tiles * conv.TILE_ROWS * groups * \
        conv.WINDOW_GROUP
    if kind == "equal":
        per_row = -(-int(nk[0]) // conv.WINDOW_GROUP) * conv.WINDOW_GROUP
        assert slots == tiles * conv.TILE_ROWS * per_row
    if kind == "spread" and n == 8192:
        # The motif lengths' spread: sorted tiles stay under 1.3 slots
        # per valid window, where unsorted 64-row tiles need ~1.79.
        assert slots < 1.3 * valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32_split_is_exact(seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(20_000)
         * 10.0 ** rng.integers(-30, 30, 20_000)).astype(np.float32)
    special = np.array([0.0, -0.0, 1.0, 1 + 2 ** -11, -(1 + 2 ** -11),
                        1 + 3 * 2 ** -12, 2 - 2 ** -23, 2.0 ** -126],
                       dtype=np.float32)
    a = torch.as_tensor(np.concatenate([a, special]))
    hi, lo = conv.split_tf32(a)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi + lo, a)                       # exact, in fp32
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    # Rounded to nearest: lo is at most half a TF32 ulp (2^-11 of a's
    # binade), and ties go away from zero as cvt.rna.tf32.f32 does.
    mag = a.double().abs()
    binade = torch.where(mag > 0, 2.0 ** torch.floor(torch.log2(mag)),
                         torch.zeros_like(mag))
    assert bool((lo.double().abs() <= binade * 2.0 ** -11).all())
    tail = hi[-len(special):].tolist()
    assert tail[3:6] == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -10]
    assert tail[6] == 2.0


def test_wrappers_take_the_plain_route_on_the_cpu():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((10, 8, 3)), dtype=torch.float32)
    proj = torch.as_tensor(rng.standard_normal((9, 12)), dtype=torch.float32)
    lens = torch.as_tensor(rng.integers(2, 9, size=10).astype(np.int32))
    counters = (conv.PARTS_LAUNCHES, conv.MAXPOOL_LAUNCHES)
    before = [c.total() for c in counters]
    c, s = conv.conv_parts(x, lens, proj, 0.5, 3)
    m = conv.conv_maxpool(x, lens, proj, 3)
    assert [c.total() for c in counters] == before
    want_c, want_s = conv.conv_parts_plain(x, lens, proj, 0.5, 3)
    assert torch.equal(c, want_c) and torch.equal(s, want_s)
    assert torch.equal(m, conv.conv_maxpool_plain(x, lens, proj, 3))
