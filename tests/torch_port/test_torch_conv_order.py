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

from xgpr_tpu_torch.ops.cuda import conv, operands


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
    hi, lo = operands.split_tf32(a)
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


# The bf16 body's pipeline (csrc/conv_ws.cuh): its launch plan, the
# tile-ordered x it copies by TMA, and projT's bf16 plane from the cache.

WS_SHAPES = [(8192, 64, 9, 4096), (8192, 64, 9, 1024), (8192, 64, 9, 128),
             (300, 64, 9, 256), (257, 8, 5, 200), (70, 16, 1, 96),
             (1000, 64, 9, 300), (200, 128, 9, 200), (1, 8, 4, 1),
             (65, 24, 9, 130), (5000, 1024, 3, 4096)]


@pytest.mark.parametrize("n,dp,width,f", WS_SHAPES)
@pytest.mark.parametrize("sms", [132, 7])
def test_ws_plan_covers_every_tile_pair_once(n, dp, width, f, sms):
    plan = conv.ws_plan(n, dp, width, f, sms)
    assert plan.row_tiles == -(-n // conv.WS_ROWS)
    assert plan.freq_tiles == -(-f // conv.TILE_FREQS)
    assert 1 <= plan.split <= max(1, plan.row_tiles)
    walks = conv.ws_tiles(plan)
    assert len(walks) == plan.split * plan.freq_tiles   # the grid
    pairs = [pair for walk in walks for pair in walk]
    assert len(pairs) == len(set(pairs)) == \
        plan.row_tiles * plan.freq_tiles
    assert set(pairs) == {(rt, ft) for rt in range(plan.row_tiles)
                          for ft in range(plan.freq_tiles)}
    # A block stays on one frequency tile; its row tiles are strided.
    for walk in walks:
        assert len({ft for _, ft in walk}) <= 1
        rts = [rt for rt, _ in walk]
        assert all(b - a == plan.split for a, b in zip(rts, rts[1:]))


@pytest.mark.parametrize("dp", [8, 24, 64, 72, 128, 136, 256, 1024])
@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 8, 9, 10, 17])
def test_ws_plan_keeps_projT_resident_only_when_it_fits(dp, width):
    plan = conv.ws_plan(4096, dp, width, 1024, 132)
    kc = -(-dp // conv.WS_CHANNELS)
    tile = width * kc * conv.WS_P_BOX
    ring = (width + 1) * kc * conv.WS_X_BOX   # a window pair's positions
    fits = tile + ring + conv.WS_RESERVED <= 232_448
    assert plan.resident == fits
    assert 2 <= plan.stages <= conv.WS_MAX_STAGES
    if plan.resident:
        assert plan.stages >= (width + 1) * kc
        assert plan.smem == tile + plan.stages * conv.WS_X_BOX + 1024
    else:
        assert conv.WS_STREAM_STAGE == conv.WS_P_BOX + 2 * conv.WS_X_BOX
        assert plan.smem == plan.stages * conv.WS_STREAM_STAGE + 1024
    # The launch's dynamic memory, its barriers and slack fit a block.
    assert plan.smem - 1024 + conv.WS_RESERVED <= 232_448


def _rebuild_from_layout(xt, order, nk_t, top, projT, width, sigma,
                         row_scale):
    """K3's (c, s) and K4's out as the bf16 kernel forms them from its
    operands, in float64: row tile i is rows 64i .. 64i + 63 of xt (zeros
    past N and past L, as TMA fills them), window j of the pairs covering
    top[i] is the sum over taps t of position box j + t against projT's
    tap t, folded in window order where j < nk_t, and written to row
    order[r]."""
    xt, pt = xt.double(), projT.double()
    n, l, dp = xt.shape
    f = pt.shape[0]
    pt = pt.reshape(f, width, dp)
    rows = conv.WS_ROWS
    c = torch.zeros((n, f), dtype=torch.float64)
    s = torch.zeros((n, f), dtype=torch.float64)
    m = torch.zeros((n, f), dtype=torch.float64)
    for i, t_top in enumerate(top.tolist()):
        pairs = (t_top + 1) // 2
        tile = torch.zeros((rows, l + 1, dp), dtype=torch.float64)
        got = xt[i * rows:(i + 1) * rows]
        tile[:len(got), :l] = got
        nk = torch.zeros(rows, dtype=torch.int64)
        nk[:len(got)] = nk_t[i * rows:(i + 1) * rows].long()
        tc = torch.zeros((rows, f), dtype=torch.float64)
        ts, tm = torch.zeros_like(tc), torch.zeros_like(tc)
        for j in range(2 * pairs):
            g = sum(tile[:, j + t, :] @ pt[:, t, :].T for t in range(width))
            valid = (j < nk)[:, None]
            tc += torch.where(valid, torch.cos(g * sigma), 0.0)
            ts += torch.where(valid, torch.sin(g * sigma), 0.0)
            tm = torch.where(valid, torch.maximum(tm, g), tm)
        dst = order[i * rows:(i + 1) * rows].long()
        k = len(got)
        c[dst], s[dst], m[dst] = tc[:k], ts[:k], tm[:k]
    return c * row_scale[:, None], s * row_scale[:, None], m


@pytest.mark.parametrize("n,l,d,width,f,kind", [
    (150, 16, 64, 9, 40, "spread"), (130, 12, 7, 5, 20, "spread"),
    (100, 12, 9, 9, 24, "equal"), (70, 6, 10, 1, 16, "spread"),
    (64, 10, 3, 4, 8, "equal")])
def test_tile_layout_rebuilds_the_plain_outputs(n, l, d, width, f, kind):
    rng = np.random.default_rng(n + d)
    # bf16-representable operands, so the layout's bf16 copies are exact.
    x = torch.as_tensor(rng.standard_normal((n, l, d)) * 0.5) \
        .to(torch.bfloat16).double()
    proj = torch.as_tensor(rng.standard_normal((width * d, f)) * 0.3) \
        .to(torch.bfloat16).double()
    lens = _lengths(n, l, width, d, kind)
    xt, order, nk_t, top = conv.tile_layout(x, lens, width)
    dp = -(-d // 8) * 8
    assert xt.dtype == torch.bfloat16 and tuple(xt.shape) == (n, l, dp)
    assert order.dtype == nk_t.dtype == top.dtype == torch.int32
    o, nk = conv.row_order(lens, width, l - width + 1)
    assert torch.equal(order, o) and torch.equal(nk_t, nk[o.long()])
    assert torch.equal(xt[:, :, :d].double(), x[o.long()])
    assert float(xt[:, :, d:].abs().sum()) == 0.0
    assert len(top) == -(-n // conv.WS_ROWS)
    projT = operands.projT_planes(proj, "bf16", width)[0]
    scale = torch.linspace(0.5, 1.5, n, dtype=torch.float64)
    c, s, m = _rebuild_from_layout(xt, order, nk_t, top, projT, width, 0.7,
                                   scale)
    want_c, want_s = conv.conv_parts_plain(x, lens, proj, 0.7, width, scale,
                                           "exact")
    want_m = conv.conv_maxpool_plain(x, lens, proj, width)
    for got, want in ((c, want_c), (s, want_s), (m, want_m)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)
    if kind == "equal":
        assert len(set(top.tolist())) == 1


@pytest.mark.parametrize("d,width,f", [(64, 9, 96), (7, 5, 50), (21, 1, 33),
                                       (128, 9, 20)])
def test_conv_projT_bf16_plane_is_cached_and_exact(d, width, f):
    rng = np.random.default_rng(d + width)
    proj = torch.as_tensor(rng.standard_normal((width * d, f)) * 0.3,
                           dtype=torch.float32)
    x = torch.zeros((2, width + 1, d), dtype=torch.float32)
    plane, none = operands.projT_planes(proj, "bf16", width)
    assert none is None
    want = operands.kernel_planes(conv.pad_operands(x, proj, width, 8)[1],
                                  "bf16")[0]
    assert plane.dtype == torch.bfloat16 and plane.is_contiguous()
    assert torch.equal(plane, want)
    assert operands.projT_planes(proj, "bf16", width)[0] is plane  # a hit
    # The dense transpose of the same tensor is another entry.
    dense = operands.projT_planes(proj, "bf16")[0]
    assert dense.shape == (f, -(-width * d // 8) * 8)
    proj.mul_(0.5)                                   # a new version
    again = operands.projT_planes(proj, "bf16", width)[0]
    assert again is not plane
    assert torch.equal(again, operands.kernel_planes(
        conv.pad_operands(x, proj, width, 8)[1], "bf16")[0])
