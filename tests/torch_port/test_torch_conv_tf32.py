"""K3/K4's 3xTF32 body (csrc/conv_tf32.cuh): its host-side plan and
layouts, and its walk's index arithmetic, on the CPU.

The wrapper lays x out in tile order as TF32 hi and lo planes
(``conv.tile_layout(..., "tf32x3")``) and takes projT's planes from the
cache kept with proj (``operands.projT_planes(proj, "tf32x3", width)``);
each is held against ``kernel_planes`` of the padded operands.  The plan
(``conv.tf32_plan``) must give every (row tile, frequency tile) to exactly
one block, for every card it can choose.  Then the kernel's walk is
replayed in numpy, block by block: the producer's TMA boxes in the order
it fills the two rings (projT's (tap, line) boxes, the pair's position
boxes, each a box of the laid-out operands with the hardware's zero
fill), and the consumers' reads of those fills by the kernel's cursors
(each window's products tap-major, then channel lines, lo*hi + hi*lo +
hi*hi; window j + 1's skipped in the last pair of a tile whose largest
count is odd), the releases (each fill freed once, after its last read and one
line late, as the kernel frees a line once the next one is issued; a
fill that would land on a stage not yet freed is a deadlock of the
ring) and the fold's choice of windows.  The projections for every
valid window must equal ``window_projection``'s less the dropped lo*lo
term, at float64 roundoff.  What only the card can show (that the code
compiles, that the hardware takes the boxes so) is held in
test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

from xgpr_tpu_torch.ops.cuda import conv, operands

# csrc/conv_tf32.cuh: rows of a row tile, fp32 channels of a line,
# frequencies of a projT box, stages of the position ring.
ROWS, CH, GN, X_STAGES = 64, 32, 128, 6


def _inputs(n, l, d, width, f, seed, kind="spread"):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((n, l, d)) * 0.5,
                        dtype=torch.float32)
    proj = torch.as_tensor(rng.standard_normal((width * d, f)) * 0.3,
                           dtype=torch.float32)
    if kind == "equal":
        lens = np.full(n, (l + width) // 2, dtype=np.int32)
    else:
        lens = rng.integers(width - 1, l + 1, size=n).astype(np.int32)
        lens[0] = width - 1                   # a row with no valid window
    return x, torch.as_tensor(lens), proj


PLAN_SHAPES = [(8192, 4096), (8192, 1024), (8192, 128), (300, 256),
               (257, 200), (192, 300), (320, 40), (64, 3), (1, 1),
               (65, 130), (5000, 4096), (1000, 8_388_736)]


@pytest.mark.parametrize("n,f", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 66, 7, 1])
def test_tf32_plan_covers_every_tile_pair_once(n, f, sms):
    plan = conv.tf32_plan(n, f, sms)
    assert plan.row_tiles == -(-n // ROWS)
    assert plan.freq_tiles == -(-f // GN)
    assert 1 <= plan.split <= max(1, plan.row_tiles)
    if plan.freq_tiles > 100:   # past 65,535 frequency tiles: the grid
        assert plan.split * plan.freq_tiles < 2 ** 31
        return
    walks = conv.ws_tiles(plan)
    assert len(walks) == plan.split * plan.freq_tiles   # the grid
    pairs = [pair for walk in walks for pair in walk]
    assert len(pairs) == len(set(pairs)) == plan.row_tiles * plan.freq_tiles


@pytest.mark.parametrize("n,l,d,width", [(150, 7, 5, 3), (64, 16, 64, 9),
                                         (1, 9, 3, 9), (70, 10, 128, 2)])
def test_tile_layout_splits_x_into_tf32_planes_in_tile_order(n, l, d, width):
    x, lens, _ = _inputs(n, l, d, width, 8, n + d)
    xt, order, nk_t, top = conv.tile_layout(x, lens, width, "tf32x3")
    o, nk = conv.row_order(lens, width, l - width + 1)
    hi, lo = operands.kernel_planes(operands.pad_depth(x, 4), "tf32x3")
    assert xt.dtype == torch.float32 and xt.is_contiguous()
    assert tuple(xt.shape) == (2, n, l, hi.shape[2])
    assert torch.equal(order, o) and torch.equal(nk_t, nk[o.long()])
    assert torch.equal(xt[0], hi[o.long()]) and \
        torch.equal(xt[1], lo[o.long()])
    assert torch.equal(xt[0] + xt[1], operands.pad_depth(x, 4)[o.long()])
    assert len(top) == -(-n // ROWS)


@pytest.mark.parametrize("d,width,f", [(64, 9, 96), (7, 5, 50), (21, 1, 33),
                                       (128, 9, 20)])
def test_conv_projT_tf32_planes_are_cached_and_exact(d, width, f):
    rng = np.random.default_rng(d + width + 1)
    proj = torch.as_tensor(rng.standard_normal((width * d, f)) * 0.3,
                           dtype=torch.float32)
    x = torch.zeros((2, width + 1, d), dtype=torch.float32)
    hi, lo = operands.projT_planes(proj, "tf32x3", width)
    want_hi, want_lo = operands.kernel_planes(
        conv.pad_operands(x, proj, width)[1], "tf32x3")
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert hi.is_contiguous() and lo.is_contiguous()
    assert operands.projT_planes(proj, "tf32x3", width)[0] is hi   # a hit
    proj.mul_(0.5)                                               # new version
    again = operands.projT_planes(proj, "tf32x3", width)[0]
    assert again is not hi
    assert torch.equal(again, operands.kernel_planes(
        conv.pad_operands(x, proj, width)[1], "tf32x3")[0])


def _box(a, starts, sizes):
    """a[starts : starts + sizes] along each axis, zeros past a's end (the
    TMA box's fill)."""
    out = np.zeros(sizes, dtype=np.float64)
    src = tuple(slice(max(s, 0), min(s + z, n))
                for s, z, n in zip(starts, sizes, a.shape))
    dst = tuple(slice(sl.start - s, sl.stop - s)
                for sl, s in zip(src, starts))
    if all(sl.stop > sl.start for sl in src):
        out[dst] = a[src]
    return out


class Stage:
    """A ring stage: its fills so far, each read and released."""

    def __init__(self):
        self.content = None
        self.fill = -1
        self.released = True


def _replay(xt, order, nk_t, top, hi, lo, n, l, dp, width, f, plan):
    """The kernel's walk: returns (proj, folded), proj (N, nw, F) the
    projections the consumers hold for each (input row, window) they fold,
    folded the count of folds of each (row, window, frequency)."""
    nw = l - width + 1
    kc = -(-dp // CH)
    steps = width * kc
    share = kc + 2 <= X_STAGES
    pt = np.stack([hi.numpy(), lo.numpy()]).reshape(2, f, width, dp)
    xs = xt.numpy()
    top = top.numpy()
    out = np.zeros((n, nw, f))
    folded = np.zeros((n, nw, f), dtype=np.int64)
    for walk in conv.ws_tiles(plan):
        # The producer: the x fills and the projT fills, in its order.
        xfills, pfills = [], []
        for rt, ft in walk:
            for jp in range((top[rt] + 1) // 2):
                j, line = 2 * jp, 0
                for t in range(width):
                    for kk in range(kc):
                        if not share:
                            new = [(j + t, kk), (j + t + 1, kk)]
                        else:
                            first = 0 if line == 0 else line + kc
                            new = [(j + fx // kc, fx % kc)
                                   for fx in range(first, line + kc + 1)]
                        for pos, k2 in new:
                            xfills.append(_box(
                                xs, (0, rt * ROWS, pos, CH * k2),
                                (2, ROWS, 1, CH))[:, :, 0, :])
                        pfills.append(_box(pt, (0, ft * GN, t, CH * kk),
                                           (2, GN, 1, CH))[:, :, 0, :])
                        line += 1
        # The consumers, both halves at once (a box's 128 frequencies).
        xring = [Stage() for _ in range(X_STAGES)]
        pq = xq = 0
        for rt, ft in walk:
            f0 = ft * GN
            for jp in range((top[rt] + 1) // 2):
                j = 2 * jp
                xa, xb = xq, xq + (kc if share else 1)
                step = 1 if share else 2
                xq += (width + 1) * kc if share else 2 * steps
                acc = np.zeros((2, ROWS, GN))
                # A tile of an odd largest count skips window j + 1 in its
                # last pair: a fold of it would read NaN.
                both = j + 1 < top[rt]
                if not both:
                    acc[1] = np.nan
                pending = []   # the line before's stages
                for t in range(width):
                    for kk in range(kc):
                        pbox = pfills[pq]
                        pq += 1
                        for v, fx in ((0, xa), (1, xb)):
                            st = xring[fx % X_STAGES]
                            if st.fill != fx:      # the fill lands once
                                # its stage's last fill is freed; else the
                                # producer waits forever
                                assert st.released, "ring deadlock"
                                assert fx == st.fill + X_STAGES or \
                                    st.fill < 0
                                st.fill, st.content = fx, xfills[fx]
                                st.released = False
                            if v == 1 and not both:
                                continue
                            box = st.content
                            acc[v] += box[1] @ pbox[0].T   # lo * hi
                            acc[v] += box[0] @ pbox[1].T   # hi * lo
                            acc[v] += box[0] @ pbox[0].T   # hi * hi
                        # The line before is freed once this line's
                        # products are issued: window 0's box always,
                        # window 1's at the last tap (or always, unshared).
                        for st in pending:
                            st.released = True
                        pending = [xring[xa % X_STAGES]]
                        if not share or t == width - 1:
                            pending.append(xring[xb % X_STAGES])
                        xa += step
                        xb += step
                for st in pending:
                    st.released = True
                # The fold: window j + v of row r when j + v < nk.
                for v in range(2):
                    for r in range(min(ROWS, n - rt * ROWS)):
                        row = rt * ROWS + r
                        if j + v < nk_t[row]:
                            orig = int(order[row])
                            cols = slice(f0, min(f0 + GN, f))
                            out[orig, j + v, cols] = \
                                acc[v, r, :cols.stop - f0]
                            folded[orig, j + v, cols] += 1
        assert xq == len(xfills) and pq == len(pfills)
        assert all(st.released for st in xring)
    return out, folded


TF32_SHAPES = [(300, 16, 64, 9, 256, "spread"),   # the motif L, D, w
               (200, 16, 128, 9, 200, "spread"),  # D 128: 4 lines a tap
               (257, 20, 7, 5, 131, "spread"),    # N, D, F off their tiles
               (130, 14, 21, 6, 129, "spread"),   # D 21
               (70, 9, 3, 9, 65, "spread"),       # L == w, D 3
               (192, 16, 64, 9, 140, "equal"),    # every row alike
               (320, 12, 10, 1, 40, "spread"),    # w 1
               (100, 8, 256, 3, 130, "spread")]   # D 256: no shared boxes


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("n,l,d,width,f,kind", TF32_SHAPES)
def test_tf32_walk_projects_every_valid_window(sms, n, l, d, width, f,
                                               kind):
    x, lens, proj = _inputs(n, l, d, width, f, n + l + d, kind)
    plan = conv.tf32_plan(n, f, sms)
    xt, order, nk_t, top = conv.tile_layout(x, lens, width, "tf32x3")
    hi, lo = operands.projT_planes(proj, "tf32x3", width)
    dp = xt.shape[3]
    got, folded = _replay(xt, order, nk_t, top, hi, lo, n, l, dp, width, f,
                          plan)
    mask = conv.window_mask(lens, width, l - width + 1).numpy()
    assert np.array_equal(folded, np.repeat(mask[:, :, None], f, axis=2))
    # The three products drop lo(x) * lo(proj).
    x_lo = x - operands.split_tf32(x)[0]
    p_lo = proj - operands.split_tf32(proj)[0]
    want = (conv.window_projection(x.double(), proj.double(), width,
                                   "highest")
            - conv.window_projection(x_lo.double(), p_lo.double(), width,
                                     "highest")).numpy()
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-12,
                               atol=1e-12)
