"""K3/K4's synchronous kernel (csrc/conv_sync.cuh): its host-side layouts
and its tiles' index arithmetic, on the CPU.

The wrapper lays x out for the fp32 body with the rows in tile order and
last (``conv.sync_layout``) and pads proj's frequencies to 16 bytes
(``operands.pad_freqs``); the float64 body reads x with its channels padded to
an even count and projT's cached plane.  Each is held against
``row_order`` / ``pad_operands``.  Then the kernel's walk is replayed in
numpy, copy by copy: each block's window groups and depth steps, each
thread's 16-byte copies into a stage (FmaTile.load's channel-major tiles;
DmmaTile.load's 128-byte swizzled lines), the products each stage feeds
(the fp32 tile's K-major outer products; the float64 warps' m16n8k8
fragments, assembled from every lane as PTX lays them out) and the rows
and frequencies the epilogue reads back.  The projections they give for
every valid window must equal ``window_projection`` at float64 roundoff.
What only the card can show (that the code compiles, that the hardware
takes the fragments so) is held in test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

from xgpr_tpu_torch.ops.cuda import conv, operands

SEQ, PAIR, THREADS = 64, 2, 256


def _inputs(n, l, d, width, f, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((n, l, d)))
    proj = torch.as_tensor(rng.standard_normal((width * d, f)) * 0.3)
    lens = rng.integers(width - 1, l + 1, size=n).astype(np.int32)
    lens[0] = width - 1                       # a row with no valid window
    return x, torch.as_tensor(lens), proj


def _want(x, lens, proj, width):
    """(N, nw, F) projections and the (N, nw) mask of valid windows."""
    g = conv.window_projection(x, proj, width, "highest").numpy()
    mask = conv.window_mask(lens, width, g.shape[1]).numpy()
    return g, mask


@pytest.mark.parametrize("n,l,d", [(150, 7, 5), (64, 16, 64), (1, 9, 3)])
def test_sync_layout_puts_the_tile_rows_last(n, l, d):
    x, lens, _ = _inputs(n, l, d, 3, 8, n + d)
    order, _ = conv.row_order(lens, 3, l - 2)
    xt = conv.sync_layout(x, order)
    rows = -(-n // SEQ) * SEQ
    assert xt.shape == (l, d, rows) and xt.is_contiguous()
    flat = xt.permute(2, 0, 1)
    torch.testing.assert_close(flat[:n], x[order.long()], rtol=0, atol=0)
    torch.testing.assert_close(flat[n:], x[:1].expand(rows - n, l, d),
                               rtol=0, atol=0)


@pytest.mark.parametrize("f", [128, 130, 4096, 3])
def test_sync_proj_pads_frequencies_to_16_bytes(f):
    proj = torch.as_tensor(np.random.default_rng(f).standard_normal((12, f)),
                           dtype=torch.float32)
    got = operands.pad_freqs(proj)
    fp = -(-f // 4) * 4
    assert got.shape == (12, fp) and got.is_contiguous()
    assert torch.equal(got[:, :f], proj)
    assert float(got[:, f:].abs().sum()) == 0.0
    if fp == f:
        assert got.data_ptr() == proj.data_ptr()


def _blocks(n, f, bn, order, nk):
    """(tile, f0, groups): the grid's blocks, each with its window groups
    up to its tile's largest count."""
    nk_t = nk[order.long()].numpy()
    for tile in range(-(-n // SEQ)):
        top = int(nk_t[tile * SEQ:(tile + 1) * SEQ].max())
        for f0 in range(0, f, bn):
            yield tile, f0, -(-top // PAIR)


def _fma_projections(x, lens, proj, width):
    """The fp32 body's walk (FmaTile, float64 arithmetic): (N, nw, F)
    projections, NaN where no block wrote one."""
    n, l, d = x.shape
    f = proj.shape[1]
    nw = l - width + 1
    ks, bn = 32, 128
    order, nk = conv.row_order(lens, width, nw)
    xt = conv.sync_layout(x, order).numpy().ravel()
    rows = order.numpy()
    nrows = -(-n // SEQ) * SEQ
    pr = operands.pad_freqs(proj)
    fp = pr.shape[1]
    pr = pr.numpy().ravel()
    ids = np.arange(4 * THREADS)
    k, win, qa, qb = ids >> 5, (ids >> 4) & 1, ids & 15, ids & 31
    out = np.full((n, nw, f), np.nan)
    for tile, f0, groups in _blocks(n, f, bn, order, nk):
        for gi in range(groups):
            j0 = PAIR * gi
            acc = np.zeros((PAIR * SEQ, bn))
            for tap in range(width):
                for kk in range(-(-d // ks)):
                    c = kk * ks + k
                    pos = j0 + win + tap
                    a_st = np.zeros(ks * PAIR * SEQ)
                    ok = (c < d) & (pos < l)
                    src = ((pos * d + c) * nrows + SEQ * tile + 4 * qa)[ok]
                    dst = (k * PAIR * SEQ + win * SEQ + 4 * qa)[ok]
                    for v in range(4):
                        a_st[dst + v] = xt[src + v]
                    b_st = np.zeros(ks * bn)
                    col = f0 + 4 * qb
                    ok = (c < d) & (col < fp)
                    src = ((tap * d + c) * fp + col)[ok]
                    dst = (k * bn + 4 * qb)[ok]
                    for v in range(4):
                        b_st[dst + v] = pr[src + v]
                    acc += a_st.reshape(ks, -1).T @ b_st.reshape(ks, bn)
            # Thread (warp q, lane): sequences sb + i, frequencies fb + c.
            for tid in range(THREADS):
                q, lane = tid // 32, tid % 32
                sb = 16 * (q // 2) + 4 * (lane // 8)
                fb = 64 * (q % 2) + 4 * (lane % 8)
                cols = fb + np.array([0, 1, 2, 3, 32, 33, 34, 35])
                for h in range(PAIR):
                    for i in range(4):
                        row = tile * SEQ + sb + i
                        keep = f0 + cols < f
                        if row < n and j0 + h < nw:
                            out[rows[row], j0 + h, f0 + cols[keep]] = \
                                acc[h * SEQ + sb + i, cols[keep]]
    return out


def _sw128(r, c):
    return r * 128 + ((c ^ (r % 8)) << 4)


def _dmma_projections(x, lens, proj, width):
    """The float64 body's walk (DmmaTile): steps of two swizzled lines of 16
    values, each m16n8k8 product assembled from its 32 lanes' fragments
    (a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4],
    b0 = B[t][g], b1 = B[t + 4][g]; lane (g, t) reads its c at D[g][2t + e]
    and D[g + 8][2t + e])."""
    n, l, d0 = x.shape
    f = proj.shape[1]
    nw = l - width + 1
    ks, bn, lines = 32, 64, 2     # a step: two 128-byte lines of 16
    order, nk = conv.row_order(lens, width, nw)
    rows = order.numpy()
    xp = operands.pad_depth(x, operands.depth_multiple("f64")).numpy()
    d = xp.shape[2]
    pt = operands.projT_planes(proj, "f64", width)[0].numpy()
    assert pt.shape == (f, width * d)
    a_bytes = PAIR * SEQ * 128
    tids = np.arange(THREADS)
    lc = tids % 8
    out = np.full((n, nw, f), np.nan)
    for tile, f0, groups in _blocks(n, f, bn, order, nk):
        row0 = tile * SEQ
        for gi in range(groups):
            j0 = PAIR * gi
            acc = np.zeros((8, 32, 2, 4, 4))  # warp, lane, m, n, c0..c3
            for tap in range(width):
                for kk, line in np.ndindex(-(-d // ks), lines):
                    st = np.zeros((a_bytes + bn * 128) // 8)
                    c = kk * ks + 16 * line + 2 * lc
                    for i in range(4):
                        r = (tids + THREADS * i) // 8
                        s = (r // 16) * 8 + r % 8
                        pos = j0 + (r // 8) % 2 + tap
                        for t in range(THREADS):
                            if row0 + s[t] < n and c[t] < d and pos[t] < l:
                                at = _sw128(r[t], lc[t]) // 8
                                st[at:at + 2] = xp[rows[row0 + s[t]], pos[t],
                                                   c[t]:c[t] + 2]
                    for i in range(2):
                        r = (tids + THREADS * i) // 8
                        for t in range(THREADS):
                            if c[t] < d and f0 + r[t] < f:
                                at = (a_bytes + _sw128(r[t], lc[t])) // 8
                                off = tap * d + c[t]
                                st[at:at + 2] = pt[f0 + r[t], off:off + 2]
                    for q in range(8):
                        for half in range(2):
                            for m in range(2):
                                for nn in range(4):
                                    a = np.zeros((16, 8))
                                    b = np.zeros((8, 8))
                                    for lane in range(32):
                                        g, t = lane // 4, lane % 4
                                        ch = 2 * t + half
                                        ar = 32 * (q // 2) + g + 16 * m
                                        a0 = st[_sw128(ar, ch) // 8:][:2]
                                        a1 = st[_sw128(ar + 8, ch) // 8:][:2]
                                        br = 32 * (q % 2) + g + 8 * nn
                                        bv = st[(a_bytes + _sw128(br, ch))
                                                // 8:][:2]
                                        a[g, t], a[g + 8, t] = a0[0], a1[0]
                                        a[g, t + 4] = a0[1]
                                        a[g + 8, t + 4] = a1[1]
                                        b[t, g], b[t + 4, g] = bv[0], bv[1]
                                    dd = a @ b
                                    for lane in range(32):
                                        g, t = lane // 4, lane % 4
                                        acc[q, lane, m, nn] += [
                                            dd[g, 2 * t], dd[g, 2 * t + 1],
                                            dd[g + 8, 2 * t],
                                            dd[g + 8, 2 * t + 1]]
            for q in range(8):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for m in range(2):
                        row = row0 + 16 * (q // 2) + g + 8 * m
                        for nn in range(4):
                            for h in range(PAIR):
                                for e in range(2):
                                    col = f0 + 32 * (q % 2) + 8 * nn + \
                                        2 * t + e
                                    if row < n and j0 + h < nw and col < f:
                                        out[rows[row], j0 + h, col] = \
                                            acc[q, lane, m, nn, 2 * h + e]
    return out


@pytest.mark.parametrize("n,l,d,width,f", [(70, 12, 37, 4, 130),
                                           (64, 16, 64, 9, 128),
                                           (5, 6, 3, 1, 7)])
def test_fma_tile_walk_projects_every_valid_window(n, l, d, width, f):
    x, lens, proj = _inputs(n, l, d, width, f, n * l + d)
    want, mask = _want(x, lens, proj, width)
    got = _fma_projections(x, lens, proj, width)
    assert not np.isnan(got[mask]).any()
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("n,l,d,width,f", [(9, 6, 21, 2, 70),
                                           (3, 4, 3, 1, 9)])
def test_dmma_tile_walk_projects_every_valid_window(n, l, d, width, f):
    x, lens, proj = _inputs(n, l, d, width, f, n * l + d)
    want, mask = _want(x, lens, proj, width)
    got = _dmma_projections(x, lens, proj, width)
    assert not np.isnan(got[mask]).any()
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-12,
                               atol=1e-12)
