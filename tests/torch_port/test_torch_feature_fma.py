"""K2's fp32 FMA body (csrc/feature_map_fma.cu, "highest"): its walks, its
register tile and its order, replayed on the CPU.

The kernel's own arithmetic, mirrored in ``operands`` (``fma_walks``,
``fma_cells``), must give every 128 x 128 tile of the output to one block
and every (row, frequency) of a tile to one thread; a quarter warp's A
loads must be one address and its B loads, like its stores of a row, 128
contiguous bytes.  Each output is
one fmaf chain over the channels in order from zero: replayed with an
exact fmaf (``fmaf32``, itself checked against exact rational
arithmetic), the ring's steps of 16 channels (a ragged last step), the
sequential chain over the channels and the chain of the body it replaced
(32-channel lines, the depth past D zero-filled) give the same bits.
Last, the replayed chain folded to sincos and stored by the threads'
cells and the kernel's store rules (16-byte runs where aligned, value by
value otherwise) must match ``xgpr_tpu``'s Pallas feature map in
interpret mode at 1e-5 (a ragged last block, which its gate refuses,
against the plain version).  What only the card can show is in
test_torch_cuda_kernels.py.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgpr_tpu.ops.pallas.sorf_pallas import (pad_operands,
                                             rbf_feature_map_pallas)
from xgpr_tpu_torch.ops.cuda import feature_map, operands
from xgpr_tpu_torch.ops.sorf import rbf_norm_constant


def fmaf32(a, b, c):
    """fmaf on float32 arrays: a * b + c rounded once to float32 (to
    nearest even).  The product is exact in float64; the float64 sum and
    its error (two-sum) settle the one case a second rounding could get
    wrong, a sum that lands on a midpoint of two float32 values."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64)
               for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)             # p + c == s + err exactly
    r = s.astype(np.float32)
    other = np.where(r.astype(np.float64) < s,
                     np.nextafter(r, np.float32(np.inf)),
                     np.nextafter(r, np.float32(-np.inf)))
    lo, hi = np.minimum(r, other), np.maximum(r, other)
    tie = (s - lo.astype(np.float64)) == (hi.astype(np.float64) - s)
    return np.where(tie & (err > 0), hi, np.where(tie & (err < 0), lo, r))


def test_fmaf32_rounds_once():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = rng.standard_normal(3000).astype(np.float32)
    # a * b + c = +-(1 + 2^-23 + 2^-24 - 2^-60): a hair inside a float32
    # midpoint that the float64 sum rounds onto, where rounding that sum
    # again to nearest even would step out.
    a[:500] = np.float32(2.0 ** -12 * (1 - 2.0 ** -18))
    b[:250] = np.float32(2.0 ** -12 * (1 + 2.0 ** -18))
    b[250:500] = -b[:250]
    c[:250] = np.float32(1 + 2.0 ** -23)
    c[250:500] = -c[:250]
    got = fmaf32(a, b, c)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (got[:500] != twice[:500]).all()
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        up = np.nextafter(r, np.float32(np.inf))
        dn = np.nextafter(r, np.float32(-np.inf))
        d0 = abs(exact - Fraction(float(r)))
        assert d0 <= abs(exact - Fraction(float(up)))
        assert d0 <= abs(exact - Fraction(float(dn)))
        if d0 in (abs(exact - Fraction(float(up))),
                  abs(exact - Fraction(float(dn)))):
            assert int(np.float32(r).view(np.int32)) % 2 == 0   # to even


@pytest.mark.parametrize("n,f", [(8192, 4096), (8192, 2048), (300, 200),
                                 (1, 1), (129, 4100)])
@pytest.mark.parametrize("sms", [132, 7])
def test_fma_walks_cover_every_tile_once(n, f, sms):
    rsplit = operands.tile_split(-(-n // 128), -(-f // 128),
                                 sms * feature_map.FMA_BLOCKS_PER_SM, 64)
    walks = operands.fma_walks(n, f, rsplit)
    assert len(walks) == rsplit * -(-f // 128)
    seen = [(f0, r0) for f0, rows in walks for r0 in rows]
    assert len(seen) == len(set(seen)) == -(-n // 128) * -(-f // 128)


def test_fma_thread_cells_cover_the_tile_once():
    seen = np.zeros((128, 128), dtype=int)
    for q in range(8):
        for lane in range(32):
            rows, freqs = operands.fma_cells(q, lane)
            seen[np.ix_(rows, freqs)] += 1
    assert (seen == 1).all()


def test_fma_loads_and_stores_are_broadcast_or_contiguous():
    """A quarter warp (lanes 8 ty .. 8 ty + 7) reads one A address (its
    rows' 16 bytes); in each of its two B loads (csrc/feature_map_fma.cu:
    b_at, b_at + F_RUN), and in each of its 16-byte stores of a row, its
    lanes take 8 consecutive 4-frequency runs, 128 contiguous bytes."""
    for q in range(8):
        for ty in range(4):
            cells = [operands.fma_cells(q, lane)
                     for lane in range(8 * ty, 8 * ty + 8)]
            assert len({tuple(rows) for rows, _ in cells}) == 1
            for run in (0, 1):
                firsts = [freqs[4 * run] for _, freqs in cells]
                assert firsts == list(range(firsts[0], firsts[0] + 32, 4))
                for _, freqs in cells:
                    f = freqs[4 * run]
                    assert f % 4 == 0
                    assert freqs[4 * run:4 * run + 4] == [f, f + 1, f + 2,
                                                          f + 3]


def chain(x, proj, order):
    """acc = x @ proj as fmaf chains from zero over channels in ``order``
    (indices into the depth, -1 for a zero-filled channel)."""
    acc = np.zeros((x.shape[0], proj.shape[1]), np.float32)
    for k in order:
        if k < 0:
            acc = fmaf32(np.float32(0), np.float32(0), acc)
        else:
            acc = fmaf32(x[:, k:k + 1], proj[k:k + 1, :], acc)
    return acc


def kernel_order(d):
    """The channels of the ring's steps in order: FMA_KS a step, the last
    step's channels past d not run."""
    ks = operands.FMA_KS
    return [k for step in range(-(-d // ks))
            for k in range(ks * step, min(ks * step + ks, d))]


@pytest.mark.parametrize("d", [84, 1, 16, 17, 200])
def test_fma_chain_is_the_sequential_and_the_parents(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((64, d)).astype(np.float32)
    proj = (rng.standard_normal((d, 48)) * 0.3).astype(np.float32)
    got = chain(x, proj, kernel_order(d))
    sequential = chain(x, proj, range(d))
    parent = chain(x, proj, [k if k < d else -1
                             for k in range(-(-d // 32) * 32)])
    assert np.array_equal(got.view(np.int32), sequential.view(np.int32))
    assert np.array_equal(got.view(np.int32), parent.view(np.int32))
    assert not (np.signbit(got) & (got == 0)).any()     # never -0
    assert np.abs(got - x.astype(np.float64) @ proj).max() < 1e-4


def k2_fma_replay(x, proj, intercept, padded, sms):
    """K2's outputs as csrc/feature_map_fma.cu's threads store them: each
    block's tiles, each thread's 8 rows by 8 frequencies, the fmaf chain in
    the ring's order, sincos in float32, and a run of 4 frequencies as one
    16-byte store where the kernel takes it (checked aligned) or value by
    value."""
    n, f = x.shape[0], proj.shape[1]
    acc = chain(x, proj, kernel_order(x.shape[1]))
    scale = np.float32(rbf_norm_constant(f, intercept))
    cos = (np.cos(acc) * scale).astype(np.float32)
    sin = (np.sin(acc) * scale).astype(np.float32)
    out = np.full((n, 2 * f), np.nan, dtype=np.float32)
    rsplit = operands.tile_split(-(-n // 128), -(-f // 128),
                                 sms * feature_map.FMA_BLOCKS_PER_SM, 64)
    wide = f % 2 == 0 and padded % 4 == 0
    for f0, tiles in operands.fma_walks(n, f, rsplit):
        tile_blk = f0 // padded if padded % 128 == 0 else -1
        for row0 in tiles:
            for q in range(8):
                for lane in range(32):
                    rows, freqs = operands.fma_cells(q, lane)
                    rows = [row0 + r for r in rows if row0 + r < n]
                    for hh in (0, 1):
                        run = [f0 + fr for fr in freqs[4 * hh:4 * hh + 4]]
                        blk = tile_blk if tile_blk >= 0 else run[0] // padded
                        width = min(padded, f - blk * padded)
                        if wide and run[3] < f and width % 4 == 0:
                            col = run[0] + blk * padded
                            assert col % 4 == 0 and (2 * f) % 4 == 0
                            assert all(fc // padded == blk for fc in run)
                            cols = list(range(col, col + 4))
                        else:
                            run = [fc for fc in run if fc < f]
                            cols = [fc + (fc // padded) * padded
                                    for fc in run]
                        for fc, col in zip(run, cols):
                            wd = min(padded, f - (fc // padded) * padded)
                            out[rows, col] = cos[rows, fc]
                            out[rows, col + wd] = sin[rows, fc]
    return out


@pytest.mark.parametrize("intercept", [False, True])
@pytest.mark.parametrize("n,d,padded,f", [
    (300, 84, 128, 512),   # 16-byte runs, 4 layout blocks
    (257, 84, 256, 384),   # a ragged last block at its width
    (130, 40, 64, 256),    # blocks narrower than a tile
    (200, 140, 512, 500),  # one narrow block, a partial last tile
    (129, 17, 6, 36),      # blocks of 6: value by value
    (64, 20, 64, 63),      # odd F: value by value
])
def test_k2_fma_replayed_layout_matches_pallas(intercept, n, d, padded, f):
    """Against the Pallas kernel in interpret mode where its gate takes
    the block split; a ragged last block (which it refuses) against the
    plain version, itself held against it (test_torch_feature_map.py)."""
    rng = np.random.default_rng(n + d + f)
    x = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    proj = (rng.standard_normal((d, f)) * 0.3).astype(np.float32)
    if f > padded and f % padded:
        want = feature_map.rbf_feature_map_plain(
            torch.from_numpy(x), torch.from_numpy(proj), intercept,
            padded).numpy()
    else:
        xp, pp = pad_operands(jnp.asarray(x), jnp.asarray(proj))
        want = np.asarray(rbf_feature_map_pallas(xp, pp, intercept, padded,
                                                 interpret=True))
    got = k2_fma_replay(x, proj, intercept, padded, 7)
    assert not np.isnan(got).any()
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("n,d,f", [(8, 3, 5), (130, 84, 4096), (4, 1, 4)])
def test_fma_operands(n, d, f):
    """x^T with its rows padded to 16 bytes by zeros, and proj with its
    frequencies padded likewise (proj itself when F is a multiple of 4)."""
    x = torch.randn(n, d)
    proj = torch.randn(d, f)
    xt = operands.rows_last(x)
    np_ = -(-n // 4) * 4
    assert xt.shape == (d, np_) and xt.is_contiguous()
    assert torch.equal(xt[:, :n], x.t()) and not xt[:, n:].any()
    pp = operands.pad_freqs(proj)
    assert pp.shape == (d, -(-f // 4) * 4) and pp.is_contiguous()
    assert torch.equal(pp[:, :f], proj) and not pp[:, f:].any()
    if f % 4 == 0:
        assert pp.data_ptr() == proj.data_ptr()
