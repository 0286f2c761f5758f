"""K1 and K2's 3xTF32 bodies and K1's bf16 body (csrc/dense_wgmma.cuh, one
pipeline over the format): the host-side plan and the walk's index
arithmetic, on the CPU, for each body.

The plan (``ztzv.launch_plan`` in "tf32x3" and "bf16", K2's
``tile_split``) and the blocks' walks (``operands.dense_walks``, the
kernels' own arithmetic) must give every (fixed tile, walked tile) of K2
and of each K1 pass to exactly one consumer of one block, for several
cards.  Then the pipeline is
replayed in numpy block by block: each consumer's thread 0 filling its
own ring (a stage again once the consumer has freed it; with a fixed A
tile consumer 0's filling the one ring both read) and consumer 0's
filling the streamed fixed ring, the mbarriers' phases, each consumer's
reads at the fill indices and parities the kernel computes, its release
of a line once the next is issued, and consumer 1 waiting for consumer
0's first tile; the replay fails on a box read from the wrong fill, a
stage refilled before it is freed, or a consumer that stops (a
deadlock); a line is 32 channels in 3xTF32 and 64 in bf16, so the rings
turn at other depths.  The replayed projections (3xTF32: lo*hi + hi*lo +
hi*hi of the boxes; bf16: the products of the bf16 planes' boxes; with
TMA's zero fill) must equal x @ proj less the dropped lo*lo term, or the
product of the bf16-rounded operands, at float64 roundoff.  Last, K1's
partial sums in the kernel's partition and order (per slice over its
tiles, slices in order; bf16 rounding c, s, v_c / v_s and the summed zv
where the kernel does) and K2's stores to the block [cos | sin] layout
(the staged boxes and the fragment stores) are replayed in float32 and
held against ``xgpr_tpu``'s Pallas kernels in interpret mode
(``_ztzv_parts_impl`` at 3e-5 * max(1, |ref|) in 3xTF32; under "default",
which interpret mode on the CPU computes in fp32, at 4 * 2^-8 of max|ref|,
and against the port's plain bf16 version at 1e-4 of it, ROADMAP.md's
bf16 tolerances; ``_rbf_feature_map_impl`` at 1e-5).  What only the
card can show is in test_torch_cuda_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgpr_tpu.ops.pallas.sorf_pallas import (pad_operands,
                                             rbf_feature_map_pallas)
from xgpr_tpu import config as jax_config
from xgpr_tpu.ops.pallas.ztzv_pallas import ztzv_parts_pallas
from xgpr_tpu_torch.ops.cuda import feature_map, operands, ztzv
from xgpr_tpu_torch.ops.sorf import rbf_norm_constant

# csrc/dense_wgmma.cuh: channels a line by body, the deepest resident
# fixed tile, the fixed ring's stages, each consumer's walk stages by
# kernel.
CH = {"tf32x3": 32, "bf16": 64}
RES_K, F_STAGES = 3, 3
WS = {"k2": 2, "out1": 3, "zv1": 3, "zvm": 3, "outm": 3}
BODIES = sorted(CH)


def _rhs(k, body="tf32x3"):
    """xgpr_ztzv_rhs_per_block: 1 at K 1, 8 up to K 8, then 16 (3xTF32) or
    32 (bf16)."""
    return 1 if k == 1 else 8 if k <= 8 else 32 if body == "bf16" else 16


def _passes(n, f, k, sms, body="tf32x3"):
    """(kernel, fixed_b, fixed rows, walked rows, split, kblocks) of K1's
    passes on the pipeline under launch_plan: its two passes, or on the
    reuse path the feature pass (K2's walk)."""
    plan = ztzv.launch_plan(_rhs(k, body), n, f, k, sms, body)
    if ztzv.reuses_features(body, k):
        return plan, [("k2", True, f, n, plan.rsplit, 1)]
    zv = ("zv1" if k == 1 else "zvm", False, n, f, plan.zsplit, plan.blocks)
    if k == 1:
        return plan, [zv, ("out1", True, f, n, plan.osplit, 1)]
    return plan, [zv, ("outm", False, f, n, plan.osplit, plan.blocks)]


PLAN_SHAPES = [(8192, 4096, 1), (8192, 4096, 26), (8192, 16384, 5),
               (300, 256, 1), (257, 200, 3), (130, 40, 17), (64, 3, 9),
               (1, 1, 1), (1000, 500, 64), (40, 16, 2)]


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("n,f,k", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 66, 7, 1])
def test_k1_walks_cover_every_tile_pair_once(n, f, k, sms, body):
    plan, passes = _passes(n, f, k, sms, body)
    assert plan.launches == 1
    for kind, fixed_b, fixed_rows, walk_rows, split, kb in passes:
        walks = operands.dense_walks(fixed_b, fixed_rows, walk_rows, split,
                                     kb)
        seen = []
        for w in walks:
            for c in (0, 1):
                for i in range(w.counts[c]):
                    row = w.first[c] + i * w.stride
                    # a consumer's tiles are its slice's, in order
                    assert (row // 128) % split == w.slices[c]
                    # fixed B: c's 64-row half of the walked tile; fixed
                    # A: c's 64 fixed rows against the whole tile
                    seen.append((w.fixed0, row, w.kz) if fixed_b else
                                (w.fixed0 + 64 * c, row, w.kz))
        halves = 2 * -(-(walk_rows if fixed_b else fixed_rows) // 128)
        if fixed_b:
            want = {(128 * a, 64 * b, 0) for a in range(-(-fixed_rows // 128))
                    for b in range(halves)}
        else:
            want = {(64 * a, 128 * b, z) for a in range(halves)
                    for b in range(-(-walk_rows // 128)) for z in range(kb)}
        assert len(seen) == len(set(seen)) == len(want)
        assert set(seen) == want
        # every slice of the split has a block that writes its partial
        written = {(w.fixed0, s, w.kz) for w in walks for s in w.slices}
        assert len(written) == len({w.fixed0 for w in walks}) * split * kb


# Shapes on 3xTF32's reuse path: SLQ's K 26 at slice A's chunk, K past
# one and two blocks of the streams' right-hand sides, ragged rows and F
# off the 64-wide stages (an F that is no multiple of 4 too).
REUSE_SHAPES = [(8192, 4096, 26), (8191, 4096, 17), (257, 300, 26),
                (130, 40, 64), (64, 3, 32), (1000, 501, 33), (40, 16, 700)]


@pytest.mark.parametrize("n,f,k", REUSE_SHAPES)
@pytest.mark.parametrize("sms", [132, 66, 7, 1])
def test_k1_stream_walks_cover_every_stage_once(n, f, k, sms):
    """Each stream block's stages (csrc/ztzv_reuse.cuh): pass (a) reads
    every (64 rows, 64-column stage of C or S, block of right-hand sides)
    once and pass (b) every (64 columns of C or S, 64-row stage, block)
    once; every slice of each split has a block that writes its
    partial."""
    plan = ztzv.launch_plan(_rhs(k), n, f, k, sms, "tf32x3")
    assert plan.projections == 1 and plan.rhs * plan.blocks >= k
    ctiles = -(-(-(-f // 4) * 4) // 64)
    rtiles = -(-n // 64)
    for pass_b, split in ((False, plan.zsplit), (True, plan.osplit)):
        walks = operands.stream_walks(pass_b, n, f, split, plan.blocks)
        seen = [(w.plane, w.fixed0, t, w.kz) for w in walks
                for t in w.stages]
        for w in walks:
            assert all(t % split == w.slice for t in w.stages)
        if pass_b:
            want = {(p, 64 * c, t, z) for p in (0, 1) for c in range(ctiles)
                    for t in range(rtiles) for z in range(plan.blocks)}
        else:
            want = {(None, 64 * r, t, z) for r in range(rtiles)
                    for t in range(2 * ctiles) for z in range(plan.blocks)}
        assert len(seen) == len(set(seen)) == len(want)
        assert set(seen) == want
        written = [(w.plane, w.fixed0, w.slice, w.kz) for w in walks]
        fixed = 2 * ctiles if pass_b else rtiles
        assert len(written) == len(set(written)) == \
            fixed * split * plan.blocks


@pytest.mark.parametrize("n,f", [(8192, 4096), (8192, 2048), (300, 200),
                                 (1, 1), (129, 4100)])
@pytest.mark.parametrize("sms", [132, 7])
def test_k2_walks_cover_every_tile_once(n, f, sms):
    tiles = -(-n // 128), -(-f // 128)
    split = operands.tile_split(tiles[0], tiles[1], sms, 64)
    walks = operands.dense_walks(True, f, n, split)
    assert len(walks) == split * tiles[1]
    seen = [(w.fixed0, w.first[c] + i * w.stride) for w in walks
            for c in (0, 1) for i in range(w.counts[c])]
    assert len(seen) == len(set(seen)) == 2 * tiles[0] * tiles[1]


class Barrier:
    """An mbarrier: arrivals a phase, phases completed."""

    def __init__(self, count):
        self.count, self.arrived, self.done = count, 0, 0

    def arrive(self, n=1):
        self.arrived += n
        assert self.arrived <= self.count
        if self.arrived == self.count:
            self.arrived, self.done = 0, self.done + 1


def consumer_program(w, c, kc, ws, shared):
    """Consumer c's operations in the kernel's order (Pipe::prologue,
    consume, done): the fills of the ring it reads ("fillw", j), by its
    own thread 0 or, on the ring both consumers read (``shared``, a fixed
    A tile), by consumer 0's; consumer 0's fills of the streamed fixed
    ring ("fillf", j); the waits for and reads of each ("w", j, box) /
    ("f", j); the releases ("rw", j) / ("rf", j); consumer 1's wait for
    consumer 0's first tile ("go_wait") and consumer 0's signal ("go")."""
    assert w.counts[0] == w.counts[1]       # both consumers walk alike
    resident = kc <= RES_K
    steps = w.counts[c] * kc
    fills = c == 0 or not shared
    prog = [("fillw", j) for j in range(min(ws, steps))] if fills else []
    if c == 0 and not resident:
        prog += [("fillf", j) for j in range(min(F_STAGES, steps))]
    if resident and not shared and c == 1 and steps > 0:
        prog.append(("go_wait",))

    def done(j):
        ops = [("rw", j)] + ([] if resident else [("rf", j)])
        if fills and j + ws < steps:
            ops.append(("fillw", j + ws))
        if c == 0 and not resident and j + F_STAGES < steps:
            ops.append(("fillf", j + F_STAGES))
        return ops
    j = 0
    for i in range(w.counts[c]):
        for kk in range(kc):
            prog.append(("w", j, (i, kk)))
            if not resident:
                prog.append(("f", j))
            if kk > 0:
                prog += done(j - 1)
            j += 1
        prog += done(j - 1)
        if c == 0 and i == 0 and not shared:
            prog.append(("go",))
    return prog


def replay(w, kc, ws, shared):
    """Runs one block's two consumers with the kernel's stage and parity
    arithmetic; returns, for each consumer, the tiles whose boxes it
    read.  Fails on a box read from the wrong fill, a stage refilled
    before it is freed, or a stall."""
    rings = 1 if shared else 2
    wfull = [[Barrier(1) for _ in range(ws)] for _ in range(rings)]
    wempty = [[Barrier(8 if shared else 4) for _ in range(ws)]
              for _ in range(rings)]
    ffull = [Barrier(1) for _ in range(F_STAGES)]
    fempty = [Barrier(8) for _ in range(F_STAGES)]
    held_w = [[None] * ws for _ in range(rings)]   # the fill a stage holds
    held_f = [None] * F_STAGES
    go = Barrier(1)
    progs = [consumer_program(w, c, kc, ws, shared) for c in (0, 1)]
    pc = [0, 0]
    reads = [set(), set()]
    while True:
        moved = False
        for c in (0, 1):
            if pc[c] >= len(progs[c]):
                continue
            op = progs[c][pc[c]]
            kind, r = op[0], 0 if shared else c
            if kind == "fillw":
                j = op[1]
                st = j % ws
                if wempty[r][st].done < j // ws:   # not yet freed
                    continue
                assert wempty[r][st].done == j // ws
                held_w[r][st] = j
                wfull[r][st].arrive()
            elif kind == "fillf":
                q = op[1]
                st = q % F_STAGES
                if fempty[st].done < q // F_STAGES:
                    continue
                assert fempty[st].done == q // F_STAGES
                held_f[st] = q
                ffull[st].arrive()
            elif kind in ("w", "f"):
                j = op[1]
                full, held, n = ((wfull[r], held_w[r], ws) if kind == "w"
                                 else (ffull, held_f, F_STAGES))
                st = j % n
                if full[st].done <= j // n:       # not yet filled
                    continue
                assert full[st].done == j // n + 1
                assert held[st] == j              # not refilled before read
                if kind == "w":
                    assert j == op[2][0] * kc + op[2][1]  # the box it expects
                    reads[c].add(op[2][0])
            elif kind == "rw":
                wempty[r][op[1] % ws].arrive(4)
            elif kind == "rf":
                fempty[op[1] % F_STAGES].arrive(4)
            elif kind == "go":
                go.arrive()
            elif kind == "go_wait":
                if go.done == 0:
                    continue
            pc[c] += 1
            moved = True
        if not moved:
            break
    assert pc == [len(p) for p in progs], "a consumer stalled"
    return [sorted(r) for r in reads]


RING_CASES = [  # (kind, fixed rows, walked rows, split, kblocks, dp)
    ("k2", 4096, 8192, 4, 1, 84), ("k2", 2048, 8192, 8, 1, 1024),
    ("k2", 200, 257, 1, 1, 12), ("out1", 4096, 8192, 4, 1, 84),
    ("out1", 300, 1000, 3, 1, 200), ("zv1", 8192, 4096, 2, 1, 84),
    ("zv1", 1000, 500, 3, 1, 1024), ("zvm", 8192, 4096, 2, 2, 84),
    ("zvm", 300, 300, 5, 2, 200), ("outm", 4096, 8192, 2, 2, 84),
    ("outm", 130, 900, 4, 1, 96), ("outm", 64, 128, 1, 1, 132),
]


# K2 has no bf16 body (xgpr_tpu's feature map pins HIGHEST).
@pytest.mark.parametrize("body,kind,fixed_rows,walk_rows,split,kb,dp", [
    (body,) + case for body in BODIES for case in RING_CASES
    if body == "tf32x3" or case[0] != "k2"])
def test_ring_replay_has_no_early_reuse_and_no_deadlock(
        body, kind, fixed_rows, walk_rows, split, kb, dp):
    fixed_b = kind in ("k2", "out1")
    kc = -(-dp // CH[body])
    walks = operands.dense_walks(fixed_b, fixed_rows, walk_rows, split, kb)
    for w in walks[:40]:
        reads = replay(w, kc, WS[kind], not fixed_b)
        for c in (0, 1):
            assert reads[c] == list(range(w.counts[c]))


# csrc/ztzv_reuse.cuh: the streams' ring stages and warps.
STREAM_STAGES, STREAM_WARPS = 4, 8


def stream_replay(count, stages=STREAM_STAGES, warps=STREAM_WARPS):
    """csrc/ztzv_reuse.cuh's stream(): thread 0 (of warp 0) fills the first
    ``stages`` stages, every warp waits for stage j's fill (the parity of
    j // stages), reads it and releases it, and thread 0, once all warps
    have released stage j, fills it again with stage j + stages.  Returns
    the fills each warp read, in order; fails on a read of the wrong
    fill, a stage filled before it is freed, or a warp that stops."""
    full = [Barrier(1) for _ in range(stages)]
    empty = [Barrier(warps) for _ in range(stages)]
    held = [None] * stages

    def program(w):
        prog = [("fill", j) for j in range(min(stages, count))] \
            if w == 0 else []
        for j in range(count):
            prog += [("wait", j), ("release", j)]
            if w == 0 and j + stages < count:
                prog += [("wait_empty", j), ("fill", j + stages)]
        return prog
    progs = [program(w) for w in range(warps)]
    pc = [0] * warps
    reads = [[] for _ in range(warps)]
    while True:
        moved = False
        for w in range(warps):
            if pc[w] >= len(progs[w]):
                continue
            op, j = progs[w][pc[w]]
            st, fill = j % stages, j // stages
            if op == "fill":
                assert empty[st].done == fill      # freed by every warp
                held[st] = j
                full[st].arrive()
            elif op == "wait":
                if full[st].done <= fill:
                    continue
                assert full[st].done == fill + 1 and held[st] == j
                reads[w].append(j)
            elif op == "release":
                empty[st].arrive()
            elif op == "wait_empty":
                if empty[st].done <= fill:
                    continue
            pc[w] += 1
            moved = True
        if not moved:
            break
    assert pc == [len(p) for p in progs], "a warp stalled"
    return reads


@pytest.mark.parametrize("count", [0, 1, 3, 4, 5, 8, 9, 64, 129])
def test_stream_ring_replay_has_no_early_reuse_and_no_deadlock(count):
    for reads in stream_replay(count):
        assert reads == list(range(count))


def _box(a, r0, rows, kk, ch=32):
    """Rows r0 .. r0 + rows - 1 of a (rows, dp) operand, channels ch kk ..
    ch kk + ch - 1 (one line), zeros past its end (the TMA box's fill)."""
    out = np.zeros((rows, ch))
    part = a[r0:r0 + rows, ch * kk:ch * kk + ch]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _planes(x, proj, body):
    """The (hi, lo) planes of x and proj^T the body's boxes read, float64
    (bf16: one plane, lo zero)."""
    m = operands.depth_multiple(body)
    xp = operands.kernel_planes(operands.pad_depth(x, m), body)
    pp = operands.projT_planes(proj, body)
    out = []
    for hi, lo in (xp, pp):
        hi = hi.double().numpy()
        out.append((hi, np.zeros_like(hi) if lo is None else
                    lo.double().numpy()))
    return out


@pytest.mark.parametrize("body,fixed_b,n,f,d,split", [
    ("tf32x3", True, 300, 200, 84, 2), ("tf32x3", False, 300, 200, 84, 3),
    ("tf32x3", True, 130, 260, 140, 1), ("tf32x3", False, 200, 130, 140, 2),
    ("bf16", True, 300, 200, 84, 2), ("bf16", False, 300, 200, 84, 3),
    ("bf16", False, 200, 130, 200, 2), ("bf16", True, 130, 260, 140, 1)])
def test_replayed_projections_are_the_split_products(body, fixed_b, n, f, d,
                                                     split):
    """3xTF32: x @ proj less the dropped lo*lo term; bf16: the product of
    the bf16-rounded operands (bf16's lo planes are zero, so the same
    three terms reduce to hi*hi)."""
    rng = np.random.default_rng(n + f + d)
    x = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    proj = torch.as_tensor(rng.standard_normal((d, f)) * 0.3,
                           dtype=torch.float32)
    (xh, xl), (ph, pl) = _planes(x, proj, body)
    ch = CH[body]
    kc = -(-xh.shape[1] // ch)
    if body == "bf16":
        xb = x.to(torch.bfloat16).double().numpy()
        pb = proj.to(torch.bfloat16).double().numpy()
        want = xb @ pb                                   # rounded operands
    else:
        want = (xh + xl) @ (ph + pl).T - xl @ pl.T      # less lo*lo
    fixed, walk = ((ph, pl), (xh, xl)) if fixed_b else ((xh, xl), (ph, pl))
    for w in operands.dense_walks(fixed_b, (f if fixed_b else n),
                                  (n if fixed_b else f), split):
        for c in (0, 1):
            for i in range(w.counts[c]):
                row = w.first[c] + i * w.stride
                # fixed A: consumer c's 64 rows of the 128-row box
                fr0 = w.fixed0 if fixed_b else w.fixed0 + 64 * c
                acc = 0.0
                for kk in range(kc):
                    fb = [_box(p, fr0, 128 if fixed_b else 64, kk, ch)
                          for p in fixed]
                    wb = [_box(p, row, 64 if fixed_b else 128, kk, ch)
                          for p in walk]
                    ah, al = wb if fixed_b else fb
                    bh, bl = fb if fixed_b else wb
                    acc = acc + al @ bh.T + ah @ bl.T + ah @ bh.T
                r0, c0 = (row, w.fixed0) if fixed_b else (fr0, row)
                ref = want[r0:r0 + 64, c0:c0 + 128]
                if ref.size == 0:       # a half tile past the last row
                    continue
                got = acc[:ref.shape[0], :ref.shape[1]]
                assert np.abs(got - ref).max() <= 1e-12 * max(
                    1.0, np.abs(ref).max())


def _sincos32(arg, w):
    arg = arg.astype(np.float32)
    return (np.cos(arg) * w).astype(np.float32), \
        (np.sin(arg) * w).astype(np.float32)


def _bf16(a):
    """a rounded to bf16 (to nearest even, as the kernels' as_operand and
    bf16x2), float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def k1_replay(x, m, proj, sigma, vc, vs, intercept, sms, body="tf32x3"):
    """oc, os in K1's partition and order in ``body``, float32: pass (a)'s
    partial zv per slice over its tiles in walk order, summed in slice
    order; pass (b)'s per slice likewise; the slices summed in order.  In
    bf16 the projection's operands, c and s (after the mask, scale and
    intercept), v_c / v_s and the summed zv are rounded to bf16 as the
    kernel rounds them."""
    n, f = x.shape[0], proj.shape[1]
    k = vc.shape[1]
    rhs = _rhs(k, body)
    rnd = _bf16 if body == "bf16" else (lambda a: a)
    plan = ztzv.launch_plan(rhs, n, f, k, sms, body)
    arg = ((rnd(x).astype(np.float64) @ rnd(proj).astype(np.float64))
           .astype(np.float32) * np.float32(sigma)).astype(np.float32)
    scale = np.float32(rbf_norm_constant(f, intercept))
    c, s = _sincos32(arg, (m * scale)[:, None])
    if intercept:
        c[:, 0] = m
    c, s, vc, vs = rnd(c), rnd(s), rnd(vc), rnd(vs)
    if ztzv.reuses_features(body, k):
        return reuse_replay(c, s, vc, vs, m * scale, plan)
    zv_part = np.zeros((plan.zsplit, n, k), dtype=np.float32)
    for w in operands.dense_walks(False, n, f, plan.zsplit, plan.blocks):
        q = slice(rhs * w.kz, rhs * w.kz + rhs)    # the block's rhs
        for cc in (0, 1):
            r = slice(w.fixed0 + 64 * cc, w.fixed0 + 64 * cc + 64)
            for i in range(w.counts[cc]):
                t = slice(w.first[cc] + i * w.stride,
                          w.first[cc] + i * w.stride + 128)
                zv_part[w.slices[cc], r, q] += c[r, t] @ vc[t, q] + \
                    s[r, t] @ vs[t, q]
    zv = np.zeros((n, k), dtype=np.float32)
    for p in zv_part:
        zv += p
    zv = rnd(zv)
    oc_part = np.zeros((plan.osplit, f, k), dtype=np.float32)
    os_part = np.zeros_like(oc_part)
    fixed_b = k == 1
    for w in operands.dense_walks(fixed_b, f, n, plan.osplit,
                                  1 if fixed_b else plan.blocks):
        q = slice(rhs * w.kz, rhs * w.kz + rhs)
        for cc in (0, 1):
            for i in range(w.counts[cc]):
                row = w.first[cc] + i * w.stride
                rows = slice(row, row + (64 if fixed_b else 128))
                fr = slice(w.fixed0, w.fixed0 + 128) if fixed_b else \
                    slice(w.fixed0 + 64 * cc, w.fixed0 + 64 * cc + 64)
                oc_part[w.slices[cc], fr, q] += c[rows, fr].T @ zv[rows, q]
                os_part[w.slices[cc], fr, q] += s[rows, fr].T @ zv[rows, q]
    oc, os_ = np.zeros((f, k), np.float32), np.zeros((f, k), np.float32)
    for a, b in zip(oc_part, os_part):
        oc += a
        os_ += b
    return oc, os_


def reuse_replay(c, s, vc, vs, w, plan):
    """oc, os in the reuse path's partition and order (csrc/ztzv_reuse.cuh),
    float32, from the stored features c and s (n, f): C and S hold
    cos(0) * w = w and 0 past F to the 16-byte row (ldf), v_c^T and v_s^T
    zeros there, and the TMA boxes zeros past ldf and past n.  Pass (a):
    for each stream block, its two column halves' partial zv over its
    stages in walk order (each 32 columns of a stage), the second added to
    the first, the slices summed in order; pass (b) likewise over the row
    halves of its row stages."""
    n, f = c.shape
    k = vc.shape[1]
    ldf = -(-f // 4) * 4
    ctiles = -(-ldf // 64)
    planes = np.zeros((2, n, 64 * ctiles), np.float32)
    planes[0, :, :f], planes[1, :, :f] = c, s
    planes[0, :, f:ldf] = w[:, None]
    vt = np.zeros((2, 64 * ctiles, k), np.float32)
    vt[0, :f], vt[1, :f] = vc, vs
    zv_part = np.zeros((plan.zsplit, n, k), np.float32)
    for wk in operands.stream_walks(False, n, f, plan.zsplit, plan.blocks):
        rows = slice(wk.fixed0, min(wk.fixed0 + 64, n))
        q = slice(plan.rhs * wk.kz, min(plan.rhs * (wk.kz + 1), k))
        halves = np.zeros((2, rows.stop - rows.start, q.stop - q.start),
                          np.float32)
        for t in wk.stages:
            p, c0 = t // ctiles, 64 * (t % ctiles)
            for h in (0, 1):
                cc = slice(c0 + 32 * h, c0 + 32 * h + 32)
                halves[h] += planes[p, rows, cc] @ vt[p, cc, q]
        zv_part[wk.slice, rows, q] = halves[0] + halves[1]
    zv = np.zeros((n, k), np.float32)
    for part in zv_part:
        zv += part
    out_part = np.zeros((plan.osplit, 2, 64 * ctiles, k), np.float32)
    for wk in operands.stream_walks(True, n, f, plan.osplit, plan.blocks):
        cols = slice(wk.fixed0, wk.fixed0 + 64)
        q = slice(plan.rhs * wk.kz, min(plan.rhs * (wk.kz + 1), k))
        halves = np.zeros((2, 64, q.stop - q.start), np.float32)
        for t in wk.stages:
            for h in (0, 1):
                rows = slice(64 * t + 32 * h, min(64 * t + 32 * h + 32, n))
                if rows.start < n:
                    halves[h] += planes[wk.plane, rows, cols].T @ zv[rows, q]
        out_part[wk.slice, wk.plane, cols, q] = halves[0] + halves[1]
    out = np.zeros((2, f, k), np.float32)
    for part in out_part:
        out += part[:, :f]
    return out[0], out[1]


K1_SHAPES = [(300, 84, 256, 1), (257, 84, 300, 26), (200, 140, 130, 9),
             (128, 10, 512, 3), (200, 140, 130, 17)]


@pytest.mark.parametrize("intercept", [False, True])
@pytest.mark.parametrize("n,d,f,k", K1_SHAPES)
def test_k1_replayed_order_matches_pallas(intercept, n, d, f, k):
    rng = np.random.default_rng(n * 5 + f + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    m = (rng.random(n) > 0.25).astype(np.float32)
    proj = (rng.standard_normal((d, f)) * 0.3).astype(np.float32)
    vc = rng.standard_normal((f, k)).astype(np.float32)
    vs = rng.standard_normal((f, k)).astype(np.float32)
    sigma = np.float32(0.7)
    oc_ref, os_ref = (np.asarray(a) for a in ztzv_parts_pallas(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(proj), sigma,
        jnp.asarray(vc), jnp.asarray(vs), intercept, f, interpret=True))
    oc, os_ = k1_replay(x, m, proj, sigma, vc, vs, intercept, 7)
    tol = 3e-5 * max(1.0, np.abs(oc_ref).max(), np.abs(os_ref).max())
    assert np.abs(oc - oc_ref).max() < tol
    assert np.abs(os_ - os_ref).max() < tol


# ROADMAP.md's bf16 tolerances: 4 * 2^-8 of max|ref| for K1 with a sigma
# that is not a power of two against an unrounded reference; 1e-3 of it
# for K1's bf16 body against its plain version, which rounds c, s and zv
# at the same points but sums in another fp32 order, so a value near a
# bf16 rounding boundary can round apart (chip_smoke.py: K1_DEFAULT_RTOL).
PHASE_RTOL, BODY_RTOL = 4 * 2.0 ** -8, 1e-3


@pytest.fixture
def default_precision():
    """xgpr_tpu's feature precision at "default" (the TPU's DEFAULT dot),
    restored after."""
    saved = jax_config._FEATURE_PRECISION
    jax_config.set_feature_precision("default")
    try:
        yield
    finally:
        jax_config.set_feature_precision(saved)


@pytest.mark.parametrize("intercept", [False, True])
@pytest.mark.parametrize("n,d,f,k", K1_SHAPES + [(300, 200, 256, 33)])
def test_k1_bf16_replayed_order_matches_pallas(default_precision, intercept,
                                               n, d, f, k):
    """K1's bf16 partition and order against ``ztzv_parts_pallas`` at
    "default" in interpret mode (fp32 products on the CPU: the bf16
    rounding shows at PHASE_RTOL) and against the port's plain bf16
    version, which rounds at the kernel's points (BODY_RTOL)."""
    rng = np.random.default_rng(n * 7 + f + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    m = (rng.random(n) > 0.25).astype(np.float32)
    proj = (rng.standard_normal((d, f)) * 0.3).astype(np.float32)
    vc = rng.standard_normal((f, k)).astype(np.float32)
    vs = rng.standard_normal((f, k)).astype(np.float32)
    sigma = np.float32(0.7)
    with jax.enable_x64(False):
        oc_ref, os_ref = (np.asarray(a) for a in ztzv_parts_pallas(
            jnp.asarray(x), jnp.asarray(m), jnp.asarray(proj), sigma,
            jnp.asarray(vc), jnp.asarray(vs), intercept, f, interpret=True))
    plain = ztzv.ztzv_parts_plain(*(torch.from_numpy(a) for a in (x, m, proj)),
                                  float(sigma), torch.from_numpy(vc),
                                  torch.from_numpy(vs), intercept, "hi",
                                  "default")
    got = k1_replay(x, m, proj, sigma, vc, vs, intercept, 7, "bf16")
    for g, ref, pl in zip(got, (oc_ref, os_ref), plain):
        top = np.abs(ref).max()
        assert np.abs(g - ref).max() <= PHASE_RTOL * top
        assert np.abs(g - pl.numpy()).max() <= BODY_RTOL * top


def k2_replay(x, proj, intercept, padded, sms):
    """K2's outputs as its blocks store them: staged tiles as four boxes
    of 64 rows x 32 values a half (cos at the tile's block column, sin
    the block's width on), other tiles pair by pair from the fragment."""
    n, f = x.shape[0], proj.shape[1]
    arg = (x.astype(np.float64) @ proj.astype(np.float64)).astype(np.float32)
    cos, sin = _sincos32(arg, np.float32(rbf_norm_constant(f, intercept)))
    out = np.full((n, 2 * f), np.nan, dtype=np.float32)
    split = operands.tile_split(-(-n // 128), -(-f // 128), sms, 64)
    for w in operands.dense_walks(True, f, n, split):
        f0 = w.fixed0
        blk = f0 // padded if padded % 128 == 0 else -1
        width = min(padded, f - blk * padded) if blk >= 0 else 0
        staged = blk >= 0 and f0 + 128 <= f and width % 4 == 0 and \
            f % 2 == 0
        for cc in (0, 1):
            for i in range(w.counts[cc]):
                r0 = w.first[cc] + i * w.stride
                rows = slice(r0, min(r0 + 64, n))   # TMA clips past N
                if r0 >= n:
                    continue
                if staged:
                    for hf in (0, 1):
                        for box in (0, 1):
                            col = f0 + blk * padded + 64 * hf + 32 * box
                            src = slice(f0 + 64 * hf + 32 * box,
                                        f0 + 64 * hf + 32 * box + 32)
                            out[rows, col:col + 32] = cos[rows, src]
                            out[rows, col + width:col + width + 32] = \
                                sin[rows, src]
                    continue
                for fc in range(f0, min(f0 + 128, f)):
                    b = blk if blk >= 0 else fc // padded
                    wd = min(padded, f - b * padded)
                    out[rows, fc + b * padded] = cos[rows, fc]
                    out[rows, fc + b * padded + wd] = sin[rows, fc]
    return out


@pytest.mark.parametrize("intercept", [False, True])
@pytest.mark.parametrize("n,d,padded,f", [
    (300, 84, 128, 512),   # staged tiles, 4 layout blocks
    (257, 84, 256, 384),   # a ragged last block, staged at its width
    (130, 40, 64, 256),    # blocks narrower than a tile: fragment stores
    (200, 140, 512, 500),  # one narrow block, a partial last tile
])
def test_k2_replayed_layout_matches_pallas(intercept, n, d, padded, f):
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
    got = k2_replay(x, proj, intercept, padded, 7)
    assert not np.isnan(got).any()
    assert np.abs(got - want).max() < 1e-5
