"""Host-side preparation of the kernels' operands.

Every kernel of csrc/ computes its projection in one of four bodies
(csrc/gemm_common.cuh: Format; feature_map.py ``kernel_body`` picks it
from the operands' dtype and the feature precision) and reads its
operands in 16-byte copies, K-major as that body's planes (K2's fp32 FMA
body channel-major, below):

- "tf32x3" (3xTF32 on the tensor cores): the operand split into TF32
  high parts and remainders (``split_tf32``: hi + lo == a exactly);
- "bf16" (one bf16 pass, the TPU's DEFAULT dot): one bfloat16 plane
  (``to_bf16``, rounded to nearest even);
- "fma32" (fp32 FMAs on the CUDA cores) and "f64" (float64 DMMA on the
  tensor cores): the values themselves, one plane.

These plain torch functions prepare them:

- ``kernel_planes``: an operand's planes in a body;
- ``pad_depth``: the contraction axis padded by zeros to a multiple of
  ``depth_multiple(body)`` (16-byte rows: 4 fp32, 8 bf16 or 2 float64
  values);
- ``projT_planes``: a dense projection (D, F) as the planes of its padded
  transpose (F, dp), or with ``width`` a conv projection (w*D, F) as
  those of its transpose (F, w*dp), each tap's channels padded
  (``pad_windows``); cached with the projection tensor and keyed on the
  body and width: the kernels' callers pass the same tensor on every
  call (the conv wrapper takes the cache for its bf16 body);
- ``rows_last`` and ``pad_freqs``: K2's fp32 FMA operands, x^T and
  proj, channel-major with 16-byte rows (K3 and K4's fp32 body reads proj
  as ``pad_freqs`` lays it out too); ``fma_walks`` and ``fma_cells``
  mirror that kernel's walks and thread tile for the CPU tests;
- ``tile_split``: how many blocks share a loop over tiles;
- ``dense_walks``: what each block of the dense TMA pipeline walks,
  in grid order (the kernels' own index arithmetic, which the CPU tests
  replay); ``stream_walks`` the same for K1's reuse path's streams.
"""
from collections import namedtuple
import weakref
from functools import lru_cache

import torch
import torch.nn.functional as F


def _round_tf32(a):
    """a rounded to TF32 (10 explicit mantissa bits; to nearest, ties away
    from zero, as cvt.rna.tf32.f32 rounds)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(a):
    """(hi, lo), float32: hi is a rounded to TF32 and lo = a - hi, of which
    the tensor cores read the top TF32 bits (hi + lo == a exactly)."""
    hi = _round_tf32(a)
    return hi, a - hi


def to_bf16(a):
    """a rounded to bfloat16 (to nearest even, as __float2bfloat16_rn),
    contiguous."""
    return a.to(torch.bfloat16).contiguous()


def depth_multiple(body):
    """The depth padding of a body: 16 bytes of its values."""
    return {"bf16": 8, "f64": 2}.get(body, 4)


def kernel_planes(a, body):
    """The planes of operand ``a`` (already padded) that ``body`` reads:
    (hi, lo) of a TF32 split, (bf16 values, None), or for the fp32 FMA
    and float64 bodies (a, None)."""
    if body == "bf16":
        return to_bf16(a), None
    if body == "tf32x3":
        return split_tf32(a)
    return a.contiguous(), None


def pad_depth(a, multiple=4):
    """a (..., d) contiguous, with the last axis padded by zeros to the
    next multiple of ``multiple``; a itself when it is already so."""
    d = a.shape[-1]
    dp = -(-d // multiple) * multiple
    if dp != d:
        a = F.pad(a, (0, dp - d))
    return a.contiguous()


def pad_windows(proj, width, multiple=4):
    """projT (F, w*dp), contiguous: the K-major transpose of a conv
    projection (w*D, F) in window-major row order (t*D + c), each tap's
    channels padded by zeros to dp, the next multiple of ``multiple``."""
    f = proj.shape[1]
    d = proj.shape[0] // width
    dp = -(-d // multiple) * multiple
    proj = proj.reshape(width, d, f)
    if dp != d:
        proj = F.pad(proj, (0, 0, 0, dp - d))
    return proj.reshape(width * dp, f).t().contiguous()


def rows_last(x):
    """x (n, d) as x^T (d, np), contiguous: K2's fp32 FMA body reads a
    channel's rows together; np is n rounded up to a multiple of 4
    (16-byte rows), the rows past n zeros."""
    pad = -x.shape[0] % 4
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    return x.t().contiguous()


def pad_freqs(proj):
    """proj (rows, fp), the frequencies padded by zeros to fp, the next
    multiple of 4 (16-byte rows); proj itself when it is so and 16-byte
    aligned."""
    f = proj.shape[1]
    fp = -(-f // 4) * 4
    if fp != f:
        return F.pad(proj, (0, fp - f)).contiguous()
    return proj.contiguous() if proj.data_ptr() % 16 == 0 else proj.clone()


# id(proj) -> (weak reference to proj, proj._version,
#              {(body, width): planes})
_PROJ_SPLITS = {}


def projT_planes(proj, body="tf32x3", width=None):
    """kernel_planes(pad_depth(proj.T), body) for proj (D, F): the (F, dp)
    K-major operand of the dense kernels; with ``width``, that of
    pad_windows(proj, width) for a conv projection (w*D, F).  Kept, for
    each body and width asked for, while proj lives and is not modified
    in place (its version counter), and built anew otherwise."""
    key = id(proj)
    hit = _PROJ_SPLITS.get(key)
    if hit is None or hit[0]() is not proj or hit[1] != proj._version:
        ref = weakref.ref(proj,
                          lambda _, key=key: _PROJ_SPLITS.pop(key, None))
        hit = _PROJ_SPLITS[key] = (ref, proj._version, {})
    planes = hit[2].get((body, width))
    if planes is None:
        m = depth_multiple(body)
        a = pad_depth(proj.t(), m) if width is None else \
            pad_windows(proj, width, m)
        planes = hit[2][(body, width)] = kernel_planes(a, body)
    return planes


def data_ptr(t):
    """t's device address for the C entry points; None (NULL) for None."""
    return None if t is None else t.data_ptr()


@lru_cache(maxsize=None)
def sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@lru_cache(maxsize=4096)
def tile_split(tiles, other_blocks, sms, cap):
    """How many blocks share a loop over `tiles` tiles, each slice beside
    `other_blocks` blocks, at one block per SM: the count that needs the
    fewest tile-times (waves of `sms` blocks times the tiles a block
    walks), the smallest such count."""
    best, best_cost = 1, None
    for s in range(1, max(1, min(tiles, cap)) + 1):
        cost = -(-other_blocks * s // sms) * -(-tiles // s)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


# csrc/dense_wgmma.cuh: a block's walk.  Consumer c's tile i starts at row
# first[c] + i * stride of the walked operand and c has counts[c] tiles;
# slices[c] is the slice of the split whose partial c sums, kz the block
# of right-hand sides.
DenseWalk = namedtuple("DenseWalk", "fixed0 first stride counts slices kz")


def dense_walks(fixed_b, fixed_rows, walk_rows, split, kblocks=1):
    """The walks of csrc/dense_wgmma.cuh's blocks in grid order: a block
    holds 128 of the ``fixed_rows`` rows of its fixed operand and walks
    the 128-row tiles b, b + split, ... of the other's ``walk_rows`` rows
    (slice b), for each of ``kblocks`` blocks of right-hand sides.  With
    ``fixed_b`` (K2; K1's pass (b) at K 1; no blocks of right-hand sides)
    consumer c takes rows 64c .. 64c + 63 of each walked tile; otherwise
    (K1's pass (a), pass (b) at K > 1) both consumers walk the same tiles
    and consumer c takes the fixed rows 64c .. 64c + 63."""
    tiles, fixed_tiles = -(-walk_rows // 128), -(-fixed_rows // 128)
    walks = []
    for x in range(fixed_tiles * split * (1 if fixed_b else kblocks)):
        if fixed_b:
            (ft, b), kz = divmod(x, split), 0
        else:
            ft, rest = x % fixed_tiles, x // fixed_tiles
            b, kz = rest % split, rest // split
        count = (tiles - 1 - b) // split + 1 if b < tiles else 0
        first = (128 * b, 128 * b + 64) if fixed_b else (128 * b, 128 * b)
        walks.append(DenseWalk(128 * ft, first, 128 * split,
                               (count, count), (b, b), kz))
    return walks


# csrc/ztzv_reuse.cuh: a stream block's walk.  Pass (a)'s block holds the
# 64 rows from ``fixed0`` of C and S and reads column stage t (64 columns
# of C from 64 t while t < ctiles, then of S from 64 (t - ctiles)) for t
# in ``stages``; pass (b)'s holds the 64 columns from ``fixed0`` of C
# (``plane`` 0) or S (1) and reads the 64-row stages in ``stages``.
# ``slice`` is the slice of the split whose partial it writes, ``kz`` its
# block of right-hand sides.
StreamWalk = namedtuple("StreamWalk", "fixed0 plane stages slice kz")
STREAM_TILE = 64


def stream_walks(pass_b, n, f, split, kblocks):
    """The walks of csrc/ztzv_reuse.cuh's stream blocks in grid order, the
    kernels' own arithmetic: pass (a) (``pass_b`` False) block (rt, s, kz)
    = (kz * split + s) * row tiles + rt, pass (b) block (ct, s, kz) = (kz *
    split + s) * 2 ctiles + ct, with ctiles the 64-column tiles of C (F
    rounded up to 4 columns)."""
    t = STREAM_TILE
    ctiles, rtiles = -(-(-(-f // 4) * 4) // t), -(-n // t)
    fixed, walked = (2 * ctiles, rtiles) if pass_b else (rtiles, 2 * ctiles)
    walks = []
    for x in range(fixed * split * kblocks):
        ft, rest = x % fixed, x // fixed
        s, kz = rest % split, rest // split
        stages = list(range(s, walked, split))
        if pass_b:
            walks.append(StreamWalk(t * (ft % ctiles), ft // ctiles, stages,
                                    s, kz))
        else:
            walks.append(StreamWalk(t * ft, None, stages, s, kz))
    return walks


# csrc/feature_map_fma.cu: channels a stage, and a block's tile.
FMA_KS, FMA_TILE = 16, 128


def fma_walks(n, f, rsplit):
    """The walks of csrc/feature_map_fma.cu's blocks in grid order: block
    x = ft * rsplit + b holds frequency tile ft (first frequency
    ``fixed0``) and walks the 128-row tiles b, b + rsplit, ... (the first
    row of each in ``rows``)."""
    tiles, f_tiles = -(-n // FMA_TILE), -(-f // FMA_TILE)
    walks = []
    for x in range(f_tiles * rsplit):
        ft, b = divmod(x, rsplit)
        walks.append((FMA_TILE * ft,
                      [FMA_TILE * t for t in range(b, tiles, rsplit)]))
    return walks


def fma_cells(q, lane):
    """(rows, frequencies) of a tile that thread (warp q, lane) of
    csrc/feature_map_fma.cu holds, 8 each: acc[8i + j] is rows[i] by
    frequencies[j], two runs of 4 frequencies 32 apart."""
    ty, tx = lane // 8, lane % 8
    r0, f0 = 32 * (q // 2) + 8 * ty, 64 * (q % 2) + 4 * tx
    return (list(range(r0, r0 + 8)),
            list(range(f0, f0 + 4)) + list(range(f0 + 32, f0 + 36)))
