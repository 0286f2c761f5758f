"""Conv window loop: the K3 and K4 kernels' wrappers and their plain versions.

Replaces xgpr_tpu/ops/pallas/conv_pallas.py (``conv_parts_pallas`` and
``conv_maxpool_pallas``, whose ``pallas_call``s are in ``_conv_parts_impl``
and ``_conv_maxpool_impl``) with the CUDA C++ kernels in csrc/conv.cu; see
that file for the design and what bounds it on the card.  Same calling
convention: x (N, L, D) zero-padded sequences, not scaled by sigma;
seq_lengths (N,); proj (w*D, F) in window-major row order (t*D + c), chi
folded in.  Window j of row i counts while j < seq_lengths[i] - w + 1.

- ``conv_parts``: the masked window sums of cos and sin of
  (window @ proj) * sigma, each (N, F), times an optional per-row scale
  (the caller's averaging factor times rbf_norm_constant, applied in the
  kernel's epilogue).  No intercept column.
- ``conv_maxpool``: max(0, max over valid windows of window @ proj),
  (N, F); no sigma, no sincos.

Each wrapper runs its plain version for CPU tensors and its kernel for
CUDA tensors (float32 x and proj, int32 lengths); anything else raises.
``PARTS_LAUNCHES`` and ``MAXPOOL_LAUNCHES`` count kernel launches by
their shape (N, L, D, w, F).

Before a launch the wrapper prepares the kernels' operands with the plain
torch functions below: ``row_order`` (the rows ordered by valid-window
count, so that a tile stops at its own rows' largest count),
``pad_operands`` (channels padded to a multiple of 4, and proj transposed
to the K-major projT the tiles read) and ``split_tf32`` (x and projT as
TF32 high parts and remainders, the operands of the kernels' 3xTF32
products; in operands.py, shared with K1 and K2).  ``window_slots``
counts the (row, window) slots the kernels project against the valid
windows.
"""
from collections import Counter

import torch
import torch.nn.functional as F

from .. import sincos as _sincos
from . import build
from .feature_map import check_cuda_operands, kernel_sincos_flag
from .operands import split_tf32

PARTS_LAUNCHES = Counter()
MAXPOOL_LAUNCHES = Counter()


def window_slab(x, width):
    """(N, nw, w*D) windows of (N, L, D) rows: window j is x[:, j:j+w, :]
    flattened in t*D + c order (a copy, w times the input)."""
    n, l, d = x.shape
    return x.unfold(1, width, 1).transpose(2, 3).reshape(
        n, l - width + 1, width * d)


def window_mask(seq_lengths, width, num_windows):
    """(N, nw) bool: window j of row i lies inside the row's length."""
    nk = seq_lengths.to(torch.int64) - width + 1
    return torch.arange(num_windows, device=nk.device)[None, :] < nk[:, None]


def conv_parts_plain(x, seq_lengths, proj, sigma, width, row_scale=None,
                     mode=None):
    """Plain PyTorch version of K3: window slabs, torch.matmul, the
    masked sincos of ops/sincos.py, and a sum over windows."""
    arg = torch.matmul(window_slab(x, width), proj) * sigma
    mask = window_mask(seq_lengths.to(x.device), width, arg.shape[1])
    c, s = _sincos.sincos(arg, mask.to(x.dtype)[:, :, None], mode)
    c, s = c.sum(dim=1), s.sum(dim=1)
    if row_scale is not None:
        c = c * row_scale[:, None]
        s = s * row_scale[:, None]
    return c, s


def conv_maxpool_plain(x, seq_lengths, proj, width):
    """Plain PyTorch version of K4: masked windows are -inf against a
    zero start (the implicit ReLU)."""
    g = torch.matmul(window_slab(x, width), proj)
    mask = window_mask(seq_lengths.to(x.device), width, g.shape[1])
    g = torch.where(mask[:, :, None], g, float("-inf"))
    return torch.clamp_min(g.amax(dim=1), 0.0)


# The kernels' tiling (csrc/conv.cu: WR, WG, WN): rows per tile, windows
# per group, frequencies per tile.
TILE_ROWS = 64
WINDOW_GROUP = 2
TILE_FREQS = 128


def row_order(seq_lengths, width, num_windows):
    """(order, nk), each (N,) int32 on the lengths' device: nk[i] =
    clamp(seq_lengths[i] - w + 1, 0, nw) the valid windows of row i, and
    order a stable permutation of the rows by ascending nk.  A kernel tile
    is TILE_ROWS consecutive rows of this order."""
    nk = (seq_lengths.to(torch.int64) - width + 1).clamp(0, num_windows)
    order = torch.argsort(nk, stable=True)
    return order.to(torch.int32), nk.to(torch.int32)


def pad_operands(x, proj, width):
    """(x, projT) as the kernels read them: x (N, L, dp) with the channels
    padded by zeros to dp, the next multiple of 4 (16-byte rows), and projT
    (F, w*dp) the K-major transpose of proj (w*D, F) with the matching zero
    columns.  The padding adds zero terms only."""
    d = x.shape[2]
    f = proj.shape[1]
    dp = -(-d // 4) * 4
    proj = proj.reshape(width, d, f)
    if dp != d:
        x = F.pad(x, (0, dp - d))
        proj = F.pad(proj, (0, 0, 0, dp - d))
    return x.contiguous(), proj.reshape(width * dp, f).t().contiguous()


def window_slots(seq_lengths, width, num_windows):
    """(slots, valid): the (row, window) GEMM rows the kernels project,
    TILE_ROWS x WINDOW_GROUP for each window group of each tile up to the
    tile's largest nk, against the valid windows sum(nk)."""
    order, nk = row_order(seq_lengths, width, num_windows)
    tiles = F.pad(nk[order.long()], (0, -len(nk) % TILE_ROWS))
    top = tiles.reshape(-1, TILE_ROWS).amax(dim=1).to(torch.int64)
    groups = (top + WINDOW_GROUP - 1) // WINDOW_GROUP
    return (int(groups.sum()) * TILE_ROWS * WINDOW_GROUP,
            int(nk.to(torch.int64).sum()))


def _check_shapes(name, x, seq_lengths, proj, width):
    if x.dim() != 3 or proj.dim() != 2 or \
            proj.shape[0] != width * x.shape[2] or \
            tuple(seq_lengths.shape) != (x.shape[0],):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, lengths "
                         f"{tuple(seq_lengths.shape)} and proj "
                         f"{tuple(proj.shape)} do not fit width {width}.")
    if x.shape[1] < width:
        raise ValueError("Sequence axis shorter than conv_width.")


def _kernel_operands(name, x, seq_lengths, proj, width, *more):
    """Checks for the CUDA route; returns (x_hi, x_lo, order, nk, projT_hi,
    projT_lo) as the kernel reads them (``row_order``, ``pad_operands``,
    ``split_tf32``, whose outputs are fresh, 16-byte aligned tensors)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}.")
    check_cuda_operands(name, x, proj, *more)
    if seq_lengths.device != x.device or seq_lengths.dtype != torch.int32 \
            or not seq_lengths.is_contiguous():
        raise TypeError(f"{name}: the CUDA kernel takes contiguous int32 "
                        f"lengths on {x.device}.")
    if -(-proj.shape[1] // TILE_FREQS) > 65535:
        raise ValueError(f"{name}: too many frequencies for the grid.")
    order, nk = row_order(seq_lengths, width, x.shape[1] - width + 1)
    xp, projT = pad_operands(x, proj, width)
    return split_tf32(xp) + (order, nk) + split_tf32(projT)


def conv_parts(x, seq_lengths, proj, sigma, width, row_scale=None,
               mode=None):
    """(c, s), each (N, F): masked window sums of cos/sin of
    (window @ proj) * sigma, times row_scale (N,) when given."""
    _check_shapes("conv_parts", x, seq_lengths, proj, width)
    extra = () if row_scale is None else (row_scale,)
    if all(t.device.type == "cpu" for t in (x, seq_lengths, proj) + extra):
        return conv_parts_plain(x, seq_lengths, proj, sigma, width,
                                row_scale, mode)
    exact = kernel_sincos_flag(mode)
    xh, xl, order, nk, hi, lo = _kernel_operands(
        "conv_parts", x, seq_lengths, proj, width, *extra)
    n, l, dp = xh.shape
    f = proj.shape[1]
    c = torch.empty((n, f), dtype=torch.float32, device=x.device)
    s = torch.empty((n, f), dtype=torch.float32, device=x.device)
    if n == 0 or f == 0:
        return c, s
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.xgpr_conv_parts(
            xh.data_ptr(), xl.data_ptr(), order.data_ptr(), nk.data_ptr(),
            hi.data_ptr(), lo.data_ptr(),
            None if row_scale is None else row_scale.data_ptr(),
            c.data_ptr(), s.data_ptr(), n, l, dp, width, f, float(sigma),
            exact, stream)
    build.check(rc, "conv parts kernel")
    PARTS_LAUNCHES[tuple(x.shape) + (width, f)] += 1
    return c, s


def conv_maxpool(x, seq_lengths, proj, width):
    """(N, F): max(0, max over valid windows of window @ proj)."""
    _check_shapes("conv_maxpool", x, seq_lengths, proj, width)
    if all(t.device.type == "cpu" for t in (x, seq_lengths, proj)):
        return conv_maxpool_plain(x, seq_lengths, proj, width)
    xh, xl, order, nk, hi, lo = _kernel_operands(
        "conv_maxpool", x, seq_lengths, proj, width)
    n, l, dp = xh.shape
    f = proj.shape[1]
    out = torch.empty((n, f), dtype=torch.float32, device=x.device)
    if n == 0 or f == 0:
        return out
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.xgpr_conv_maxpool(
            xh.data_ptr(), xl.data_ptr(), order.data_ptr(), nk.data_ptr(),
            hi.data_ptr(), lo.data_ptr(), out.data_ptr(), n, l, dp, width, f,
            stream)
    build.check(rc, "conv maxpool kernel")
    MAXPOOL_LAUNCHES[tuple(x.shape) + (width, f)] += 1
    return out
