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
The two are the CPU and CUDA implementations of one custom operator each,
``torch.ops.xgpr_tpu_torch.conv_parts`` and ``...conv_maxpool``, with a
fake implementation (the output shapes, for ``torch.compile``) and a
batching rule (a leading batch axis of x, and of the lengths and row
scale where they have one, folded into rows, for ``torch.func.vmap``),
as for K2 (feature_map.py).  Everything the launcher does runs inside
the operator.
On the card ``conv_parts`` runs the K3 instantiation of the sincos mode
it asks for, and both run the body of the feature precision they ask for
(the configured ones by default), never another: "high" and "highest"
3xTF32, "default" one bf16 pass on a bf16 copy of x and projT
(sigma still multiplies the fp32 product), as the TPU's DEFAULT dot rounds
both operands.  The plain versions round x and proj at the same points.
``PARTS_LAUNCHES`` and ``MAXPOOL_LAUNCHES`` count kernel launches by
their shape, (N, L, D, w, F, mode, precision) and
(N, L, D, w, F, precision).

Before a launch the wrapper prepares the kernels' operands with the plain
torch functions below: ``row_order`` (the rows ordered by valid-window
count, so that a tile stops at its own rows' largest count),
``pad_operands`` (channels padded to a multiple of 4, 8 for bf16, and
proj transposed to the K-major projT the tiles read) and
``kernel_planes`` (x and projT as the planes of the precision's body:
TF32 high parts and remainders, or bf16 values; in operands.py, shared
with K1 and K2).  ``window_slots`` counts the (row, window) slots the
kernels project against the valid windows.
"""
from collections import Counter
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import sincos as _sincos
from ..contract import bf16_mm
from . import build
from .feature_map import (check_cuda_operands, check_device, kernel_mode,
                          kernel_precision, kernel_precision_flag,
                          kernel_sincos_flag)
from .operands import data_ptr, depth_multiple, kernel_planes

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


def window_projection(x, proj, width, precision):
    """(N, nw, F) projections of every window of x: torch.matmul, or
    ``bf16_mm`` (operands rounded to bf16, fp32 sums) under "default"."""
    slab = window_slab(x, width)
    if precision == "default":
        return bf16_mm(slab, proj)
    return torch.matmul(slab, proj)


def conv_parts_plain(x, seq_lengths, proj, sigma, width, row_scale=None,
                     mode=None, precision=None):
    """Plain PyTorch version of K3: window slabs, their projection at the
    precision, the masked sincos of ops/sincos.py, and a sum over
    windows."""
    precision = kernel_precision(precision, x.device)
    arg = window_projection(x, proj, width, precision) * sigma
    mask = window_mask(seq_lengths.to(x.device), width, arg.shape[1])
    c, s = _sincos.sincos(arg, mask.to(x.dtype)[:, :, None], mode)
    c, s = c.sum(dim=1), s.sum(dim=1)
    if row_scale is not None:
        c = c * row_scale[:, None]
        s = s * row_scale[:, None]
    return c, s


def conv_maxpool_plain(x, seq_lengths, proj, width, precision=None):
    """Plain PyTorch version of K4: masked windows are -inf against a
    zero start (the implicit ReLU)."""
    g = window_projection(x, proj, width,
                          kernel_precision(precision, x.device))
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


def pad_operands(x, proj, width, multiple=4):
    """(x, projT) as the kernels read them: x (N, L, dp) with the channels
    padded by zeros to dp, the next multiple of ``multiple`` (16-byte rows:
    4 for the TF32 bodies, 8 for bf16), and projT (F, w*dp) the K-major
    transpose of proj (w*D, F) with the matching zero columns.  The
    padding adds zero terms only."""
    d = x.shape[2]
    f = proj.shape[1]
    dp = -(-d // multiple) * multiple
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


def _kernel_operands(name, x, seq_lengths, proj, width, precision, *more):
    """Checks for the CUDA route; returns (x planes, order, nk, projT
    planes) as the kernel of ``precision`` reads them (``row_order``,
    ``pad_operands``, ``kernel_planes``, whose outputs are fresh, 16-byte
    aligned tensors; the second plane is None for bf16)."""
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
    xp, projT = pad_operands(x, proj, width, depth_multiple(precision))
    return (kernel_planes(xp, precision) + (order, nk)
            + kernel_planes(projT, precision))


def conv_parts(x, seq_lengths, proj, sigma, width, row_scale=None,
               mode=None, precision=None):
    """(c, s), each (N, F): masked window sums of cos/sin of
    (window @ proj) * sigma, times row_scale (N,) when given."""
    _check_shapes("conv_parts", x, seq_lengths, proj, width)
    extra = () if row_scale is None else (row_scale,)
    check_device("conv_parts", x, seq_lengths, proj, *extra)
    return _conv_parts_op(x, seq_lengths, proj, float(sigma), int(width),
                          row_scale, kernel_mode(mode),
                          kernel_precision(precision, x.device))


@torch.library.custom_op("xgpr_tpu_torch::conv_parts", mutates_args=(),
                         device_types="cpu")
def _conv_parts_op(x: torch.Tensor, seq_lengths: torch.Tensor,
                   proj: torch.Tensor, sigma: float, width: int,
                   row_scale: Optional[torch.Tensor], mode: str,
                   precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    return conv_parts_plain(x, seq_lengths, proj, sigma, width, row_scale,
                            mode, precision)


@_conv_parts_op.register_fake
def _(x, seq_lengths, proj, sigma, width, row_scale, mode, precision):
    shape = (x.shape[0], proj.shape[1])
    return x.new_empty(shape), x.new_empty(shape)


def _rows_first(t, dim, batch):
    """t with its batch axis ``dim`` first, expanded over ``batch`` when
    it has none, and folded into its leading (row) axis."""
    t = t.movedim(dim, 0) if dim is not None else \
        t.expand((batch,) + tuple(t.shape))
    return t.reshape((-1,) + tuple(t.shape[2:])).contiguous()


def _fold_rows(name, info, in_dims):
    if in_dims[2] is not None:
        raise NotImplementedError(f"{name} maps over rows only, not over "
                                  "projections")
    return info.batch_size


@torch.library.register_vmap("xgpr_tpu_torch::conv_parts")
def _(info, in_dims, x, seq_lengths, proj, sigma, width, row_scale, mode,
      precision):
    b = _fold_rows("conv_parts", info, in_dims)
    scale = None if row_scale is None else \
        _rows_first(row_scale, in_dims[5], b)
    c, s = _conv_parts_op(_rows_first(x, in_dims[0], b),
                          _rows_first(seq_lengths, in_dims[1], b), proj,
                          sigma, width, scale, mode, precision)
    return (c.reshape(b, -1, c.shape[-1]), s.reshape(b, -1, s.shape[-1])), \
        (0, 0)


@_conv_parts_op.register_kernel("cuda")
def _conv_parts_kernel(x, seq_lengths, proj, sigma, width, row_scale, mode,
                       precision):
    """The K3 launcher: operand checks and preparation, one launch."""
    extra = () if row_scale is None else (row_scale,)
    xh, xl, order, nk, hi, lo = _kernel_operands(
        "conv_parts", x, seq_lengths, proj, width, precision, *extra)
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
            xh.data_ptr(), data_ptr(xl), order.data_ptr(), nk.data_ptr(),
            hi.data_ptr(), data_ptr(lo), data_ptr(row_scale),
            c.data_ptr(), s.data_ptr(), n, l, dp, width, f, float(sigma),
            kernel_sincos_flag(mode), kernel_precision_flag(precision),
            stream)
    build.check(rc, "conv parts kernel")
    PARTS_LAUNCHES[tuple(x.shape) + (width, f, mode, precision)] += 1
    return c, s


def conv_maxpool(x, seq_lengths, proj, width, precision=None):
    """(N, F): max(0, max over valid windows of window @ proj)."""
    _check_shapes("conv_maxpool", x, seq_lengths, proj, width)
    check_device("conv_maxpool", x, seq_lengths, proj)
    return _conv_maxpool_op(x, seq_lengths, proj, int(width),
                            kernel_precision(precision, x.device))


@torch.library.custom_op("xgpr_tpu_torch::conv_maxpool", mutates_args=(),
                         device_types="cpu")
def _conv_maxpool_op(x: torch.Tensor, seq_lengths: torch.Tensor,
                     proj: torch.Tensor, width: int,
                     precision: str) -> torch.Tensor:
    return conv_maxpool_plain(x, seq_lengths, proj, width, precision)


@_conv_maxpool_op.register_fake
def _(x, seq_lengths, proj, width, precision):
    return x.new_empty((x.shape[0], proj.shape[1]))


@torch.library.register_vmap("xgpr_tpu_torch::conv_maxpool")
def _(info, in_dims, x, seq_lengths, proj, width, precision):
    b = _fold_rows("conv_maxpool", info, in_dims)
    out = _conv_maxpool_op(_rows_first(x, in_dims[0], b),
                           _rows_first(seq_lengths, in_dims[1], b), proj,
                           width, precision)
    return out.reshape(b, -1, out.shape[-1]), 0


@_conv_maxpool_op.register_kernel("cuda")
def _conv_maxpool_kernel(x, seq_lengths, proj, width, precision):
    """The K4 launcher: operand checks and preparation, one launch."""
    xh, xl, order, nk, hi, lo = _kernel_operands(
        "conv_maxpool", x, seq_lengths, proj, width, precision)
    n, l, dp = xh.shape
    f = proj.shape[1]
    out = torch.empty((n, f), dtype=torch.float32, device=x.device)
    if n == 0 or f == 0:
        return out
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.xgpr_conv_maxpool(
            xh.data_ptr(), data_ptr(xl), order.data_ptr(), nk.data_ptr(),
            hi.data_ptr(), data_ptr(lo), out.data_ptr(), n, l, dp, width, f,
            kernel_precision_flag(precision), stream)
    build.check(rc, "conv maxpool kernel")
    MAXPOOL_LAUNCHES[tuple(x.shape) + (width, f, precision)] += 1
    return out
