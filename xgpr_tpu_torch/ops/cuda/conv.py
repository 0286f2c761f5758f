"""Conv window loop: the K3 and K4 kernels' wrappers and their plain versions.

Replaces xgpr_tpu/ops/pallas/conv_pallas.py (``conv_parts_pallas`` and
``conv_maxpool_pallas``, whose ``pallas_call``s are in ``_conv_parts_impl``
and ``_conv_maxpool_impl``) with the CUDA C++ kernels of csrc/: what they
compute and what bounds them on the card is written in csrc/conv.cuh,
each body's design in its own file (below).  Same calling
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
CUDA tensors (x, proj and the row scale all float32 or all float64, int32
lengths, any layout); anything else raises.
The two are the CPU and CUDA implementations of one custom operator each,
``torch.ops.xgpr_tpu_torch.conv_parts`` and ``...conv_maxpool``, with a
fake implementation (the output shapes, for ``torch.compile``) and a
batching rule (a leading batch axis of x, and of the lengths and row
scale where they have one, folded into rows, for ``torch.func.vmap``),
as for K2 (feature_map.py).  Everything the launcher does runs inside
the operator.
On the card ``conv_parts`` runs the K3 instantiation of the sincos mode
it asks for, and both run the body of the dtype and feature precision
they ask for (the configured ones by default; feature_map.py
``kernel_body``), never another: for float32 "high" 3xTF32, "highest"
fp32 FMAs on the CUDA cores (fp32-exact, as xgpr_tpu's HIGHEST),
"default" one bf16 pass on a bf16 copy of x and projT (sigma still
multiplies the fp32 product), as the TPU's DEFAULT dot rounds both
operands; float64 operands the float64 DMMA body with the builtin
sincos, whatever the precision.  The plain versions round x and proj at
the same points.  ``PARTS_LAUNCHES`` and ``MAXPOOL_LAUNCHES`` count
kernel launches by their shape, (N, L, D, w, F, mode, precision) and
(N, L, D, w, F, precision), float64 launches under ("exact", "float64")
(``launch_tags``).

Before a launch the wrapper prepares each body's operands.  Every body
reads the rows ordered by valid-window count (``row_order``), so that a
tile of 64 rows stops at its own rows' largest count, and x and projT
with the channels padded to 16 bytes (a multiple of 4, 8 for bf16, 2 for
float64; ``pad_operands``: proj transposed to the K-major projT) as the
body's planes (``kernel_planes`` in operands.py, shared with K1 and K2:
TF32 high parts and remainders, bf16 values, or the values themselves).
projT's planes come from the cache kept with proj
(``operands.projT_planes``), so a chunk loop prepares them once.

- The TMA pipelines, 3xTF32 ("high", the "balanced" default;
  csrc/conv_tf32.cuh) and bf16 ("default", the "max" preset;
  csrc/conv_ws.cuh), copy x by TMA in boxes of 64 tile rows a position:
  ``tile_layout`` writes x's planes in tile order beside each row's
  window count and each tile's largest, on the card in one pass with the
  rounding (csrc/conv_layout.cuh).  ``tf32_plan`` spreads the 3xTF32
  body's row tiles over the blocks of each frequency tile; ``ws_plan``
  chooses whether the bf16 body's projT tile stays in shared memory, the
  ring's depth and how many blocks share a frequency tile; ``ws_tiles``
  lists the walks of both pipelines' blocks.
- The synchronous bodies ("highest" fp32 FMAs and float64) are one kernel
  (csrc/conv_sync.cuh): ``sync_layout`` writes x for the fp32 body in
  tile order transposed, each tile's sequences contiguous,
  ``operands.pad_freqs`` (shared with K2's fp32 body) pads proj's
  frequencies to 16 bytes, and float64 reads x as
  ``pad_operands`` pads it beside projT's cached plane.

Any number of frequency tiles is taken: every body's grid is 1-D.
``window_slots`` counts the (row, window) slots the kernels project
against the valid windows.  ``parts_launcher`` and ``maxpool_launcher``
prepare a launch and return it apart, so that a script can time the
launch alone.
"""
from collections import Counter, namedtuple
from functools import lru_cache
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import sincos as _sincos
from ..contract import bf16_mm
from . import build
from .feature_map import (BODY_FLAGS, check_device, cuda_operands,
                          kernel_body, kernel_mode, kernel_precision,
                          kernel_sincos_flag, launch_tags)
from .operands import (data_ptr, depth_multiple, kernel_planes, pad_depth,
                       pad_freqs, pad_windows, projT_planes, sm_count,
                       tile_split)

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
    precision = kernel_precision(precision, x.device, x.dtype)
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
                          kernel_precision(precision, x.device, x.dtype))
    mask = window_mask(seq_lengths.to(x.device), width, g.shape[1])
    g = torch.where(mask[:, :, None], g, float("-inf"))
    return torch.clamp_min(g.amax(dim=1), 0.0)


# The kernels' tiling: rows per tile, windows per group, frequencies per
# tile of the TMA pipelines; the synchronous kernel's frequencies per
# block by body (csrc/conv_sync.cuh: FmaTile, DmmaTile).
TILE_ROWS = 64
WINDOW_GROUP = 2
TILE_FREQS = 128
SYNC_FREQS = {"fma32": 128, "f64": 64}


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
    transpose of proj (w*D, F) with the matching zero columns
    (``operands.pad_windows``).  The padding adds zero terms only."""
    return pad_depth(x, multiple), pad_windows(proj, width, multiple)


def window_slots(seq_lengths, width, num_windows):
    """(slots, valid): the (row, window) GEMM rows the kernels project,
    TILE_ROWS x WINDOW_GROUP for each window group of each tile up to the
    tile's largest nk, against the valid windows sum(nk).  The bf16 body's
    row tiles and window pairs are the same sizes."""
    order, nk = row_order(seq_lengths, width, num_windows)
    tiles = F.pad(nk[order.long()], (0, -len(nk) % TILE_ROWS))
    top = tiles.reshape(-1, TILE_ROWS).amax(dim=1).to(torch.int64)
    groups = (top + WINDOW_GROUP - 1) // WINDOW_GROUP
    return (int(groups.sum()) * TILE_ROWS * WINDOW_GROUP,
            int(nk.to(torch.int64).sum()))


# The bf16 body's pipeline (csrc/conv_ws.cuh): rows of a row tile (the
# wgmma M), channels of a box (one 128-byte line), the bytes of a
# position box of x, of a projT box and of a streamed stage (a projT box
# and a window pair's two position boxes), the ring's stage cap, and a
# block's shared memory with what the kernel keeps of it for the
# alignment slack and the barriers.
WS_ROWS = 64
WS_CHANNELS = 64
WS_X_BOX = WS_ROWS * 128
WS_P_BOX = TILE_FREQS * 128
WS_STREAM_STAGE = WS_P_BOX + 2 * WS_X_BOX
WS_MAX_STAGES = 32
WS_SMEM = 232_448
WS_RESERVED = 2048

WsPlan = namedtuple("WsPlan", "resident stages split row_tiles freq_tiles "
                              "smem")


@lru_cache(maxsize=256)
def ws_plan(n, dp, width, f, sms):
    """The bf16 body's launch plan for N rows of dp channels, width w and
    F frequencies on a card of ``sms`` SMs.  The kernel takes windows in
    pairs, so a pair reads w + 1 positions.  projT's tile (128 frequencies
    x w*dp bf16) is resident when it fits in a block's shared memory
    beside a ring of (w + 1) * kc position boxes (kc channel lines a tap;
    the ring's stages hold one box each, as many as fit); otherwise every
    stage holds a projT box beside the pair's two position boxes.
    ``split`` blocks share each frequency tile (``tile_split``: the fewest
    tile-times at one block per SM); block (b, ft) walks row tiles b,
    b + split, ... (``ws_tiles``).  ``smem`` is the dynamic shared memory
    the launch asks for."""
    kc = -(-dp // WS_CHANNELS)
    steps = width * kc
    room = WS_SMEM - WS_RESERVED
    stages = (room - steps * WS_P_BOX) // WS_X_BOX
    resident = stages >= (width + 1) * kc
    if not resident:
        stages = room // WS_STREAM_STAGE
    stages = min(stages, WS_MAX_STAGES)
    row_tiles = -(-n // WS_ROWS)
    freq_tiles = -(-f // TILE_FREQS)
    split = tile_split(row_tiles, freq_tiles, sms, row_tiles)
    smem = (steps * WS_P_BOX + stages * WS_X_BOX if resident
            else stages * WS_STREAM_STAGE) + 1024
    return WsPlan(resident, stages, split, row_tiles, freq_tiles, smem)


def ws_tiles(plan):
    """The (row tile, frequency tile) pairs of each block of ``plan`` (a
    ``ws_plan`` or a ``tf32_plan``), block ft * split + b in grid order, as
    the TMA pipelines walk them."""
    return [[(rt, ft) for rt in range(b, plan.row_tiles, plan.split)]
            for ft in range(plan.freq_tiles) for b in range(plan.split)]


Tf32Plan = namedtuple("Tf32Plan", "split row_tiles freq_tiles")


@lru_cache(maxsize=256)
def tf32_plan(n, f, sms):
    """The 3xTF32 body's launch plan for N rows and F frequencies on a
    card of ``sms`` SMs: ``split`` blocks share each frequency tile
    (``tile_split``: the fewest tile-times at one block per SM), and
    block (b, ft) walks row tiles b, b + split, ... (``ws_tiles``).  A row
    tile is TILE_ROWS rows (csrc/conv_tf32.cuh)."""
    row_tiles = -(-n // TILE_ROWS)
    freq_tiles = -(-f // TILE_FREQS)
    split = tile_split(row_tiles, freq_tiles, sms, row_tiles)
    return Tf32Plan(split, row_tiles, freq_tiles)


def tile_layout(x, seq_lengths, width, body="bf16"):
    """The TMA pipelines' row operands (xt, order, nk_t, top): the rows
    grouped by valid-window count nk, ascending (``row_order``'s order);
    xt x's rows in that order with the channels padded to
    ``depth_multiple(body)``, as the body's planes, so that a row tile is
    64 consecutive rows (a TMA box per position): for "bf16" (N, L, dp)
    bf16, for "tf32x3" (2, N, L, dp) float32, the TF32 high parts then the
    remainders (``kernel_planes``); nk_t the rows' counts in that order;
    top (ceil(N / 64),) int32 each tile's largest count.  For CUDA tensors
    (x float32, int32 lengths) the kernels of csrc/conv_layout.cuh make
    them, in four launches, the planes in the pass that gathers the rows;
    rows of one count may land there in any order, which changes no output
    (a row's sums read its own windows alone)."""
    if x.device.type == "cuda":
        return _tile_layout_cuda(x, seq_lengths, width, body)
    order, nk = row_order(seq_lengths, width, x.shape[1] - width + 1)
    idx = order.long()
    hi, lo = kernel_planes(pad_depth(x, depth_multiple(body)), body)
    xt = hi.index_select(0, idx) if lo is None else \
        torch.stack((hi, lo)).index_select(1, idx)
    nk_t = nk.index_select(0, idx)
    top = F.pad(nk_t, (0, -len(nk_t) % WS_ROWS)).reshape(-1, WS_ROWS)
    return xt, order, nk_t, top.amax(dim=1).to(torch.int32).contiguous()


def sync_layout(x, order):
    """The fp32 synchronous body's x: (L, D, NP), x[order[s], p, c] at
    [p, c, s] for the rows in tile order, NP the row count rounded up to
    whole tiles of TILE_ROWS (the rows past N repeat row 0; no output
    reads them), so that a tile's 64 sequences lie together for each
    (position, channel).  One gather."""
    n = x.shape[0]
    idx = F.pad(order.long(), (0, -n % TILE_ROWS))
    return x.permute(1, 2, 0).index_select(2, idx)


def _check_shapes(name, x, seq_lengths, proj, width):
    if x.dim() != 3 or proj.dim() != 2 or \
            proj.shape[0] != width * x.shape[2] or \
            tuple(seq_lengths.shape) != (x.shape[0],):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, lengths "
                         f"{tuple(seq_lengths.shape)} and proj "
                         f"{tuple(proj.shape)} do not fit width {width}.")
    if x.shape[1] < width:
        raise ValueError("Sequence axis shorter than conv_width.")


def _tile_layout_cuda(x, seq_lengths, width, body):
    n, l, d = x.shape
    dp = -(-d // depth_multiple(body)) * depth_multiple(body)
    dev = x.device
    xt = torch.empty((n, l, dp), dtype=torch.bfloat16, device=dev) \
        if body == "bf16" else \
        torch.empty((2, n, l, dp), dtype=torch.float32, device=dev)
    # One allocation: order, nk_t, top and the kernels' scratch.
    tiles = -(-n // WS_ROWS)
    ints = torch.empty(2 * n + tiles + 2 * (l - width + 2),
                       dtype=torch.int32, device=dev)
    order, nk_t, top, scratch = ints.split(
        [n, n, tiles, 2 * (l - width + 2)])
    if n:
        lengths = seq_lengths.contiguous()
        x = x.contiguous()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            build.check(build.library().xgpr_conv_tile_layout(
                x.data_ptr(), lengths.data_ptr(), n, l, d, dp, width,
                BODY_FLAGS[body], xt.data_ptr(), order.data_ptr(),
                nk_t.data_ptr(), top.data_ptr(), scratch.data_ptr(), stream),
                "conv tile layout")
    return xt, order, nk_t, top


def _checked(name, kernel, x, seq_lengths, proj, precision, *more):
    """Checks for the CUDA route of ``kernel`` ("K3" or "K4"); returns
    (dtype, body, x, proj, *more), contiguous, and the body of the
    operands' dtype and ``precision`` (``kernel_body``)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}.")
    dtype, (x, proj, *more) = cuda_operands(name, x, proj, *more)
    body = kernel_body(kernel, dtype, precision)
    if seq_lengths.device != x.device or seq_lengths.dtype != torch.int32:
        raise TypeError(f"{name}: the CUDA kernel takes int32 lengths on "
                        f"{x.device}.")
    return (dtype, body, x, proj) + tuple(more)


def _sync_args(x, seq_lengths, proj, width, body):
    """The synchronous bodies' operands, as xgpr_conv_parts_sync /
    xgpr_conv_maxpool_sync take them: (x, order, nk, proj) (fp32:
    ``sync_layout`` and ``pad_freqs``; float64: x padded to an even channel
    count and projT's cached plane), (d, fp) the channels of x as laid out
    and proj's row stride, and the tensors to keep alive."""
    order, nk = row_order(seq_lengths, width, x.shape[1] - width + 1)
    if body == "fma32":
        xs, pr = sync_layout(x, order), pad_freqs(proj)
        dims = (x.shape[2], pr.shape[1])
    else:
        xs = pad_depth(x, depth_multiple(body))
        pr = projT_planes(proj, body, width)[0]
        dims = (xs.shape[2], proj.shape[1])
    return ((xs.data_ptr(), order.data_ptr(), nk.data_ptr(),
             pr.data_ptr()), dims, (xs, order, nk, pr))


def _ws_args(x, seq_lengths, proj, width):
    """The bf16 body's operands, as xgpr_conv_parts_ws /
    xgpr_conv_maxpool_ws take them: (xt, order, nk_t, top, projT)
    (``tile_layout``, projT's bf16 plane from the cache kept with proj),
    the padded channel count, the plan's (resident, stages, split), and
    the tensors to keep alive."""
    xt, order, nk, top = tile_layout(x, seq_lengths, width, "bf16")
    projT = projT_planes(proj, "bf16", width)[0]
    n, _, dp = xt.shape
    plan = ws_plan(n, dp, width, proj.shape[1], sm_count(x.device.index))
    return ((xt.data_ptr(), order.data_ptr(), nk.data_ptr(), top.data_ptr(),
             projT.data_ptr()), dp,
            (int(plan.resident), plan.stages, plan.split),
            (xt, order, nk, top, projT))


def _tf32_args(x, seq_lengths, proj, width):
    """The 3xTF32 body's operands, as xgpr_conv_parts_tf32 /
    xgpr_conv_maxpool_tf32 take them: (xt, order, nk_t, top, projT's hi
    and lo planes) (``tile_layout`` on the card, the planes from the cache
    kept with proj), the padded channel count, the plan's (split,), and
    the tensors to keep alive."""
    xt, order, nk, top = tile_layout(x, seq_lengths, width, "tf32x3")
    hi, lo = projT_planes(proj, "tf32x3", width)
    _, n, _, dp = xt.shape
    plan = tf32_plan(n, proj.shape[1], sm_count(x.device.index))
    return ((xt.data_ptr(), order.data_ptr(), nk.data_ptr(), top.data_ptr(),
             hi.data_ptr(), lo.data_ptr()), dp, (plan.split,),
            (xt, order, nk, top, hi, lo))


def conv_parts(x, seq_lengths, proj, sigma, width, row_scale=None,
               mode=None, precision=None):
    """(c, s), each (N, F): masked window sums of cos/sin of
    (window @ proj) * sigma, times row_scale (N,) when given."""
    _check_shapes("conv_parts", x, seq_lengths, proj, width)
    extra = () if row_scale is None else (row_scale,)
    check_device("conv_parts", x, seq_lengths, proj, *extra)
    return _conv_parts_op(x, seq_lengths, proj, float(sigma), int(width),
                          row_scale, kernel_mode(mode),
                          kernel_precision(precision, x.device, x.dtype))


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


def _launch(x, fn, args, keep, what):
    """The launch of a prepared kernel call: fn(*args, stream) on x's
    device and current stream; raises on a CUDA error.  ``keep`` holds
    the tensors whose addresses args carries."""
    def launch():
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            build.check(fn(*args, stream), what)
    launch.keep = keep
    return launch


def parts_launcher(x, seq_lengths, proj, sigma, width, row_scale, mode,
                   precision):
    """((c, s), launch) for K3 on CUDA tensors at a resolved sincos mode
    and precision: the outputs, allocated, and the launch that fills them,
    its operands prepared; launch() is the kernel's launch alone.  The
    bf16 body runs conv_ws.cuh (xgpr_conv_parts_ws), "fma32" and "f64" the
    synchronous kernel conv_sync.cuh (xgpr_conv_parts_sync), "tf32x3" the
    TMA pipeline conv_tf32.cuh (xgpr_conv_parts_tf32)."""
    extra = () if row_scale is None else (row_scale,)
    dtype, body, x, proj, *extra = _checked(
        "conv_parts", "K3", x, seq_lengths, proj, precision, *extra)
    row_scale = extra[0] if extra else None
    n, l, _ = x.shape
    f = proj.shape[1]
    c = torch.empty((n, f), dtype=dtype, device=x.device)
    s = torch.empty((n, f), dtype=dtype, device=x.device)
    if n == 0 or f == 0:
        return (c, s), lambda: None
    lib = build.library()
    tail = (data_ptr(row_scale), c.data_ptr(), s.data_ptr())
    if body == "bf16":
        ptrs, dp, plan, keep = _ws_args(x, seq_lengths, proj, width)
        fn = lib.xgpr_conv_parts_ws
        args = ptrs + tail + (n, l, dp, width, f, float(sigma),
                              kernel_sincos_flag(mode)) + plan
    elif body in SYNC_FREQS:
        ptrs, dims, keep = _sync_args(x, seq_lengths, proj, width, body)
        fn = lib.xgpr_conv_parts_sync
        args = ptrs + tail + (n, l) + dims[:1] + (width, f) + dims[1:] + (
            float(sigma), kernel_sincos_flag(mode), BODY_FLAGS[body])
    else:
        ptrs, dp, plan, keep = _tf32_args(x, seq_lengths, proj, width)
        fn = lib.xgpr_conv_parts_tf32
        args = ptrs + tail + (n, l, dp, width, f, float(sigma),
                              kernel_sincos_flag(mode)) + plan
    return (c, s), _launch(x, fn, args, keep + (row_scale,),
                           "conv parts kernel")


@_conv_parts_op.register_kernel("cuda")
def _conv_parts_kernel(x, seq_lengths, proj, sigma, width, row_scale, mode,
                       precision):
    """The K3 launcher: operand checks and preparation, one launch."""
    out, launch = parts_launcher(x, seq_lengths, proj, sigma, width,
                                 row_scale, mode, precision)
    if out[0].numel():
        launch()
        PARTS_LAUNCHES[tuple(x.shape) + (width, proj.shape[1])
                       + launch_tags(out[0].dtype, mode, precision)] += 1
    return out


def conv_maxpool(x, seq_lengths, proj, width, precision=None):
    """(N, F): max(0, max over valid windows of window @ proj)."""
    _check_shapes("conv_maxpool", x, seq_lengths, proj, width)
    check_device("conv_maxpool", x, seq_lengths, proj)
    return _conv_maxpool_op(x, seq_lengths, proj, int(width),
                            kernel_precision(precision, x.device, x.dtype))


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


def maxpool_launcher(x, seq_lengths, proj, width, precision):
    """(out, launch) for K4 on CUDA tensors at a resolved precision, as
    ``parts_launcher``."""
    dtype, body, x, proj = _checked("conv_maxpool", "K4", x, seq_lengths,
                                    proj, precision)
    n, l, _ = x.shape
    f = proj.shape[1]
    out = torch.empty((n, f), dtype=dtype, device=x.device)
    if n == 0 or f == 0:
        return out, lambda: None
    lib = build.library()
    if body == "bf16":
        ptrs, dp, plan, keep = _ws_args(x, seq_lengths, proj, width)
        fn = lib.xgpr_conv_maxpool_ws
        args = ptrs + (out.data_ptr(), n, l, dp, width, f) + plan
    elif body in SYNC_FREQS:
        ptrs, dims, keep = _sync_args(x, seq_lengths, proj, width, body)
        fn = lib.xgpr_conv_maxpool_sync
        args = ptrs + (out.data_ptr(), n, l) + dims[:1] + (width, f) + \
            dims[1:] + (BODY_FLAGS[body],)
    else:
        ptrs, dp, plan, keep = _tf32_args(x, seq_lengths, proj, width)
        fn = lib.xgpr_conv_maxpool_tf32
        args = ptrs + (out.data_ptr(), n, l, dp, width, f) + plan
    return out, _launch(x, fn, args, keep, "conv maxpool kernel")


@_conv_maxpool_op.register_kernel("cuda")
def _conv_maxpool_kernel(x, seq_lengths, proj, width, precision):
    """The K4 launcher: operand checks and preparation, one launch."""
    out, launch = maxpool_launcher(x, seq_lengths, proj, width, precision)
    if out.numel():
        launch()
        MAXPOOL_LAUNCHES[tuple(x.shape) + (width, proj.shape[1])
                         + launch_tags(out.dtype, None, precision)[1:]] += 1
    return out
