"""Dense RBF feature map: the K2 kernel's wrapper and its plain version.

Replaces xgpr_tpu/ops/pallas/sorf_pallas.py (``rbf_feature_map_pallas``,
whose ``pallas_call`` is in ``_rbf_feature_map_impl``) with the CUDA C++
kernel in csrc/feature_map.cu; see that file for the design and what
bounds it on the card.  Same calling convention: x already scaled by
sigma, proj (D, F) with chi folded in, output (N, 2F) in the block
[cos | sin] layout.  The intercept overwrite of column 0 stays in the
kernel layer (kernels/basic.py).

Before a launch the wrapper pads x's columns to a multiple of 4 and
splits x into TF32 high parts and remainders (operands.py: three
elementwise passes over x, 2.75 MB at RBF's 8192 x 84 chunk); the split
of proj's transpose is cached with proj (``projT_split``).

``rbf_feature_map`` runs the plain version for a CPU tensor and the
kernel for a CUDA tensor; anything else raises.  A CUDA tensor gets the
kernel of the sincos mode it asks for (the configured one by default):
"hi", "exact", "fast" and "poly" are each a kernel instantiation.

The two are the CPU and CUDA implementations of one custom operator,
``torch.ops.xgpr_tpu_torch.rbf_feature_map`` (``torch.library``), so
that ``torch.compile(fullgraph=True)`` traces through a caller (the
operator's fake implementation gives its output's shape) and
``torch.func.vmap`` maps it (its batching rule folds a leading batch
axis of x into rows: the map is row-wise).  The whole launcher, the
operand checks and preparation included, runs inside the operator.
``LAUNCHES`` counts kernel launches by their shape and mode
(N, D, F, mode).  K2 has no precision variant: xgpr_tpu's Pallas feature
map pins HIGHEST, so it runs its 3xTF32 body under every preset.  The
precision switch of K1, K3 and K4 (``kernel_precision``,
``kernel_precision_flag``) lives here beside the sincos switch.
"""
from collections import Counter

import torch

from .. import sincos as _sincos
from ..layout import assemble_cos_sin
from ..sorf import rbf_norm_constant
from ...config import feature_matmul_precision, sincos_mode
from . import build
from .operands import (pad_depth, projT_split, sm_count, split_tf32,
                       tile_split)

LAUNCHES = Counter()

TILE = 128  # rows and frequencies per tile (csrc/tf32_gemm.cuh: GM, GN)


def rbf_feature_map_plain(x, proj, fit_intercept, padded, mode=None):
    """Plain PyTorch version of the kernel: the same arithmetic in the same
    order, with torch.matmul for the projection."""
    scale = torch.tensor(rbf_norm_constant(proj.shape[1], fit_intercept),
                         dtype=x.dtype, device=x.device)
    c, s = _sincos.sincos(torch.matmul(x, proj), scale, mode)
    return assemble_cos_sin(c, s, padded)


# The kernels' sincos switch (csrc/common.cuh: SincosMode), one
# instantiation of each kernel per mode.
_MODE_FLAGS = {"hi": 0, "exact": 1, "fast": 2, "poly": 3}


def kernel_mode(mode=None) -> str:
    """The sincos mode a kernel launch runs: ``mode``, or the configured
    one when None, with "auto" read as "hi".  Anything else raises."""
    mode = sincos_mode() if mode is None else mode
    mode = "hi" if mode == "auto" else mode
    if mode not in _MODE_FLAGS:
        raise ValueError(f"unknown sincos mode {mode!r}; the kernels take "
                         f"auto, {', '.join(_MODE_FLAGS)}.")
    return mode


def kernel_sincos_flag(mode=None) -> int:
    """The kernels' sincos switch for ``mode`` (``kernel_mode``): 0 "hi",
    1 "exact", 2 "fast", 3 "poly"."""
    return _MODE_FLAGS[kernel_mode(mode)]


# The bodies of K1, K3 and K4 by feature precision (csrc/tf32_gemm.cuh:
# Format): "high" 3xTF32, "highest" the same 3xTF32 body (PREC_HIGHEST),
# "default" one bf16 pass.
_PRECISION_FLAGS = {"high": 0, "highest": 1, "default": 2}


def kernel_precision(precision=None, device="cuda") -> str:
    """The feature precision a launch (or a plain version) runs at:
    ``precision``, or the configured one on ``device`` when None.
    Anything else raises."""
    if precision is None:
        precision = feature_matmul_precision(device)
    if precision not in _PRECISION_FLAGS:
        raise ValueError(f"unknown feature precision {precision!r}; the "
                         f"kernels take {', '.join(_PRECISION_FLAGS)}.")
    return precision


def kernel_precision_flag(precision=None) -> int:
    """The kernels' precision switch for ``precision``
    (``kernel_precision``): 0 "high", 1 "highest", 2 "default"."""
    return _PRECISION_FLAGS[kernel_precision(precision)]


def check_cuda_operands(name, *tensors):
    """fp32, contiguous, on one CUDA device; raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands are on different devices "
                             f"({t.device} and {dev}).")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                            f"{t.dtype}.")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous.")


def check_device(name, *tensors):
    """Raise for a device that has neither a kernel nor a plain version."""
    for t in tensors:
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: no kernel for {t.device}.")


def rbf_feature_map(x, proj, fit_intercept, padded, mode=None):
    """(N, 2F) block-layout RBF features of sigma-scaled rows x (N, D)."""
    if x.dim() != 2 or proj.dim() != 2 or x.shape[1] != proj.shape[0]:
        raise ValueError(f"rbf_feature_map: shapes {tuple(x.shape)} and "
                         f"{tuple(proj.shape)} do not contract.")
    check_device("rbf_feature_map", x, proj)
    return _rbf_feature_map_op(x, proj, bool(fit_intercept), int(padded),
                               kernel_mode(mode))


@torch.library.custom_op("xgpr_tpu_torch::rbf_feature_map", mutates_args=(),
                         device_types="cpu")
def _rbf_feature_map_op(x: torch.Tensor, proj: torch.Tensor,
                        fit_intercept: bool, padded: int,
                        mode: str) -> torch.Tensor:
    return rbf_feature_map_plain(x, proj, fit_intercept, padded, mode)


@_rbf_feature_map_op.register_fake
def _(x, proj, fit_intercept, padded, mode):
    return x.new_empty((x.shape[0], 2 * proj.shape[1]))


@torch.library.register_vmap("xgpr_tpu_torch::rbf_feature_map")
def _(info, in_dims, x, proj, fit_intercept, padded, mode):
    if in_dims[1] is not None:
        raise NotImplementedError("rbf_feature_map maps over rows of x "
                                  "only, not over projections")
    xb = x.movedim(in_dims[0], 0)
    out = _rbf_feature_map_op(xb.reshape(-1, xb.shape[-1]).contiguous(),
                              proj, fit_intercept, padded, mode)
    return out.reshape(xb.shape[0], xb.shape[1], -1), 0


@_rbf_feature_map_op.register_kernel("cuda")
def _rbf_feature_map_kernel(x, proj, fit_intercept, padded, mode):
    """The K2 launcher: operand checks, x's TF32 split, one launch."""
    if x.device.type != "cuda":
        raise ValueError(f"rbf_feature_map: no kernel for {x.device}.")
    check_cuda_operands("rbf_feature_map", x, proj)
    n = x.shape[0]
    f = proj.shape[1]
    out = torch.empty((n, 2 * f), dtype=torch.float32, device=x.device)
    if n == 0 or f == 0:
        return out
    xh, xl = split_tf32(pad_depth(x))
    ph, pl = projT_split(proj)
    row_tiles, f_tiles = -(-n // TILE), -(-f // TILE)
    rsplit = tile_split(row_tiles, f_tiles, sm_count(x.device.index), 64)
    lib = build.library()
    scale = rbf_norm_constant(f, fit_intercept)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.xgpr_feature_map(xh.data_ptr(), xl.data_ptr(),
                                  ph.data_ptr(), pl.data_ptr(),
                                  out.data_ptr(), n, xh.shape[1], f,
                                  int(padded), scale,
                                  kernel_sincos_flag(mode), rsplit, stream)
    build.check(rc, "feature map kernel")
    LAUNCHES[(n, x.shape[1], f, mode)] += 1
    return out
