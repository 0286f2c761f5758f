"""Dense RBF feature map: the K2 kernel's wrapper and its plain version.

Replaces xgpr_tpu/ops/pallas/sorf_pallas.py (``rbf_feature_map_pallas``,
whose ``pallas_call`` is in ``_rbf_feature_map_impl``) with the CUDA C++
kernel in csrc/feature_map.cuh; see that file for the design and what
bounds it on the card.  Same calling convention: x already scaled by
sigma, proj (D, F) with chi folded in, output (N, 2F) in the block
[cos | sin] layout, in the operands' dtype.  The intercept overwrite of
column 0 stays in the kernel layer (kernels/basic.py).

Before a launch the wrapper makes the operands contiguous, pads x's
columns to 16 bytes and, for float32, splits x into TF32 high parts and
remainders (operands.py: three elementwise passes over x, 2.75 MB at
RBF's 8192 x 84 chunk); proj's transpose is prepared once per body and
cached with proj (``projT_planes``).  float32 operands run the 3xTF32
body, or at the "highest" feature precision the fp32 FMA body on the CUDA
cores (fp32-exact, as xgpr_tpu's Pallas feature map, which pins HIGHEST),
which reads x^T (one transpose a call, ``rows_last``) and proj with its
frequencies padded to 16 bytes (``pad_freqs``, proj itself when F is a
multiple of 4); float64 operands the float64 DMMA body with the builtin
sincos (``kernel_body``).

``rbf_feature_map`` runs the plain version for a CPU tensor and the
kernel for a CUDA tensor; anything else raises.  A CUDA tensor gets the
kernel of the sincos mode and feature precision it asks for (the
configured ones by default, resolved before the operator):
"hi", "exact", "fast" and "poly" are each a kernel instantiation.

The two are the CPU and CUDA implementations of one custom operator,
``torch.ops.xgpr_tpu_torch.rbf_feature_map`` (``torch.library``), so
that ``torch.compile(fullgraph=True)`` traces through a caller (the
operator's fake implementation gives its output's shape) and
``torch.func.vmap`` maps it (its batching rule folds a leading batch
axis of x into rows: the map is row-wise).  The whole launcher, the
operand checks and preparation included, runs inside the operator.
``LAUNCHES`` counts kernel launches by their shape, mode and the
precision that ran (N, D, F, mode, precision; ``launch_tags``):
xgpr_tpu's Pallas feature map pins HIGHEST, so K2's float32 launches run
fp32 FMAs under "highest" (the "reference" preset) and the 3xTF32 body,
fp32-grade, under "high" and "default" alike, and count as "highest"
and "high".
The switches every kernel shares live here: the sincos mode
(``kernel_mode``), the feature precision of K1-K4
(``kernel_precision``), the operands' dtype (``operand_dtype``) and the
body these choose (``kernel_body``).
"""
from collections import Counter

import torch

from .. import sincos as _sincos
from ..layout import assemble_cos_sin
from ..sorf import rbf_norm_constant
from ...config import feature_matmul_precision, sincos_mode
from . import build
from .operands import (data_ptr, depth_multiple, kernel_planes, pad_depth,
                       pad_freqs, projT_planes, rows_last, sm_count,
                       tile_split)

LAUNCHES = Counter()

TILE = 128  # rows and frequencies per tile (csrc/gemm_common.cuh: GM, GN;
#             csrc/dense_wgmma.cuh: a block's 128-wide walk tiles;
#             csrc/feature_map_fma.cu: TILE)
# Blocks of the fp32 FMA body an SM holds (csrc/feature_map_fma.cu:
# MIN_BLOCKS): its row split fills this many a SM.
FMA_BLOCKS_PER_SM = 2


def rbf_feature_map_plain(x, proj, fit_intercept, padded, mode=None,
                          precision=None):
    """Plain PyTorch version of the kernel: the same arithmetic in the same
    order, with torch.matmul for the projection, fp32-exact on the card
    (TF32 off) at every ``precision``, as xgpr_tpu's Pallas feature map
    pins HIGHEST; ``precision`` is checked and otherwise not read."""
    kernel_precision(precision, x.device, x.dtype)
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


PRECISIONS = ("high", "highest", "default")


def kernel_precision(precision=None, device="cuda", dtype=None) -> str:
    """The feature precision a launch (or a plain version) runs at:
    ``precision``, or when None the configured one for operands of
    ``dtype`` on ``device`` ("highest" for float64).  Anything else
    raises."""
    if precision is None:
        precision = feature_matmul_precision(device, dtype)
    if precision not in PRECISIONS:
        raise ValueError(f"unknown feature precision {precision!r}; the "
                         f"kernels take {', '.join(PRECISIONS)}.")
    return precision


# The bodies of the kernels by the flag their C entry points take
# (csrc/gemm_common.cuh: Format): 3xTF32, one bf16 pass and float64 DMMA on
# the tensor cores, fp32 FMAs on the CUDA cores.
BODY_FLAGS = {"tf32x3": 0, "fma32": 1, "bf16": 2, "f64": 3}


def kernel_body(kernel, dtype, precision) -> str:
    """The body a launch of ``kernel`` ("K1" .. "K4") runs on operands of
    ``dtype`` at feature ``precision``: float64 operands run "f64"
    whatever the precision, as xgpr_tpu's float64 runs ignore the knobs;
    float32 ones "bf16" under "default" (K1, K3, K4), "fma32" under
    "highest" for K2, K3 and K4 (fp32-exact, as the TPU's HIGHEST; K1
    keeps 3xTF32, fp32-grade there, PERF.md) and "tf32x3" otherwise (K2
    under "default" too: xgpr_tpu's Pallas feature map pins HIGHEST).
    Anything else raises."""
    if kernel not in ("K1", "K2", "K3", "K4"):
        raise ValueError(f"unknown kernel {kernel!r}")
    kernel_precision(precision)
    if dtype == torch.float64:
        return "f64"
    if dtype != torch.float32:
        raise TypeError(f"{kernel}: the CUDA kernels take float32 or "
                        f"float64, got {dtype}.")
    if precision == "highest" and kernel != "K1":
        return "fma32"
    if precision == "default" and kernel != "K2":
        return "bf16"
    return "tf32x3"


def launch_tags(dtype, mode, precision):
    """The (mode, precision) entries of a launch's counter key, what the
    launch ran: float64 operands run the builtin sincos ("exact") in the
    float64 body ("float64") whatever was asked."""
    if dtype == torch.float64:
        return "exact", "float64"
    return mode, precision


def operand_dtype(name, *tensors):
    """The dtype the floating operands of one kernel call share, float32
    or float64; mixed or other dtypes raise."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"{name}: the operands mix dtypes "
                        f"({', '.join(sorted(map(str, dtypes)))}); the CUDA "
                        "kernels take float32 or float64 throughout.")
    dtype = dtypes.pop()
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the CUDA kernels take float32 or float64, "
                        f"got {dtype}.")
    return dtype


def cuda_operands(name, *tensors):
    """(dtype, tensors): the floating operands of a launch on one CUDA
    device, made contiguous, with their shared dtype (``operand_dtype``);
    raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands are on different devices "
                             f"({t.device} and {dev}).")
    return (operand_dtype(name, *tensors),
            tuple(t.contiguous() for t in tensors))


def check_device(name, *tensors):
    """Raise for a device that has neither a kernel nor a plain version."""
    for t in tensors:
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: no kernel for {t.device}.")


def rbf_feature_map(x, proj, fit_intercept, padded, mode=None,
                    precision=None):
    """(N, 2F) block-layout RBF features of sigma-scaled rows x (N, D), at
    the feature ``precision`` (``kernel_precision``; the plain version is
    the same at every precision)."""
    if x.dim() != 2 or proj.dim() != 2 or x.shape[1] != proj.shape[0]:
        raise ValueError(f"rbf_feature_map: shapes {tuple(x.shape)} and "
                         f"{tuple(proj.shape)} do not contract.")
    check_device("rbf_feature_map", x, proj)
    return _rbf_feature_map_op(x, proj, bool(fit_intercept), int(padded),
                               kernel_mode(mode),
                               kernel_precision(precision, x.device, x.dtype))


@torch.library.custom_op("xgpr_tpu_torch::rbf_feature_map", mutates_args=(),
                         device_types="cpu")
def _rbf_feature_map_op(x: torch.Tensor, proj: torch.Tensor,
                        fit_intercept: bool, padded: int,
                        mode: str, precision: str) -> torch.Tensor:
    return rbf_feature_map_plain(x, proj, fit_intercept, padded, mode,
                                 precision)


@_rbf_feature_map_op.register_fake
def _(x, proj, fit_intercept, padded, mode, precision):
    return x.new_empty((x.shape[0], 2 * proj.shape[1]))


@torch.library.register_vmap("xgpr_tpu_torch::rbf_feature_map")
def _(info, in_dims, x, proj, fit_intercept, padded, mode, precision):
    if in_dims[1] is not None:
        raise NotImplementedError("rbf_feature_map maps over rows of x "
                                  "only, not over projections")
    xb = x.movedim(in_dims[0], 0)
    out = _rbf_feature_map_op(xb.reshape(-1, xb.shape[-1]).contiguous(),
                              proj, fit_intercept, padded, mode, precision)
    return out.reshape(xb.shape[0], xb.shape[1], -1), 0


@_rbf_feature_map_op.register_kernel("cuda")
def _rbf_feature_map_kernel(x, proj, fit_intercept, padded, mode, precision):
    """The K2 launcher: operand checks, x's planes, one launch."""
    if x.device.type != "cuda":
        raise ValueError(f"rbf_feature_map: no kernel for {x.device}.")
    return launcher(x, proj, fit_intercept, padded, mode, precision)()


def launcher(x, proj, fit_intercept, padded, mode=None, precision=None):
    """The kernel launch of one ``rbf_feature_map`` call on CUDA operands,
    prepared: a function of no arguments that launches the kernel on the
    current stream into its output, counts the launch and returns the
    output."""
    dtype, (x, proj) = cuda_operands("rbf_feature_map", x, proj)
    mode = kernel_mode(mode)
    precision = kernel_precision(precision, x.device, dtype)
    body = kernel_body("K2", dtype, precision)
    n = x.shape[0]
    f = proj.shape[1]
    out = torch.empty((n, 2 * f), dtype=dtype, device=x.device)
    if n == 0 or f == 0:
        return lambda: out
    slots = sm_count(x.device.index)
    if body == "fma32":
        xh, xl, ph, pl = rows_last(x), None, pad_freqs(proj), None
        dp, slots = x.shape[1], slots * FMA_BLOCKS_PER_SM
    else:
        xh, xl = kernel_planes(pad_depth(x, depth_multiple(body)), body)
        ph, pl = projT_planes(proj, body)
        dp = xh.shape[1]
    row_tiles, f_tiles = -(-n // TILE), -(-f // TILE)
    rsplit = tile_split(row_tiles, f_tiles, slots, 64)
    lib = build.library()
    scale = rbf_norm_constant(f, fit_intercept)
    ran = "highest" if body == "fma32" else "high"
    key = (n, x.shape[1], f) + launch_tags(dtype, mode, ran)

    def launch():
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.xgpr_feature_map(xh.data_ptr(), data_ptr(xl),
                                      ph.data_ptr(), data_ptr(pl),
                                      out.data_ptr(), n, dp, f,
                                      int(padded), scale,
                                      kernel_sincos_flag(mode),
                                      BODY_FLAGS[body], rsplit, stream)
        build.check(rc, "feature map kernel")
        LAUNCHES[key] += 1
        return out
    return launch
