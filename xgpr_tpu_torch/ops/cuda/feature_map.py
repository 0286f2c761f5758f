"""Dense RBF feature map: the K2 kernel's wrapper and its plain version.

Replaces xgpr_tpu/ops/pallas/sorf_pallas.py (``rbf_feature_map_pallas``,
whose ``pallas_call`` is in ``_rbf_feature_map_impl``) with the CUDA C++
kernel in csrc/feature_map.cu; see that file for the design and what
bounds it on the card.  Same calling convention: x already scaled by
sigma, proj (D, F) with chi folded in, output (N, 2F) in the block
[cos | sin] layout.  The intercept overwrite of column 0 stays in the
kernel layer (kernels/basic.py).

``rbf_feature_map`` runs the plain version for a CPU tensor and the
kernel for a CUDA tensor; anything else raises.  ``LAUNCHES`` counts
kernel launches.
"""
import torch

from .. import sincos as _sincos
from ..layout import assemble_cos_sin
from ..sorf import rbf_norm_constant
from ...config import sincos_mode
from . import build

LAUNCHES = 0


def rbf_feature_map_plain(x, proj, fit_intercept, padded, mode=None):
    """Plain PyTorch version of the kernel: the same arithmetic in the same
    order, with torch.matmul for the projection."""
    scale = torch.tensor(rbf_norm_constant(proj.shape[1], fit_intercept),
                         dtype=x.dtype, device=x.device)
    c, s = _sincos.sincos(torch.matmul(x, proj), scale, mode)
    return assemble_cos_sin(c, s, padded)


def kernel_sincos_flag(mode=None) -> int:
    """The kernels' sincos switch: 0 = "hi", 1 = "exact".  The other modes
    are not implemented in the kernels and raise rather than silently
    computing another one."""
    mode = sincos_mode() if mode is None else mode
    if mode in ("auto", "hi"):
        return 0
    if mode == "exact":
        return 1
    raise NotImplementedError(
        f"sincos mode {mode!r} is not implemented in the CUDA kernels; "
        "use 'hi' (the default) or 'exact'.")


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


def rbf_feature_map(x, proj, fit_intercept, padded, mode=None):
    """(N, 2F) block-layout RBF features of sigma-scaled rows x (N, D)."""
    global LAUNCHES
    if x.dim() != 2 or proj.dim() != 2 or x.shape[1] != proj.shape[0]:
        raise ValueError(f"rbf_feature_map: shapes {tuple(x.shape)} and "
                         f"{tuple(proj.shape)} do not contract.")
    if x.device.type == "cpu" and proj.device.type == "cpu":
        return rbf_feature_map_plain(x, proj, fit_intercept, padded, mode)
    if x.device.type != "cuda":
        raise ValueError(f"rbf_feature_map: no kernel for {x.device}.")
    check_cuda_operands("rbf_feature_map", x, proj)
    exact = kernel_sincos_flag(mode)
    n, d = x.shape
    f = proj.shape[1]
    if (f + 63) // 64 > 65535:
        raise ValueError("rbf_feature_map: too many frequencies for the grid.")
    out = torch.empty((n, 2 * f), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = build.library()
    scale = rbf_norm_constant(f, fit_intercept)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.xgpr_feature_map(x.data_ptr(), proj.data_ptr(),
                                  out.data_ptr(), n, d, f, int(padded),
                                  scale, exact, stream)
    build.check(rc, "feature map kernel")
    LAUNCHES += 1
    return out
