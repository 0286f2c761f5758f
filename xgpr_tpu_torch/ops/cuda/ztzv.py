"""Fused CG matvec for one chunk: the K1 kernel's wrapper and its plain version.

Replaces xgpr_tpu/ops/pallas/ztzv_pallas.py (``ztzv_parts_pallas``, whose
``pallas_call`` is in ``_ztzv_parts_impl``) with the CUDA C++ kernels in
csrc/ztzv.cu; see that file for the design and what bounds it on the card.
Before a launch the wrapper pads x's columns to a multiple of 4 and splits
x into TF32 high parts and remainders (operands.py: three elementwise
passes over the chunk, 2.75 MB at 8192 x 84); the split of proj's
transpose is cached with proj (``projT_split``).
Same semantics: x raw (not sigma-scaled), sigma multiplies the product,
scale = rbf_norm_constant(F, intercept), mask * scale folded into both
parts, and with an intercept cos column 0 equals the mask.

``ztzv_parts`` runs the plain version for CPU tensors and the kernel for
CUDA tensors; anything else raises.  A CUDA call runs the kernels of the
sincos mode it asks for (the configured one by default).  ``LAUNCHES``
counts kernel launches (one per call, covering its three CUDA launches) by
their shape and mode (R, D, F, K, mode): K is 1 in a fit's CG and 26 in
SLQ's.  Two calls on the same
inputs give the same bits.
"""
from collections import Counter

import torch

from .. import sincos as _sincos
from ..contract import parts_contract
from ..sorf import rbf_norm_constant
from . import build
from .feature_map import (TILE, check_cuda_operands, kernel_mode,
                          kernel_sincos_flag)
from .operands import (pad_depth, projT_split, sm_count, split_tf32,
                       tile_split)

LAUNCHES = Counter()

ZV_RHS = 8  # right-hand sides per block of the zv pass when K > 1


def ztzv_parts_plain(x, m, proj, sigma, v_c, v_s, fit_intercept, mode=None):
    """Plain PyTorch version: materialises the (R, F) parts and contracts
    them with torch.matmul."""
    scale = torch.tensor(rbf_norm_constant(proj.shape[1], fit_intercept),
                         dtype=x.dtype, device=x.device)
    sig = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
    arg = torch.matmul(x, proj) * sig
    c, s = _sincos.sincos(arg, (m * scale)[:, None], mode)
    if fit_intercept:
        c[:, 0] = m
    return parts_contract(c, s, v_c, v_s)


def ztzv_parts(x, m, proj, sigma, v_c, v_s, fit_intercept, mode=None):
    """(oc, os), each (F, K): the chunk's Z^T (Z v) in cos/sin halves.

    x (R, D) raw rows; m (R,) row mask; proj (D, F); sigma a float;
    v_c / v_s (F, K) the cos/sin halves of the CG direction.
    """
    n, d = x.shape
    f = proj.shape[1]
    k = v_c.shape[1]
    if proj.shape[0] != d or m.shape != (n,) or v_c.shape != (f, k) \
            or v_s.shape != (f, k) or k < 1:
        raise ValueError("ztzv_parts: inconsistent operand shapes.")
    if all(t.device.type == "cpu" for t in (x, m, proj, v_c, v_s)):
        return ztzv_parts_plain(x, m, proj, sigma, v_c, v_s, fit_intercept,
                                mode)
    if x.device.type != "cuda":
        raise ValueError(f"ztzv_parts: no kernel for {x.device}.")
    check_cuda_operands("ztzv_parts", x, m, proj, v_c, v_s)
    mode = kernel_mode(mode)
    opts = dict(dtype=torch.float32, device=x.device)
    if n == 0 or f == 0:
        return torch.zeros((f, k), **opts), torch.zeros((f, k), **opts)
    zv_blocks = 1 if k == 1 else -(-k // ZV_RHS)
    if k > 65535:
        raise ValueError("ztzv_parts: too many right-hand sides for the "
                         "launch grid.")
    xh, xl = split_tf32(pad_depth(x))
    ph, pl = projT_split(proj)
    row_tiles, f_tiles = -(-n // TILE), -(-f // TILE)
    sms = sm_count(x.device.index)
    zsplit = tile_split(f_tiles, row_tiles * zv_blocks, sms, 16)
    osplit = tile_split(row_tiles, f_tiles * k, sms, 32)
    zv_part = torch.empty((zsplit, n, k), **opts)
    oc_part = torch.empty((osplit, f, k), **opts)
    os_part = torch.empty((osplit, f, k), **opts)
    oc = torch.empty((f, k), **opts)
    os_ = torch.empty((f, k), **opts)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.xgpr_ztzv(
            xh.data_ptr(), xl.data_ptr(), m.data_ptr(), ph.data_ptr(),
            pl.data_ptr(), float(sigma), v_c.data_ptr(), v_s.data_ptr(),
            zv_part.data_ptr(), oc_part.data_ptr(), os_part.data_ptr(),
            oc.data_ptr(), os_.data_ptr(), n, xh.shape[1], f, k, zsplit,
            osplit, rbf_norm_constant(f, fit_intercept),
            int(bool(fit_intercept)), kernel_sincos_flag(mode), stream)
    build.check(rc, "ztzv kernel")
    LAUNCHES[(n, d, f, k, mode)] += 1
    return oc, os_
