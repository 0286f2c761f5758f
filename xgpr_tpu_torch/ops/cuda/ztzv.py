"""Fused CG matvec for one chunk: the K1 kernel's wrapper and its plain version.

Replaces xgpr_tpu/ops/pallas/ztzv_pallas.py (``ztzv_parts_pallas``, whose
``pallas_call`` is in ``_ztzv_parts_impl``) with the CUDA C++ kernels in
csrc/ztzv.cu; see that file for the design and what bounds it on the card.
Same semantics: x raw (not sigma-scaled), sigma multiplies the product,
scale = rbf_norm_constant(F, intercept), mask * scale folded into both
parts, and with an intercept cos column 0 equals the mask.

``ztzv_parts`` runs the plain version for CPU tensors and the kernel for
CUDA tensors; anything else raises.  ``LAUNCHES`` counts kernel launches
(one per call, covering its three CUDA launches).
"""
from functools import lru_cache

import torch

from .. import sincos as _sincos
from ..contract import parts_contract
from ..sorf import rbf_norm_constant
from . import build
from .feature_map import check_cuda_operands, kernel_sincos_flag

LAUNCHES = 0

_TILE = 64          # rows and frequencies per tile (csrc/common.cuh)
_BLOCKS_PER_SM = 4  # blocks to aim for per SM when splitting a launch


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


@lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _split(tiles, other_blocks, sms, cap):
    """How many slices of the loop dimension to give separate blocks, so
    the launch has about _BLOCKS_PER_SM blocks per SM."""
    want = -(-_BLOCKS_PER_SM * sms // max(1, other_blocks))
    return max(1, min(want, tiles, cap))


def ztzv_parts(x, m, proj, sigma, v_c, v_s, fit_intercept, mode=None):
    """(oc, os), each (F, K): the chunk's Z^T (Z v) in cos/sin halves.

    x (R, D) raw rows; m (R,) row mask; proj (D, F); sigma a float;
    v_c / v_s (F, K) the cos/sin halves of the CG direction.
    """
    global LAUNCHES
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
    exact = kernel_sincos_flag(mode)
    kchunks = 1 if k == 1 else -(-k // 8)
    row_tiles, f_tiles = -(-n // _TILE), -(-f // _TILE)
    if kchunks > 65535:
        raise ValueError("ztzv_parts: shapes exceed the launch grid.")
    sms = _sm_count(x.device.index)
    zsplit = _split(f_tiles, row_tiles * kchunks, sms, 16)
    osplit = _split(row_tiles, f_tiles * kchunks, sms, 32)
    opts = dict(dtype=torch.float32, device=x.device)
    zv_part = torch.empty((zsplit, n, k), **opts)
    oc_part = torch.empty((osplit, f, k), **opts)
    os_part = torch.empty((osplit, f, k), **opts)
    oc = torch.empty((f, k), **opts)
    os_ = torch.empty((f, k), **opts)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.xgpr_ztzv(
            x.data_ptr(), m.data_ptr(), proj.data_ptr(), float(sigma),
            v_c.data_ptr(), v_s.data_ptr(), zv_part.data_ptr(),
            oc_part.data_ptr(), os_part.data_ptr(), oc.data_ptr(),
            os_.data_ptr(), n, d, f, k, zsplit, osplit,
            rbf_norm_constant(f, fit_intercept), int(bool(fit_intercept)),
            exact, stream)
    build.check(rc, "ztzv kernel")
    LAUNCHES += 1
    return oc, os_
