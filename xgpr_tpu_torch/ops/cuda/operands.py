"""Host-side preparation of the kernels' operands.

Every kernel of csrc/ computes its projection in one of four bodies
(csrc/tf32_gemm.cuh: Format; feature_map.py ``kernel_body`` picks it from
the operands' dtype and the feature precision) and reads both operands
K-major, in 16-byte copies, as that body's planes:

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
  transpose (F, dp), cached with the projection tensor and keyed on the
  body: the RBF kernels and Conv1dTwoLayer's second layer pass the
  same tensor on every call;
- ``tile_split``: how many blocks share a loop over tiles.
"""
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


# id(proj) -> (weak reference to proj, proj._version, {body: planes})
_PROJ_SPLITS = {}


def projT_planes(proj, body="tf32x3"):
    """kernel_planes(pad_depth(proj.T), body) for proj (D, F): the (F, dp)
    K-major operand of the dense kernels.  Kept, for each body asked for,
    while proj lives and is not modified in place (its version counter),
    and built anew otherwise."""
    key = id(proj)
    hit = _PROJ_SPLITS.get(key)
    if hit is None or hit[0]() is not proj or hit[1] != proj._version:
        ref = weakref.ref(proj,
                          lambda _, key=key: _PROJ_SPLITS.pop(key, None))
        hit = _PROJ_SPLITS[key] = (ref, proj._version, {})
    planes = hit[2].get(body)
    if planes is None:
        planes = hit[2][body] = kernel_planes(
            pad_depth(proj.t(), depth_multiple(body)), body)
    return planes


def data_ptr(t):
    """t's device address for the C entry points; None (NULL) for None."""
    return None if t is None else t.data_ptr()


@lru_cache(maxsize=None)
def sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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
