"""Host-side preparation of the tensor-core kernels' operands.

Every kernel of csrc/ computes its projection as a 3xTF32 product on the
tensor cores (csrc/tf32_gemm.cuh) and reads both operands K-major, in
16-byte copies, already split into TF32 high parts and remainders.  These
plain torch functions prepare them:

- ``split_tf32``: (hi, lo) with hi + lo == a exactly;
- ``pad_depth``: the contraction axis padded by zeros to a multiple of 4;
- ``projT_split``: a dense projection (D, F) as the split of its padded
  transpose (F, dp), cached with the projection tensor: the RBF kernels
  and Conv1dTwoLayer's second layer pass the same tensor on every call;
- ``tile_split``: how many blocks share a loop over tiles.
"""
import weakref
from functools import lru_cache

import torch
import torch.nn.functional as F


def split_tf32(a):
    """(hi, lo), float32 with hi + lo == a exactly: hi is a rounded to TF32
    (10 explicit mantissa bits; to nearest, ties away from zero, as
    cvt.rna.tf32.f32 rounds) and lo = a - hi, of which the tensor cores
    read the top TF32 bits."""
    bits = a.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, a - hi


def pad_depth(a):
    """a (..., d) contiguous, with the last axis padded by zeros to the
    next multiple of 4 (16-byte rows); a itself when it is already so."""
    d = a.shape[-1]
    dp = -(-d // 4) * 4
    if dp != d:
        a = F.pad(a, (0, dp - d))
    return a.contiguous()


# id(proj) -> (weak reference to proj, proj._version, (hi, lo))
_PROJ_SPLITS = {}


def projT_split(proj):
    """split_tf32(pad_depth(proj.T)) for proj (D, F): the (F, dp) K-major
    operand of the dense kernels.  Kept while proj lives and is not
    modified in place (its version counter), and built anew otherwise."""
    key = id(proj)
    hit = _PROJ_SPLITS.get(key)
    if hit is not None and hit[0]() is proj and hit[1] == proj._version:
        return hit[2]
    out = split_tf32(pad_depth(proj.t()))
    ref = weakref.ref(proj, lambda _, key=key: _PROJ_SPLITS.pop(key, None))
    _PROJ_SPLITS[key] = (ref, proj._version, out)
    return out


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
