"""K1, Z^T (Z v) with the features made on the fly: its launch counter
(``ops/cuda/ztzv.LAUNCHES``, keyed by the rows and depth of x, the
frequencies, the right-hand sides and the launch's tags), the host range
its device time is charged to, and the work of its launches.

K1 is no custom op, so in traced runs ``ranged`` opens the range
``gpbench/k1`` around the kernel layer's entry, ``kernels/basic.py``'s
``ztzv_parts``, by assignment, and puts the entry back after.
"""
import contextlib
from collections import Counter

import torch

from gpbench.harness import peaks

RANGE = "gpbench/k1"


def launches():
    from xgpr_tpu_torch.ops.cuda import ztzv
    return Counter(ztzv.LAUNCHES)


@contextlib.contextmanager
def ranged():
    from xgpr_tpu_torch.kernels import basic
    original = basic.ztzv_parts

    def in_range(*args, **kwargs):
        with torch.profiler.record_function(RANGE):
            return original(*args, **kwargs)
    basic.ztzv_parts = in_range
    try:
        yield
    finally:
        basic.ztzv_parts = original


def shape_work(rows, dim, freqs, rhs, launches, esize=4):
    """(flops, bytes) of K1 launches over ``rows`` real rows in all: the
    projection 2 R D F and the contractions Z^T (Z v) on the cos and sin
    halves, 8 R F K; x and the mask read per row, the projection and
    v_c, v_s, oc, os (F x K each) per launch."""
    flops = rows * (2 * dim * freqs + 8 * freqs * rhs)
    nbytes = rows * (dim + 1) * esize \
        + launches * (dim * freqs + 4 * freqs * rhs) * esize
    return flops, nbytes


def work(counts, basis, config):
    """(flops, bytes) of the launches in ``counts``, at every shape."""
    esize = peaks.ESIZE[config["model"]["feature_dtype"]]
    flops = nbytes = 0
    for key, n in counts.items():
        key_rows, dim, freqs, rhs = key[:4]
        rows, _ = peaks.covered(key_rows, n, basis)
        f, b = shape_work(rows, dim, freqs, rhs, n, esize)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes
