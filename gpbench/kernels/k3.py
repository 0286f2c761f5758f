"""K3, the convolution's feature parts: its launch counter
(``ops/cuda/conv.PARTS_LAUNCHES``, keyed by the rows, length and
channels of x, the width, the frequencies and the launch's tags), the
custom op its device time is charged to, and the work of its launches.
"""
from collections import Counter

from gpbench.harness import peaks

RANGE = "xgpr_tpu_torch::conv_parts"


def launches():
    from xgpr_tpu_torch.ops.cuda import conv
    return Counter(conv.PARTS_LAUNCHES)


def shape_work(rows, windows, seq_len, chans, width, freqs, launches,
               esize=4):
    """(flops, bytes) of K3 launches over ``rows`` real rows holding
    ``windows`` valid windows in all: 2 w C F per valid window; x, the
    length and the cos and sin outputs per row, the projection per
    launch."""
    flops = 2 * windows * width * chans * freqs
    nbytes = rows * (seq_len * chans * esize + 4 + 2 * freqs * esize) \
        + launches * width * chans * freqs * esize
    return flops, nbytes


def work(counts, basis, config):
    """(flops, bytes) of the launches in ``counts``, at every shape."""
    esize = peaks.ESIZE[config["model"]["feature_dtype"]]
    flops = nbytes = 0
    for key, n in counts.items():
        key_rows, seq_len, chans, width, freqs = key[:5]
        rows, windows = peaks.covered(key_rows, n, basis)
        f, b = shape_work(rows, windows, seq_len, chans, width, freqs, n,
                          esize)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes
