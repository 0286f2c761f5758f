"""K4, the convolution's ReLU max-pool (Conv1dTwoLayer's layer 1 and
FastConv1d's static layer): its launch counter
(``ops/cuda/conv.MAXPOOL_LAUNCHES``, keyed by the rows, length and
channels of x, the width, the frequencies and the precision), the custom
op its device time is charged to, and the work of its launches.
"""
from collections import Counter

from gpbench.harness import peaks

RANGE = "xgpr_tpu_torch::conv_maxpool"


def launches():
    from xgpr_tpu_torch.ops.cuda import conv
    return Counter(conv.MAXPOOL_LAUNCHES)


def shape_work(rows, windows, seq_len, chans, width, freqs, launches,
               esize=4):
    """(flops, bytes) of K4 launches over ``rows`` real rows holding
    ``windows`` valid windows in all: 2 w C F per valid window; x, the
    length and the F outputs per row, the projection per launch."""
    flops = 2 * windows * width * chans * freqs
    nbytes = rows * (seq_len * chans * esize + 4 + freqs * esize) \
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
