"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, without
sparsity, at the 700 W power limit (NVIDIA's data sheet), and the
roofline arithmetic that every kernel's count shares.

A share counts the work the calls' shapes need once (each kernel's
count is in ``gpbench/kernels/<kernel>.py``): the multiply-adds of a
projection or a contraction, 2 flops each, never a body's emulation
passes; each input byte read once and each output byte written once.
The sincos evaluations are not counted.  The peak is that of the
fastest tensor-core format the configuration's feature precision admits:
TF32 for float32 features (the float32 bodies emulate float32 on TF32
tensor cores), bf16 for bf16, FP64 for float64.
"""
FLOPS = {"tf32": 495e12, "bf16": 989e12, "fp64": 67e12}
FORMAT_OF = {"float32": "tf32", "bfloat16": "bf16", "float64": "fp64"}
ESIZE = {"float32": 4, "bfloat16": 2, "float64": 8}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops, nbytes, feature_dtype):
    """The least time the card could take: operations over the peak or
    bytes over the bandwidth, whichever is longer."""
    return max(flops / FLOPS[FORMAT_OF[feature_dtype]],
               nbytes / HBM_BYTES_PER_S)


def share(flops, nbytes, seconds, feature_dtype):
    """The roofline share in %, or None when nothing was timed."""
    if not seconds or seconds <= 0 or flops <= 0:
        return None
    return 100.0 * least_seconds(flops, nbytes, feature_dtype) / seconds


def covered(key_rows, launches, basis):
    """(real rows, valid windows or None) that ``launches`` launches of
    ``key_rows`` rows each covered.  Launches at the chunk's row count
    are chunks of whole passes over the operation's data (``basis``:
    its real ``rows``, their ``windows`` or None, its ``chunks`` of
    ``chunk_rows``), so a pass's padded rows are not counted; launches
    at another row count are taken as real rows throughout.  Windows
    are the rows' share of the basis's."""
    if key_rows == basis["chunk_rows"]:
        rows = launches * basis["rows"] / basis["chunks"]
    else:
        rows = launches * key_rows
    windows = None if basis.get("windows") is None else \
        rows * basis["windows"] / basis["rows"]
    return rows, windows
